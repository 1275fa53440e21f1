"""Speed-of-light accounting for the hot kernel paths, at an NVIDIA H100's
rates.

Counterpart of ``sgp_tpu/obs/roofline.py``: the dense, COO and IID-step
functions count the same bytes and matrix products, priced at the card's
rates; the block-sparse one counts the function's own work (each input
read once, each output written once), which is the floor, where the JAX
module counts its kernel's walk of the block store. A program's floor is
the larger of its bytes over the memory rate and its products over the
rate of the pipe that computes them; the IID step's gather also has a
measured floor a draw, where a random access costs more than its bytes. The rates, and K1's count, are
the one source of ``chip_smoke.py``'s bounds. Host arithmetic only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12   # device memory
FFMA_FLOPS = 67e12          # f32 on the FMA pipe, outside the tensor cores
TF32_FLOPS = 495e12         # TF32 on the tensor cores
BF16_FLOPS = 989e12         # bf16 on the tensor cores, f32 accumulate
# f32-accurate products on the tensor cores: three TF32 products each
# (the split of each f32 operand into a high and a low TF32 part)
TF32_PASSES = 3

# the card's random-row gather, measured on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit by chip_smoke.py phase 20 (e): a gather of 1 KiB
# rows (torch.index_select of 2**20 draws from a 1 GiB table, 20x the 50 MB
# L2) sustains 1.447e9 rows a second, 1.13x the time of its bytes (each
# row read and written): near the memory rate, unlike the TPU's, so a
# random gather costs about its bytes here
ROW_GATHER_LAT_S = 6.91e-10


@dataclass
class Bound:
    """A program's floor: seconds, and the wall that sets it. ``pipe``
    names the pipe of the products: ``"fma"`` or ``"tensor"``; ``bytes``
    and ``flops`` are the counts it was priced for."""
    seconds: float
    bytes_seconds: float
    math_seconds: float
    pipe: str = "tensor"
    bytes: float = 0.0
    flops: float = 0.0

    @property
    def limiter(self) -> str:
        """``"bytes"``, or the products' pipe."""
        return "bytes" if self.bytes_seconds >= self.math_seconds \
            else self.pipe

    def pct_of(self, measured_seconds: float) -> float:
        """Fraction of the attainable rate the measurement achieved."""
        return self.seconds / max(measured_seconds, 1e-12)


def products_time(flops: float, precision: str = "highest"):
    """Seconds and pipe of ``flops`` matrix-product operations:
    ``"highest"`` (f32-accurate) on the cheaper of the FMA pipe and
    3xTF32 on the tensor cores; ``"default"`` one bf16 pass on the tensor
    cores, as the port's dense operator computes; ``"fma"`` the FMA pipe
    alone (elementwise sums, which the tensor cores do not take)."""
    if precision == "default":
        return flops / BF16_FLOPS, "tensor"
    if precision not in ("highest", "fma"):
        raise ValueError(f"unknown precision {precision!r}")
    fma = flops / FFMA_FLOPS
    tensor = flops * TF32_PASSES / TF32_FLOPS
    if precision == "highest" and tensor < fma:
        return tensor, "tensor"
    return fma, "fma"


def _bound(bytes_moved: float, flops: float,
           precision: str = "default") -> Bound:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_math, pipe = products_time(flops, precision)
    return Bound(max(t_bytes, t_math), t_bytes, t_math, pipe=pipe,
                 bytes=bytes_moved, flops=flops)


def dense_spmm_bound(n: int, f: int, itemsize: int = 4,
                     precision: str = "default") -> Bound:
    """One ``[N, N] @ [N, F]`` pass: the operator read dominates bytes;
    ``precision`` prices the products, not the bytes."""
    bytes_moved = n * n * itemsize + 2 * n * f * 4
    flops = 2.0 * n * n * f
    return _bound(bytes_moved, flops, precision)


def bsr_spmm_bound(nnzb: int, n_block_rows: int, f: int,
                   block: int = 128, blk_itemsize: int = 2,
                   x_itemsize: int = 4, n: Optional[int] = None,
                   nonzeros: Optional[int] = None) -> Bound:
    """K1's floor, ``A @ x`` over ``nnzb`` stored ``block``-square tiles:
    the tiles and their int32 indices (a block column and a block row a
    tile, a row pointer a block row) and ``x [n, f]`` read once, the f32
    output ``[n, f]`` written once; 2 products per stored nonzero and
    column of x (``nonzeros``, every stored entry when not given), in bf16
    for 2-byte tiles, f32-accurate for 4-byte ones. ``n`` defaults to the
    block rows' span."""
    n = n_block_rows * block if n is None else n
    nonzeros = nnzb * block * block if nonzeros is None else nonzeros
    bytes_moved = (nnzb * (block * block * blk_itemsize + 4 + 4)
                   + (n_block_rows + 1) * 4
                   + n * f * x_itemsize + n * f * 4)
    return _bound(bytes_moved, 2.0 * nonzeros * f,
                  "default" if blk_itemsize == 2 else "highest")


def coo_spmm_bound(n_edges: int, n: int, f: int,
                   itemsize: int = 4) -> Bound:
    """Gather + segment-sum floor: per edge one x-row read and one message
    write and read around the segment reduction, whose sums run on the FMA
    pipe."""
    bytes_moved = (n_edges * (4 + 4 + itemsize)            # src/dst/w
                   + 3 * n_edges * f * itemsize            # gather + msg
                   + n * f * itemsize)                     # output
    flops = 2.0 * n_edges * f
    return _bound(bytes_moved, flops, "fma")


def iid_step_bound(batch: int, row_bytes: int, flops_per_step: float,
                   param_bytes: int = 0, gather_block: int = 1) -> dict:
    """The fused IID train step's floor: the sample-row gather (the larger
    of its bytes' time and ``ROW_GATHER_LAT_S`` per draw); the forward
    and backward products, f32-accurate (the port's decoder runs in f32,
    TF32 off); Adam's read and write of the parameter state. Returns the
    perfectly overlapped floor (the max) and the serial one (the sum).

    ``gather_block=G`` models the blocked gather (G consecutive rows per
    random draw): the latency term counts draws, the byte term every
    row."""
    t_gather = max(batch * row_bytes / HBM_BYTES_PER_S,
                   batch // max(gather_block, 1) * ROW_GATHER_LAT_S)
    t_math, pipe = products_time(flops_per_step, "highest")
    t_adam = param_bytes / HBM_BYTES_PER_S
    return {"t_gather_bound_s": t_gather, "t_math_bound_s": t_math,
            "math_pipe": pipe, "t_adam_bound_s": t_adam,
            "floor_overlap_s": max(t_gather, t_math, t_adam),
            "floor_serial_s": t_gather + t_math + t_adam}
