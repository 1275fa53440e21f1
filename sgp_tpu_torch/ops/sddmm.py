"""Block-sparse SDDMM and graph attention on the 128x128 BSR structure.

Counterpart of ``sgp_tpu/ops/sddmm.py``. SDDMM (sampled dense-dense
matmul) computes ``(Q @ K^T)[i, j]`` only at the stored 128x128 blocks of a
graph's adjacency; with a masked softmax and a block SpMM it gives sparse
graph attention, numerically the edge-list
``ops/functional.py::sparse_multi_head_attention``.

- :func:`bsr_attention_structure` packs a host graph once.
- :func:`bsr_sddmm` is the entry of kernel K2, differentiable. On a CUDA
  tensor it launches ``csrc/sddmm.cu`` (CUDA C++ for ``sm_90a``, built with
  ``nvcc`` at first use, loaded with ``ctypes``) or raises; on a CPU tensor
  it runs :func:`bsr_sddmm_plain`. There is no other fallback. Its backward
  is two block SpMMs over the structure (K1 on the card, its plain version
  on the CPU): ``dQ = dS @ K`` and ``dK = dS^T @ Q``, with no
  order-dependent sum (the JAX package has no backward kernel).
- :func:`bsr_masked_softmax` and the block SpMM tail :func:`_block_spmv`,
  which runs through the port's K1 (``ops/bsr_kernel.py::bsr_spmm``) and
  its backward.
- :func:`bsr_multi_head_attention`, q/k/v ``[N, H, D]``, heads on axis 1.

The JAX op's ``variant=`` argument is gone: the tensor's device decides.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from sgp_tpu_torch.ops import _build
from sgp_tpu_torch.ops.bsr_kernel import _spmm, bsr_spmm, kept_transpose
from sgp_tpu_torch.ops.scatter import segment_max, segment_sum
from sgp_tpu_torch.utils.device import resolve_device

BLOCK = 128


@dataclasses.dataclass
class BSRAttentionStructure:
    """Static block pattern of a graph's adjacency, for attention.

    ``mask_blocks`` marks the true edge positions inside each stored block
    (a stored 128x128 tile still has zeros where no edge exists, and
    attention must not attend there). ``row_ptr`` is ``Graph.to_bsr``'s
    offsets over block rows, which the block SpMM (K1) walks."""
    block_rows: torch.Tensor     # [nnzb] int32, sorted
    block_cols: torch.Tensor     # [nnzb] int32
    mask_blocks: torch.Tensor    # [nnzb, B, B] bool
    row_ptr: torch.Tensor        # [n_block_rows + 1] int32
    n_block_rows: int
    num_nodes: int


def bsr_attention_structure(g, device=None) -> BSRAttentionStructure:
    """Pack a host :class:`~sgp_tpu_torch.graph.Graph`'s connectivity into
    the block pattern, once per graph. Built from unit edge weights, so
    explicit zero-weight edges stay attendable. ``device=None`` means
    ``cuda:0`` (``utils/device.py``)."""
    from sgp_tpu_torch.graph.sparse import Graph

    device = resolve_device(device)
    unit = Graph(g.src, g.dst, np.ones(len(g.src), np.float32), g.num_nodes)
    blocks, cols, ptr = unit.to_bsr(BLOCK)
    rows = np.repeat(np.arange(len(ptr) - 1, dtype=np.int32), np.diff(ptr))
    as_t = lambda a: torch.as_tensor(a, device=device)
    return BSRAttentionStructure(as_t(rows), as_t(cols), as_t(blocks != 0.0),
                                 as_t(ptr), len(ptr) - 1, g.num_nodes)


# -- K2: the SDDMM ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def build():
    """Compile ``csrc/sddmm.cu`` (once per source hash) and load it;
    returns ``(lib, seconds, log)`` as :func:`_build.build` does."""
    lib, seconds, log = _build.build("sddmm")
    for name in ("sgp_sddmm_f32", "sgp_sddmm_bf16"):
        _build.bind(lib, name, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    return lib, seconds, log


def _pad_tiles(x: torch.Tensor, n_block_rows: int) -> torch.Tensor:
    """[N, D] -> [n_block_rows, B, D] node tiles, rows past N zero. (The
    JAX helper also pads D to 128, which adds only zeros to the sums.)"""
    n, d = x.shape
    out = torch.zeros((n_block_rows * BLOCK, d), dtype=x.dtype,
                      device=x.device)
    out[:n] = x
    return out.view(n_block_rows, BLOCK, d)


def bsr_sddmm_plain(q: torch.Tensor, k: torch.Tensor,
                    block_rows: torch.Tensor, block_cols: torch.Tensor,
                    n_block_rows: int) -> torch.Tensor:
    """The plain PyTorch version of K2, mirroring ``bsr_sddmm_xla``: gather
    the q and k node tiles of every block, one batched f32 matmul (TF32 is
    off in the port). q/k ``[N, D]``; returns ``[nnzb, B, B]`` f32."""
    qt = _pad_tiles(q, n_block_rows)[block_rows.long()].float()
    kt = _pad_tiles(k, n_block_rows)[block_cols.long()].float()
    return torch.bmm(qt, kt.transpose(1, 2))


def _check_input(name: str, t: torch.Tensor, like: torch.Tensor):
    if t.device != like.device or t.dtype != like.dtype or t.ndim != 2 \
            or t.shape != like.shape or t.stride(1) != 1:
        raise ValueError(
            f"{name} must be [N, D] {like.dtype} on {like.device} with unit "
            f"column stride, got {t.dtype} {tuple(t.shape)} strides "
            f"{t.stride()} on {t.device}")


def _aligned_rows(x: torch.Tensor) -> torch.Tensor:
    """x itself where its rows start on 16 bytes (base and row stride), as
    the kernel's 16-byte copies need; else a copy whose rows are padded with
    zero columns to a multiple of 16 bytes, viewed back to x's width (D = 1
    in f32, a head view ``q[:, h]`` of ``[N, 3, 5]``)."""
    per16 = 16 // x.element_size()
    if x.data_ptr() % 16 == 0 and x.stride(0) % per16 == 0:
        return x
    n, d = x.shape
    padded = torch.zeros((n, -(-d // per16) * per16), dtype=x.dtype,
                         device=x.device)
    padded[:, :d] = x
    return padded[:, :d]


def bsr_sddmm_kernel(q: torch.Tensor, k: torch.Tensor,
                     block_rows: torch.Tensor, block_cols: torch.Tensor,
                     n_block_rows: int) -> torch.Tensor:
    """Launch K2 on CUDA tensors: q/k ``[N, D]`` f32 or bf16 with unit
    column stride (any row stride, so ``q[:, h]`` of ``[N, H, D]`` passes
    without a copy); returns ``[nnzb, B, B]`` f32 from ``torch.empty``,
    every element written. Raises on what the kernel does not take."""
    if not q.is_cuda:
        raise ValueError(f"bsr_sddmm_kernel runs on CUDA tensors, not "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q and k must be float32 or bfloat16, got {q.dtype}")
    _check_input("q", q, q)
    _check_input("k", k, q)
    q, k = _aligned_rows(q), _aligned_rows(k)
    n, d = q.shape
    if n > n_block_rows * BLOCK or n_block_rows * BLOCK > 2 ** 31 - 1:
        raise ValueError(f"N = {n} does not fit {n_block_rows} block rows")
    for name, t in (("block_rows", block_rows), ("block_cols", block_cols)):
        if t.device != q.device or t.dtype != torch.int32 \
                or not t.is_contiguous() or t.ndim != 1:
            raise ValueError(f"{name} must be a contiguous [nnzb] int32 "
                             f"tensor on {q.device}, got {t.dtype} on "
                             f"{t.device}")
    nnzb = block_rows.numel()
    if block_cols.numel() != nnzb:
        raise ValueError(f"block_rows ({nnzb}) and block_cols "
                         f"({block_cols.numel()}) differ in length")
    out = torch.empty((nnzb, BLOCK, BLOCK), dtype=torch.float32,
                      device=q.device)
    if nnzb == 0:
        return out
    lib = build()[0]
    fn = lib.sgp_sddmm_bf16 if q.dtype == torch.bfloat16 \
        else lib.sgp_sddmm_f32
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), block_rows.data_ptr(),
                 block_cols.data_ptr(), out.data_ptr(), nnzb, n, d,
                 q.stride(0), k.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"sddmm kernel launch failed: CUDA error {err}")
    bsr_sddmm_kernel.launches += 1
    return out


bsr_sddmm_kernel.launches = 0  # kernel launches since the last reset to 0


def _sddmm_forward(q, k, block_rows, block_cols, n_block_rows):
    if q.device.type == "cpu":
        return bsr_sddmm_plain(q, k, block_rows, block_cols, n_block_rows)
    return bsr_sddmm_kernel(q, k, block_rows, block_cols, n_block_rows)


class _BSRSDDMM(torch.autograd.Function):
    """K2 (or its plain version on the CPU) forward; the backward is two
    block SpMMs with the f32 score gradients as tiles (K1 on the card, its
    plain version on the CPU): ``dQ = A_ds @ K`` over the structure's
    ``row_ptr``, ``dK = A_ds^T @ Q`` over its transpose with the tiles
    ``ds[perm]^T``. That is ``jax.grad`` of ``bsr_sddmm_xla``, in f32, cast
    to the inputs' dtypes; K1 sums in a fixed order, so two calls give the
    same bits."""

    @staticmethod
    def forward(ctx, q, k, block_rows, block_cols, row_ptr):
        ctx.save_for_backward(q, k, block_rows, block_cols, row_ptr)
        return _sddmm_forward(q, k, block_rows, block_cols,
                              row_ptr.numel() - 1)

    @staticmethod
    def backward(ctx, ds):
        q, k, rows, cols, row_ptr = ctx.saved_tensors
        ds = ds.float().contiguous()
        dq = dk = None
        if ctx.needs_input_grad[0]:
            dq = _spmm(ds, cols, row_ptr, rows, k.float()).to(q.dtype)
        if ctx.needs_input_grad[1]:
            # the tiles of A_ds^T change every call: not kept in the cache
            perm, t_cols, t_ptr, t_rows = kept_transpose(cols).index(
                cols, rows, row_ptr.numel() - 1)
            t_tiles = ds[perm].transpose(1, 2).contiguous()
            dk = _spmm(t_tiles, t_cols, t_ptr, t_rows, q.float()).to(k.dtype)
        return dq, dk, None, None, None


def bsr_sddmm(q: torch.Tensor, k: torch.Tensor,
              struct: BSRAttentionStructure) -> torch.Tensor:
    """``[nnzb, B, B]`` f32 scores ``Q @ K^T`` at the stored blocks; q/k
    ``[N, D]`` f32 or bf16. K2 on a CUDA tensor, the plain version on a CPU
    one; differentiable in q and k."""
    if struct.block_rows.numel() == 0:
        return torch.zeros((0, BLOCK, BLOCK), dtype=torch.float32,
                           device=q.device)
    return _BSRSDDMM.apply(q, k, struct.block_rows, struct.block_cols,
                           struct.row_ptr)


# -- softmax and the block SpMM tail ----------------------------------------

def bsr_masked_softmax(logit_blocks: torch.Tensor,
                       struct: BSRAttentionStructure) -> torch.Tensor:
    """Softmax over each destination row's true edges, across all the row's
    stored blocks. Rows with no edges produce zero weights."""
    neg = torch.finfo(torch.float32).min
    rows = struct.block_rows.long()
    l = torch.where(struct.mask_blocks, logit_blocks, neg)
    # per-block row maxima -> per-destination-row maxima
    m_row = segment_max(l.amax(dim=2), rows, struct.n_block_rows)  # [nbr, B]
    m_row = torch.clamp(m_row, min=neg)       # empty rows: -inf -> finite
    p = torch.where(struct.mask_blocks,
                    torch.exp(l - m_row[rows][:, :, None]), 0.0)
    denom = segment_sum(p.sum(dim=2), rows, struct.n_block_rows)  # [nbr, B]
    # not 1e-38: subnormal in f32, flushed to zero on the TPU -> 0/0
    denom = torch.clamp(denom, min=1e-30)
    return p / denom[rows][:, :, None]


def _block_spmv(att_blocks: torch.Tensor, v: torch.Tensor,
                struct: BSRAttentionStructure) -> torch.Tensor:
    """``att @ v`` with the f32 attention weights in block form (the SpMM
    tail of attention): K1 with the weights as its tiles, differentiable
    through ``bsr_spmm``'s backward (``d_att`` on K2, ``dv`` on K1 over the
    structure's transpose). v ``[N, D]``; returns ``[N, D]`` in v's
    dtype."""
    return bsr_spmm(att_blocks, struct.block_cols, struct.row_ptr,
                    struct.block_rows, v)


def bsr_multi_head_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, struct: BSRAttentionStructure,
                             scale: float | None = None) -> torch.Tensor:
    """Sparse multi-head attention with block-sampled scores: per-edge
    logits ``<q_dst, k_src>``, softmax over each node's in-edges, weighted
    value aggregation. q/k/v ``[N, H, D]``; returns ``[N, H, D]``. The
    scores are scaled in f32 after the SDDMM; ``scale=None`` means
    ``D ** -0.5``."""
    d = q.shape[-1]
    s = scale if scale is not None else d ** -0.5
    outs = []
    for h in range(q.shape[1]):
        logits = bsr_sddmm(q[:, h], k[:, h], struct) * s
        att = bsr_masked_softmax(logits, struct)
        outs.append(_block_spmv(att, v[:, h], struct))
    return torch.stack(outs, dim=1)
