"""Block-sparse-row SpMM ``out = A @ x``: CUDA kernel and plain version.

Counterpart of ``sgp_tpu/ops/bsr_kernel.py``. The operator is packed into
dense 128x128 tiles at its nonzero block positions (``Graph.to_bsr``):
``blocks [nnzb, 128, 128]``, ``block_cols [nnzb]`` and ``row_ptr
[n_block_rows + 1]``. Each output row accumulates over its block row's
tiles in f32; block rows without tiles give zeros.

- :func:`bsr_spmm` is the entry. On a CUDA tensor it launches the kernel
  in ``csrc/bsr_spmm.cu`` (CUDA C++ for ``sm_90a``, built with ``nvcc`` at
  first use into the repository's ``build/`` directory, keyed on a hash of
  the source, and loaded with ``ctypes``) or raises; on a CPU tensor it
  runs :func:`bsr_spmm_plain`. There is no other fallback.
- :func:`bsr_spmm_plain` mirrors ``bsr_spmm_xla``: a tile gather, one
  ``torch.bmm`` and an ``index_add_`` over the block rows. It is what the
  CPU tests run, and the kernel's oracle on the card.

Both round like the Pallas kernel: with bf16 tiles, x is read as bf16,
products and sums are f32, and the result is rounded to bf16 before the
cast back to x's dtype (``bsr_spmm_xla`` skips that last rounding).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

BLOCK = 128

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "bsr_spmm.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@functools.lru_cache(maxsize=None)
def build():
    """Compile the kernel once per source hash and load it.

    Returns ``(lib, seconds, log)``: the ``ctypes`` library, the compile
    time (0 when the library was already built) and ``nvcc``'s output,
    which holds ``ptxas``'s register and shared-memory report."""
    source = _SOURCE.read_bytes()
    key = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"bsr_spmm_{key}.so"
    seconds, log = 0.0, ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                               str(_SOURCE)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("sgp_bsr_spmm_f32", "sgp_bsr_spmm_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, seconds, log


def _compute_dtype(blocks: torch.Tensor) -> torch.dtype:
    if blocks.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"blocks must be float32 or bfloat16, "
                        f"got {blocks.dtype}")
    return blocks.dtype


def bsr_spmm(blocks: torch.Tensor, block_cols: torch.Tensor,
             row_ptr: torch.Tensor, block_rows: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for ``x [N, F]`` with ``N <= n_block_rows * 128``; returns
    ``[N, F]`` in x's dtype. ``block_rows [nnzb]`` (the block row of each
    tile, sorted) feeds the plain version; the kernel walks ``row_ptr``.

    The index arrays are trusted: :meth:`BSROperator.from_bsr` validates
    them on the host once."""
    cdt = _compute_dtype(blocks)
    n_block_rows = row_ptr.numel() - 1
    if x.ndim != 2 or x.shape[0] > n_block_rows * BLOCK:
        raise ValueError(f"x must be [N, F] with N <= {n_block_rows * BLOCK},"
                         f" got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return bsr_spmm_plain(blocks, block_cols, block_rows, n_block_rows, x)
    if not x.is_cuda:
        raise ValueError(f"bsr_spmm runs on CPU or CUDA, not {x.device}")
    for name, t, dt in (("blocks", blocks, cdt), ("block_cols", block_cols,
                        torch.int32), ("row_ptr", row_ptr, torch.int32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    if blocks.shape[1:] != (BLOCK, BLOCK) or \
            block_cols.shape != (blocks.shape[0],):
        raise ValueError(f"blocks {tuple(blocks.shape)} / block_cols "
                         f"{tuple(block_cols.shape)} do not match")
    n, f = x.shape
    xk = x.to(cdt).contiguous()
    out = torch.empty((n, f), dtype=cdt, device=x.device)
    lib = build()[0]
    fn = lib.sgp_bsr_spmm_bf16 if cdt == torch.bfloat16 \
        else lib.sgp_bsr_spmm_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(blocks.data_ptr(), block_cols.data_ptr(),
                 row_ptr.data_ptr(), xk.data_ptr(), out.data_ptr(),
                 n_block_rows, n, f, stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed: CUDA error {err}")
    bsr_spmm.launches += 1
    return out.to(x.dtype)


bsr_spmm.launches = 0  # kernel launches since the last reset to 0


def bsr_spmm_plain(blocks: torch.Tensor, block_cols: torch.Tensor,
                   block_rows: torch.Tensor, n_block_rows: int,
                   x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`bsr_spmm` (same arguments,
    ``n_block_rows`` given): gather the x tile of every stored block, one
    batched f32 matmul, then a sum over block rows."""
    cdt = _compute_dtype(blocks)
    n, f = x.shape
    x_pad = torch.zeros((n_block_rows * BLOCK, f), dtype=cdt,
                        device=x.device)
    x_pad[:n] = x.to(cdt)
    xt = x_pad.view(n_block_rows, BLOCK, f)[block_cols.long()]
    mm = torch.bmm(blocks.float(), xt.float())          # [nnzb, B, F] f32
    agg = torch.zeros((n_block_rows, BLOCK, f), dtype=torch.float32,
                      device=x.device)
    agg.index_add_(0, block_rows.long(), mm)
    return agg.view(-1, f)[:n].to(cdt).to(x.dtype)


def prepare_bsr(blocks: np.ndarray, block_cols: np.ndarray,
                row_ptr: np.ndarray):
    """Host-side prep, done once at operator build: validates the index
    arrays the kernel trusts and returns ``(blocks f32, cols int32,
    row_ptr int32, block_rows int32)``."""
    blocks = np.asarray(blocks, np.float32)
    cols = np.asarray(block_cols, np.int64)
    ptr = np.asarray(row_ptr, np.int64)
    nnzb, n_br = blocks.shape[0], len(ptr) - 1
    if blocks.shape[1:] != (BLOCK, BLOCK) or cols.shape != (nnzb,):
        raise ValueError(f"blocks {blocks.shape} / block_cols {cols.shape} "
                         f"are not [nnzb, {BLOCK}, {BLOCK}] / [nnzb]")
    if len(ptr) == 0 or ptr[0] != 0 or ptr[-1] != nnzb \
            or np.any(np.diff(ptr) < 0):
        raise ValueError("row_ptr must rise from 0 to nnzb")
    if nnzb and (cols.min() < 0 or cols.max() >= n_br):
        raise ValueError(f"block_cols must lie in [0, {n_br})")
    rows = np.repeat(np.arange(n_br, dtype=np.int32), np.diff(ptr))
    return blocks, cols.astype(np.int32), ptr.astype(np.int32), rows
