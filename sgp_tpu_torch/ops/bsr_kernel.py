"""Block-sparse-row SpMM ``out = A @ x``: CUDA kernel and plain version.

Counterpart of ``sgp_tpu/ops/bsr_kernel.py``. The operator is packed into
dense 128x128 tiles at its nonzero block positions (``Graph.to_bsr``):
``blocks [nnzb, 128, 128]``, ``block_cols [nnzb]`` and ``row_ptr
[n_block_rows + 1]``. Each output row accumulates over its block row's
tiles in f32; block rows without tiles give zeros.

- :func:`bsr_spmm` is the entry, differentiable in the tiles and in x. It
  calls the custom op ``sgp::bsr_spmm`` (``torch.library``), so
  ``torch.export`` and ``torch.compile`` trace it as one node. On a CUDA
  tensor the op launches the kernel in ``csrc/bsr_spmm.cu`` (CUDA C++ for
  ``sm_90a``, built with ``nvcc`` at first use into the repository's
  ``build/`` directory, keyed on a hash of the source, and loaded with
  ``ctypes``) or raises; on a CPU tensor it runs :func:`bsr_spmm_plain`.
  There is no other fallback. Its backward runs on the same routes:
  ``dx = A^T @ g`` is the block SpMM over the transposed block structure
  (:class:`BlockTranspose`, kept per structure by :func:`kept_transpose`),
  ``d_blocks`` the SDDMM of ``g`` and ``x`` at the stored blocks
  (``ops/sddmm.py``, K2 on the card).
- :func:`bsr_spmm_plain` mirrors ``bsr_spmm_xla``: a tile gather, one
  ``torch.bmm`` and an ``index_add_`` over the block rows. It is what the
  CPU tests run, and the kernel's oracle on the card.

Both round like the Pallas kernel: with bf16 tiles, x is read as bf16,
products and sums are f32, and the result is rounded to bf16 before the
cast back to x's dtype (``bsr_spmm_xla`` skips that last rounding). The
backward computes in f32 (bf16 tiles are widened exactly, x is rounded to
bf16 as the forward reads it) and casts each gradient to its input's
dtype, as ``jax.grad`` of ``bsr_spmm_xla`` does.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from sgp_tpu_torch.ops import _build

BLOCK = 128


@functools.lru_cache(maxsize=None)
def build():
    """Compile ``csrc/bsr_spmm.cu`` (once per source hash) and load it;
    returns ``(lib, seconds, log)`` as :func:`_build.build` does."""
    lib, seconds, log = _build.build("bsr_spmm")
    for name in ("sgp_bsr_spmm_f32", "sgp_bsr_spmm_bf16"):
        _build.bind(lib, name, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p])
    for name in ("sgp_bsr_spmm_workspace_f32", "sgp_bsr_spmm_workspace_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_longlong
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
    Differentiable in ``blocks`` and ``x``.

    The index arrays are trusted: :meth:`BSROperator.from_bsr` validates
    them on the host once."""
    _compute_dtype(blocks)
    n_block_rows = row_ptr.numel() - 1
    if x.ndim != 2 or x.shape[0] > n_block_rows * BLOCK:
        raise ValueError(f"x must be [N, F] with N <= {n_block_rows * BLOCK},"
                         f" got {tuple(x.shape)}")
    return _spmm(blocks, block_cols, row_ptr, block_rows, x)


bsr_spmm.launches = 0  # kernel launches since the last reset to 0


@torch.library.custom_op("sgp::bsr_spmm", mutates_args=(),
                         device_types="cpu")
def _spmm(blocks: torch.Tensor, block_cols: torch.Tensor,
          row_ptr: torch.Tensor, block_rows: torch.Tensor,
          x: torch.Tensor) -> torch.Tensor:
    """The op ``sgp::bsr_spmm``: the plain version on CPU tensors, the
    kernel on CUDA ones (:func:`_launch`)."""
    return bsr_spmm_plain(blocks, block_cols, block_rows,
                          row_ptr.numel() - 1, x)


@_spmm.register_kernel("cuda")
def _launch(blocks, block_cols, row_ptr, block_rows, x):
    """Check what the kernel reads, size its workspace and launch it on
    the current stream; each launch adds one to ``bsr_spmm.launches``,
    from eager code and from an exported program alike."""
    cdt = _compute_dtype(blocks)
    n_block_rows = row_ptr.numel() - 1
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
    nnzb = blocks.shape[0]
    # the kernel copies x in 16-byte pieces: rows padded with zero columns
    # to a multiple of 16 bytes, the base 16-byte aligned
    per16 = 16 // blocks.element_size()
    ldx = -(-f // per16) * per16
    xk = x.to(cdt).contiguous()
    if ldx != f or xk.data_ptr() % 16:
        xk = torch.nn.functional.pad(xk, (0, ldx - f))
    if blocks.data_ptr() % 16:
        blocks = blocks.clone()
    out = torch.empty((n, f), dtype=cdt, device=x.device)
    lib = build()[0]
    bf16 = cdt == torch.bfloat16
    fn = lib.sgp_bsr_spmm_bf16 if bf16 else lib.sgp_bsr_spmm_f32
    with torch.cuda.device(x.device):
        ws_bytes = (lib.sgp_bsr_spmm_workspace_bf16 if bf16 else
                    lib.sgp_bsr_spmm_workspace_f32)(nnzb, f)
        if ws_bytes < 0:
            raise RuntimeError(f"bsr_spmm launch plan failed: CUDA error "
                               f"{-ws_bytes}")
        # the parts of the block rows that two CTAs share, joined in order
        ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(blocks.data_ptr(), block_cols.data_ptr(),
                 row_ptr.data_ptr(), xk.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), nnzb, n_block_rows, n, f, ldx, stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed: CUDA error {err}")
    bsr_spmm.launches += 1
    return out.to(x.dtype)


@_spmm.register_fake
def _(blocks, block_cols, row_ptr, block_rows, x):
    return x.new_empty(x.shape)


class BlockTranspose:
    """The structure of ``A^T`` for one block structure, built on the
    tiles' device the first time a gradient asks for it and kept: the
    permutation that sorts the tiles by (column, row), and the transposed
    ``block_cols``, ``row_ptr`` and ``block_rows``. Its f32 tiles
    ``blocks[perm]^T`` are kept too while the tiles they come from are
    constant (the same tensor at the same version, needing no gradient),
    as an operator's are."""

    def __init__(self):
        self._index = None
        self._tiles = None
        self._tiles_of = None

    def index(self, block_cols: torch.Tensor, block_rows: torch.Tensor,
              n_block_rows: int):
        """``(perm int64, cols, row_ptr, rows int32)`` on the tiles'
        device."""
        if self._index is None:
            self._index = transpose_index(block_cols, block_rows,
                                          n_block_rows)
        return self._index

    def tiles(self, blocks: torch.Tensor, perm: torch.Tensor):
        """The f32 tiles of ``A^T`` in the transposed order."""
        key = (blocks, blocks._version)
        if self._tiles is not None and self._tiles_of[0] is key[0] \
                and self._tiles_of[1] == key[1]:
            return self._tiles
        tiles = transposed_tiles(blocks, perm)
        if not blocks.requires_grad:
            self._tiles, self._tiles_of = tiles, key
        return tiles


def transpose_index(block_cols: torch.Tensor, block_rows: torch.Tensor,
                    n_block_rows: int):
    """The transposed structure from torch ops, so a traced backward
    (``torch.export``, ``torch.compile``) records it: ``perm`` (int64)
    sorts the tiles by (column, row); the transpose's ``cols``,
    ``row_ptr`` and ``rows`` are int32."""
    cols, rows = block_cols.long(), block_rows.long()
    perm = torch.argsort(cols * n_block_rows + rows)
    t_rows = cols[perm]
    ptr = torch.zeros(n_block_rows + 1, dtype=torch.int64,
                      device=cols.device).index_add_(
        0, t_rows + 1, torch.ones_like(t_rows)).cumsum(0)
    return perm, rows[perm].int(), ptr.int(), t_rows.int()


def transposed_tiles(blocks: torch.Tensor, perm: torch.Tensor):
    return blocks.detach()[perm].transpose(1, 2).float().contiguous()


# a structure's block_cols tensor -> its BlockTranspose, while it lives
_TRANSPOSES = WeakIdKeyDictionary()


def kept_transpose(block_cols: torch.Tensor) -> BlockTranspose:
    """The :class:`BlockTranspose` kept for the block structure whose
    column tensor is ``block_cols``: operators and attention structures
    that share that tensor share it."""
    kept = _TRANSPOSES.get(block_cols)
    if kept is None:
        kept = _TRANSPOSES[block_cols] = BlockTranspose()
    return kept


def _setup_context(ctx, inputs, output):
    blocks, block_cols, row_ptr, block_rows, x = inputs
    ctx.save_for_backward(blocks, x, block_cols, block_rows)
    ctx.n_block_rows = row_ptr.numel() - 1
    # a traced backward sees fake tensors: it keeps nothing
    ctx.transpose = kept_transpose(block_cols) \
        if type(block_cols) is torch.Tensor else None


def _backward(ctx, g):
    """The VJP of ``sgp::bsr_spmm``: ``dx = A^T @ g`` through the op on
    the transposed structure, ``d_blocks[k] = g_tile[rows[k]] @
    x_tile[cols[k]]^T`` through the SDDMM, both in f32 on the tensors'
    device."""
    from sgp_tpu_torch.ops.sddmm import _sddmm_forward
    blocks, x, block_cols, block_rows = ctx.saved_tensors
    nbr = ctx.n_block_rows
    g = g.float().contiguous()
    d_blocks = dx = None
    if ctx.needs_input_grad[0]:
        # x as the forward read it: rounded to the tiles' dtype
        xr = x.detach().to(blocks.dtype).float().contiguous()
        d_blocks = _sddmm_forward(g, xr, block_rows, block_cols,
                                  nbr).to(blocks.dtype)
    if ctx.needs_input_grad[4]:
        if ctx.transpose is None:
            perm, t_cols, t_ptr, t_rows = transpose_index(
                block_cols, block_rows, nbr)
            t_tiles = transposed_tiles(blocks, perm)
        else:
            perm, t_cols, t_ptr, t_rows = ctx.transpose.index(
                block_cols, block_rows, nbr)
            t_tiles = ctx.transpose.tiles(blocks, perm)
        dx = _spmm(t_tiles, t_cols, t_ptr, t_rows, g).to(x.dtype)
    return d_blocks, None, None, None, dx


_spmm.register_autograd(_backward, setup_context=_setup_context)


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
