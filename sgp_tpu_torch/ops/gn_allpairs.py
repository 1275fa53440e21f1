"""Fused GatedGN dense all-pairs message aggregation: CUDA kernel and plain
version, forward and backward.

Counterpart of ``sgp_tpu/ops/gn_allpairs.py``. For each destination ``i``
and source ``j`` with ``mask[i, j] != 0`` the per-pair chain is::

    s  = p_i[i] + p_j[j]           t = act(s)
    mb = act(t @ w2 + b2)          g = sigmoid(mb @ wg + bg)
    out[i] = sum_j mask[i, j] * g * mb

- :func:`gn_allpairs_aggregate` is the entry, a ``torch.autograd.Function``
  with the JAX signature plus an optional window table ``band=(block,
  widths, los)`` (``graph.band_windows``): dst rows ``[k*block,
  (k+1)*block)`` then sweep only the columns ``[los[k], los[k] +
  widths[k])`` (``widths`` one int or one per block). ``mask`` gets no
  gradient.
- :func:`gn_allpairs_fwd` and :func:`gn_allpairs_bwd` are its two halves.
  On a CUDA tensor each launches its kernel in ``csrc/gn_allpairs.cu``
  (CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use into
  ``build/`` and loaded with ``ctypes``) or raises: on a failed build or
  launch, and on a shape the kernel does not take (``h2 > 32`` or
  ``h > 64``). On a CPU tensor each runs its plain version. Each counts its
  kernel launches in ``.launches``.
- :func:`gn_allpairs_fwd_plain` and :func:`gn_allpairs_bwd_plain` are the
  plain PyTorch versions: the kernels' oracle on the card and what the CPU
  runs. They compute every pair of a block of dst rows and multiply by the
  mask, as the Pallas kernel does, blocked over dst rows (the JAX layer's
  block size) so that one ``[B, rows, N, h]`` block, not ``[B, N, N, h]``,
  is live. The backward recomputes each block.
- :func:`gn_allpairs_reference` is the unfused oracle, for small ``N``.

Rounding follows the JAX wrapper and kernel: ``p_j``, ``w2`` and ``wg`` are
cast to ``p_i``'s dtype, ``b2`` and ``bg`` to f32; ``t`` is rounded to that
dtype before the ``w2`` product; in the backward ``ghat`` is rounded to it,
``dt`` contracts the rounded ``w2`` with the f32 ``dmt``, and ``dw2`` uses
``dmt`` rounded to it. Every sum is f32; the output is f32 and the node
gradients come back in the inputs' dtype.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sgp_tpu_torch.ops import _build
from sgp_tpu_torch.ops.activations import ACTIVATIONS

MAX_H2 = 32          # the kernel's limits: one lane per channel of t,
MAX_H = 64           # two output channels per lane
_PART = MAX_H2 * MAX_H + 2 * MAX_H + 1   # weight-grad partial per row
_ACT_CODE = {"silu": 0, "swish": 0, "tanh": 1, "relu": 2, "elu": 3}


@functools.lru_cache(maxsize=None)
def build():
    """Compile ``csrc/gn_allpairs.cu`` (once per source hash) and load it;
    returns ``(lib, seconds, log)`` as :func:`_build.build` does."""
    lib, seconds, log = _build.build("gn_allpairs")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _build.bind(lib, "sgp_gn_allpairs_blocks",
                [ci, ci, ci, ctypes.POINTER(ctypes.c_int)])
    _build.bind(lib, "sgp_gn_allpairs_parts", [ci])
    _build.bind(lib, "sgp_gn_allpairs_fwd",
                [ci, ci] + [vp] * 11 + [ci] * 5 + [vp])
    _build.bind(lib, "sgp_gn_allpairs_bwd",
                [ci, ci] + [vp] * 18 + [ci] * 6 + [vp])
    return lib, seconds, log


@functools.lru_cache(maxsize=None)
def _blocks(device: int, code: int, bf16: int, kernel_pass: int) -> int:
    """The persistent grid of one kernel on one device (pass 0 forward, 1
    the backward's rows, 2 its columns)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = build()[0].sgp_gn_allpairs_blocks(code, bf16, kernel_pass,
                                                 ctypes.byref(out))
    if err != 0 or out.value <= 0:
        raise RuntimeError(
            f"gn_allpairs: no resident block (CUDA error {err})")
    return out.value


def row_blocks(n: int, h: int, itemsize: int, band=None):
    """``(r0, r1, c0, c1)`` per block of dst rows of the plain all-pairs
    math: the window table's blocks, or row blocks of the JAX layer's size
    (a block's ``[rows, N, h]`` message tensor about 256 MB) over all
    columns."""
    if band is not None:
        block, widths, los = band
        for k, r0 in enumerate(range(0, n, block)):
            w = widths[k] if isinstance(widths, (tuple, list)) else widths
            yield r0, min(r0 + block, n), los[k], los[k] + w
        return
    blk = max(128, min(n, int(2 ** 28 / max(n * h * itemsize, 1))))
    for r0 in range(0, n, blk):
        yield r0, min(r0 + blk, n), 0, n


def _check(p_i, p_j, mask, w2, b2, wg, bg, activation, band):
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} is not one of "
                         f"{sorted(ACTIVATIONS)}")
    if p_i.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"p_i must be float32 or bfloat16, got {p_i.dtype}")
    if p_i.ndim != 3:
        raise ValueError(f"p_i must be [B, N, h2], got {tuple(p_i.shape)}")
    b, n, h2 = p_i.shape
    h = w2.shape[-1]
    for name, t, shape in (("p_j", p_j, (b, n, h2)), ("mask", mask, (n, n)),
                           ("w2", w2, (h2, h)), ("b2", b2, (h,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if wg.numel() != h or bg.numel() != 1:
        raise ValueError(f"wg must hold {h} values and bg 1, got "
                         f"{tuple(wg.shape)} and {tuple(bg.shape)}")
    if band is not None:
        block, widths, los = band
        n_blk = -(-n // block)
        ws = widths if isinstance(widths, (tuple, list)) else (widths,) * n_blk
        if len(ws) != n_blk or len(los) != n_blk or any(
                lo < 0 or w < 0 or lo + w > n for lo, w in zip(los, ws)):
            raise ValueError(f"band {band!r} does not fit N={n}")


def _prep(p_i, p_j, w2, b2, wg, bg):
    """Cast as the Pallas wrapper does: p_j, w2 and wg to p_i's dtype (held
    in f32 here), b2 and bg to f32."""
    cd = p_i.dtype
    return (p_j.to(cd), w2.to(cd).float().contiguous(),
            b2.float().reshape(-1).contiguous(),
            wg.to(cd).float().reshape(-1).contiguous(),
            bg.float().reshape(1).contiguous())


def _device(p_i, name: str) -> str:
    if p_i.device.type == "cpu":
        return "cpu"
    if not p_i.is_cuda:
        raise ValueError(f"{name} runs on CPU or CUDA, not {p_i.device}")
    return "cuda"


@functools.lru_cache(maxsize=None)
def _bounds_host(n: int, band):
    """``(row_lo, row_hi, col_lo, col_hi)`` int32 ``[N]``: dst row ``i``
    sweeps the columns ``[row_lo[i], row_hi[i])``; source column ``j`` is
    swept by rows within ``[col_lo[j], col_hi[j])`` only."""
    if band is None:
        lo, hi = np.zeros(n, np.int32), np.full(n, n, np.int32)
        return lo, hi, lo, hi
    row_lo, row_hi = np.zeros(n, np.int32), np.zeros(n, np.int32)
    col_lo, col_hi = np.full(n, n, np.int32), np.zeros(n, np.int32)
    for r0, r1, c0, c1 in row_blocks(n, 0, 0, band):
        row_lo[r0:r1], row_hi[r0:r1] = c0, c1
        col_lo[c0:c1] = np.minimum(col_lo[c0:c1], r0)
        col_hi[c0:c1] = np.maximum(col_hi[c0:c1], r1)
    col_lo[col_hi == 0] = 0
    return row_lo, row_hi, col_lo, col_hi


@functools.lru_cache(maxsize=64)
def _bounds(n: int, band, device: torch.device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _bounds_host(n, band))


def _byte_mask(mask: torch.Tensor) -> torch.Tensor:
    """The mask as the kernel reads it: one byte per entry, nonzero = edge."""
    if mask.dtype == torch.bool:
        return mask.contiguous().view(torch.uint8)
    if mask.dtype == torch.uint8:
        return mask.contiguous()
    return (mask != 0).view(torch.uint8)


def _launch_setup(p_i, p_j, mask, w2, b2, wg, bg, activation, band):
    """The kernel's inputs, contiguous and on one device, and its ids."""
    if activation not in _ACT_CODE:
        raise ValueError(
            f"the gn_allpairs kernel has no activation {activation!r}")
    h2, h = w2.shape
    if h2 > MAX_H2 or h > MAX_H:
        raise ValueError(f"the gn_allpairs kernel takes h2 <= {MAX_H2} and "
                         f"h <= {MAX_H}, got h2={h2}, h={h}")
    dev = p_i.device
    tensors = (p_i, *_prep(p_i, p_j, w2, b2, wg, bg), mask)
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"gn_allpairs: every input must be on {dev}, "
                             f"got one on {t.device}")
    pi_c, pj_c, w2c, b2f, wgc, bgf, _ = (t.contiguous() for t in tensors)
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    ids = (_ACT_CODE[activation], int(p_i.dtype == torch.bfloat16), index)
    return (pi_c, pj_c, _byte_mask(mask), w2c, b2f, wgc, bgf,
            _bounds(p_i.shape[1], band, dev), ids)


def gn_allpairs_fwd(p_i: torch.Tensor, p_j: torch.Tensor, mask: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor, wg: torch.Tensor,
                    bg: torch.Tensor, activation: str = "silu",
                    band=None) -> torch.Tensor:
    """The aggregate ``[B, N, h]`` f32 (no autograd)."""
    band = _hashable(band)
    _check(p_i, p_j, mask, w2, b2, wg, bg, activation, band)
    if _device(p_i, "gn_allpairs_fwd") == "cpu":
        return gn_allpairs_fwd_plain(p_i, p_j, mask, w2, b2, wg, bg,
                                     activation, band)
    b, n, h2 = p_i.shape
    h = w2.shape[-1]
    pi_c, pj_c, m8, w2c, b2f, wgc, bgf, bounds, (code, bf16, dev) = \
        _launch_setup(p_i, p_j, mask, w2, b2, wg, bg, activation, band)
    out = torch.empty((b, n, h), dtype=torch.float32, device=p_i.device)
    if out.numel() == 0:
        return out
    counter = torch.zeros(1, dtype=torch.int32, device=p_i.device)
    lib = build()[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sgp_gn_allpairs_fwd(
            code, bf16, pi_c.data_ptr(), pj_c.data_ptr(), m8.data_ptr(),
            bounds[0].data_ptr(), bounds[1].data_ptr(), w2c.data_ptr(),
            b2f.data_ptr(), wgc.data_ptr(), bgf.data_ptr(), out.data_ptr(),
            counter.data_ptr(), b * n, n, h2, h, _blocks(dev, code, bf16, 0),
            stream)
    if err != 0:
        raise RuntimeError(
            f"gn_allpairs_fwd kernel launch failed: CUDA error {err}")
    gn_allpairs_fwd.launches += 1
    return out


gn_allpairs_fwd.launches = 0  # kernel launches since the last reset to 0


def gn_allpairs_bwd(p_i: torch.Tensor, p_j: torch.Tensor, mask: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor, wg: torch.Tensor,
                    bg: torch.Tensor, ghat: torch.Tensor,
                    activation: str = "silu", band=None):
    """``(d_pi, d_pj, dw2, db2, dwg, dbg)`` for the cotangent ``ghat
    [B, N, h]`` of :func:`gn_allpairs_fwd`'s output, each in its input's
    dtype and shape."""
    band = _hashable(band)
    _check(p_i, p_j, mask, w2, b2, wg, bg, activation, band)
    if _device(p_i, "gn_allpairs_bwd") == "cpu":
        return gn_allpairs_bwd_plain(p_i, p_j, mask, w2, b2, wg, bg, ghat,
                                     activation, band)
    b, n, h2 = p_i.shape
    h = w2.shape[-1]
    if tuple(ghat.shape) != (b, n, h):
        raise ValueError(f"ghat must be {(b, n, h)}, got {tuple(ghat.shape)}")
    if ghat.device != p_i.device:
        raise ValueError(f"gn_allpairs: every input must be on {p_i.device}, "
                         f"got one on {ghat.device}")
    pi_c, pj_c, m8, w2c, b2f, wgc, bgf, bounds, (code, bf16, dev) = \
        _launch_setup(p_i, p_j, mask, w2, b2, wg, bg, activation, band)
    gh = torch.zeros((b * n, MAX_H), dtype=torch.float32, device=p_i.device)
    gh[:, :h] = ghat.reshape(b * n, h).to(p_i.dtype)   # rows of 64 channels
    dpi = torch.empty((b, n, h2), dtype=torch.float32, device=p_i.device)
    dpj = torch.empty_like(dpi)
    grads = torch.zeros(h2 * h + 2 * h + 1, dtype=torch.float32,
                        device=p_i.device)
    if dpi.numel() == 0:
        return _cast_grads(p_i, p_j, w2, b2, wg, bg, dpi, dpj,
                           *_split_grads(grads, h2, h))
    lib = build()[0]
    part = torch.empty((lib.sgp_gn_allpairs_parts(b * n), _PART),
                       dtype=torch.float32, device=p_i.device)
    counters = torch.zeros(2, dtype=torch.int32, device=p_i.device)
    m8_t = _transposed(mask, m8)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sgp_gn_allpairs_bwd(
            code, bf16, pi_c.data_ptr(), pj_c.data_ptr(), m8.data_ptr(),
            m8_t.data_ptr(), *(t.data_ptr() for t in bounds),
            w2c.data_ptr(), b2f.data_ptr(), wgc.data_ptr(), bgf.data_ptr(),
            gh.data_ptr(), dpi.data_ptr(), dpj.data_ptr(), part.data_ptr(),
            grads.data_ptr(), counters.data_ptr(), b * n, n, h2, h,
            _blocks(dev, code, bf16, 1), _blocks(dev, code, bf16, 2), stream)
    if err != 0:
        raise RuntimeError(
            f"gn_allpairs_bwd kernel launch failed: CUDA error {err}")
    gn_allpairs_bwd.launches += 1
    return _cast_grads(p_i, p_j, w2, b2, wg, bg, dpi, dpj,
                       *_split_grads(grads, h2, h))


gn_allpairs_bwd.launches = 0  # kernel launches since the last reset to 0

_MASK_T = []   # [(mask, its version, its transpose)]: the last mask only


def _transposed(mask: torch.Tensor, m8: torch.Tensor) -> torch.Tensor:
    """``m8^T`` contiguous (``m8`` the kernel's bytes of ``mask``), kept for
    the next call while ``mask`` is the same tensor at the same version: a
    training run's mask is constant, so its transpose (``N^2`` bytes) is
    built once, not every backward."""
    if _MASK_T and _MASK_T[0][0] is mask and _MASK_T[0][1] == mask._version:
        return _MASK_T[0][2]
    m8_t = m8.t().contiguous()
    _MASK_T[:] = [(mask, mask._version, m8_t)]
    return m8_t


def _split_grads(grads, h2: int, h: int):
    dw2, db2, dwg, dbg = torch.split(grads, [h2 * h, h, h, 1])
    return dw2.view(h2, h), db2, dwg, dbg


def _cast_grads(p_i, p_j, w2, b2, wg, bg, dpi, dpj, dw2, db2, dwg, dbg):
    return (dpi.to(p_i.dtype), dpj.to(p_j.dtype), dw2.to(w2.dtype),
            db2.reshape(b2.shape).to(b2.dtype),
            dwg.reshape(wg.shape).to(wg.dtype),
            dbg.reshape(bg.shape).to(bg.dtype))


def _chain(pi_b, pj_c, mask_b, w2c, b2f, wgc, bgf, act, cd):
    """The chain of one block of pairs, as the Pallas kernel computes it:
    returns ``(s, t, mt, mb, g, keep)``, with ``s`` ``[B, rows, cols,
    h2]``."""
    s = pi_b.float().unsqueeze(-2) + pj_c.float().unsqueeze(-3)
    t = act(s).to(cd)
    mt = torch.matmul(t.float(), w2c) + b2f
    mb = act(mt)
    g = torch.sigmoid(torch.matmul(mb, wgc.unsqueeze(-1)) + bgf)
    keep = (mask_b != 0).float().unsqueeze(-1)               # [rows, cols, 1]
    return s, t, mt, mb, g, keep


def gn_allpairs_fwd_plain(p_i, p_j, mask, w2, b2, wg, bg,
                          activation: str = "silu", band=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`gn_allpairs_fwd`."""
    act, _ = ACTIVATIONS[activation]
    cd = p_i.dtype
    pj_c, w2c, b2f, wgc, bgf = _prep(p_i, p_j, w2, b2, wg, bg)
    b, n, _ = p_i.shape
    h = w2c.shape[1]
    out = torch.zeros((b, n, h), dtype=torch.float32, device=p_i.device)
    for r0, r1, c0, c1 in row_blocks(n, h, p_i.element_size(), band):
        _, _, _, mb, g, keep = _chain(p_i[:, r0:r1], pj_c[:, c0:c1],
                                      mask[r0:r1, c0:c1], w2c, b2f, wgc, bgf,
                                      act, cd)
        out[:, r0:r1] = ((g * mb) * keep).sum(-2)
    return out


def gn_allpairs_bwd_plain(p_i, p_j, mask, w2, b2, wg, bg, ghat,
                          activation: str = "silu", band=None):
    """The plain PyTorch version of :func:`gn_allpairs_bwd`: each block's
    chain recomputed, then the Pallas ``_bwd_kernel``'s cotangents; ``d_pi``
    sums a block's rows, ``d_pj`` its columns."""
    act, dact = ACTIVATIONS[activation]
    cd = p_i.dtype
    pj_c, w2c, b2f, wgc, bgf = _prep(p_i, p_j, w2, b2, wg, bg)
    b, n, h2 = p_i.shape
    h = w2c.shape[1]
    gh = ghat.to(cd).float()
    f32 = dict(dtype=torch.float32, device=p_i.device)
    dpi, dpj = torch.zeros((b, n, h2), **f32), torch.zeros((b, n, h2), **f32)
    dw2, db2 = torch.zeros((h2, h), **f32), torch.zeros(h, **f32)
    dwg, dbg = torch.zeros(h, **f32), torch.zeros((), **f32)
    for r0, r1, c0, c1 in row_blocks(n, h, p_i.element_size(), band):
        s, t, mt, mb, g, keep = _chain(p_i[:, r0:r1], pj_c[:, c0:c1],
                                       mask[r0:r1, c0:c1], w2c, b2f, wgc, bgf,
                                       act, cd)
        e = keep * gh[:, r0:r1].unsqueeze(-2)                # [B, r, c, h]
        dgz = (e * mb).sum(-1, keepdim=True) * g * (1.0 - g)
        dmt = (e * g + wgc * dgz) * dact(mt)
        ds = torch.matmul(dmt, w2c.T) * dact(s)              # [B, r, c, h2]
        dpi[:, r0:r1] += ds.sum(-2)
        dpj[:, c0:c1] += ds.sum(-3)
        dw2 += t.float().reshape(-1, h2).T @ dmt.to(cd).float().reshape(-1, h)
        db2 += dmt.reshape(-1, h).sum(0)
        dwg += (mb * dgz).reshape(-1, h).sum(0)
        dbg += dgz.sum()
    return _cast_grads(p_i, p_j, w2, b2, wg, bg, dpi, dpj, dw2, db2, dwg, dbg)


class _GnAllPairs(torch.autograd.Function):

    @staticmethod
    def forward(ctx, p_i, p_j, mask, w2, b2, wg, bg, activation, band):
        ctx.save_for_backward(p_i, p_j, mask, w2, b2, wg, bg)
        ctx.activation, ctx.band = activation, band
        return gn_allpairs_fwd(p_i, p_j, mask, w2, b2, wg, bg, activation,
                               band)

    @staticmethod
    def backward(ctx, ghat):
        dpi, dpj, dw2, db2, dwg, dbg = gn_allpairs_bwd(
            *ctx.saved_tensors, ghat, ctx.activation, ctx.band)
        return dpi, dpj, None, dw2, db2, dwg, dbg, None, None


def gn_allpairs_aggregate(p_i: torch.Tensor, p_j: torch.Tensor,
                          mask: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, wg: torch.Tensor, bg: torch.Tensor,
                          activation: str = "silu",
                          band=None) -> torch.Tensor:
    """Fused gated all-pairs message aggregation, differentiable.

    Args:
      p_i: ``[B, N, h2]`` destination-side projections (``W_i x + b_i``).
      p_j: ``[B, N, h2]`` source-side projections (``W_j x``).
      mask: ``[N, N]``, ``mask[dst, src] != 0`` marks an edge (weights are
        ignored); no gradient.
      w2, b2, wg, bg: the second edge-MLP layer ``[h2, h]``, ``[h]`` and the
        gate layer ``[h, 1]``, ``[1]``.
      activation: one of :data:`ACTIVATIONS`.
      band: ``None`` (every column of every row) or ``(block, widths,
        los)``; mask entries outside the windows are not edges.

    Returns: ``[B, N, h]`` float32.
    """
    return _GnAllPairs.apply(p_i, p_j, mask, w2, b2, wg, bg, activation,
                             band)


def _hashable(band):
    if band is None:
        return None
    block, widths, los = band
    widths = tuple(int(w) for w in widths) \
        if isinstance(widths, (tuple, list)) else int(widths)
    return int(block), widths, tuple(int(lo) for lo in los)


def gn_allpairs_reference(p_i, p_j, mask, w2, b2, wg, bg,
                          activation: str = "silu") -> torch.Tensor:
    """The unfused oracle (materialises ``[B, N, N, h]``: small N only)."""
    act, _ = ACTIVATIONS[activation]
    s = p_i.unsqueeze(-2) + p_j.unsqueeze(-3)
    mb = act(act(s) @ w2 + b2)
    g = torch.sigmoid(mb @ wg.reshape(-1, 1) + bg)
    keep = (mask != 0).float()
    return torch.einsum("ij,...ijh->...ih", keep, (g * mb).float())
