"""Fused GatedGN ELL (padded-neighbour) message aggregation: CUDA kernel
and plain version, forward and backward.

Counterpart of ``sgp_tpu/ops/gn_ell.py``. For each destination node ``n``
and each of its ``D`` neighbour slots (``graph.padded_incoming``'s layout)
the per-pair chain is::

    s  = p_i[n] + pjn[n, d]        t = act(s)
    mb = act(t @ w2 + b2)          g = sigmoid(mb @ wg + bg)
    out[n] = sum_d mask[n, d] * g * mb

- :func:`gn_ell_aggregate` is the entry, a ``torch.autograd.Function``
  with the JAX signature. ``nmask`` gets no gradient; the gradient of
  ``pjn`` flows back through the caller's gather into ``p_j``.
- :func:`gn_ell_fwd` and :func:`gn_ell_bwd` are its two halves. On a CUDA
  tensor each launches its kernel in ``csrc/gn_ell.cu`` (CUDA C++ for
  ``sm_90a``, built with ``nvcc`` at first use into ``build/`` and loaded
  with ``ctypes``; both run the 16-pair tensor-core tile they share with
  the all-pairs kernel in ``csrc/gated_pair.cuh``) or raises: on a
  failed build or launch, and on a shape the kernel does not take
  (``h2 > 32`` or ``h > 64``). On a CPU tensor
  each runs its plain version. Each counts its kernel launches in
  ``.launches``.
- :func:`gn_ell_fwd_plain` and :func:`gn_ell_bwd_plain` are the plain
  PyTorch versions: the kernels' oracle on the card and what the CPU runs.
  The backward recomputes the chain per pair as the Pallas ``_bwd_kernel``
  does.
- :func:`gn_ell_reference` is the unfused oracle, ``gn_ell_reference`` of
  the JAX package.

Rounding follows the Pallas kernel: ``p_i``, ``w2`` and ``wg`` are cast to
``pjn``'s dtype; with bf16 inputs ``t`` is rounded to bf16 before the
``w2`` product and ``dmt`` before the ``w2^T`` and ``dw2`` products,
``d_pjn`` comes back in bf16, and every sum is f32. The output and
``d_pi`` are f32 before the cast back to the inputs' dtypes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from sgp_tpu_torch.ops import _build
from sgp_tpu_torch.ops.activations import ACTIVATIONS

MAX_H2 = 32          # the kernel's limits: one lane per channel of t,
MAX_H = 64           # two output channels per lane
_WARPS = 4           # warps per block in csrc/gn_ell.cu
_PART = MAX_H2 * MAX_H + 2 * MAX_H + 1   # weight-grad partial per warp
_ACT_CODE = {"silu": 0, "swish": 0, "tanh": 1, "relu": 2, "elu": 3}


@functools.lru_cache(maxsize=None)
def build():
    """Compile ``csrc/gn_ell.cu`` (once per source hash) and load it;
    returns ``(lib, seconds, log)`` as :func:`_build.build` does."""
    lib, seconds, log = _build.build("gn_ell")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _build.bind(lib, "sgp_gn_ell_blocks",
                [ci, ci, ci, ctypes.POINTER(ctypes.c_int)])
    _build.bind(lib, "sgp_gn_ell_fwd", [ci, ci] + [vp] * 8 + [ci] * 6 + [vp])
    _build.bind(lib, "sgp_gn_ell_bwd", [ci, ci] + [vp] * 12 + [ci] * 6 + [vp])
    return lib, seconds, log


@functools.lru_cache(maxsize=None)
def _blocks(device: int, code: int, bf16: int, backward: int) -> int:
    """The persistent grid of one kernel on one device."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = build()[0].sgp_gn_ell_blocks(code, bf16, backward,
                                            ctypes.byref(out))
    if err != 0 or out.value <= 0:
        raise RuntimeError(f"gn_ell: no resident block (CUDA error {err})")
    return out.value


def _check(p_i, pjn, nmask, w2, b2, wg, bg, activation):
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} is not one of "
                         f"{sorted(ACTIVATIONS)}")
    if pjn.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pjn must be float32 or bfloat16, got {pjn.dtype}")
    if pjn.ndim != 4:
        raise ValueError(f"pjn must be [B, N, D, h2], got {tuple(pjn.shape)}")
    b, n, d, h2 = pjn.shape
    h = w2.shape[-1]
    for name, t, shape in (("p_i", p_i, (b, n, h2)), ("nmask", nmask, (n, d)),
                           ("w2", w2, (h2, h)), ("b2", b2, (h,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if wg.numel() != h or bg.numel() != 1:
        raise ValueError(f"wg must hold {h} values and bg 1, got "
                         f"{tuple(wg.shape)} and {tuple(bg.shape)}")


def _prep(p_i, pjn, w2, b2, wg, bg):
    """Cast as the Pallas wrapper does: p_i, w2 and wg to pjn's dtype (held
    in f32 here), b2 and bg to f32."""
    cd = pjn.dtype
    return (p_i.to(cd), w2.to(cd).float().contiguous(),
            b2.float().reshape(-1).contiguous(),
            wg.to(cd).float().reshape(-1).contiguous(),
            bg.float().reshape(1).contiguous())


def _device(p_i, name: str) -> str:
    if p_i.device.type == "cpu":
        return "cpu"
    if not p_i.is_cuda:
        raise ValueError(f"{name} runs on CPU or CUDA, not {p_i.device}")
    return "cuda"


def _kernel_inputs(tensors, device, h2: int, h: int, activation: str):
    if activation not in _ACT_CODE:
        raise ValueError(f"the gn_ell kernel has no activation {activation!r}")
    if h2 > MAX_H2 or h > MAX_H:
        raise ValueError(f"the gn_ell kernel takes h2 <= {MAX_H2} and "
                         f"h <= {MAX_H}, got h2={h2}, h={h}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"gn_ell: every input must be on {device}, "
                             f"got one on {t.device}")
    return [t.contiguous() for t in tensors]


def gn_ell_fwd(p_i: torch.Tensor, pjn: torch.Tensor, nmask: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor, wg: torch.Tensor,
               bg: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    """The aggregate ``[B, N, h]`` f32 (no autograd)."""
    _check(p_i, pjn, nmask, w2, b2, wg, bg, activation)
    if _device(p_i, "gn_ell_fwd") == "cpu":
        return gn_ell_fwd_plain(p_i, pjn, nmask, w2, b2, wg, bg, activation)
    b, n, d, h2 = pjn.shape
    h = w2.shape[-1]
    pi_c, w2c, b2f, wgc, bgf = _prep(p_i, pjn, w2, b2, wg, bg)
    mask = (nmask != 0).to(torch.uint8)
    pi_c, pjn_c, mask, w2c, b2f, wgc, bgf = _kernel_inputs(
        (pi_c, pjn, mask, w2c, b2f, wgc, bgf), p_i.device, h2, h, activation)
    out = torch.empty((b, n, h), dtype=torch.float32, device=p_i.device)
    if out.numel() == 0:
        return out
    code, bf16 = _ACT_CODE[activation], int(pjn.dtype == torch.bfloat16)
    lib = build()[0]
    dev = p_i.device.index if p_i.device.index is not None \
        else torch.cuda.current_device()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sgp_gn_ell_fwd(
            code, bf16, pi_c.data_ptr(), pjn_c.data_ptr(), mask.data_ptr(),
            w2c.data_ptr(), b2f.data_ptr(), wgc.data_ptr(), bgf.data_ptr(),
            out.data_ptr(), b * n, n, d, h2, h,
            _blocks(dev, code, bf16, 0), stream)
    if err != 0:
        raise RuntimeError(f"gn_ell_fwd kernel launch failed: CUDA error {err}")
    gn_ell_fwd.launches += 1
    return out


gn_ell_fwd.launches = 0  # kernel launches since the last reset to 0


def gn_ell_bwd(p_i: torch.Tensor, pjn: torch.Tensor, nmask: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor, wg: torch.Tensor,
               bg: torch.Tensor, ghat: torch.Tensor,
               activation: str = "silu"):
    """``(d_pi, d_pjn, dw2, db2, dwg, dbg)`` for the cotangent ``ghat
    [B, N, h]`` of :func:`gn_ell_fwd`'s output, each in its input's dtype
    and shape."""
    _check(p_i, pjn, nmask, w2, b2, wg, bg, activation)
    if _device(p_i, "gn_ell_bwd") == "cpu":
        return gn_ell_bwd_plain(p_i, pjn, nmask, w2, b2, wg, bg, ghat,
                                activation)
    b, n, d, h2 = pjn.shape
    h = w2.shape[-1]
    if tuple(ghat.shape) != (b, n, h):
        raise ValueError(f"ghat must be {(b, n, h)}, got {tuple(ghat.shape)}")
    pi_c, w2c, b2f, wgc, bgf = _prep(p_i, pjn, w2, b2, wg, bg)
    mask = (nmask != 0).to(torch.uint8)
    # rows of 64 channels, zero past h (the kernel reads channel pairs);
    # f32, not rounded, as the Pallas wrapper leaves it
    gh = torch.nn.functional.pad(ghat.float(), (0, MAX_H - h))
    pi_c, pjn_c, mask, w2c, b2f, wgc, bgf, gh = _kernel_inputs(
        (pi_c, pjn, mask, w2c, b2f, wgc, bgf, gh), p_i.device,
        h2, h, activation)
    dev = p_i.device.index if p_i.device.index is not None \
        else torch.cuda.current_device()
    code, bf16 = _ACT_CODE[activation], int(pjn.dtype == torch.bfloat16)
    blocks = _blocks(dev, code, bf16, 1)
    dpi = torch.empty((b, n, h2), dtype=torch.float32, device=p_i.device)
    dpjn = torch.empty_like(pjn_c)
    part = torch.empty((blocks * _WARPS, _PART), dtype=torch.float32,
                       device=p_i.device)
    grads = torch.empty(h2 * h + 2 * h + 1, dtype=torch.float32,
                        device=p_i.device)
    lib = build()[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sgp_gn_ell_bwd(
            code, bf16, pi_c.data_ptr(), pjn_c.data_ptr(), mask.data_ptr(),
            w2c.data_ptr(), b2f.data_ptr(), wgc.data_ptr(), bgf.data_ptr(),
            gh.data_ptr(), dpi.data_ptr(), dpjn.data_ptr(), part.data_ptr(),
            grads.data_ptr(), b * n, n, d, h2, h, blocks, stream)
    if err != 0:
        raise RuntimeError(f"gn_ell_bwd kernel launch failed: CUDA error {err}")
    gn_ell_bwd.launches += 1
    dw2, db2, dwg, dbg = torch.split(grads, [h2 * h, h, h, 1])
    return _cast_grads(p_i, pjn, w2, b2, wg, bg, dpi, dpjn,
                       dw2.view(h2, h), db2, dwg, dbg)


gn_ell_bwd.launches = 0  # kernel launches since the last reset to 0


def _cast_grads(p_i, pjn, w2, b2, wg, bg, dpi, dpjn, dw2, db2, dwg, dbg):
    return (dpi.to(p_i.dtype), dpjn.to(pjn.dtype), dw2.to(w2.dtype),
            db2.reshape(b2.shape).to(b2.dtype),
            dwg.reshape(wg.shape).to(wg.dtype),
            dbg.reshape(bg.shape).to(bg.dtype))


def _chain(p_i, pjn, nmask, w2, b2, wg, bg, activation):
    """The per-pair forward chain of the Pallas ``_chain``, in PyTorch:
    returns ``(s, t, mt, mb, g, maskf, w2c, wgc)``."""
    act, _ = ACTIVATIONS[activation]
    pi_c, w2c, b2f, wgc, bgf = _prep(p_i, pjn, w2, b2, wg, bg)
    s = pi_c.float().unsqueeze(-2) + pjn.float()          # [B, N, D, h2]
    t = act(s).to(pjn.dtype)
    mt = torch.matmul(t.float(), w2c) + b2f               # [B, N, D, h]
    mb = act(mt)
    g = torch.sigmoid(torch.matmul(mb, wgc.unsqueeze(-1)) + bgf)
    maskf = (nmask != 0).float().unsqueeze(-1)            # [N, D, 1]
    return s, t, mt, mb, g, maskf, w2c, wgc


def gn_ell_fwd_plain(p_i, pjn, nmask, w2, b2, wg, bg,
                     activation: str = "silu") -> torch.Tensor:
    """The plain PyTorch version of :func:`gn_ell_fwd`."""
    _, _, _, mb, g, maskf, _, _ = _chain(p_i, pjn, nmask, w2, b2, wg, bg,
                                         activation)
    return ((g * maskf) * mb).sum(-2)


def gn_ell_bwd_plain(p_i, pjn, nmask, w2, b2, wg, bg, ghat,
                     activation: str = "silu"):
    """The plain PyTorch version of :func:`gn_ell_bwd`: the forward chain
    recomputed, then the Pallas ``_bwd_kernel``'s cotangents."""
    _, dact = ACTIVATIONS[activation]
    s, t, mt, mb, g, maskf, w2c, wgc = _chain(p_i, pjn, nmask, w2, b2, wg,
                                              bg, activation)
    h2, h = w2c.shape
    e = ghat.float().unsqueeze(-2) * maskf                # [B, N, D, h]
    dgz = (e * mb).sum(-1, keepdim=True) * g * (1.0 - g)
    dmt = (e * g + wgc * dgz) * dact(mt)
    dmt_c = dmt.to(pjn.dtype).float()
    ds = torch.matmul(dmt_c, w2c.T) * dact(s)             # [B, N, D, h2]
    dw2 = t.float().reshape(-1, h2).T @ dmt_c.reshape(-1, h)
    return _cast_grads(p_i, pjn, w2, b2, wg, bg, ds.sum(-2), ds, dw2,
                       dmt.reshape(-1, h).sum(0),
                       (mb * dgz).reshape(-1, h).sum(0), dgz.sum())


class _GnEll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, p_i, pjn, nmask, w2, b2, wg, bg, activation):
        ctx.save_for_backward(p_i, pjn, nmask, w2, b2, wg, bg)
        ctx.activation = activation
        return gn_ell_fwd(p_i, pjn, nmask, w2, b2, wg, bg, activation)

    @staticmethod
    def backward(ctx, ghat):
        dpi, dpjn, dw2, db2, dwg, dbg = gn_ell_bwd(
            *ctx.saved_tensors, ghat, ctx.activation)
        return dpi, dpjn, None, dw2, db2, dwg, dbg, None


def gn_ell_aggregate(p_i: torch.Tensor, pjn: torch.Tensor,
                     nmask: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     wg: torch.Tensor, bg: torch.Tensor,
                     activation: str = "silu") -> torch.Tensor:
    """Fused gated ELL message aggregation, differentiable.

    Args:
      p_i: ``[B, N, h2]`` destination-side projections.
      pjn: ``[B, N, D, h2]`` gathered source-side projections
        (``p_j[src_idx]`` in ``padded_incoming``'s layout).
      nmask: ``[N, D]`` slot validity (0 = padding); no gradient.
      w2, b2, wg, bg: the second edge-MLP layer ``[h2, h]``, ``[h]`` and the
        gate layer ``[h, 1]``, ``[1]``.
      activation: one of :data:`ACTIVATIONS`.

    Returns: ``[B, N, h]`` float32.
    """
    return _GnEll.apply(p_i, pjn, nmask, w2, b2, wg, bg, activation)


def gn_ell_reference(p_i, pjn, nmask, w2, b2, wg, bg,
                     activation: str = "silu") -> torch.Tensor:
    """The unfused oracle (the blocked-XLA ELL math), autograd-friendly."""
    act, _ = ACTIVATIONS[activation]
    s = p_i.unsqueeze(-2) + pjn
    mb = act(act(s) @ w2 + b2)
    g = torch.sigmoid(mb @ wg.reshape(-1, 1) + bg)
    return ((g * mb) * nmask.unsqueeze(-1)).float().sum(-2)
