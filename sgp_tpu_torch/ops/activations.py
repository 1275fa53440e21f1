"""The GatedGN kernels' activation table: ``name -> (act, dact)``.

Counterpart of ``ACTIVATIONS`` in ``sgp_tpu/ops/gn_allpairs.py``, which
both fused GatedGN kernels share (the ELL one, ``ops/gn_ell.py``, and the
dense all-pairs one). ``act`` computes in f32 and returns its input's
dtype; ``dact`` computes in f32 and returns f32 (it multiplies f32
cotangents). The CUDA kernels compute the same functions in f32; every one
maps 0 to 0, which lets them pad channels with zeros.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _dsilu(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _dtanh(x):
    t = torch.tanh(x)
    return 1.0 - t * t


def _drelu(x):
    return (x > 0).to(x.dtype)


def _delu(x):
    return torch.where(x > 0, torch.ones_like(x), torch.exp(x))


def _f32_compute(fn, keep_dtype: bool):
    def wrapped(x):
        y = fn(x.float())
        return y.to(x.dtype) if keep_dtype else y
    return wrapped


ACTIVATIONS = {
    name: (_f32_compute(f, True), _f32_compute(df, False))
    for name, (f, df) in {
        "silu": (F.silu, _dsilu),
        "swish": (F.silu, _dsilu),
        "tanh": (torch.tanh, _dtanh),
        "relu": (torch.relu, _drelu),
        "elu": (F.elu, _delu),
    }.items()
}
