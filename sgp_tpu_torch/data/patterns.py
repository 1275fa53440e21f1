"""Axis patterns and broadcasting (``tsl/ops/pattern.py:11-69`` and
``tsl/data/utils.py:88-145``).

A copy of ``sgp_tpu/data/patterns.py``: a pattern names an array's axes,
``t``/``s`` time, ``n`` nodes, ``c``/``f`` channels, ``e`` edges and ``b``
the batch. :func:`broadcast` takes numpy arrays or torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch

_ALIASES = {"s": "t", "f": "c"}
_VALID = {"t", "n", "c", "e", "b"}


def parse_pattern(pattern: str) -> list:
    dims = [_ALIASES.get(d, d) for d in pattern.strip().split(" ") if d]
    for d in dims:
        if d not in _VALID:
            raise ValueError(f"invalid pattern dim {d!r} in {pattern!r}")
    return dims


def check_pattern(pattern: str, ndim: int = None) -> str:
    dims = parse_pattern(pattern)
    if ndim is not None and len(dims) != ndim:
        raise ValueError(
            f"pattern {pattern!r} has {len(dims)} dims, array has {ndim}")
    return " ".join(dims)


def broadcast(x, pattern: str, target: str, t: int = None, n: int = None):
    """``x`` with axes ``pattern`` expanded to ``target``: each missing
    axis inserted, and a missing ``t`` or ``n`` axis broadcast to size
    ``t`` or ``n`` when given. A numpy array stays numpy (a read-only
    view); anything else becomes a tensor (an ``expand`` view), where the
    JAX package makes a ``jax.numpy`` array."""
    src = parse_pattern(pattern)
    dst = parse_pattern(target)
    assert all(d in dst for d in src), (pattern, target)
    is_np = isinstance(x, np.ndarray)
    out = x if is_np else torch.as_tensor(x)
    for i, d in enumerate(dst):
        if d not in src:
            out = np.expand_dims(out, axis=i) if is_np \
                else torch.unsqueeze(out, i)
            size = {"t": t, "n": n}.get(d)
            if size is not None:
                shape = list(out.shape)
                shape[i] = size
                out = np.broadcast_to(out, tuple(shape)) if is_np \
                    else out.expand(tuple(shape))
    return out
