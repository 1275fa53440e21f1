"""Closed-form ridge readout.

Counterpart of ``sgp_tpu/train/ridge.py``: the normal equations

    (X^T X + lambda I) W = X^T Y

with the centred Gram matrix accumulated on the device in f32 (in chunks,
so X never needs to be resident at once) and solved by Cholesky, with a
minimum-norm least-squares solve when Cholesky fails. The intercept is
sklearn's ``fit_intercept=True``: centre X and Y, solve, recover the bias.

Every product is a true f32 product: the package turns TF32 off, which is
the JAX package's ``precision="highest"``. Inputs given as numpy arrays go
to ``device`` (default ``cuda:0``; ``"cpu"`` for the CPU); tensors stay
where they are.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sgp_tpu_torch.utils.device import resolve_device


def _f32(a, device=None) -> torch.Tensor:
    """``a`` as an f32 tensor: a tensor on its own device, an array on
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a.float()
    return torch.as_tensor(np.asarray(a, np.float32),
                           device=resolve_device(device))


def _gram_moments(x: torch.Tensor, y: torch.Tensor,
                  fit_intercept: bool = True):
    """``(G, M, x_mean, y_mean, n)`` of the centred design and targets."""
    n = x.shape[0]
    x_mean = x.mean(0) if fit_intercept else x.new_zeros(x.shape[1])
    y_mean = y.mean(0) if fit_intercept else y.new_zeros(y.shape[1])
    xc = x - x_mean
    yc = y - y_mean
    return xc.T @ xc, xc.T @ yc, x_mean, y_mean, float(n)


def ridge_regression(x, y, alpha: float = 1.0, fit_intercept: bool = True,
                     chunk: Optional[int] = 65536, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit ``Y ~ X W + b``; returns ``(W [D, C], b [C])``. Above ``chunk``
    samples the Gram accumulates over sample blocks in two passes: the
    means, then the centred Gram and moments per block."""
    x = _f32(x, device)
    y = _f32(y, x.device)
    n, d = x.shape
    if chunk is None or n <= chunk:
        g, m, x_mean, y_mean, _ = _gram_moments(x, y, fit_intercept)
    else:
        x_mean = x.mean(0) if fit_intercept else x.new_zeros(d)
        y_mean = y.mean(0) if fit_intercept else y.new_zeros(y.shape[1])
        g = x.new_zeros((d, d))
        m = x.new_zeros((d, y.shape[1]))
        for s in range(0, n, chunk):
            xc = x[s:s + chunk] - x_mean
            yc = y[s:s + chunk] - y_mean
            g = g + xc.T @ xc
            m = m + xc.T @ yc
    w = solve_ridge_normal(g, m, alpha)
    b = y_mean - x_mean @ w if fit_intercept else y.new_zeros(y.shape[1])
    return w, b


def solve_ridge_normal(gram: torch.Tensor, moment: torch.Tensor,
                       alpha: float) -> torch.Tensor:
    """Solve ``(G + alpha I) W = M``: by Cholesky, or, when Cholesky fails
    or its solution is not finite (alpha <= 0, a singular Gram), by the
    minimum-norm least-squares solve of ``jnp.linalg.lstsq`` (an SVD
    pseudo-inverse with its cut-off, eps * D). ``cholesky_ex`` reports a
    failed factor in ``info`` (JAX's ``cho_factor`` returns NaNs instead),
    so a non-zero ``info`` counts as not finite. One host sync a solve."""
    d = gram.shape[0]
    a = gram + alpha * torch.eye(d, dtype=gram.dtype, device=gram.device)
    chol, info = torch.linalg.cholesky_ex(a)
    if int(info) == 0:
        sol = torch.cholesky_solve(moment, chol)
        if bool(torch.isfinite(sol).all()):
            return sol
    # on CUDA torch.linalg.lstsq solves full-rank systems only ("gels")
    return torch.linalg.pinv(a) @ moment


def take_steps(p: torch.Tensor, steps) -> torch.Tensor:
    """Time steps of a (possibly many-GB, device-resident) array: a
    contiguous run (a single step included) is a slice, anything else an
    index."""
    steps = np.asarray(steps)
    if len(steps) == 1 or np.all(np.diff(steps) == 1):
        return p[int(steps[0]):int(steps[0]) + len(steps)]
    return p[torch.as_tensor(steps, device=p.device)]


def gather_feat_parts(parts: Sequence[torch.Tensor], steps) -> torch.Tensor:
    """The channel concatenation of the feature parts at ``steps``, in f32
    (one chunk at a time: no full-width copy beside the resident parts)."""
    chunks = [take_steps(p, steps).float() for p in parts]
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks, -1)


def closed_form_readout_streaming(feats, targets: torch.Tensor,
                                  train_steps: np.ndarray, horizon: int,
                                  alpha: float = 1.0, chunk: int = 256):
    """The closed-form fit on a device-resident encoding: the Gram and the
    per-lag moments accumulate chunk by chunk over the training window
    steps, so the flattened ``[T*N, D]`` design never exists. ``feats`` is
    a ``[T, N, D]`` tensor or a list of ``[T, N, *]`` parts, concatenated
    per chunk; ``targets [T, N, C]`` lives beside them; lag ``l`` (1-based)
    of step ``t`` is ``targets[t + l]``. Two passes, as
    :func:`ridge_regression`'s chunked branch: the means, then the centred
    Gram and moments. Returns ``[(W, b)] * horizon``."""
    parts = list(feats) if isinstance(feats, (list, tuple)) else [feats]
    train_steps = np.asarray(train_steps)
    t_count = len(train_steps)
    n = parts[0].shape[1]
    d = sum(int(p.shape[2]) for p in parts)
    c = targets.shape[2]
    total = float(t_count * n)
    contiguous = t_count > 1 and bool(np.all(np.diff(train_steps) == 1))

    def chunk_inputs(s):
        steps = train_steps[s:s + chunk]
        if contiguous:
            t0, tc = int(steps[0]), len(steps)
            f = torch.cat([p[t0:t0 + tc].float() for p in parts], -1)
            y_chunks = torch.stack([targets[t0 + lag:t0 + lag + tc]
                                    for lag in range(1, horizon + 1)])
        else:
            f = gather_feat_parts(parts, steps)
            y_chunks = torch.stack([take_steps(targets, steps + lag)
                                    for lag in range(1, horizon + 1)])
        return f.reshape(-1, d), y_chunks.float().reshape(horizon, -1, c)

    device = parts[0].device
    sx = torch.zeros(d, device=device)
    sy = torch.zeros((horizon, c), device=device)
    for s in range(0, t_count, chunk):
        f, ys = chunk_inputs(s)
        sx += f.sum(0)
        sy += ys.sum(1)
    mu = sx / total
    nus = sy / total                                        # [H, C]

    g = torch.zeros((d, d), device=device)
    m = torch.zeros((horizon, d, c), device=device)
    for s in range(0, t_count, chunk):
        f, ys = chunk_inputs(s)
        f2 = f - mu
        g += f2.T @ f2
        m += torch.einsum("nd,hnc->hdc", f2, ys - nus[:, None, :])

    out = []
    for lag in range(horizon):
        w = solve_ridge_normal(g, m[lag], alpha)
        out.append((w, nus[lag] - mu @ w))
    return out


def closed_form_readout(x_train, targets_by_lag, alpha: float = 1.0,
                        device=None):
    """Per-lag ridge fits sharing one design matrix, so the Gram is
    computed once for every lag. ``x_train [M, D]``; ``targets_by_lag``,
    one ``[M, C]`` per lag. Returns one ``(W, b)`` per lag."""
    x = _f32(x_train, device)
    x_mean = x.mean(0)
    xc = x - x_mean
    g = xc.T @ xc
    out = []
    for y in targets_by_lag:
        y = _f32(y, x.device)
        y_mean = y.mean(0)
        w = solve_ridge_normal(g, xc.T @ (y - y_mean), alpha)
        out.append((w, y_mean - x_mean @ w))
    return out
