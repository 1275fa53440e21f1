"""Similarity and distance matrices for graph construction.

Counterpart of ``sgp_tpu/graph/similarities.py``. The gaussian kernels,
the haversine distance and top-k sparsification stay numpy on the host.
The O(N²·T) similarities (the Pearson correlations and the windowed
correntropy) run as torch products on ``device`` (the card unless the
caller names the CPU) and return numpy arrays, since
``TabularDataset.get_connectivity`` consumes numpy. The products run in
the input's dtype with TF32 off (``sgp_tpu_torch/__init__.py``), so an f32
input gives the JAX package's f32 arithmetic and a float64 input its
float64 yardstick.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sgp_tpu_torch import epsilon
from sgp_tpu_torch.utils.device import resolve_device

_AVG_EARTH_RADIUS_KM = 6371.0088


def gaussian_kernel(x: np.ndarray, theta: Optional[float] = None
                    ) -> np.ndarray:
    """``exp(-(x/theta)^2)``; ``theta`` defaults to ``std(x)``."""
    if theta is None:
        theta = np.std(x)
    return np.exp(-np.square(x / theta))


def thresholded_gaussian_kernel(x: np.ndarray, theta: Optional[float] = None,
                                threshold: Optional[float] = None,
                                threshold_on_input: bool = False
                                ) -> np.ndarray:
    """Gaussian kernel with small weights (or large inputs) zeroed out."""
    weights = gaussian_kernel(x, theta)
    if threshold is None:
        return weights
    keep = (x <= threshold) if threshold_on_input else (weights >= threshold)
    return np.where(keep, weights, 0.0)


def geographical_distance(latlon: np.ndarray, to_rad: bool = True
                          ) -> np.ndarray:
    """Pairwise haversine distance in km for ``[N, 2]`` (lat, lon) points,
    in float64."""
    x = np.asarray(latlon, np.float64)
    if to_rad:
        x = np.radians(x)
    lat, lon = x[:, 0], x[:, 1]
    dlat = lat[:, None] - lat[None, :]
    dlon = lon[:, None] - lon[None, :]
    a = (np.sin(dlat / 2) ** 2
         + np.cos(lat)[:, None] * np.cos(lat)[None, :]
         * np.sin(dlon / 2) ** 2)
    return 2 * _AVG_EARTH_RADIUS_KM * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=resolve_device(device))


def pearson_similarity(x, device=None) -> np.ndarray:
    """Pearson correlation between the rows of ``x [N, T]`` in ``x``'s
    dtype, ``1e-8`` added to the norms' product; unit diagonal."""
    x = _on(x, device)
    xc = x - x.mean(1, keepdim=True)
    norms = torch.linalg.vector_norm(xc, dim=1)
    corr = (xc @ xc.T) / (norms[:, None] * norms[None, :] + 1e-8)
    corr.fill_diagonal_(1.0)
    return corr.cpu().numpy()


def corrcoef(x, device=None) -> np.ndarray:
    """``np.corrcoef(x, rowvar=False)`` for ``x [T, N]``: the columns'
    covariance in float64 over ``T - 1``, divided by the standard
    deviations on either side and clipped into [-1, 1]."""
    x = _on(x, device).double()
    xc = x - x.mean(0, keepdim=True)
    c = (xc.T @ xc) * (1.0 / (x.shape[0] - 1))
    std = torch.sqrt(torch.diagonal(c))
    c /= std[:, None]
    c /= std[None, :]
    return c.clamp_(-1.0, 1.0).cpu().numpy()


def _rbf_kernel(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """Pairwise ``exp(-gamma * ||xi - xj||^2)`` between rows of ``x``, as
    ``sq_i + sq_j - 2 x x^T`` clamped at 0, with ``sq`` read off the Gram's
    diagonal: a row's distance to itself is then exactly 0, where a
    separate sum of squares would leave f32's rounding of two sums of
    ``T`` terms (at a weekly period, up to ~1e-5 off 1 on the diagonal)."""
    gram = x @ x.T
    sq = torch.diagonal(gram)
    d2 = sq[:, None] + sq[None, :] - 2.0 * gram
    return torch.exp(-gamma * d2.clamp_(min=0.0))


def correntropy(x, period: int, mask=None, gamma: float = 0.05,
                device=None) -> np.ndarray:
    """Windowed correntropy similarity between the ``N`` columns of
    ``x [T, N]``: an RBF kernel in ``x``'s dtype on each of the ``(T - 1)
    // period`` whole windows (the window ending exactly at ``T`` is
    dropped, as the reference's ``range(period, T, period)`` drops it),
    summed in float64 over the windows where both columns have no missing
    value, over the count of such windows plus ``1e-8``. Window by window
    on ``device``; never ``[n_win, N, N]`` at once. The distances are
    taken after each step's mean over the nodes is subtracted, which
    leaves them unchanged in exact arithmetic and keeps f32's rounding of
    the Gram small where the nodes share a course."""
    x = _on(x, device)
    t, n = x.shape
    if mask is None:
        mask = ~torch.isnan(x)
    mask = _on(mask, x.device).reshape(t, n).bool()
    n_win = max((t - 1) // period, 0)
    chunks = torch.nan_to_num(x[:n_win * period]).reshape(n_win, period, n)
    valid = mask[:n_win * period].reshape(n_win, period, n).all(dim=1)
    sim = torch.zeros((n, n), dtype=torch.float64, device=x.device)
    for w in range(n_win):
        # each step's mean over the nodes subtracted: every distance is
        # unchanged, and the sums f32 rounds shrink to the nodes' spread
        # around their shared course (~1/70 of them on PV-US's daylight)
        chunk = chunks[w] - chunks[w].mean(1, keepdim=True)
        ok = valid[w].to(chunk.dtype)
        sim += _rbf_kernel(chunk.T, gamma).mul_(ok[:, None]).mul_(
            ok[None, :])
    valid = valid.double()
    tot = valid.T @ valid          # windows valid for both: exact counts
    return (sim / (tot + epsilon)).cpu().numpy()


def top_k(matrix: np.ndarray, k: int, include_self: bool = False,
          keep_values: bool = False) -> np.ndarray:
    """Keep the top-``k`` entries of each row, zeroing the rest.

    Builds a boolean keep-mask from the per-row top-``k`` column set;
    with ``include_self=False`` the diagonal is forced below every
    candidate so a node never selects itself.
    """
    n_rows, n_cols = matrix.shape
    scores = np.array(matrix, dtype=np.float64, copy=True)
    if not include_self:
        assert n_rows == n_cols, "self-exclusion needs a square matrix"
        scores[np.diag_indices(n_rows)] = -np.inf
    keep = np.zeros_like(scores, dtype=bool)
    topk_cols = np.argpartition(scores, n_cols - k, axis=1)[:, n_cols - k:]
    np.put_along_axis(keep, topk_cols, True, axis=1)
    if keep_values:
        return np.where(keep, matrix, 0).astype(matrix.dtype)
    return keep.astype(matrix.dtype)
