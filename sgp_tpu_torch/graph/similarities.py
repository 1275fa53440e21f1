"""Similarity matrices for graph construction.

A numpy copy of the part of ``sgp_tpu/graph/similarities.py`` that the
serving path reaches: the gaussian kernel and top-k sparsification.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def gaussian_kernel(x: np.ndarray, theta: Optional[float] = None
                    ) -> np.ndarray:
    """``exp(-(x/theta)^2)``; ``theta`` defaults to ``std(x)``."""
    if theta is None:
        theta = np.std(x)
    return np.exp(-np.square(x / theta))


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
