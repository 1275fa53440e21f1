"""Temporal and spatial aggregation of series (numpy).

A copy of ``sgp_tpu/data/aggregation.py`` (``tsl/ops/framearray.py``'s
``aggregate``, ``reduce`` and ``temporal_mean``): resample a ``[T, ...]``
series onto a coarser time grid, aggregate nodes into clusters, and the
seasonal (weekday x time-of-day) mean profile used to clean data and to
debias the Pearson similarity.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def temporal_aggregate(x: np.ndarray, factor: int, how: str = "mean"
                       ) -> np.ndarray:
    """Aggregate every ``factor`` consecutive steps (``mean``, ``sum`` or
    ``nearest``); a tail shorter than ``factor`` is dropped."""
    t = (x.shape[0] // factor) * factor
    xr = x[:t].reshape((t // factor, factor) + x.shape[1:])
    if how == "mean":
        return xr.mean(axis=1)
    if how == "sum":
        return xr.sum(axis=1)
    if how == "nearest":
        return xr[:, 0]
    raise ValueError(how)


def spatial_aggregate(x: np.ndarray, node_index: np.ndarray,
                      how: str = "sum", num_clusters: Optional[int] = None
                      ) -> np.ndarray:
    """Sum (or, with ``how="mean"``, average) the nodes (axis 1) of each
    cluster, given each node's cluster id."""
    node_index = np.asarray(node_index)
    k = num_clusters or int(node_index.max()) + 1
    out = np.zeros(x.shape[:1] + (k,) + x.shape[2:], x.dtype)
    np.add.at(out, (slice(None), node_index), x)
    if how == "mean":
        counts = np.bincount(node_index, minlength=k).reshape(
            (1, k) + (1,) * (x.ndim - 2))
        out = out / np.maximum(counts, 1)
    return out


def temporal_mean(x: np.ndarray, index: np.ndarray,
                  steps_per_day: Optional[int] = None) -> np.ndarray:
    """The mean of each (weekday, time of day) slot over the series,
    leaving NaNs out, broadcast back to ``[T, ...]``."""
    index = np.asarray(index, "datetime64[ns]")
    day = index.astype("datetime64[D]")
    weekday = (day.astype("int64") + 3) % 7   # 1970-01-01 was a Thursday
    tod = (index - day).astype("timedelta64[s]").astype("int64")
    _, tod_ids = np.unique(tod, return_inverse=True)
    n_tod = tod_ids.max() + 1
    slot = weekday * n_tod + tod_ids
    out_shape = (7 * n_tod,) + x.shape[1:]
    sums = np.zeros(out_shape)
    counts = np.zeros(out_shape)
    np.add.at(sums, slot, np.nan_to_num(x))
    np.add.at(counts, slot, (~np.isnan(x)).astype(np.float64))
    means = sums / np.maximum(counts, 1)
    return means[slot].astype(x.dtype)
