"""METR-LA traffic dataset loader, without pandas.

Counterpart of ``sgp_tpu/data/datasets/metr_la.py``: loads local files
(``<data_dir>/MetrLA/metr_la.h5`` in the h5py layout +
``metr_la_dist.npy``, the latter built from ``distances_la.csv`` when
absent). Nothing is downloaded; place the files locally or use
:class:`SyntheticDiffusion`.
"""
from __future__ import annotations

import os

import numpy as np

from sgp_tpu_torch.data.datasets.base import TabularDataset
from sgp_tpu_torch.data.datasets.build import (build_distance_matrix,
                                               read_hdf_any, read_sensor_ids,
                                               reindex_rows, time_grid)
from sgp_tpu_torch.graph.similarities import gaussian_kernel


def fill_masked(values: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Masked-out entries of each column filled forward, then the leading
    ones backward (pandas' ``ffill().bfill()``); a column with no valid
    entry stays NaN."""
    t = np.arange(len(values))[:, None]
    filled = np.where(mask, values, np.nan)
    ok = ~np.isnan(filled)
    cols = np.arange(values.shape[1])[None, :]
    last = np.maximum.accumulate(np.where(ok, t, 0), axis=0)
    filled = filled[last, cols]
    ok = ~np.isnan(filled)
    nxt = np.minimum.accumulate(np.where(ok, t, len(values) - 1)[::-1],
                                axis=0)[::-1]
    return filled[nxt, cols]


class _DistanceTrafficDataset(TabularDataset):
    """Shared loader for METR-LA / PEMS-BAY style (h5 + dist npy) data."""

    similarity_options = {"distance"}
    h5_name: str = ""
    dist_name: str = ""
    dist_csv_name: str = ""       # raw (from, to, cost) CSV
    ids_txt_name: str = ""        # sensor-id list ("" -> ids = h5 columns)
    freq = np.timedelta64(5, "m")
    mask_zeros = True
    impute_zeros = True

    def _maybe_build_dist(self, h5: str, dist: str):
        """Build the distance matrix from the raw CSV when the built
        ``.npy`` is absent."""
        csv = os.path.join(self.root, self.dist_csv_name)
        if not (self.dist_csv_name and os.path.exists(csv)):
            return False
        if self.ids_txt_name:
            ids = read_sensor_ids(os.path.join(self.root,
                                               self.ids_txt_name))
        else:
            ids = [int(c) for c in read_hdf_any(h5)[2]]
        build_distance_matrix(csv, ids, out_npy=dist)
        return True

    def load(self):
        h5 = os.path.join(self.root, self.h5_name)
        dist = os.path.join(self.root, self.dist_name)
        if os.path.exists(h5) and not os.path.exists(dist):
            self._maybe_build_dist(h5, dist)
        if not (os.path.exists(h5) and os.path.exists(dist)):
            raise FileNotFoundError(
                f"{type(self).__name__}: expected {h5} and {dist}; the "
                "datasets' raw files are not in the repository and nothing "
                "is downloaded — provide them or use SyntheticDiffusion.")
        values, index, _ = read_hdf_any(h5)
        # reindex onto a complete uniform grid (missing rows -> NaN)
        grid = time_grid(index.min(), index.max(), self.freq)
        values = reindex_rows(values, index, grid).astype(np.float32)
        mask = np.ones_like(values, bool)
        if self.mask_zeros:
            mask &= values != 0.0
        mask &= ~np.isnan(values)
        if self.impute_zeros:
            values = np.nan_to_num(fill_masked(values, mask))
        self.target = values[..., None]
        self.mask = mask[..., None]
        self.index = grid
        self.dist = np.load(dist)

    def compute_similarity(self, method: str, **kwargs) -> np.ndarray:
        assert method == "distance"
        finite = self.dist.reshape(-1)
        finite = finite[~np.isinf(finite)]
        sigma = finite.std()
        sim = gaussian_kernel(self.dist, sigma)
        sim[np.isinf(self.dist)] = 0.0
        return sim


class MetrLA(_DistanceTrafficDataset):
    """207 LA loop detectors, 5-min, Mar-Jun 2012 (34,272 steps)."""
    h5_name = "metr_la.h5"
    dist_name = "metr_la_dist.npy"
    dist_csv_name = "distances_la.csv"
    ids_txt_name = "sensor_ids_la.txt"


class _PemsBayBase(_DistanceTrafficDataset):
    h5_name = "pems_bay.h5"
    dist_name = "pems_bay_dist.npy"
    dist_csv_name = "distances_bay.csv"
    ids_txt_name = ""    # BAY sensor ids come from the h5 columns
