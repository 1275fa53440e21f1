"""CER-En Irish smart-meter energy dataset (6,435 meters, 30-min), without
pandas.

Counterpart of ``sgp_tpu/data/datasets/cer_en.py``: ``cer_en.h5`` in the
h5py layout, built from the six licensed ``File<i>.txt.zip`` archives when
only they are present (:func:`build_cer_en`). Similarity by masked
weekly-window correntropy or the meters' Pearson correlation, both on the
device.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from sgp_tpu_torch.data.datasets.base import TabularDataset
from sgp_tpu_torch.data.datasets.build import (build_cer_en, read_hdf_any,
                                               reindex_rows, time_grid)
from sgp_tpu_torch.data.datasets.pv_us import standardize
from sgp_tpu_torch.graph.similarities import corrcoef, correntropy

AGG_SCALE = 1000


class CEREn(TabularDataset):
    similarity_options = {"correntropy", "pearson"}

    def load(self):
        path = os.path.join(self.root, "cer_en.h5")
        if not os.path.exists(path):
            zips = [f for f in (os.listdir(self.root)
                                if os.path.isdir(self.root) else [])
                    if f.endswith(".zip")]
            if zips:
                build_cer_en(self.root)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"CEREn: expected {path} (or the raw File<i>.txt.zip "
                "archives); the CER dataset is license-gated and not in the "
                "repository — provide the files or use SyntheticDiffusion.")
        values, index, _ = read_hdf_any(path)
        self._set_frame(values, index)

    @classmethod
    def from_arrays(cls, values: np.ndarray, index: np.ndarray) -> "CEREn":
        """The dataset on a frame already in memory (``values [T, N]``,
        its datetime64 ``index``), as :meth:`load` sets it from the
        file."""
        ds = cls.__new__(cls)
        ds.root, ds.covariates, ds._similarity_cache = None, {}, {}
        ds._set_frame(values, index)
        return ds

    def _set_frame(self, values: np.ndarray, index: np.ndarray):
        """``asfreq("30min")``: the frame reindexed onto the complete
        30-minute grid from its first to its last timestamp (absent rows
        NaN); the mask is where a value is present."""
        grid = time_grid(index.min(), index.max(), np.timedelta64(30, "m"))
        values = reindex_rows(values, index, grid).astype(np.float32)
        self.mask = (~np.isnan(values))[..., None]
        self.target = np.nan_to_num(values)[..., None]
        self.index = grid

    def compute_similarity(self, method: str, gamma: float = 0.05,
                           train_slice: Optional[np.ndarray] = None,
                           device=None, **kwargs) -> np.ndarray:
        x = self.target[..., 0] * self.mask[..., 0]
        mask = self.mask[..., 0:1].astype(np.uint8)
        if train_slice is not None:
            x = self.target[train_slice, :, 0]
            mask = mask[train_slice]
        if method == "pearson":
            return corrcoef(x, device=device)
        if method == "correntropy":
            xs = standardize(x, device)
            step = self.index[1] - self.index[0]
            period = int(np.timedelta64(7, "D") / step)
            # masked weekly-window correntropy (windows with missing
            # values excluded)
            return correntropy(xs, period=period, mask=mask, gamma=gamma,
                               device=device)
        raise NotImplementedError(method)
