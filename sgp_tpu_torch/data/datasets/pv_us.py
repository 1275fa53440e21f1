"""PV-US solar production dataset (NREL, 5,016 plants, year 2006),
without pandas.

Counterpart of ``sgp_tpu/data/datasets/pv_us.py``: per-zone HDF5 files
(``east.h5`` / ``west.h5``) in the h5py layout, the ``actual`` frame and a
``metadata`` group of columns; east-duplicate plants dropped; similarity by
a gaussian kernel (theta 150 km) over the plants' haversine distances on
the host, or by weekly-window correntropy on the device. Nothing is
downloaded; provide the files locally or use :class:`SyntheticDiffusion`.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from sgp_tpu_torch.data.datasets.base import TabularDataset
from sgp_tpu_torch.data.datasets.build import (_h5py, load_frame_h5,
                                               reindex_rows)
from sgp_tpu_torch.graph.similarities import (correntropy, gaussian_kernel,
                                              geographical_distance)
from sgp_tpu_torch.utils.device import resolve_device


def standardize(x: np.ndarray, device=None) -> torch.Tensor:
    """``(x - x.mean()) / x.std()`` over all entries in ``x``'s dtype on
    ``device`` (the population std, as numpy's)."""
    x = torch.as_tensor(x, device=resolve_device(device))
    return (x - x.mean()) / x.std(correction=0)


def _concat_columns(frames):
    """``pd.concat(frames, axis=1)``: the frames' columns side by side on
    their common index, or on the sorted union of their indexes (absent
    rows NaN) when they differ."""
    index = frames[0][1]
    if any(len(i) != len(index) or (i != index).any() for _, i, _ in frames):
        index = np.unique(np.concatenate([i for _, i, _ in frames]))
        frames = [(reindex_rows(v, i, index), index, c)
                  for v, i, c in frames]
    return (np.concatenate([v for v, _, _ in frames], axis=1), index,
            np.concatenate([np.asarray(c) for _, _, c in frames]))


class PvUS(TabularDataset):
    available_zones = ["east", "west"]
    similarity_options = {"distance", "correntropy"}

    def __init__(self, zones: Union[str, List, None] = None,
                 mask_zeros: bool = False, root: Optional[str] = None):
        if zones is None:
            zones = self.available_zones
        elif isinstance(zones, str):
            zones = [zones]
        assert set(zones).issubset(self.available_zones)
        self.zones = zones
        self.mask_zeros = mask_zeros
        super().__init__(root=root)

    @staticmethod
    def _read_zone(path):
        """A zone file in the h5py layout: the ``actual`` frame and the
        ``metadata`` columns (bytes decoded to str)."""
        actual = load_frame_h5(path, key="actual")
        h5py = _h5py(path)
        with h5py.File(path, "r") as f:
            grp = f["metadata"]
            md = {k: grp[k][()] for k in grp}
        return actual, {k: (v.astype(str) if v.dtype.kind == "S" else v)
                        for k, v in md.items()}

    def load(self):
        actual, metadata = [], []
        for zone in self.zones:
            path = os.path.join(self.root, f"{zone}.h5")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"PvUS: expected {path}; the datasets' raw files are "
                    "not in the repository and nothing is downloaded — "
                    "provide them or use SyntheticDiffusion.")
            a, m = self._read_zone(path)
            actual.append(a)
            metadata.append(m)
        values, index, plants = _concat_columns(actual)
        # columns, then the metadata rows, sorted by plant id
        order = np.argsort(plants, kind="stable")
        values, plants = values[:, order], plants[order]
        md = {k: np.concatenate([m[k] for m in metadata])
              for k in metadata[0]}
        ids = md.pop("plant_id", np.arange(len(next(iter(md.values())))))
        order = np.argsort(ids, kind="stable")
        md = {k: v[order] for k, v in md.items()}
        ids = ids[order]
        if len(self.zones) == 2:
            dup = ids[np.char.endswith(md["state_id"].astype(str), "-east")]
            missing = np.setdiff1d(dup, plants)
            if len(missing):
                raise KeyError(f"{list(missing)} not found in axis")
            keep = ~np.isin(ids, dup)
            md = {k: v[keep] for k, v in md.items()}
            ids = ids[keep]
            keep = ~np.isin(plants, dup)
            values, plants = values[:, keep], plants[keep]
        values = values.astype(np.float32)
        self.target = values[..., None]
        self.mask = ((values > 0) if self.mask_zeros
                     else np.ones_like(values, bool))[..., None]
        self.index = index
        self.plants = plants
        self.metadata: Dict[str, np.ndarray] = {"plant_id": ids, **md}

    def compute_similarity(self, method: str, theta: float = 150,
                           gamma: float = 0.05, device=None,
                           **kwargs) -> np.ndarray:
        if method == "distance":
            coords = np.stack([self.metadata["lat"], self.metadata["lon"]],
                              axis=1)
            dist = geographical_distance(coords, to_rad=True)
            return gaussian_kernel(dist, theta=theta)
        if method == "correntropy":
            steps_per_week = int(np.timedelta64(7, "D")
                                 / (self.index[1] - self.index[0]))
            x = standardize(self.target[..., 0], device)
            return correntropy(x, period=steps_per_week, gamma=gamma,
                               device=device)
        raise NotImplementedError(method)
