"""Synthetic spatiotemporal diffusion dataset.

A numpy copy of ``sgp_tpu/data/datasets/synthetic.py``: an AR(1)
diffusion process on a random geometric sensor graph with a daily
seasonal component and injected missingness. The same seed gives the same
arrays bit for bit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from sgp_tpu_torch.data.datasets.base import TabularDataset
from sgp_tpu_torch.graph.similarities import gaussian_kernel


class SyntheticDiffusion(TabularDataset):
    similarity_options = {"distance"}

    def __init__(self, num_nodes: int = 64, num_steps: int = 2000,
                 seed: int = 0, freq_minutes: int = 5,
                 missing_rate: float = 0.02, root: Optional[str] = None):
        self.num_nodes = num_nodes
        self.num_steps = num_steps
        self.seed = seed
        self.freq_minutes = freq_minutes
        self.missing_rate = missing_rate
        super().__init__(root=root)

    def load(self):
        rng = np.random.default_rng(self.seed)
        n, t = self.num_nodes, self.num_steps
        # sensors on the unit square; kernel weights over distance
        self._pos = rng.random((n, 2)).astype(np.float32)
        d = np.linalg.norm(self._pos[:, None] - self._pos[None], axis=-1)
        self._dist = d.astype(np.float32)
        adj = gaussian_kernel(d, theta=0.15)
        np.fill_diagonal(adj, 0.0)
        adj[adj < 0.3] = 0.0
        # row-normalized diffusion operator
        rowsum = adj.sum(1, keepdims=True)
        op = np.divide(adj, rowsum, out=np.zeros_like(adj),
                       where=rowsum > 0)
        # AR(1) diffusion with daily seasonality + node offsets
        steps_per_day = 24 * 60 // self.freq_minutes
        phase = 2 * np.pi * np.arange(t) / steps_per_day
        season = 10.0 * np.sin(phase)[:, None] \
            + 4.0 * np.cos(2 * phase)[:, None] * rng.standard_normal((1, n))
        x = np.zeros((t, n), np.float32)
        z = rng.standard_normal(n).astype(np.float32)
        for s in range(t):
            z = (0.7 * (op @ z) + 0.25 * z
                 + 0.3 * rng.standard_normal(n)).astype(np.float32)
            x[s] = z
        base = 50.0 + 8.0 * rng.standard_normal(n)
        self.target = (base[None] + season + 6.0 * x)[..., None] \
            .astype(np.float32)
        self.mask = rng.random(self.target.shape) >= self.missing_rate
        self.target = np.where(self.mask, self.target, 0.0)
        self.index = (np.datetime64("2020-01-01T00:00") +
                      np.arange(t) * np.timedelta64(self.freq_minutes, "m")
                      ).astype("datetime64[ns]")

    def compute_similarity(self, method: str, theta: float = 0.15,
                           **kwargs) -> np.ndarray:
        assert method == "distance"
        sim = gaussian_kernel(self._dist, theta=theta)
        np.fill_diagonal(sim, 0.0)
        return sim
