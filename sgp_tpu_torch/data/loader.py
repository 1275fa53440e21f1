"""Batch iterators over window items and (time, node) pairs.

A numpy copy of ``WindowedLoader`` and ``IIDLoader`` in
``sgp_tpu/data/loader.py``: no worker processes, a batch is one vectorized
gather, and the numpy generator shuffles and draws in the same order as
the JAX package's loaders.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from sgp_tpu_torch.data.spatiotemporal import Batch, SpatioTemporalDataset


class WindowedLoader:
    """Mini-batches of window items; with ``shuffle`` each pass draws a new
    permutation from the loader's generator."""

    def __init__(self, dataset: SpatioTemporalDataset,
                 items: Optional[np.ndarray] = None,
                 batch_size: int = 32, shuffle: bool = False,
                 limit_batches: Optional[int] = None,
                 seed: int = 0, drop_last: bool = False):
        self.dataset = dataset
        self.items = (np.arange(len(dataset)) if items is None
                      else np.asarray(items))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.limit_batches = limit_batches
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.items) // self.batch_size if self.drop_last \
            else -(-len(self.items) // self.batch_size)
        if self.limit_batches is not None:
            n = min(n, self.limit_batches)
        return n

    def __iter__(self) -> Iterator[Batch]:
        order = self._rng.permutation(self.items) if self.shuffle \
            else self.items
        for b in range(len(self)):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            if len(sel) == 0:
                return
            yield self.dataset.gather_batch(sel)


class IIDLoader:
    """Uniform (time, node)-pair batches: each pass yields ``num_batches``
    batches of ``batch_size`` pairs drawn with replacement over the valid
    window starts (``step_index``) and the nodes, from the loader's numpy
    generator (the JAX package's draws, bit for bit)."""

    def __init__(self, dataset: SpatioTemporalDataset,
                 batch_size: int = 4096, num_batches: int = 1000,
                 seed: int = 0,
                 step_index: Optional[np.ndarray] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_batches = num_batches
        self._rng = np.random.default_rng(seed)
        self.valid_starts = (dataset.indices() if step_index is None
                             else np.asarray(step_index))

    def __len__(self) -> int:
        return self.num_batches

    def draw(self):
        """One batch's ``(steps, nodes)``."""
        t = self._rng.choice(self.valid_starts, self.batch_size)
        n = self._rng.integers(0, self.dataset.n_nodes, self.batch_size)
        return t, n

    def __iter__(self) -> Iterator[Batch]:
        for _ in range(self.num_batches):
            yield self.dataset.gather_iid_batch(*self.draw())
