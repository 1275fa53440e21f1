"""Batch iterator over window items.

A numpy copy of ``WindowedLoader`` in ``sgp_tpu/data/loader.py``: no
worker processes, a batch is one vectorized host gather, and the numpy
generator shuffles in the same order as the JAX package's loader.
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
