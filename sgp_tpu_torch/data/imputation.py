"""Synthetic missing data and the windowed imputation dataset.

Counterpart of ``sgp_tpu/data/imputation.py`` (``tsl``'s
``ops/imputation.py`` and ``data/imputation_stds.py``): point failures and
contiguous blackout windows injected into a series, and a windowed
dataset whose input is the corrupted series and whose target is the
original. Host numpy, drawing from the same ``default_rng`` in the same
order as the JAX package, so the same seed gives the same masks.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from sgp_tpu_torch.data.spatiotemporal import Batch, SpatioTemporalDataset


def sample_mask(shape, p: float = 0.002, p_noise: float = 0.0,
                min_seq: int = 1, max_seq: int = 1,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """A *missing* mask (True = missing): point noise with probability
    ``p_noise``, plus blackout windows of ``[min_seq, max_seq]`` steps
    that start with probability ``p``."""
    rng = rng or np.random.default_rng()
    mask = rng.random(shape) < p_noise
    starts = np.nonzero(rng.random(shape) < p)
    t = shape[0]
    for idx in zip(*starts):
        length = int(rng.integers(min_seq, max_seq + 1))
        s = idx[0]
        mask[(slice(s, min(s + length, t)),) + idx[1:]] = True
    return mask


def add_missing_values(dataset: SpatioTemporalDataset,
                       p_fault: float = 0.0015, p_noise: float = 0.05,
                       min_seq: int = 1, max_seq: int = 10,
                       seed: int = 56789) -> SpatioTemporalDataset:
    """Attach the ``eval_mask`` covariate: the points valid in the data
    that :func:`sample_mask` hides from training."""
    rng = np.random.default_rng(seed)
    missing = sample_mask(dataset.target.shape, p=p_fault, p_noise=p_noise,
                          min_seq=min_seq, max_seq=max_seq, rng=rng)
    dataset.add_covariate("eval_mask",
                          (missing & dataset.mask).astype(np.float32),
                          pattern="t n c")
    return dataset


class ImputationDataset(SpatioTemporalDataset):
    """Windowed imputation view. A batch holds, over the window:

    - ``x``: the series with the hidden (``eval_mask``) points zeroed;
    - ``y``: the raw series, hidden values included (the target);
    - ``mask``: what the model may condition on, valid and not hidden
      (the trainer whitens a further random part of it);
    - ``eval_mask``: the hidden points, scored by the loss and by the
      evaluation.
    """

    def gather_batch(self, item_idx, node_index=None) -> Batch:
        batch = super().gather_batch(item_idx, node_index=node_index)
        assert "eval_mask" in self.covariates, \
            "call add_missing_values first"
        starts = self.indices()[np.asarray(item_idx)]
        w_steps = starts[:, None] + self.windowing.window_offsets()[None, :]
        ev_w = self.covariates["eval_mask"].value.astype(bool)[w_steps]
        valid_w = self.mask[w_steps].astype(bool)
        y_w = self.target[w_steps]
        if node_index is not None:
            ni = np.asarray(node_index)
            ev_w, valid_w, y_w = (a[..., ni, :] for a in (ev_w, valid_w,
                                                          y_w))
        batch["x"] = np.where(ev_w, 0.0, batch["x"])
        batch["y"] = y_w
        batch["mask"] = valid_w & ~ev_w
        batch["eval_mask"] = ev_w
        return batch
