"""Sliding-window index math.

Pure re-derivation of the reference's windowing semantics
(``tsl/data/spatiotemporal_dataset.py:195-200, 548-560, 788-810``):

- window start indices: ``arange(0, T - sample_span + 1, stride)``
- window steps of item i: ``arange(idx, idx + window, window_lag)``
- horizon steps: ``arange(idx + horizon_offset,
  idx + horizon_offset + horizon, horizon_lag)`` with
  ``horizon_offset = window + delay``
- ``sample_span = max(horizon_offset + horizon, window)``
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Windowing:
    window: int = 1
    horizon: int = 1
    delay: int = 0
    stride: int = 1
    window_lag: int = 1
    horizon_lag: int = 1

    @property
    def horizon_offset(self) -> int:
        return self.window + self.delay

    @property
    def sample_span(self) -> int:
        return max(self.horizon_offset + self.horizon, self.window)

    @property
    def window_steps(self) -> int:
        """Number of steps actually gathered inside the window."""
        return len(range(0, self.window, self.window_lag))

    @property
    def horizon_steps(self) -> int:
        """Number of steps gathered in the horizon (with lag thinning) —
        e.g. horizon 22 lag 7 -> 4 eval steps, as in the large-scale
        configs (``config/largescale_100nn/sgp_pv.yaml``)."""
        return len(range(0, self.horizon, self.horizon_lag))

    def indices(self, n_steps: int) -> np.ndarray:
        """All valid window-start steps."""
        last = n_steps - self.sample_span
        if last < 0:
            return np.empty(0, np.int64)
        return np.arange(0, last + 1, self.stride, dtype=np.int64)

    def window_offsets(self) -> np.ndarray:
        return np.arange(0, self.window, self.window_lag, dtype=np.int64)

    def horizon_offsets(self) -> np.ndarray:
        return (self.horizon_offset
                + np.arange(0, self.horizon, self.horizon_lag, dtype=np.int64))
