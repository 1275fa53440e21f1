"""Train/val/test splitters over window items, and the datetime encoding.

A numpy copy of the part of ``sgp_tpu/data/splitters.py`` that the
training slice reaches: a split is three arrays of item indices (positions
into ``dataset.indices()``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Split:
    train: np.ndarray
    val: np.ndarray
    test: np.ndarray

    def __repr__(self):
        return (f"Split(train={len(self.train)}, val={len(self.val)}, "
                f"test={len(self.test)})")


class Splitter:
    def split(self, dataset) -> Split:
        raise NotImplementedError


class TemporalSplitter(Splitter):
    """Tail split by length or fraction: test is the last ``test_len``
    items, val precedes it, and the train and val tails are trimmed by
    ``ceil(window / stride)`` items so that their windows do not reach into
    the next split."""

    def __init__(self, val_len: float = 0.1, test_len: float = 0.2):
        self.val_len = val_len
        self.test_len = test_len

    def split(self, dataset) -> Split:
        idx = np.arange(len(dataset))
        val_len, test_len = self.val_len, self.test_len
        if test_len < 1:
            test_len = int(test_len * len(idx))
        if val_len < 1:
            val_len = int(val_len * (len(idx) - test_len))
        test_start = len(idx) - int(test_len)
        val_start = test_start - int(val_len)
        w = dataset.windowing
        offset = -(-w.window // w.stride)
        return Split(idx[:max(val_start - offset, 0)],
                     idx[val_start:max(test_start - offset, 0)],
                     idx[test_start:])


def datetime_encoded(index: np.ndarray, units) -> np.ndarray:
    """Sin/cos encodings of the timestamps' phase within each unit:
    ``[T, 2 * len(units)]`` float32 (sin, cos per unit)."""
    if isinstance(units, str):
        units = [units]
    nanos = {
        "day": 24 * 3600 * 10**9, "hour": 3600 * 10**9,
        "minute": 60 * 10**9, "second": 10**9,
        "week": 7 * 24 * 3600 * 10**9,
        "year": int(365.2425 * 24 * 3600 * 10**9),
    }
    idx_nano = np.asarray(index, "datetime64[ns]").astype(np.int64)
    cols = []
    for unit in units:
        phase = idx_nano * (2 * np.pi / nanos[unit])
        cols.append(np.sin(phase))
        cols.append(np.cos(phase))
    return np.stack(cols, axis=-1).astype(np.float32)
