"""Train/val/test splitters over window items, and the calendar
encodings.

A numpy copy of ``sgp_tpu/data/splitters.py`` (``tsl/data/datamodule/
splitters.py``): a split is three arrays of item indices (positions into
``dataset.indices()``). :class:`TemporalSplitter` splits the tail by
length, :class:`AtTimeStepSplitter` at timestamps (the traffic datasets'
split), :class:`DisjointMonthsSplitter` by calendar month, and
:class:`FixedIndicesSplitter` returns the split it was given.
"""
from __future__ import annotations

import dataclasses
from datetime import datetime
from typing import Optional, Tuple, Union

import numpy as np

TsLike = Union[Tuple, datetime, np.datetime64, str, None]


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


def _to_datetime64(ts: TsLike) -> Optional[np.datetime64]:
    if ts is None:
        return None
    if isinstance(ts, np.datetime64):
        return ts
    if isinstance(ts, datetime):
        return np.datetime64(ts)
    if isinstance(ts, (tuple, list)):
        return np.datetime64(datetime(*ts))
    return np.datetime64(ts)


def indices_between(dataset, first_ts: TsLike = None,
                    last_ts: TsLike = None) -> np.ndarray:
    """The items whose horizon starts in ``[first_ts, last_ts]``: the
    timestamps' positions in the index (both ends included), shifted back
    by the windowing's ``horizon_offset``, select the window starts."""
    assert dataset.index is not None, "needs a datetime index"
    index = dataset.index
    first, last = _to_datetime64(first_ts), _to_datetime64(last_ts)
    first_loc = 0 if first is None else int(
        np.searchsorted(index, first, side="left"))
    last_loc = len(index) if last is None else int(
        np.searchsorted(index, last, side="right"))
    w = dataset.windowing
    first_sample = first_loc - w.horizon_offset
    last_sample = last_loc - w.horizon_offset - 1
    starts = dataset.indices()
    return np.nonzero((starts >= first_sample) & (starts < last_sample))[0]


class AtTimeStepSplitter(Splitter):
    """A split at timestamps: test and validation are the items between
    their first and last timestamps. With ``drop_following_steps`` the
    validation items from the first test item on are dropped and train is
    every item before the first test item: it overlaps the validation
    items, a quirk of the reference kept for parity. Otherwise the three
    sets are made disjoint."""

    def __init__(self, first_val_ts: TsLike = None,
                 first_test_ts: TsLike = None, last_val_ts: TsLike = None,
                 last_test_ts: TsLike = None,
                 drop_following_steps: bool = True):
        self.first_val_ts = first_val_ts
        self.first_test_ts = first_test_ts
        self.last_val_ts = last_val_ts
        self.last_test_ts = last_test_ts
        self.drop_following_steps = drop_following_steps

    def split(self, dataset) -> Split:
        test_idx = indices_between(dataset, self.first_test_ts,
                                   self.last_test_ts)
        val_idx = indices_between(dataset, self.first_val_ts,
                                  self.last_val_ts)
        if self.drop_following_steps and len(test_idx):
            val_idx = val_idx[val_idx < test_idx.min()]
            train_idx = np.arange(test_idx.min())
        else:
            val_idx = np.setdiff1d(val_idx, test_idx)
            train_idx = np.setdiff1d(np.arange(len(dataset)), test_idx)
            train_idx = np.setdiff1d(train_idx, val_idx)
        return Split(train_idx, val_idx, test_idx)


class FixedIndicesSplitter(Splitter):
    def __init__(self, train, val, test):
        self._split = Split(np.asarray(train), np.asarray(val),
                            np.asarray(test))

    def split(self, dataset) -> Split:
        return self._split


def datetime_onehot(index: np.ndarray, units) -> np.ndarray:
    """One-hot calendar features of ``weekday`` (7), ``hour`` (24) and
    ``month`` (12), concatenated: ``[T, sum of the widths]`` float32."""
    if isinstance(units, str):
        units = [units]
    idx = np.asarray(index, "datetime64[ns]")
    cols = []
    for unit in units:
        if unit == "weekday":   # 1970-01-01 was a Thursday
            vals = (idx.astype("datetime64[D]").astype("int64") + 3) % 7
            k = 7
        elif unit == "hour":
            vals = idx.astype("datetime64[h]").astype("int64") % 24
            k = 24
        elif unit == "month":
            vals = idx.astype("datetime64[M]").astype("int64") % 12
            k = 12
        else:
            raise ValueError(unit)
        cols.append(np.eye(k, dtype=np.float32)[vals])
    return np.concatenate(cols, axis=-1)


def holidays_onehot(index: np.ndarray, country: str = None,
                    holidays_list=None) -> np.ndarray:
    """A holiday indicator column ``[T, 1]``: the days of ``index`` in
    ``holidays_list``. ``country`` alone needs the ``holidays`` package,
    which neither the JAX package's environment nor the port's has."""
    idx_days = np.asarray(index, "datetime64[D]")
    if holidays_list is None:
        if country is None:
            raise ValueError("pass holidays_list (the 'holidays' package "
                             "is unavailable in this environment)")
        import holidays as _hol  # not installed where the port runs
        years = np.unique(idx_days.astype("datetime64[Y]")).astype(str)
        holidays_list = list(_hol.country_holidays(
            country, years=[int(y) for y in years]))
    hol = np.asarray(holidays_list, "datetime64[D]")
    return np.isin(idx_days, hol).astype(np.float32)[:, None]


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


def disjoint_months(dataset, months, synch_mode: str = "window"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """``(other_idxs, month_idxs)``: an item is in ``month_idxs`` when its
    window (``synch_mode="window"``) or horizon (``"horizon"``) lies wholly
    inside ``months``, in ``other_idxs`` when it lies wholly outside them;
    an item across a month boundary is in neither."""
    assert dataset.index is not None, "needs a datetime index"
    months = np.atleast_1d(np.asarray(months, int))
    w = dataset.windowing
    if synch_mode == "window":
        start, end = 0, max(w.window - 1, 0)
    elif synch_mode == "horizon":
        start = w.horizon_offset
        end = w.horizon_offset + w.horizon - 1
    else:
        raise ValueError("synch_mode must be 'window' or 'horizon'")
    starts = dataset.indices()
    month_of = dataset.index.astype("datetime64[M]").astype(int) % 12 + 1
    idxs = np.arange(len(starts))

    def both_in(mset):
        return (np.isin(month_of[starts + start], mset)
                & np.isin(month_of[starts + end], mset))

    month_idxs = idxs[both_in(months)]
    other_idxs = idxs[both_in(np.setdiff1d(np.arange(1, 13), months))]
    return other_idxs, month_idxs


class DisjointMonthsSplitter(Splitter):
    """Validation and test are the items wholly inside ``val_months`` and
    ``test_months``; train the items wholly inside the other months, so no
    training window reaches into them."""

    def __init__(self, val_months=(12,), test_months=(1,),
                 synch_mode: str = "window"):
        self.val_months = val_months
        self.test_months = test_months
        self.synch_mode = synch_mode

    def split(self, dataset) -> Split:
        _, test_idx = disjoint_months(dataset, self.test_months,
                                      self.synch_mode)
        _, val_idx = disjoint_months(dataset, self.val_months,
                                     self.synch_mode)
        val_idx = np.setdiff1d(val_idx, test_idx)
        train_idx, _ = disjoint_months(
            dataset, np.union1d(np.asarray(self.val_months, int),
                                np.asarray(self.test_months, int)),
            self.synch_mode)
        return Split(train_idx, val_idx, test_idx)
