"""The port's splitters, calendar encodings, aggregation and pattern
utilities against the JAX package's, on the CPU.

Both are numpy (the port keeps its own copies), so every result must be
equal, not close: the splits of ``AtTimeStepSplitter`` (with and without
``drop_following_steps``, at the traffic datasets' timestamps through
``get_splitter("la" | "bay")`` on 5-minute indices around each boundary in
2012 and 2017, and at ones given as tuples, strings, ``datetime`` and
``datetime64``), ``indices_between``, ``FixedIndicesSplitter``,
``disjoint_months`` and ``DisjointMonthsSplitter``; ``datetime_onehot`` and
``holidays_onehot`` (and its error without the ``holidays`` package);
``temporal_aggregate``, ``spatial_aggregate`` and ``temporal_mean``; and
``patterns``, whose ``broadcast`` takes torch tensors where the JAX one
takes ``jax.numpy`` arrays (values equal to the numpy route's).
"""
from datetime import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.data import aggregation as j_agg
from sgp_tpu.data import patterns as j_pat
from sgp_tpu.data import splitters as j_split
from sgp_tpu.data.spatiotemporal import SpatioTemporalDataset as JDataset
from sgp_tpu.data.windowing import Windowing as JWindowing
from sgp_tpu.exp.common import get_splitter as j_get_splitter

from sgp_tpu_torch.data import (AtTimeStepSplitter, DisjointMonthsSplitter,
                                FixedIndicesSplitter, SpatioTemporalDataset,
                                Windowing, datetime_onehot, disjoint_months,
                                holidays_onehot, indices_between)
from sgp_tpu_torch.data import aggregation as t_agg
from sgp_tpu_torch.data import patterns as t_pat
from sgp_tpu_torch.exp.common import get_splitter

STEP = np.timedelta64(5, "m")


def datasets(start: str, steps: int, window=12, horizon=12, delay=0,
             freq=STEP, nodes=3):
    """The same dataset over a regular datetime index in both packages."""
    index = np.datetime64(start) + np.arange(steps) * freq
    target = np.random.default_rng(0).random((steps, nodes, 1)).astype(
        np.float32)
    return (JDataset(target, index=index,
                     windowing=JWindowing(window=window, horizon=horizon,
                                          delay=delay)),
            SpatioTemporalDataset(target, index=index,
                                  windowing=Windowing(window=window,
                                                      horizon=horizon,
                                                      delay=delay)))


def equal_splits(got, want):
    for part in ("train", "val", "test"):
        np.testing.assert_array_equal(getattr(got, part),
                                      getattr(want, part), err_msg=part)


@pytest.mark.parametrize("name,start", [("la", "2012-05-20T00:00"),
                                        ("bay", "2017-05-05T00:00")])
@pytest.mark.parametrize("horizon,delay", [(12, 0), (3, 2)])
def test_get_splitter_traffic_datasets(name, start, horizon, delay):
    """The paper's timestamps on 5-minute indices that span them (25 days
    for METR-LA in 2012, 28 for PEMS-BAY in 2017)."""
    steps = (25 if name == "la" else 28) * 288
    jds, ds = datasets(start, steps, horizon=horizon, delay=delay)
    splitter = get_splitter(name)
    assert isinstance(splitter, AtTimeStepSplitter)
    want = j_get_splitter(name).split(jds)
    got = splitter.split(ds)
    equal_splits(got, want)
    assert len(got.train) and len(got.val) and len(got.test)
    # the reference's quirk: train is every item before the first test one
    np.testing.assert_array_equal(got.train, np.arange(got.test.min()))
    assert repr(got) == repr(want)


@pytest.mark.parametrize("stamps", [
    dict(first_val_ts="2012-05-22T06:00", last_val_ts="2012-05-23T00:00",
         first_test_ts="2012-05-23T12:00"),
    dict(first_val_ts=(2012, 5, 22, 6), last_test_ts=(2012, 5, 24),
         first_test_ts=datetime(2012, 5, 23, 12)),
    dict(first_val_ts=np.datetime64("2012-05-22T06:00"),
         first_test_ts=np.datetime64("2012-05-23T12:00"))])
@pytest.mark.parametrize("drop", [True, False])
def test_at_time_step_splitter(stamps, drop):
    jds, ds = datasets("2012-05-20T00:00", 6 * 288, window=6, horizon=3)
    want = j_split.AtTimeStepSplitter(drop_following_steps=drop,
                                      **stamps).split(jds)
    got = AtTimeStepSplitter(drop_following_steps=drop, **stamps).split(ds)
    equal_splits(got, want)
    if not drop:
        assert not np.intersect1d(got.train, got.val).size
        assert not np.intersect1d(got.val, got.test).size


def test_indices_between_and_fixed_indices():
    jds, ds = datasets("2017-05-05T00:00", 2 * 288, window=4, horizon=2)
    for first, last in ((None, None), ("2017-05-05T10:00", None),
                        (None, "2017-05-06T01:05"),
                        ("2017-05-05T10:00", "2017-05-05T11:00")):
        np.testing.assert_array_equal(indices_between(ds, first, last),
                                      j_split.indices_between(jds, first,
                                                              last))
    parts = (np.arange(5), np.arange(5, 8), [9, 10])
    equal_splits(FixedIndicesSplitter(*parts).split(ds),
                 j_split.FixedIndicesSplitter(*parts).split(jds))


@pytest.mark.parametrize("synch_mode", ["window", "horizon"])
def test_disjoint_months(synch_mode):
    jds, ds = datasets("2020-01-01T00:00", 24 * 120, window=24, horizon=12,
                       freq=np.timedelta64(1, "h"))
    for months in (2, (1, 3)):
        for got, want in zip(disjoint_months(ds, months, synch_mode),
                             j_split.disjoint_months(jds, months,
                                                     synch_mode)):
            np.testing.assert_array_equal(got, want)
    equal_splits(
        DisjointMonthsSplitter((3,), (4,), synch_mode).split(ds),
        j_split.DisjointMonthsSplitter((3,), (4,), synch_mode).split(jds))
    with pytest.raises(ValueError, match="synch_mode"):
        disjoint_months(ds, 2, "neither")


def test_calendar_encodings():
    index = (np.datetime64("2021-12-24T00:00")
             + np.arange(40 * 24) * np.timedelta64(1, "h")
             ).astype("datetime64[ns]")
    for units in ("weekday", ["weekday", "hour", "month"]):
        got = datetime_onehot(index, units)
        np.testing.assert_array_equal(got,
                                      j_split.datetime_onehot(index, units))
        assert got.dtype == np.float32
    with pytest.raises(ValueError):
        datetime_onehot(index, "minute")
    days = ["2021-12-25", "2022-01-01"]
    np.testing.assert_array_equal(
        holidays_onehot(index, holidays_list=days),
        j_split.holidays_onehot(index, holidays_list=days))
    with pytest.raises(ValueError, match="holidays"):
        holidays_onehot(index)
    with pytest.raises(ValueError, match="holidays"):
        j_split.holidays_onehot(index)
    # a country needs the package, which neither environment has
    for fn in (holidays_onehot, j_split.holidays_onehot):
        with pytest.raises(ModuleNotFoundError, match="holidays"):
            fn(index, country="US")


def test_aggregation():
    rng = np.random.default_rng(0)
    x = rng.random((50, 6, 2)).astype(np.float32)
    for how in ("mean", "sum", "nearest"):
        np.testing.assert_array_equal(t_agg.temporal_aggregate(x, 4, how),
                                      j_agg.temporal_aggregate(x, 4, how))
    clusters = np.array([0, 2, 2, 1, 0, 2])
    for how, k in (("sum", None), ("mean", None), ("mean", 5)):
        np.testing.assert_array_equal(
            t_agg.spatial_aggregate(x, clusters, how, k),
            j_agg.spatial_aggregate(x, clusters, how, k))
    index = np.datetime64("2021-03-01T00:00") + np.arange(50) * \
        np.timedelta64(6, "h")
    xn = x.copy()
    xn[rng.random(x.shape) < 0.1] = np.nan
    np.testing.assert_array_equal(t_agg.temporal_mean(xn, index),
                                  j_agg.temporal_mean(xn, index))
    with pytest.raises(ValueError):
        t_agg.temporal_aggregate(x, 4, "median")


def test_patterns():
    for pattern in ("t n c", "s n f", "b t n c", "e"):
        assert t_pat.parse_pattern(pattern) == j_pat.parse_pattern(pattern)
        assert t_pat.check_pattern(pattern) == j_pat.check_pattern(pattern)
    for bad in ("t x", "t n c d"):
        with pytest.raises(ValueError):
            t_pat.check_pattern(bad, ndim=3)
    x = np.random.default_rng(0).random((4, 2)).astype(np.float32)
    for pattern, target, kw in (("n c", "t n c", {"t": 5}),
                                ("t c", "t n c", {"n": 3}),
                                ("n c", "b t n c", {})):
        want = np.asarray(j_pat.broadcast(x, pattern, target, **kw))
        got = t_pat.broadcast(x, pattern, target, **kw)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
        tensor = t_pat.broadcast(torch.as_tensor(x), pattern, target, **kw)
        assert isinstance(tensor, torch.Tensor)
        np.testing.assert_array_equal(tensor.numpy(), want)
        # a non-numpy input: a jax.numpy array there, a tensor here
        np.testing.assert_array_equal(
            t_pat.broadcast(x.tolist(), pattern, target, **kw).numpy(),
            np.asarray(j_pat.broadcast(jnp.asarray(x), pattern, target,
                                       **kw)))
