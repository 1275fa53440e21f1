"""Host-side graph and data prep of the PyTorch port is bit-exact against
the JAX package: the same numpy inputs give the same arrays."""
import numpy as np
import pytest
import torch

import sgp_tpu.data as jd
import sgp_tpu.graph as jg
from sgp_tpu.data.datasets.synthetic import SyntheticDiffusion as JSynth

import sgp_tpu_torch.data as td
import sgp_tpu_torch.graph as tg
from sgp_tpu_torch.data.datasets import SyntheticDiffusion as TSynth


def _pair(rng, n=300, e=3000):
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    return jg.Graph(src, dst, w, n), tg.Graph(src, dst, w, n)


def _same_graph(a, b):
    assert a.num_nodes == b.num_nodes
    for name in ("src", "dst", "weight"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fn", ["coalesce", "transpose", "to_undirected",
                                "add_self_loops", "remove_self_loops"])
def test_graph_algorithms_bit_exact(rng, fn):
    jgr, tgr = _pair(rng)
    _same_graph(getattr(jg, fn)(jgr), getattr(tg, fn)(tgr))


@pytest.mark.parametrize("norm", ["row", "sym", "none"])
def test_normalize_adj_bit_exact(rng, norm):
    jgr, tgr = _pair(rng)
    _same_graph(jg.normalize_adj(jg.coalesce(jgr), norm),
                tg.normalize_adj(tg.coalesce(tgr), norm))


@pytest.mark.parametrize("n", [100, 300, 517])
def test_to_bsr_bit_exact(rng, n):
    jgr, tgr = _pair(rng, n=n, e=6 * n)
    jgr, tgr = jg.coalesce(jgr), tg.coalesce(tgr)
    for a, b in zip(jgr.to_bsr(128), tgr.to_bsr(128)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jgr.to_dense(), tgr.to_dense())


@pytest.mark.parametrize("include_self", [False, True])
def test_top_k_and_gaussian_kernel_bit_exact(rng, include_self):
    d = rng.random((40, 40)).astype(np.float32)
    np.testing.assert_array_equal(jg.gaussian_kernel(d, 0.2),
                                  tg.gaussian_kernel(d, 0.2))
    np.testing.assert_array_equal(jg.gaussian_kernel(d),
                                  tg.gaussian_kernel(d))
    for keep in (False, True):
        np.testing.assert_array_equal(
            jg.top_k(d, 7, include_self=include_self, keep_values=keep),
            tg.top_k(d, 7, include_self=include_self, keep_values=keep))


def test_synthetic_dataset_bit_exact():
    a = JSynth(num_nodes=60, num_steps=300, seed=3)
    b = TSynth(num_nodes=60, num_steps=300, seed=3)
    for name in ("target", "mask", "index", "_dist", "_pos"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.n_steps, a.n_nodes, a.n_channels) == \
        (b.n_steps, b.n_nodes, b.n_channels)


@pytest.mark.parametrize("kwargs", [
    dict(knn=8, include_self=False),
    dict(knn=8, include_self=True, threshold=0.5),
    dict(threshold=0.3, force_symmetric=True, normalize_axis="row"),
    dict(knn=5, binary_weights=True, include_self=False),
])
def test_get_connectivity_bit_exact(kwargs):
    a = JSynth(num_nodes=70, num_steps=20, seed=1)
    b = TSynth(num_nodes=70, num_steps=20, seed=1)
    _same_graph(a.get_connectivity(**kwargs), b.get_connectivity(**kwargs))


@pytest.mark.parametrize("axis,masked", [((0, 1), True), ((0, 1), False),
                                         (0, True)])
def test_robust_scaler_matches(rng, axis, masked):
    x = (rng.standard_normal((50, 9, 2)) * 5 + 3).astype(np.float32)
    mask = rng.random(x.shape) > 0.1 if masked else None
    a = jd.RobustScaler(axis=axis, quantile_range=(10., 90.)).fit(x, mask)
    b = td.RobustScaler(axis=axis, quantile_range=(10., 90.)).fit(x, mask)
    np.testing.assert_array_equal(a.bias, b.bias)
    np.testing.assert_array_equal(a.scale, b.scale)
    # the device transform: f32 elementwise, rtol 1e-6 for the division
    pa, pb = a.params(), b.params()
    np.testing.assert_allclose(pb.transform(torch.as_tensor(x)).numpy(),
                               np.asarray(pa.transform(x)), rtol=1e-6)
    np.testing.assert_allclose(
        pb.inverse_transform(torch.as_tensor(x)).numpy(),
        np.asarray(pa.inverse_transform(x)), rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(window=1, horizon=22, horizon_lag=7),
                                dict(window=12, horizon=12, delay=2,
                                     stride=3, window_lag=2)])
def test_windowing_matches(kw):
    a, b = jd.Windowing(**kw), td.Windowing(**kw)
    assert (a.horizon_steps, a.window_steps, a.sample_span) == \
        (b.horizon_steps, b.window_steps, b.sample_span)
    np.testing.assert_array_equal(a.indices(100), b.indices(100))
    np.testing.assert_array_equal(a.horizon_offsets(), b.horizon_offsets())
