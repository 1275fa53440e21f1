"""The loader-side SGP supports of the port against the JAX package's, on
the CPU: ``spgemm`` and ``sgp_spatial_support`` (equal edges, weights
within 1e-7), ``apply_support`` with and without ``node_index``, the
``SGPLoader`` and ``SGPIIDLoader`` batches (within 1e-6 of the largest
value), the ``IIDLoader`` draws and batches (equal), and the dataset's
device-resident encoding (``encode_dataset(device_resident=True)``): the
same batches as the host encoding, gathered where the tensor lives.

Inputs are made from a seed with numpy at ``tests/test_runners.py``'s
``BASE`` size: 12 nodes, 160 steps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.data import IIDLoader as JIIDLoader
from sgp_tpu.data import SpatioTemporalDataset as JDataset
from sgp_tpu.data import Windowing as JWindowing
from sgp_tpu.data import sgp_loader as j_sl
from sgp_tpu.encode.spatial import sgp_spatial_support as j_support
from sgp_tpu.graph import Graph as JGraph
from sgp_tpu.graph import coalesce as j_coalesce
from sgp_tpu.graph.sparse import spgemm as j_spgemm

from sgp_tpu_torch.data import IIDLoader, SpatioTemporalDataset, Windowing
from sgp_tpu_torch.data import sgp_loader as t_sl
from sgp_tpu_torch.encode import (SGPEncoder, encode_dataset,
                                  sgp_spatial_support)
from sgp_tpu_torch.graph import Graph, coalesce, spgemm

torch.set_num_threads(1)

N, T, C = 12, 160, 2
TOL_W = 1e-7       # support weights: the same scipy products in f32
TOL_X = 1e-6       # propagated batches, relative to the largest value


def _graphs(seed=0, e=50):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, e), rng.integers(0, N, e)
    w = rng.random(e).astype(np.float32)
    return (coalesce(Graph(src, dst, w, N)),
            j_coalesce(JGraph(src, dst, w, N)))


def _datasets(window=1, horizon=2, seed=1):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((T, N, C)).astype(np.float32)
    mask = rng.random((T, N, C)) > 0.1
    u = rng.standard_normal((T, 3)).astype(np.float32)
    g, jg = _graphs()
    t_ds = SpatioTemporalDataset(data, mask=mask, graph=g,
                                 covariates={"u": u},
                                 windowing=Windowing(window, horizon))
    j_ds = JDataset(data, mask=mask, graph=jg, covariates={"u": u},
                    windowing=JWindowing(window, horizon))
    return t_ds, j_ds


def _close(got, want, tol=TOL_X):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, \
        np.abs(got - want).max() / scale


def _same_graph(got: Graph, want):
    np.testing.assert_array_equal(got.src, want.src)
    np.testing.assert_array_equal(got.dst, want.dst)
    assert got.num_nodes == want.num_nodes
    np.testing.assert_allclose(got.weight, want.weight, rtol=0, atol=TOL_W)


def test_spgemm_matches_jax():
    (a, ja), (b, jb) = _graphs(0), _graphs(3)
    _same_graph(spgemm(a, b), j_spgemm(ja, jb))


SUPPORT_CASES = [
    dict(k=3), dict(k=3, true_powers=False), dict(k=2, bidirectional=True),
    dict(k=2, bidirectional=True, true_powers=False),
    dict(k=2, global_attr=True), dict(k=3, undirected=True),
    dict(k=2, add_loops=True), dict(k=1, remove_loops=True),
    dict(k=4, bidirectional=True, global_attr=True)]


@pytest.mark.parametrize("kw", SUPPORT_CASES, ids=[
    "-".join(f"{k}={v}" for k, v in c.items()) for c in SUPPORT_CASES])
def test_sgp_spatial_support_matches_jax(kw):
    g, jg = _graphs()
    got, want = sgp_spatial_support(g, **kw), j_support(jg, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same_graph(a, b)


def test_support_powers_are_powers_or_the_quirk():
    """``true_powers`` gives A^2, A^3; the quirk appends A^2 twice."""
    g, _ = _graphs()
    true, quirk = (sgp_spatial_support(g, k=3, true_powers=p)
                   for p in (True, False))
    a = true[0].to_dense().astype(np.float64)
    np.testing.assert_allclose(true[2].to_dense(), a @ a @ a, atol=1e-6)
    np.testing.assert_allclose(quirk[2].to_dense(), a @ a, atol=1e-6)


@pytest.mark.parametrize("node_index", [None, np.array([3, 0, 11, 3, 7])],
                         ids=["full", "node_index"])
@pytest.mark.parametrize("kw", [dict(k=2), dict(k=2, bidirectional=True,
                                                global_attr=True)],
                         ids=["k2", "k2-bidirectional-global"])
def test_apply_support_matches_jax(kw, node_index):
    g, jg = _graphs()
    x = np.random.default_rng(2).standard_normal((4, 3, N, C)).astype(
        np.float32)
    ops = t_sl.build_support_operators(g, device="cpu", **kw)
    jops = j_sl.build_support_operators(jg, **kw)
    got = t_sl.apply_support(torch.as_tensor(x), ops, node_index)
    want = j_sl.apply_support(jnp.asarray(x), jops, node_index)
    _close(got, want)


def test_build_support_operators_modes_agree():
    """The dense, BSR (K1's plain version on the CPU) and COO supports
    give the same batches."""
    g, _ = _graphs()
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2, 1, N, C)).astype(np.float32))
    outs = [t_sl.apply_support(x, t_sl.build_support_operators(
        g, k=2, bidirectional=True, operator_mode=mode, device="cpu"))
        for mode in ("dense", "bsr", "coo")]
    for out in outs[1:]:
        _close(out, outs[0])


def test_sgp_loader_matches_jax():
    t_ds, j_ds = _datasets(window=3)
    g, jg = t_ds.graph, j_ds.graph
    kw = dict(k=2, bidirectional=True, global_attr=True)
    items = np.arange(40)
    got = list(t_sl.SGPLoader(t_ds, t_sl.build_support_operators(
        g, device="cpu", **kw), items=items, batch_size=16, shuffle=True,
        seed=5))
    want = list(j_sl.SGPLoader(j_ds, j_sl.build_support_operators(jg, **kw),
                               items=items, batch_size=16, shuffle=True,
                               seed=5))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert set(a) == set(b)
        _close(a["x"], b["x"])
        for k in ("y", "mask", "u"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_iid_loader_draws_match_jax():
    t_ds, j_ds = _datasets()
    steps = t_ds.indices()[:100]
    got = list(IIDLoader(t_ds, batch_size=16, num_batches=3, seed=7,
                         step_index=steps))
    want = list(JIIDLoader(j_ds, batch_size=16, num_batches=3, seed=7,
                           step_index=steps))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_sgp_iid_loader_matches_jax():
    t_ds, j_ds = _datasets(window=2)
    kw = dict(k=2, bidirectional=True)
    got = list(t_sl.SGPIIDLoader(t_ds, t_sl.build_support_operators(
        t_ds.graph, device="cpu", **kw), batch_size=16, num_batches=2,
        seed=3))
    want = list(j_sl.SGPIIDLoader(j_ds, j_sl.build_support_operators(
        j_ds.graph, **kw), batch_size=16, num_batches=2, seed=3))
    for a, b in zip(got, want):
        assert a["x"].shape == (16, 2, 5 * C)
        _close(a["x"], b["x"])
        for k in ("y", "mask", "u", "node_index"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def _encoded(device_resident, store_dtype=None, save_path=None):
    t_ds, _ = _datasets(window=2)
    enc = SGPEncoder(input_size=C + 3, reservoir_size=4, receptive_field=2,
                     bidirectional=True, global_attr=True, device="cpu")
    encode_dataset(t_ds, enc, encode_exogenous=True, keep_raw=True,
                   device_resident=device_resident, store_dtype=store_dtype,
                   save_path=save_path)
    return t_ds


@pytest.mark.parametrize("store_dtype", [None, "bfloat16"])
def test_device_resident_encoding_gathers_like_the_host_one(store_dtype,
                                                            tmp_path):
    """The encoding stays a tensor (in ``store_dtype``) where the encoder
    ran; the window and (time, node) batches gathered from it equal the
    host encoding's, f32 features; a cache written by a resident encode
    loads back onto the device."""
    host = _encoded(False, store_dtype)
    path = str(tmp_path / "enc.npz")
    dev = _encoded(True, store_dtype, save_path=path)
    enc = dev.covariates["encoded_x"].value
    assert isinstance(enc, torch.Tensor)
    assert enc.dtype == (torch.bfloat16 if store_dtype else torch.float32)
    items, t, n = np.array([0, 5, 17]), np.array([3, 9]), np.array([1, 11])
    for a, b in ((dev.gather_batch(items), host.gather_batch(items)),
                 (dev.gather_iid_batch(t, n), host.gather_iid_batch(t, n)),
                 (dev.gather_batch(items, node_index=np.array([2, 4])),
                  host.gather_batch(items, node_index=np.array([2, 4])))):
        assert isinstance(a["x"], torch.Tensor) and a["x"].dtype == \
            torch.float32
        np.testing.assert_array_equal(a["x"].numpy(), b["x"])
        for k in ("y", "mask", "u"):
            np.testing.assert_array_equal(np.asarray(a[k]), b[k])
    cached = _encoded(True, store_dtype, save_path=path)
    assert torch.equal(cached.covariates["encoded_x"].value, enc)


def test_tensor_and_host_covariates_concatenate():
    """Input keys mixing a tensor covariate with host ones (a global one
    broadcast over nodes) give the host dataset's arrays and batches, as
    tensors."""
    host, dev = _datasets(window=2)[0], _datasets(window=2)[0]
    enc = np.random.default_rng(6).standard_normal((T, N, 5)).astype(
        np.float32)
    host.add_covariate("encoded_x", enc)
    dev.add_covariate("encoded_x", torch.as_tensor(enc))
    for ds in (host, dev):
        ds.set_input_keys(["encoded_x", "u", "target_scaled"])
    got, want = dev.input_array(), host.input_array()
    assert isinstance(got, torch.Tensor) and got.shape == (T, N, 5 + 3 + C)
    np.testing.assert_array_equal(got.numpy(), want)
    items = np.array([1, 8, 30])
    np.testing.assert_array_equal(dev.gather_batch(items)["x"].numpy(),
                                  host.gather_batch(items)["x"])
