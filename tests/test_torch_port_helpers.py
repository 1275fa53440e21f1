"""The port's public helpers that mirror the JAX package's (ROADMAP A13),
each against the JAX function on the same inputs, on the CPU:
``MinMaxScaler`` (fitted bounds equal), the pinball loss and the metric
wrappers (1e-6), ``save_train_state`` / ``load_train_state`` (the JAX
weights, carried into the port's model, come back equal, with the
optimizer's and the generator's state and the ``extra`` dict; a failed
write keeps the previous file), ``power_iteration_spectral_radius`` (from
JAX's start draw: 1e-5 relative, and against LAPACK), ``dummy_graph``,
``band_graph`` and ``morton_order`` (equal) and ``Config`` (the same
absolute ``*_dir`` keys and overrides from the same flat YAML file).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.data.scalers import MinMaxScaler as JMinMax
from sgp_tpu.graph import sparse as j_sparse
from sgp_tpu.models import SGPModel as JSGPModel
from sgp_tpu.ops.linalg import \
    power_iteration_spectral_radius as j_power_iteration
from sgp_tpu.train import checkpoint as j_ckpt
from sgp_tpu.train import metrics as j_metrics
from sgp_tpu.utils.config import Config as JConfig

from sgp_tpu_torch.data import MinMaxScaler
from sgp_tpu_torch.graph import band_graph, dummy_graph, morton_order
from sgp_tpu_torch.models import SGPModel, flax_to_torch
from sgp_tpu_torch.ops import (power_iteration_spectral_radius,
                               spectral_radius_exact)
from sgp_tpu_torch.train import checkpoint as t_ckpt
from sgp_tpu_torch.train import metrics as t_metrics
from sgp_tpu_torch.utils import Config, config

torch.set_num_threads(1)

TOL = 1e-6


@pytest.mark.parametrize("masked,axis,out_range", [
    (False, 0, (0.0, 1.0)), (True, 0, (-1.0, 1.0)), (True, (0, 1), (2., 5.))])
def test_min_max_scaler_matches_jax(rng, masked, axis, out_range):
    x = rng.standard_normal((40, 6, 2)).astype(np.float32) * 3 + 1
    x[:, 2] = 4.0                                # a constant feature
    mask = rng.random(x.shape) > 0.2 if masked else None
    got = MinMaxScaler(axis, out_range).fit(x, mask)
    want = JMinMax(axis, out_range).fit(x, mask)
    for name in ("bias", "scale"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    np.testing.assert_allclose(got.transform(x), want.transform(x), rtol=0,
                               atol=TOL)
    with pytest.raises(ValueError, match="out_range"):
        MinMaxScaler(out_range=(1.0, 0.0)).fit(x)


@pytest.mark.parametrize("masked", [False, True])
def test_pinball_and_metric_wrappers_match_jax(rng, masked):
    y_hat = rng.standard_normal((5, 4, 7, 3)).astype(np.float32)
    y = rng.standard_normal((5, 4, 7, 3)).astype(np.float32)
    mask = (rng.random(y.shape) > 0.3) if masked else None
    tm = None if mask is None else torch.as_tensor(mask)
    th, ty = torch.as_tensor(y_hat), torch.as_tensor(y)
    for q in (0.1, 0.5, 0.9):
        np.testing.assert_allclose(
            t_metrics.pinball_loss(th, ty, q).numpy(),
            np.asarray(j_metrics.pinball_loss(y_hat, y, q)), rtol=0, atol=TOL)
        np.testing.assert_allclose(
            float(t_metrics.masked_pinball(th, ty, tm, q)),
            float(j_metrics.masked_pinball(y_hat, y, mask, q)), rtol=TOL)
    pairs = [
        (t_metrics.multi_loss([t_metrics.masked_mae, t_metrics.masked_mse],
                              [0.3, 2.0]),
         j_metrics.multi_loss([j_metrics.masked_mae, j_metrics.masked_mse],
                              [0.3, 2.0])),
        (t_metrics.metric_at_steps(t_metrics.masked_mae, [0, 2]),
         j_metrics.metric_at_steps(j_metrics.masked_mae, [0, 2])),
        (t_metrics.metric_on_channels(t_metrics.masked_mse, [1]),
         j_metrics.metric_on_channels(j_metrics.masked_mse, [1]))]
    for t_fn, j_fn in pairs:
        want = float(j_fn(jnp.asarray(y_hat), jnp.asarray(y),
                          None if mask is None else jnp.asarray(mask)))
        np.testing.assert_allclose(float(t_fn(th, ty, tm)), want, rtol=TOL)


def _sgp_pair():
    kw = dict(input_size=6, order=3, n_nodes=5, hidden_size=12, mlp_size=8,
              output_size=1, n_layers=1, horizon=2)
    jm = JSGPModel(**kw)
    key = jax.random.PRNGKey(0)
    params = jm.init({"params": key, "dropout": key}, x=jnp.zeros((4, 6)),
                     node_index=jnp.zeros(4, jnp.int32), iid=True)
    return kw, jax.tree.map(np.asarray, params)


def test_train_state_round_trips_as_jax(tmp_path, monkeypatch):
    kw, params = _sgp_pair()
    j_path, t_path = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    extra = {"epoch": 3, "best_loss": 0.25}
    opt_state = {"count": np.int32(7)}
    j_ckpt.save_train_state(j_path, params, opt_state, np.uint32([0, 5]),
                            extra)
    j_params, _, j_rng, j_extra = j_ckpt.load_train_state(
        j_path, params, opt_state)

    model = flax_to_torch(params, SGPModel(**kw))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.ones(4, 6), node_index=torch.zeros(4, dtype=torch.long),
          iid=True).sum().backward()
    opt.step()
    gen = torch.Generator().manual_seed(5)
    t_ckpt.save_train_state(t_path, model, opt, gen, extra)
    assert not os.path.exists(t_path + ".tmp")

    fresh = SGPModel(**kw)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
    fresh_gen = torch.Generator().manual_seed(99)
    got_extra = t_ckpt.load_train_state(t_path, fresh, fresh_opt, fresh_gen)
    assert got_extra == j_extra == extra
    want = flax_to_torch(j_params, SGPModel(**kw)).state_dict()
    model_state = model.state_dict()
    for name, value in fresh.state_dict().items():
        torch.testing.assert_close(value, model_state[name], rtol=0, atol=0)
    assert set(want) == set(model_state)
    assert fresh_opt.state_dict()["state"][0]["step"] == 1
    assert torch.equal(fresh_gen.get_state(), gen.get_state())
    np.testing.assert_array_equal(np.asarray(j_rng), [0, 5])

    # a write that fails keeps the previous file whole
    def broken(obj, path):
        with open(path, "wb") as fp:
            fp.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError, match="disk full"):
        t_ckpt.save_train_state(t_path, model, extra={"epoch": 4})
    assert t_ckpt.load_train_state(t_path, fresh) == extra


@pytest.mark.parametrize("n,seed", [(60, 0), (200, 3)])
def test_power_iteration_matches_jax(rng, n, seed):
    """A reservoir-like matrix with a dominant complex pair of modulus 1.3
    over a bulk of radius ~0.5, in a random basis."""
    w = 0.5 * rng.standard_normal((n, n)) / np.sqrt(n)
    w[:2, :2] += 1.3 * np.array([[np.cos(1.0), -np.sin(1.0)],
                                 [np.sin(1.0), np.cos(1.0)]])
    basis = np.linalg.qr(rng.standard_normal((n, n)))[0]
    w = (basis @ w @ basis.T).astype(np.float32)
    q0 = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n, 2),
                                      jnp.float32))
    want = float(j_power_iteration(jnp.asarray(w), 300, seed))
    got = power_iteration_spectral_radius(w, 300, q0=q0, device="cpu")
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    np.testing.assert_allclose(float(got), spectral_radius_exact(w),
                               rtol=1e-4)
    # a start block of its own: the same radius
    drawn = power_iteration_spectral_radius(w, 300, seed=seed, device="cpu")
    np.testing.assert_allclose(float(drawn), want, rtol=1e-4)


@pytest.mark.parametrize("kind,directed", [
    ("identity", True), ("full", True), ("random", True), ("random", False),
    ("none", True)])
def test_dummy_graphs_equal_jax(kind, directed):
    got = dummy_graph(kind, 17, edge_prob=0.2, directed=directed, seed=4)
    want = j_sparse.dummy_graph(kind, 17, edge_prob=0.2, directed=directed,
                                seed=4)
    if want is None:
        assert got is None
        return
    for name in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))
    with pytest.raises(ValueError, match="unknown"):
        dummy_graph("grid", 4)


def test_band_graph_and_morton_order_equal_jax(rng):
    for n, h in ((30, 4), (9, 1)):
        got, want = band_graph(n, h), j_sparse.band_graph(n, h)
        for name in ("src", "dst", "weight"):
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(want, name)))
    pos = rng.random((500, 2)) * [3.0, 1.0]
    np.testing.assert_array_equal(morton_order(pos),
                                  j_sparse.morton_order(pos))
    with pytest.raises(ValueError, match="positions"):
        morton_order(pos[:, :1])


def test_config_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = Config(data_dir="data", logs_dir="~/runs", n=3)
    want = JConfig(data_dir="data", logs_dir="~/runs", n=3)
    assert dict(got) == dict(want)
    assert got.data_dir == str(tmp_path / "data") and got.n == 3
    with pytest.raises(AttributeError):
        got.missing
    path = tmp_path / "sgp_tpu_config.yaml"
    path.write_text("data_dir: raw/files\nlr: 0.01\nflag: yes\n"
                    "names:\n  - a\n  - b\n")
    assert dict(got.update_from_yaml(str(path))) == \
        dict(want.update_from_yaml(str(path)))
    assert isinstance(config, Config)
    assert set(config) >= {"root_dir", "config_dir", "data_dir", "logs_dir"}
