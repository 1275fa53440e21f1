"""The port's traffic SGP path against the JAX package's, on the CPU.

- ``make_fused_window_step`` on the JAX step's draws (``train_on``), 4
  steps with and without supports: losses and weights within 1e-5
  (measured: losses 4.0e-7 relative, weights 2.2e-6 of the larger of the
  largest weight and 1).
- ``SGPOnlineModel`` and ``ESNModel`` forward and gradients on weights
  carried by ``flax_to_torch``: 1e-5; the ESN's reservoir, drawn from the
  same seed, equal to the JAX one bit for bit.
- The runner (``exp/run_traffic_sgp.py``) against the JAX runner at
  ``tests/test_runners.py``'s ``BASE`` size (12 nodes, 160 steps,
  reservoir 4, hidden 16, MLP 8, batch 8), 8 epochs of 4 steps, the port
  starting from the JAX run's initial weights and, on the fused route,
  taking its window draws; the non-fused routes' loaders draw the same
  batches from the same seed. Test MAE within TOL_RUN (5e-4) relative.
  Measured: fused 3.9e-7, ESN 3.4e-7, online_sgp 1.8e-5, ``--fused
  false`` 5.0e-5, ``--sgp-preprocessing`` 7.4e-5. The last three come
  from their first step: the two encodings differ by up to 3.5e-7 (f32
  sums in another order), one sample's MAE sign turns, and Adam's first
  step moves one horizon step's readout bias, whose signs nearly cancel,
  by 6.9e-4 in one package and not in the other. Each trained MAE lies
  below its own ``--epochs 0`` run.
- Every route runs on the CPU; ``--data-sharding batch`` off the fused
  route raises; without ``--device`` the runner asks for the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sgp_tpu.train.predictor as j_predictor
from sgp_tpu.data import ScalerParams as JScalerParams
from sgp_tpu.data.sgp_loader import build_support_operators as j_supports
from sgp_tpu.encode.reservoir import Reservoir as JReservoir
from sgp_tpu.exp import run_traffic_sgp as j_runner
from sgp_tpu.exp.common import Experiment as JExperiment
from sgp_tpu.graph import Graph as JGraph
from sgp_tpu.graph import coalesce as j_coalesce
from sgp_tpu.models import SGPModel as JSGPModel
from sgp_tpu.models import SGPOnlineModel as JOnline
from sgp_tpu.models.esn import ESNModel as JESN
from sgp_tpu.ops import build_operator as j_build_operator
from sgp_tpu.train.fused_window import make_fused_window_step as j_step
from sgp_tpu.utils.config import config as jax_config

import sgp_tpu_torch.exp.run_traffic_sgp as runner
import sgp_tpu_torch.train.predictor as t_predictor
from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.data.sgp_loader import build_support_operators
from sgp_tpu_torch.exp.common import Experiment
from sgp_tpu_torch.graph import Graph, coalesce
from sgp_tpu_torch.models import (ESNModel, SGPModel, SGPOnlineModel,
                                  flax_to_torch, get_model_class)
from sgp_tpu_torch.ops import build_operator
from sgp_tpu_torch.train.fused_window import make_fused_window_step
from sgp_tpu_torch.utils.config import config as torch_config

torch.set_num_threads(1)

TOL = 1e-5          # steps and models on carried weights
TOL_RUN = 5e-4      # the runners' test MAE, relative
BASE = ["--dataset-name", "synthetic", "--synthetic-nodes", "12",
        "--synthetic-steps", "160", "--epochs", "8",
        "--batches-epoch", "4", "--reservoir-size", "4",
        "--mlp-size", "8", "--hidden-size", "16", "--batch-size", "8",
        "--seed", "0", "--patience", "5"]
T, N, CIN = 90, 10, 4


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setitem(torch_config, "logs_dir", str(tmp_path / "torch"))
    monkeypatch.setattr(jax_config, "logs_dir", str(tmp_path / "jax"))


def _graphs(rng, n=N, e=40):
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    return coalesce(Graph(src, dst, w, n)), j_coalesce(JGraph(src, dst, w, n))


def _params_close(tm, params, tol=TOL):
    """Every weight of ``tm`` against the flax tree ``params`` (carried
    into a fresh twin of ``tm`` by ``flax_to_torch``)."""
    import copy
    ref = flax_to_torch(jax.tree.map(np.asarray, params), copy.deepcopy(tm))
    for (name, got), want in zip(tm.state_dict().items(),
                                 ref.state_dict().values()):
        scale = max(float(want.abs().max()), 1.0)
        assert float((got - want).abs().max()) <= tol * scale, name


@pytest.mark.parametrize("supports,scale_target", [
    (False, False), (True, False), (True, True)],
    ids=["plain", "supports", "supports-scale_target"])
def test_fused_window_step_matches_jax(rng, supports, scale_target):
    g, jg = _graphs(rng)
    x = rng.standard_normal((T, N, CIN)).astype(np.float32)
    y = (rng.standard_normal((T, N, 1)) * 3 + 1).astype(np.float32)
    m = rng.random((T, N, 1)) > 0.1
    u = rng.standard_normal((T, N, 1)).astype(np.float32)
    starts, w_off, h_off = np.arange(T - 6), np.arange(2), 2 + np.arange(3)
    bias, scale = np.float32([[0.5]]), np.float32([[2.0]])
    kw = dict(k=2, bidirectional=True, global_attr=True)
    jops = j_supports(jg, **kw) if supports else None
    tops = build_support_operators(g, device="cpu", **kw) if supports \
        else None
    width = CIN * (1 + (len(tops) if supports else 0))
    common = dict(input_size=width, order=width // CIN, n_nodes=N,
                  hidden_size=18, mlp_size=8, output_size=1, n_layers=2,
                  horizon=3, exog_size=1, resnet=True)
    jm, tm = JSGPModel(**common), SGPModel(**common)
    key = jax.random.PRNGKey(3)
    params = jm.init({"params": key, "dropout": key},
                     jnp.zeros((2, 2, N, width)), u=jnp.zeros((2, 2, N, 1)))
    flax_to_torch(jax.tree.map(np.asarray, params), tm)
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-2))
    jstep = j_step(jm, opt, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                   jnp.asarray(starts), jnp.asarray(w_off),
                   jnp.asarray(h_off), JScalerParams(bias, scale),
                   u=jnp.asarray(u), support_ops=jops, batch_size=8,
                   scale_target=scale_target)
    tstep = make_fused_window_step(
        tm, torch.optim.Adam(tm.parameters(), lr=1e-2), torch.as_tensor(x),
        torch.as_tensor(y), torch.as_tensor(m), starts, w_off, h_off,
        ScalerParams(torch.as_tensor(bias), torch.as_tensor(scale)),
        u=torch.as_tensor(u), support_ops=tops, batch_size=8,
        scale_target=scale_target, grad_clip=5.0)
    state = opt.init(params)
    for i in range(4):
        k = jax.random.PRNGKey(10 + i)
        items = jax.random.choice(jax.random.split(k)[0], jnp.asarray(starts),
                                  (8,))
        params, state, want = jstep(params, state, k)
        got = tstep.train_on(torch.as_tensor(np.array(items)))
        assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    _params_close(tm, params)


def test_fused_window_step_samples_and_learns(rng):
    """``step(generator)``: draws from the item starts with the given
    generator (the same stream, the same run) and lowers the loss."""
    x = rng.standard_normal((T, N, CIN)).astype(np.float32)
    y = x[..., :1] * 2.0
    runs = []
    for _ in range(2):
        tm = SGPModel(input_size=CIN, order=1, n_nodes=N, hidden_size=16,
                      mlp_size=8, output_size=1, n_layers=1, horizon=1,
                      generator=torch.Generator().manual_seed(0))
        step = make_fused_window_step(
            tm, torch.optim.Adam(tm.parameters(), lr=1e-2),
            torch.as_tensor(x), torch.as_tensor(y),
            torch.ones((T, N, 1), dtype=torch.bool), np.arange(T - 2),
            np.arange(1), np.arange(1),
            ScalerParams(torch.zeros(1), torch.ones(1)), batch_size=16,
            steps_per_call=20)
        gen = torch.Generator().manual_seed(1)
        runs.append([float(step(gen)) for _ in range(6)])
    assert runs[0] == runs[1]
    assert runs[0][-1] < 0.5 * runs[0][0], runs[0]


@pytest.mark.parametrize("bidirectional", [True, False])
def test_sgp_online_model_matches_jax(rng, bidirectional):
    g, jg = _graphs(rng)
    kw = dict(input_size=3, n_nodes=N, output_size=2, horizon=4,
              receptive_field=2, reservoir_layers=1,
              bidirectional=bidirectional, hidden_size=20, mlp_size=8,
              exog_size=2, resnet=True)
    jm, tm = JOnline(**kw), SGPOnlineModel(**kw)
    from sgp_tpu.encode.spatial import \
        prepare_propagation_graphs as j_prepare
    from sgp_tpu_torch.encode import prepare_propagation_graphs
    jops = [j_build_operator(x) for x in j_prepare(
        jg, bidirectional=bidirectional)]
    tops = [build_operator(x, device="cpu") for x in
            prepare_propagation_graphs(g, bidirectional=bidirectional)]
    x = rng.standard_normal((5, 2, N, 3)).astype(np.float32)
    u = rng.standard_normal((5, 2, N, 2)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), x, jops, u=u)
    flax_to_torch(jax.tree.map(np.asarray, params), tm)

    def j_loss(p):
        return jnp.sum(jm.apply(p, x, jops, u=u) ** 2)
    want, j_grads = jax.value_and_grad(j_loss)(params)
    got = (tm(torch.as_tensor(x), tops, u=torch.as_tensor(u)) ** 2).sum()
    got.backward()
    assert abs(float(got) - float(want)) <= TOL * float(want)
    _grads_close(tm, j_grads)


def _grads_close(tm, j_grads):
    import copy
    ref = flax_to_torch(jax.tree.map(np.asarray, j_grads),
                        copy.deepcopy(tm))
    for (name, p), want in zip(tm.named_parameters(), ref.parameters()):
        scale = max(float(want.abs().max()), 1e-6)
        assert float((p.grad - want).abs().max()) <= TOL * scale, name


def test_esn_model_matches_jax(rng):
    kw = dict(input_size=3, hidden_size=6, output_size=1, exog_size=1,
              rec_layers=2, horizon=4, seed=5)
    jm, tm = JESN.build(**kw), ESNModel.build(**kw)
    jres = JReservoir(input_size=4, hidden_size=6, num_layers=2,
                      leaking_rate=0.9, spectral_radius=0.9, density=0.7,
                      activation="tanh", seed=5)
    for i, layer in enumerate(jres.layers):
        for name in ("w_ih", "w_hh", "b_ih"):
            np.testing.assert_array_equal(
                getattr(tm, f"{name}_{i}").numpy(),
                np.asarray(getattr(layer, name)))
        assert tm.alphas[i] == float(layer.alpha)
    assert [n for n, _ in tm.named_parameters()] == [
        "readout.linear.weight", "readout.linear.bias"]
    x = rng.standard_normal((3, 5, N, 3)).astype(np.float32)
    u = rng.standard_normal((3, 5, N, 1)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(1), x, u=u)
    flax_to_torch(jax.tree.map(np.asarray, params), tm)

    def j_loss(p):
        return jnp.sum(jm.apply(p, x, u=u) ** 2)
    want, j_grads = jax.value_and_grad(j_loss)(params)
    out = tm(torch.as_tensor(x), u=torch.as_tensor(u))
    assert out.shape == (3, 4, N, 1)
    got = (out ** 2).sum()
    got.backward()
    assert abs(float(got) - float(want)) <= TOL * float(want)
    _grads_close(tm, j_grads)


def test_registry_builds_the_traffic_models():
    assert get_model_class("esn") is ESNModel
    assert get_model_class("online_sgp") is SGPOnlineModel


def _carry(monkeypatch, seed: int = 0):
    """The JAX runner's initial weights into the port's ``Predictor.init``
    and, for the fused route, its window draws into the port's step (the
    JAX runner's key stream: ``key, k = split(key)`` an epoch,
    ``split(k, steps)`` a step, ``split(step_key)[0]`` for the items)."""
    params = []
    j_init, t_init = j_predictor.Predictor.init, t_predictor.Predictor.init

    def record(self, *a, **k):
        out = j_init(self, *a, **k)
        params.append(jax.tree.map(np.asarray, self.params))
        return out

    def carry(self, *a, **k):
        out = t_init(self, *a, **k)
        flax_to_torch(params[-1], self.model)
        return out

    make_step = runner.make_fused_window_step

    def jax_draws(*args, **kw):
        step = make_step(*args, **kw)
        starts = jnp.asarray(args[5])
        key = [jax.random.PRNGKey(seed)]

        def run(generator):
            key[0], k = jax.random.split(key[0])
            n = kw["steps_per_call"]
            keys = jax.random.split(k, n) if n > 1 else [k]
            return torch.stack([step.train_on(torch.as_tensor(np.array(
                jax.random.choice(jax.random.split(sk)[0], starts,
                                  (kw["batch_size"],)))))
                for sk in keys]).mean()
        return run

    monkeypatch.setattr(j_predictor.Predictor, "init", record)
    monkeypatch.setattr(t_predictor.Predictor, "init", carry)
    monkeypatch.setattr(runner, "make_fused_window_step", jax_draws)


def _port(argv):
    return Experiment(runner.run_experiment, runner.configure_parser()).run(
        list(argv) + ["--device", "cpu"])


def _jax(argv):
    return JExperiment(j_runner.run_experiment,
                       j_runner.configure_parser()).run(list(argv))


ROUTES = {"fused": [], "sgp_preprocessing": ["--sgp-preprocessing", "true",
                                             "--receptive-field", "2",
                                             "--bidirectional", "true"],
          "online_sgp": ["--model-name", "online_sgp",
                         "--receptive-field", "2"],
          "fused_false": ["--fused", "false"],
          "esn": ["--model-name", "esn"]}


@pytest.mark.parametrize("route", list(ROUTES))
def test_runner_matches_jax_runner(monkeypatch, route):
    argv = BASE + ROUTES[route]
    _carry(monkeypatch)
    want, untrained = _jax(argv), _jax(argv + ["--epochs", "0"])
    got, got_untrained = _port(argv), _port(argv + ["--epochs", "0"])
    for res in (want, got):
        assert all(np.isfinite(v) for v in res.values()), res
    np.testing.assert_allclose(got["test_mae"], want["test_mae"],
                               rtol=TOL_RUN)
    np.testing.assert_allclose(got_untrained["test_mae"],
                               untrained["test_mae"], rtol=TOL_RUN)
    assert got["test_mae"] < got_untrained["test_mae"]
    assert want["test_mae"] < untrained["test_mae"]


@pytest.mark.parametrize("flags,mode", [
    (["--iid-sampling", "true"], "auto"),
    (["--iid-sampling", "true", "--sgp-preprocessing", "true"], "auto"),
    (["--sgp-preprocessing", "true", "--fused", "false"], "bsr"),
    (["--model-name", "online_sgp"], "bsr")],
    ids=["iid", "iid-sgp_preprocessing", "sgp_preprocessing-bsr",
         "online_sgp-bsr"])
def test_runner_routes_train_on_the_cpu(flags, mode):
    """The routes without a parity run: finite metrics below the untrained
    run's; ``operator_mode = "bsr"`` set on the parsed namespace builds
    BSR supports and operators (K1's plain version on the CPU)."""
    def run(args):
        args.operator_mode = mode
        return runner.run_experiment(args)

    def port(argv):
        return Experiment(run, runner.configure_parser()).run(
            argv + ["--device", "cpu"])
    res, untrained = port(BASE + flags), port(BASE + flags +
                                              ["--epochs", "0"])
    assert all(np.isfinite(v) for v in res.values()), res
    assert res["test_mae"] < untrained["test_mae"]


def test_data_sharding_batch_raises():
    """``--data-sharding batch`` backs the fused SGP route only (it runs:
    ``tests/test_torch_port_dp.py``); another route raises, as in the JAX
    runner, before any data."""
    with pytest.raises(ValueError, match="requires the fused SGP path"):
        _port(BASE + ["--data-sharding", "batch", "--fused", "false"])


def test_runner_defaults_to_the_card(monkeypatch):
    """No ``--device``: the runner asks for ``cuda:0`` and raises without a
    card instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment(runner.run_experiment, runner.configure_parser()).run(
            list(BASE))
