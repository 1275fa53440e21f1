"""The port's node-sharded encode, ridge, IID step and eval and the sharded
large-scale runner (``sgp_tpu_torch.parallel``) against the JAX package's,
on the same numpy inputs.

The JAX side runs in this process on the virtual 8-device CPU mesh; the
port's ranks run as 2 or 4 gloo processes (``run_ranks``, one spawn a
test) that read the inputs from ``tmp_path``. Tolerances:

- the encoding within 1e-5 of its largest value (sums in another order);
- the ridge by each run's f32-vs-float64 gap: the port's ``(W, b)`` within
  max(1e-5 of the largest, 3 x JAX's distance) of a float64 fit (the Gram
  is ill-conditioned, as in ``tests/test_torch_port_closed_form.py``);
- one IID step on the JAX step's own per-shard draws (``fold_in``,
  ``split``, ``choice``, ``randint`` replayed here): the loss within 1e-5
  relative, each weight within 1e-5 of the model's largest where its
  gradient lies beyond 1e-5 of the largest gradient (the gradient floor:
  below it the sign of Adam's first step is rounding), within two steps
  (2 lr) elsewhere; every rank's weights bit-identical; the packed rows
  within 1e-6 of the unpacked layout (the encoding holds bf16 values);
- the eval's metrics within 1e-5 relative;
- the runner at one rank gives the unsharded runner's test metrics bit
  for bit; at two ranks both end with the same weights, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sgp_tpu.data.scalers import ScalerParams as JScalerParams
from sgp_tpu.encode import Reservoir as JReservoir
from sgp_tpu.graph import Graph as JGraph
from sgp_tpu.models import SGPModel as JSGPModel
from sgp_tpu.parallel import make_mesh as j_make_mesh
from sgp_tpu.parallel.encode import encode_series_sharded as j_encode
from sgp_tpu.parallel.encode import sharded_ridge_nodes as j_ridge
from sgp_tpu.parallel.sharding import make_sharded_iid_eval as j_eval
from sgp_tpu.parallel.sharding import make_sharded_iid_step as j_step
from sgp_tpu.train.iid import pack_iid_data as j_pack
from sgp_tpu.train.metrics import _METRIC_FNS, _masked_reduce
from sgp_tpu.train.metrics import MaskedMetrics as JMetrics

from sgp_tpu_torch.exp import run_largescale_sgp as runner
from sgp_tpu_torch.exp.common import Experiment
from sgp_tpu_torch.graph import Graph, coalesce, normalize_adj
from sgp_tpu_torch.models import SGPModel, flax_to_torch
from sgp_tpu_torch.parallel import run_ranks
from sgp_tpu_torch.parallel.workers import (encode_worker, eval_worker,
                                            ridge_worker, runner_worker,
                                            step_worker)

torch.set_num_threads(1)

TOL = 1e-5
GRAD_FLOOR = 1e-5
T, D, C = 40, 6, 1
H_OFF = np.array([1, 3])
LR = 1e-3
CLIP = 0.5


def random_graph(rng, n, e):
    return normalize_adj(coalesce(Graph(
        rng.integers(0, n, e), rng.integers(0, n, e),
        rng.random(e).astype(np.float32), n)), "row")


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("world", [2, 4])
def test_encode_series_sharded_matches_jax(rng, tmp_path, world):
    """Bidirectional, with the global mean, k 2, on 30 nodes (not a
    multiple of 4): the reservoir of each rank's node block, the padding
    rows zeroed before the mean, the halo K-hops both ways."""
    n, t, f = 30, 12, 3
    g = random_graph(rng, n, 200)
    x = rng.standard_normal((t, n, f)).astype(np.float32)
    res_kw = dict(input_size=f, hidden_size=5, num_layers=2, seed=3)
    enc_kw = dict(k=2, bidirectional=True, global_attr=True)
    path = tmp_path / "enc.npz"
    np.savez(path, src=g.src, dst=g.dst, weight=g.weight, num_nodes=n,
             x_series=x)
    got = run_ranks(encode_worker, world, "gloo", "cpu", str(path),
                    {"device": "cpu", "reservoir": res_kw,
                     "encode": enc_kw})[0]
    mesh = j_make_mesh(world, 1)
    with mesh:
        want = np.asarray(j_encode(
            JReservoir(**res_kw), x, JGraph(g.src, g.dst, g.weight, n),
            mesh, axis="data", **enc_kw))[:, :n]
    assert got.shape == want.shape == (t, n, 5 * 2 * (1 + 2 + 2 + 1))
    assert rel_err(got, want) <= TOL


def _ridge64(x, y, alpha, keep, fit_intercept):
    xf = x.reshape(-1, x.shape[-1]).astype(np.float64)[keep]
    yf = y.reshape(-1, y.shape[-1]).astype(np.float64)[keep]
    xm = xf.mean(0) if fit_intercept else np.zeros(xf.shape[1])
    ym = yf.mean(0) if fit_intercept else np.zeros(yf.shape[1])
    xc, yc = xf - xm, yf - ym
    w = np.linalg.solve(xc.T @ xc + alpha * np.eye(xf.shape[1]), xc.T @ yc)
    return w, ym - xm @ w


def test_sharded_ridge_nodes_matches_jax(rng, tmp_path):
    """2 ranks on 13 nodes (one padding row): the masked Gram, moments and
    sums all-reduced, the same solve on both ranks; with and without the
    intercept and a row mask."""
    t, n, d, c = 30, 13, 7, 2
    x = rng.standard_normal((t, n, d)).astype(np.float32)
    x[..., 0] *= 50                       # an ill-conditioned Gram
    y = (x @ rng.standard_normal((d, c)) + 3.0).astype(np.float32)
    mask = rng.random((t, n, 1)) > 0.2
    path = tmp_path / "ridge.npz"
    np.savez(path, x=x, y=y, mask=mask)
    runs = [dict(alpha=0.1), dict(alpha=1.0, fit_intercept=False),
            dict(alpha=0.5, mask=True)]
    ranks = run_ranks(ridge_worker, 2, "gloo", "cpu", str(path),
                      {"device": "cpu", "runs": runs})
    mesh = j_make_mesh(2, 1)
    for i, run in enumerate(runs):
        (w0, b0), (w1, b1) = ranks[0][i], ranks[1][i]
        np.testing.assert_array_equal(w0, w1)
        np.testing.assert_array_equal(b0, b1)
        fit = run.get("fit_intercept", True)
        with mesh:
            jw, jb = j_ridge(x, y, run["alpha"], mesh,
                             mask=mask if run.get("mask") else None,
                             fit_intercept=fit)
        keep = mask.reshape(-1) if run.get("mask") else slice(None)
        w64, b64 = _ridge64(x, y, run["alpha"], keep, fit)
        for got, want, ref in ((w0, jw, w64), (b0, jb, b64)):
            gap = np.abs(np.asarray(want) - ref).max()
            assert np.abs(got - ref).max() <= max(
                TOL * np.abs(ref).max(), 3 * gap), run


def _iid_problem(rng, n):
    enc = rng.standard_normal((T, n, D)).astype(np.float32)
    enc = torch.as_tensor(enc).to(torch.bfloat16).float().numpy()
    tgt = (rng.standard_normal((T, n, C)) * 10).astype(np.float32)
    mask = rng.random((T, n, C)) > 0.2
    valid = np.arange(T - int(H_OFF[-1]) - 1)
    return enc, tgt, mask, valid


def _models(n_model, u_size, tmp_path):
    """The JAX model, its weights, and the port's model config with the
    same weights saved for the ranks."""
    kw = dict(input_size=D, order=3, n_nodes=n_model, hidden_size=12,
              mlp_size=8, output_size=C, n_layers=2, horizon=len(H_OFF),
              exog_size=u_size)
    jm = JSGPModel(**kw)
    key = jax.random.PRNGKey(0)
    params = jm.init({"params": key, "dropout": key}, jnp.zeros((4, D)),
                     node_index=jnp.zeros(4, jnp.int32), iid=True,
                     **({"u": jnp.zeros((4, u_size))} if u_size else {}))
    tm = flax_to_torch(jax.tree.map(np.asarray, params), SGPModel(**kw))
    state = tmp_path / "state.pt"
    torch.save(tm.state_dict(), state)
    return jm, params, {"model": kw, "state": str(state)}, kw


def _jax_draws(key, valid, world, local_bs, n_local):
    """Each shard's draws of one JAX step (``sharding.py:173-185``)."""
    keys = jax.random.split(key, 1)
    ts, ns = [], []
    for shard in range(world):
        rng_t, rng_n, _ = jax.random.split(
            jax.random.fold_in(keys[0], shard), 3)
        ts.append(np.asarray(jax.random.choice(rng_t, jnp.asarray(valid),
                                               (local_bs,))))
        ns.append(np.asarray(jax.random.randint(rng_n, (local_bs,), 0,
                                                n_local)))
    return np.stack(ts)[:, None], np.stack(ns)[:, None]   # [S, 1, B/S]


def _jax_grads(jm, params, enc, tgt, mask, u, scaler, t, n_glob):
    """The gradient of the whole batch's masked MAE (the emulation of
    ``tests/test_parallel.py:143``)."""
    def loss(p):
        x = enc[t, n_glob]
        steps = t[:, None] + H_OFF[None, :]
        kw = {} if u is None else {"u": u[t] if u.ndim == 2
                                   else u[t, n_glob]}
        y_hat = jm.apply(p, jnp.asarray(x), node_index=jnp.asarray(n_glob),
                         training=False, iid=True, **kw)
        y_hat = scaler.index_nodes_iid(jnp.asarray(n_glob)
                                       ).inverse_transform(y_hat)
        v, c = _masked_reduce(_METRIC_FNS["mae"], y_hat,
                              jnp.asarray(tgt[steps, n_glob[:, None]]),
                              jnp.asarray(mask[steps, n_glob[:, None]]))
        return v / jnp.maximum(c, 1.0)
    return jax.grad(loss)(params)


def _torch_layout(kw, tree) -> dict:
    m = flax_to_torch(jax.tree.map(np.asarray, tree), SGPModel(**kw))
    return {k: v.detach().numpy() for k, v in m.state_dict().items()}


@pytest.mark.parametrize("world,n,n_model,u_kind", [
    (2, 16, 16, "global"), (4, 13, 16, "node")])
def test_sharded_iid_step_matches_jax(rng, tmp_path, world, n, n_model,
                                      u_kind):
    """One clipped Adam step on ``world`` ranks from the JAX step's draws:
    the loss, the weights (beyond the gradient floor), every rank's
    weights bit for bit; 13 nodes on 4 ranks pads 3 node rows (masked);
    then the packed rows against the unpacked layout."""
    enc, tgt, mask, valid = _iid_problem(rng, n)
    u = (rng.standard_normal((T, 3)) if u_kind == "global" else
         rng.standard_normal((T, n, 2))).astype(np.float32)
    bias = np.zeros((1, 1, C), np.float32)
    scale = np.full((1, 1, C), 2.0, np.float32)
    batch = 8 * world
    jm, params, cfg, kw = _models(n_model, u.shape[-1], tmp_path)
    n_local = -(-n // world)
    key = jax.random.PRNGKey(7)
    t, n_loc = _jax_draws(key, valid, world, batch // world, n_local)
    path = tmp_path / "step.npz"
    np.savez(path, encoded=enc, target=tgt, mask=mask, valid=valid,
             h_off=H_OFF, bias=bias, scale=scale, t=t, n=n_loc,
             **{"u" if u.ndim == 2 else "u_node": u})
    ranks = run_ranks(step_worker, world, "gloo", "cpu", str(path), {
        **cfg, "device": "cpu", "lr": LR, "grad_clip": CLIP,
        "batch_size": batch,
        "variants": [{}, {"dtype": "bfloat16", "packed": True}]})

    opt = optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(LR))
    mesh = j_make_mesh(world, 1)
    jscaler = JScalerParams(jnp.asarray(bias), jnp.asarray(scale))
    step = j_step(jm, opt, jnp.asarray(enc), jnp.asarray(tgt),
                  jnp.asarray(mask), jnp.asarray(valid), jnp.asarray(H_OFF),
                  jscaler, mesh, u=jnp.asarray(u), batch_size=batch)
    with mesh:
        p1, _, j_loss = step(params, opt.init(params), key)
    n_glob = (np.arange(world)[:, None] * n_local + n_loc[:, 0]).reshape(-1)
    # the padding rows' draws carry mask False: the gradient over the
    # real nodes' draws only (ids past N clamp like JAX's gather)
    real = n_glob < n
    grads = _jax_grads(jm, params, enc, tgt, mask, u, jscaler,
                       t[:, 0].reshape(-1)[real], n_glob[real])
    want, g = _torch_layout(kw, p1), _torch_layout(kw, grads)
    p_top = max(np.abs(v).max() for v in want.values())
    g_top = max(np.abs(v).max() for v in g.values())

    losses, state = ranks[0][0]
    assert abs(losses[0] - float(j_loss)) <= TOL * abs(float(j_loss))
    for name, w in want.items():
        beyond = np.abs(g[name]) > GRAD_FLOOR * g_top
        err = np.abs(state[name] - w)
        assert (err[beyond] <= TOL * p_top).all(), name
        assert (err <= 2 * LR + TOL * p_top).all(), name
    for other in ranks[1:]:
        for (l0, s0), (l1, s1) in zip(ranks[0], other):
            assert l0 == l1
            for name in s0:
                np.testing.assert_array_equal(s0[name], s1[name])
    # the encoding holds bf16 values: the packed rows carry the same
    (l_bf, s_bf), (l_pk, s_pk) = ranks[0][0], ranks[0][1]
    np.testing.assert_allclose(l_pk, l_bf, rtol=1e-6)
    for name in s_bf:
        np.testing.assert_allclose(s_pk[name], s_bf[name], rtol=0,
                                   atol=1e-6 * p_top)


def test_sharded_iid_eval_matches_jax(rng, tmp_path):
    """2 ranks on 13 nodes (one padding row) with per-node scaler params:
    the unpacked layout, the packed rows with ``x_slice`` and explicit
    targets, and with ``unpack_targets``; every rank's metrics equal."""
    n = 13
    enc, tgt, mask, valid = _iid_problem(rng, n)
    bias = (rng.standard_normal((1, n, C)) * 3).astype(np.float32)
    scale = (rng.random((1, n, C)) * 4 + 1).astype(np.float32)
    jm, params, cfg, _ = _models(14, 0, tmp_path)
    items, w_off = valid[::3], np.array([0])
    path = tmp_path / "eval.npz"
    np.savez(path, encoded=enc, target=tgt, mask=mask, items=items,
             w_off=w_off, h_off=H_OFF, bias=bias, scale=scale)
    variants = [{}, {"packed": True}, {"packed": True,
                                       "unpack_targets": True}]
    ranks = run_ranks(eval_worker, 2, "gloo", "cpu", str(path), {
        **cfg, "device": "cpu", "batch_size": 4, "variants": variants})
    mesh = j_make_mesh(2, 1)
    jscaler = JScalerParams(jnp.asarray(bias), jnp.asarray(scale))
    packed = j_pack(jnp.asarray(enc), jnp.asarray(tgt), jnp.asarray(mask),
                    H_OFF)
    for i, v in enumerate(variants):
        unpack = v.get("unpack_targets", False)
        with mesh:
            ev = j_eval(jm, packed if v.get("packed") else jnp.asarray(enc),
                        None if unpack else jnp.asarray(tgt),
                        None if unpack else jnp.asarray(mask), items, w_off,
                        H_OFF, jscaler, JMetrics.forecasting(), mesh,
                        batch_size=4, x_slice=D if v.get("packed") else None,
                        unpack_targets=unpack, n_nodes=n)
            want = ev(params)
        assert ranks[0][i] == ranks[1][i]
        for k, w in want.items():
            assert abs(ranks[0][i][k] - float(w)) <= TOL * abs(float(w)), \
                (v, k)


RUNNER_ARGV = ["--dataset-name", "synthetic", "--synthetic-nodes", "13",
               "--synthetic-steps", "160", "--reservoir-size", "4",
               "--hidden-size", "16", "--mlp-size", "8", "--batch-size", "8",
               "--epochs", "2", "--batches-epoch", "3", "--device", "cpu",
               "--seed", "0"]


def test_sharded_runner_on_one_rank_equals_unsharded():
    """``--data-sharding nodes`` on one rank: the same draws (rank 0's
    generator is the unsharded runner's), the same steps, the same test
    metrics bit for bit."""
    base = Experiment(runner.run_experiment,
                      runner.configure_parser_largescale()).run(RUNNER_ARGV)
    (res, _), = run_ranks(runner_worker, 1, "gloo", "cpu",
                          RUNNER_ARGV + ["--data-sharding", "nodes"])
    assert res["data_sharding"] == "nodes"
    for k in ("test_mae", "test_mse", "test_mape"):
        assert res[k] == base[k], k


def test_sharded_runner_on_two_ranks_keeps_replicas_equal():
    """Two ranks on 13 nodes: finite test metrics, the same on both
    ranks, and the same final weights bit for bit (the stratified
    trainer's sharded branch: ``tests/test_torch_port_dp.py``)."""
    (r0, w0), (r1, w1) = run_ranks(
        runner_worker, 2, "gloo", "cpu",
        RUNNER_ARGV + ["--data-sharding", "nodes"])
    assert r0["test_mae"] == r1["test_mae"]
    assert np.isfinite(r0["test_mae"]) and r0["data_sharding"] == "nodes"
    for name in w0:
        np.testing.assert_array_equal(w0[name], w1[name])
