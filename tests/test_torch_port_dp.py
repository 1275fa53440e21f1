"""The port's data-parallel training (``sgp_tpu_torch.parallel`` and
``Predictor(mesh=)``) against the JAX package's, on the same numpy inputs.

The JAX side runs in this process on the virtual 8-device CPU mesh; the
port's ranks run as gloo processes (``run_ranks``) that read the inputs
from a temporary directory: every 2-rank check in one spawn
(``workers.jobs_worker``), the 4-rank stratified step in another. Each
step is held on the JAX step's own draws (``fold_in``, ``split``,
``choice``, ``randint`` replayed here), the starts shared by every rank in
the stratified step. Tolerances (those of ``test_torch_port_parallel.py``):

- a step's loss within 1e-5 relative; each weight within 1e-5 of the
  model's largest where its gradient lies beyond 1e-5 of the largest
  gradient (the gradient floor: below it the sign of Adam's first step is
  rounding), within two steps (2 lr) elsewhere; every rank's weights bit
  for bit;
- the eval's and the runners' metrics within 1e-5 relative;
- at one rank, each sharded step or runner gives its single-device
  counterpart's results bit for bit.

The JAX stratified step reads padded node rows with ``take``, which fills
NaN: its comparisons keep the padded ids inside the model's embedding
(``n_model``) and use a scaler shared by the nodes, and hold the BSR
supports at an N that 4 ranks divide; the port clamps the ids, so its own
BSR step at an N the ranks do not divide, padded rows drawn, is held to
its dense-support step (ROADMAP §C). Dropout is 0 throughout: JAX draws
one mask over the global batch under ``Predictor(mesh=)`` and one stream
a device in the window step, neither of which torch can repeat.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sgp_tpu.train.predictor as j_predictor
from sgp_tpu.data import SpatioTemporalDataset as JDataset
from sgp_tpu.data import StandardScaler as JStandardScaler
from sgp_tpu.data import WindowedLoader as JWindowedLoader
from sgp_tpu.data import Windowing as JWindowing
from sgp_tpu.data.scalers import ScalerParams as JScalerParams
from sgp_tpu.data.sgp_loader import build_support_operators as j_supports
from sgp_tpu.exp import run_largescale_baselines as j_large
from sgp_tpu.exp import run_traffic_baselines as j_traffic
from sgp_tpu.exp.common import Experiment as JExperiment
from sgp_tpu.graph import Graph as JGraph
from sgp_tpu.models import RNNModel as JRNNModel
from sgp_tpu.models.graph_layers import \
    diff_conv_support as j_diff_conv_support
from sgp_tpu.models.gwnet import GraphWaveNetModel as JGraphWaveNet
from sgp_tpu.models import SGPModel as JSGPModel
from sgp_tpu.ops import GlobalMeanOperator as JGlobalMean
from sgp_tpu.parallel import make_mesh as j_make_mesh
from sgp_tpu.parallel.sharding import make_sharded_iid_eval as j_eval
from sgp_tpu.parallel.sharding import \
    make_sharded_iid_stratified_step as j_strat
from sgp_tpu.parallel.sharding import make_sharded_window_step as j_window
from sgp_tpu.train import Predictor as JPredictor
from sgp_tpu.train.metrics import _METRIC_FNS, _masked_reduce
from sgp_tpu.train.metrics import MaskedMetrics as JMetrics
from sgp_tpu.utils.config import config as jax_config

from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.data.sgp_loader import build_support_operators
from sgp_tpu_torch.exp import run_largescale_sgp as t_large_sgp
from sgp_tpu_torch.exp import run_traffic_baselines as t_traffic
from sgp_tpu_torch.exp import run_traffic_sgp as t_traffic_sgp
from sgp_tpu_torch.exp.common import Experiment
from sgp_tpu_torch.graph import Graph
from sgp_tpu_torch.models import SGPModel, flax_to_torch
from sgp_tpu_torch.parallel import (make_mesh, make_sharded_iid_eval,
                                    make_sharded_iid_stratified_step,
                                    make_sharded_window_step, run_ranks,
                                    shard_nodes)
from sgp_tpu_torch.parallel.workers import (jobs_worker, predictor_worker,
                                            runner_worker)
from sgp_tpu_torch.train import MaskedMetrics
from sgp_tpu_torch.train.fused_window import (make_fused_eval,
                                              make_fused_window_step)
from sgp_tpu_torch.train.iid import make_fused_iid_stratified_step
from sgp_tpu_torch.utils.config import config as torch_config
from test_torch_port_parallel import _torch_layout

torch.set_num_threads(1)

TOL = 1e-5
GRAD_FLOOR = 1e-5
T, HT, C = 40, 4, 1
H_OFF = np.array([1, 3])
LR = 1e-3
CLIP = 0.5
K = 2                     # the supports' receptive field
TB = 3                    # stratified: shared starts a step

# (world, N, n_model, supports, u): the JAX stratified step's cases
STRAT_CASES = {"2-dense": (2, 13, 14, "dense", "global"),
               "4-bsr": (4, 16, 16, "bsr", "node")}

SGP_ARGV = ["--dataset-name", "synthetic", "--synthetic-nodes", "13",
            "--synthetic-steps", "160", "--reservoir-size", "4",
            "--hidden-size", "16", "--mlp-size", "8", "--batch-size", "8",
            "--epochs", "2", "--batches-epoch", "3", "--device", "cpu",
            "--seed", "0"]
# a learning rate at which the validation MAE turns up within a few epochs
# (argparse keeps the last --epochs)
EARLY_STOP_ARGV = SGP_ARGV + ["--epochs", "8", "--patience", "0", "--lr",
                              "0.3"]
STRAT_ARGV = SGP_ARGV + ["--iid-stratified", "true", "--times-per-batch",
                         "2", "--global-attr", "true"]
BASE_ARGV = ["--dataset-name", "synthetic", "--synthetic-nodes", "16",
             "--synthetic-steps", "160", "--epochs", "2", "--batches-epoch",
             "2", "--hidden-size", "8", "--ff-size", "8", "--batch-size",
             "8", "--window", "4", "--horizon", "3", "--seed", "0",
             "--patience", "5", "--model-name", "gatedgn",
             "--gn-aggregation", "ell"]
# the baseline runners' flags beside BASE_ARGV
BASELINES = {"traffic_baselines": (j_traffic, ["--adj-knn", "4"]),
             "largescale_baselines": (j_large, [
                 "--num-subgraph-nodes", "6", "--subgraph-k", "1",
                 "--max-edges", "64"])}
METRICS = ("test_mae", "test_mse", "test_mape")


def _graphs(rng, n, e=60):
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    return Graph(src, dst, w, n), JGraph(src, dst, w, n)


def _sgp_models(n_model, d_in, order, u_size, tmp, name, window=False):
    """The JAX SGP decoder's weights (IID inputs, or windows with
    ``window``) and the port's config with them saved for the ranks
    (``workers._sgp_model``)."""
    kw = dict(input_size=d_in, order=order, n_nodes=n_model, hidden_size=12,
              mlp_size=8, output_size=C, n_layers=2, horizon=len(H_OFF),
              exog_size=u_size, resnet=True)
    jm = JSGPModel(**kw)
    key = jax.random.PRNGKey(0)
    u0 = {} if not u_size else {"u": jnp.zeros(
        (2, 1, n_model, u_size) if window else (4, u_size))}
    x0 = jnp.zeros((2, 1, n_model, d_in)) if window else jnp.zeros((4, d_in))
    kwargs = {} if window else {"node_index": jnp.zeros(4, jnp.int32),
                                "iid": True}
    params = jm.init({"params": key, "dropout": key}, x0, **kwargs, **u0)
    tm = flax_to_torch(jax.tree.map(np.asarray, params), SGPModel(**kw))
    state = tmp / f"{name}_state.pt"
    torch.save(tm.state_dict(), state)
    return jm, params, kw, {"model": kw, "state": str(state),
                            "device": "cpu"}


def _weights_hold(got: dict, want: dict, grads: dict):
    """The module docstring's rule for the weights after one step."""
    p_top = max(np.abs(v).max() for v in want.values())
    g_top = max(np.abs(v).max() for v in grads.values())
    for name, w in want.items():
        beyond = np.abs(grads[name]) > GRAD_FLOOR * g_top
        err = np.abs(got[name] - w)
        assert (err[beyond] <= TOL * p_top).all(), name
        assert (err <= 2 * LR + TOL * p_top).all(), name


def _replicas_equal(ranks):
    for losses, state, *_ in ranks[1:]:
        assert losses == ranks[0][0]
        for name in state:
            np.testing.assert_array_equal(state[name], ranks[0][1][name])


def _masked_mae_grads(jm, params, x, y, m, node_index, u, scale):
    """The gradient of the masked MAE of the inverse-scaled output (the
    scaler shared by the nodes: zero bias)."""
    def loss(p):
        kw = {} if u is None else {"u": jnp.asarray(u)}
        if node_index is not None:
            kw.update(node_index=jnp.asarray(node_index), iid=True)
        y_hat = jm.apply(p, jnp.asarray(x), training=False, **kw) * scale
        v, c = _masked_reduce(_METRIC_FNS["mae"], y_hat, jnp.asarray(y),
                              jnp.asarray(m))
        return v / jnp.maximum(c, 1.0)
    return jax.grad(loss)(params)


# -- the stratified step ----------------------------------------------------

def _strat_problem(rng, n, u_kind):
    h = rng.standard_normal((T, n, HT)).astype(np.float32)
    tgt = (rng.standard_normal((T, n, C)) * 10).astype(np.float32)
    mask = rng.random((T, n, C)) > 0.2
    u = (rng.standard_normal((T, 3)) if u_kind == "global" else
         rng.standard_normal((T, n, 2))).astype(np.float32)
    valid = np.arange(T - int(H_OFF[-1]) - 1)
    return h, tgt, mask, u, valid


def _strat_case(rng, tmp, name):
    """One stratified case: the inputs and draws in ``tmp``, the JAX step's
    loss and weights, the JAX gradient of the union of the real draws."""
    world, n, n_model, mode, u_kind = STRAT_CASES[name]
    g, jg = _graphs(rng, n)
    h, tgt, mask, u, valid = _strat_problem(rng, n, u_kind)
    scale = np.full((1, 1, C), 2.0, np.float32)
    jops = j_supports(jg, k=K, operator_mode=mode)
    d_in = HT * (1 + len(jops) + 1)
    jm, params, kw, cfg = _sgp_models(n_model, d_in, d_in // HT,
                                      u.shape[-1], tmp, name)
    p_local, n_local = 2, -(-n // world)
    key = jax.random.PRNGKey(11)
    rng_t, rng_n, _ = jax.random.split(jax.random.split(key, 1)[0], 3)
    t = np.asarray(jax.random.choice(rng_t, jnp.asarray(valid), (TB,)))
    n_loc = np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(rng_n, s), (TB, p_local), 0, n_local))
        for s in range(world)])
    path = tmp / f"{name}.npz"
    np.savez(path, h=h, target=tgt, mask=mask, valid=valid, h_off=H_OFF,
             bias=np.zeros_like(scale), scale=scale, t=t[None],
             n=n_loc[:, None], src=g.src, dst=g.dst, weight=g.weight,
             num_nodes=n, **{"u" if u.ndim == 2 else "u_node": u})
    opt = optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(LR))
    mesh = j_make_mesh(world, 1)
    step = j_strat(jm, opt, jnp.asarray(h), jnp.asarray(tgt),
                   jnp.asarray(mask), jnp.asarray(valid), jnp.asarray(H_OFF),
                   JScalerParams(jnp.zeros_like(scale), jnp.asarray(scale)),
                   jops, mesh, global_attr=True, u=jnp.asarray(u),
                   times_per_batch=TB, nodes_per_time=p_local * world)
    with mesh:
        p1, _, j_loss = step(params, opt.init(params), key)
    # the union of the real draws, through the dense supports
    dense = [np.asarray(op.mat) for op in j_supports(jg, k=K,
                                                     operator_mode="dense")]
    n_glob = (np.arange(world)[:, None, None] * n_local + n_loc).reshape(
        world, -1)
    t_flat = np.tile(np.repeat(t, p_local), world)
    n_flat = n_glob.reshape(-1)
    real = n_flat < n
    t_flat, n_flat = t_flat[real], n_flat[real]
    x = np.concatenate([h[t_flat, n_flat]] + [
        np.einsum("bn,bnf->bf", a[n_flat], h[t_flat]) for a in dense]
        + [h[t_flat].mean(1)], -1)
    steps = t_flat[:, None] + H_OFF[None, :]
    grads = _masked_mae_grads(
        jm, params, x, tgt[steps, n_flat[:, None]],
        mask[steps, n_flat[:, None]], n_flat,
        u[t_flat] if u.ndim == 2 else u[t_flat, n_flat], scale[0, 0])
    cfg.update(lr=LR, grad_clip=CLIP, k=K, mode=mode, global_attr=True)
    return {"path": str(path), "config": cfg, "loss": float(j_loss),
            "want": _torch_layout(kw, p1), "grads": _torch_layout(kw, grads)}


def _pad_case(rng, tmp):
    """The 4-rank step on 13 nodes with draws on the padding rows (numpy
    draws; the port alone: JAX's ``take`` fills those rows with NaN)."""
    n, world = 13, 4
    g, _ = _graphs(rng, n)
    h, tgt, mask, u, valid = _strat_problem(rng, n, "node")
    d_in = HT * (2 + len(build_support_operators(g, k=K, device="cpu")))
    _, _, _, cfg = _sgp_models(n, d_in, d_in // HT, 2, tmp, "pad")
    n_loc = rng.integers(0, 4, (world, 1, TB, 2))
    n_loc[3, 0, :, 0] = 3                  # rank 3's row 3 is node 15
    path = tmp / "pad.npz"
    np.savez(path, h=h, target=tgt, mask=mask, valid=valid, h_off=H_OFF,
             bias=np.zeros((1, 1, C), np.float32),
             scale=np.full((1, 1, C), 2.0, np.float32),
             t=rng.choice(valid, (1, TB)), n=n_loc, u_node=u, src=g.src,
             dst=g.dst, weight=g.weight, num_nodes=n)
    cfg.update(lr=LR, grad_clip=CLIP, k=K, global_attr=True)
    return {"path": str(path), "config": cfg}


# -- the eval with support_ops ----------------------------------------------

EVAL_VARIANTS = [{"supports": {"k": K, "operator_mode": "dense",
                               "global_attr": True}},
                 {"supports": {"k": K, "operator_mode": "bsr",
                               "global_attr": True}}]


def _eval_case(rng, tmp):
    """The JAX sharded eval with ``support_ops`` on 13 nodes over 2 ranks
    (one padding row) and per-node scaler parameters, each variant."""
    n = 13
    g, jg = _graphs(rng, n)
    h, tgt, mask, _, valid = _strat_problem(rng, n, "global")
    bias = (rng.standard_normal((1, n, C)) * 3).astype(np.float32)
    scale = (rng.random((1, n, C)) * 4 + 1).astype(np.float32)
    n_ops = len(j_supports(jg, k=K)) + 1
    jm, params, _, cfg = _sgp_models(14, HT * (1 + n_ops), 1 + n_ops, 0,
                                     tmp, "eval")
    items, w_off = valid[::3], np.array([0])
    path = tmp / "eval.npz"
    np.savez(path, encoded=h, target=tgt, mask=mask, items=items,
             w_off=w_off, h_off=H_OFF, bias=bias, scale=scale, src=g.src,
             dst=g.dst, weight=g.weight, num_nodes=n)
    mesh = j_make_mesh(2, 1)
    wants = []
    for v in EVAL_VARIANTS:
        ops = j_supports(jg, k=K, operator_mode=v["supports"][
            "operator_mode"]) + [JGlobalMean(n)]
        with mesh:
            wants.append(j_eval(
                jm, jnp.asarray(h), jnp.asarray(tgt), jnp.asarray(mask),
                items, w_off, H_OFF, JScalerParams(jnp.asarray(bias),
                                                   jnp.asarray(scale)),
                JMetrics.forecasting(), mesh, batch_size=4, support_ops=ops,
                n_nodes=n)(params))
    cfg.update(batch_size=4, variants=EVAL_VARIANTS)
    return {"path": str(path), "config": cfg, "want": wants}


# -- the window step ----------------------------------------------------------

def _window_case(rng, tmp):
    """One JAX sharded window step on 2 ranks (BSR supports, k 2, both
    directions, the global mean; node-level u) and its gradient."""
    n, cin = 10, 2
    g, jg = _graphs(rng, n, 40)
    x = rng.standard_normal((T, n, cin)).astype(np.float32)
    tgt = (rng.standard_normal((T, n, C)) * 3 + 1).astype(np.float32)
    mask = rng.random((T, n, C)) > 0.1
    u = rng.standard_normal((T, n, 1)).astype(np.float32)
    starts, w_off = np.arange(T - 6), np.arange(2)
    scale = np.full((1, 1, C), 2.0, np.float32)
    sup = dict(k=K, bidirectional=True, global_attr=True)
    jops = j_supports(jg, operator_mode="bsr", **sup)
    d_in = cin * (1 + len(jops))
    jm, params, kw, cfg = _sgp_models(n, d_in, 1 + len(jops), 1, tmp,
                                      "window", True)
    world, local_bs = 2, 4
    key = jax.random.PRNGKey(5)
    items = np.stack([np.asarray(jax.random.choice(jax.random.split(
        jax.random.fold_in(jax.random.split(key, 1)[0], s))[0],
        jnp.asarray(starts), (local_bs,))) for s in range(world)])
    path = tmp / "window.npz"
    np.savez(path, x=x, target=tgt, mask=mask, u=u, starts=starts,
             w_off=w_off, h_off=H_OFF, bias=np.zeros_like(scale),
             scale=scale, items=items[:, None], src=g.src, dst=g.dst,
             weight=g.weight, num_nodes=n)
    opt = optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(LR))
    mesh = j_make_mesh(world, 1)
    step = j_window(jm, opt, jnp.asarray(x), jnp.asarray(tgt),
                    jnp.asarray(mask), jnp.asarray(starts),
                    jnp.asarray(w_off), jnp.asarray(H_OFF),
                    JScalerParams(jnp.zeros_like(scale), jnp.asarray(scale)),
                    mesh, u=jnp.asarray(u), support_ops=jops,
                    batch_size=world * local_bs)
    with mesh:
        p1, _, j_loss = step(params, opt.init(params), key)
    union = items.reshape(-1)
    xs = jnp.asarray(x[union[:, None] + w_off])
    xs = jnp.concatenate([xs] + [op @ xs for op in jops], -1)
    steps = union[:, None] + H_OFF[None, :]
    grads = _masked_mae_grads(jm, params, xs, tgt[steps], mask[steps], None,
                              u[union[:, None] + w_off], scale[0, 0])
    cfg.update(lr=LR, grad_clip=CLIP, supports={
        **sup, "operator_mode": "bsr"})
    return {"path": str(path), "config": cfg, "loss": float(j_loss),
            "want": _torch_layout(kw, p1), "grads": _torch_layout(kw, grads)}


# -- Predictor(mesh=) ---------------------------------------------------------

RNN_CASE = {"model": "rnn", "windowing": {"window": 4, "horizon": 2},
            "batch_size": 8, "loader_seed": 3, "lr": 1e-2, "epochs": 2,
            "kw": {"hidden_size": 8, "ff_size": 8}}
GWNET_CASE = {"model": "gwnet", "windowing": {"window": 6, "horizon": 2},
              "batch_size": 8, "lr": 1e-2, "epochs": 1, "seed": 3,
              "kw": {"hidden_size": 8, "ff_size": 8, "n_layers": 2,
                     "emb_size": 4}}


def _jax_mesh_fit(tmp, name, model, ds, items, case, **kw):
    """The JAX ``Predictor(mesh=)`` fit of ``case`` over the 8-device mesh
    and its evaluation on ``items``; the initial weights it drew pickled
    under ``tmp`` for the port (their path returned beside the metrics)."""
    recorded = []
    init = j_predictor.Predictor.init

    def record(self, *a, **k):
        out = init(self, *a, **k)
        recorded.append(jax.tree.map(np.asarray, self.params))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_predictor.Predictor, "init", record)
        pred = JPredictor(model, lr=case["lr"], seed=0,
                          mesh=j_make_mesh(8, 1), **kw)
        pred.fit(JWindowedLoader(ds, items, batch_size=case["batch_size"],
                                 shuffle=True,
                                 seed=case.get("loader_seed", 0)),
                 epochs=case["epochs"], scaler=ds.scaler_params())
    want = pred.evaluate(JWindowedLoader(ds, items,
                                         batch_size=case["batch_size"]))
    init_path = tmp / f"{name}_init.pkl"
    with open(init_path, "wb") as fp:
        pickle.dump(recorded[0], fp)
    return want, str(init_path)


def _predictor_case(rng, tmp):
    """The JAX ``Predictor(mesh=)`` fits of ``RNN_CASE`` and ``GWNET_CASE``
    (20 windows in batches of 8 over the 8-device mesh: a ragged tail of 4
    replicated; GraphWaveNet's batch norm takes the global batch's
    statistics under GSPMD) from the initial weights they record for the
    port, and the port's ``Predictor`` cases: the RNN fit, a batch size 2
    ranks do not divide, GraphWaveNet on 16 nodes with the batch norm's
    statistics summed over the ranks and left rank-local, and GraphWaveNet
    on one process."""
    series = (rng.standard_normal((90, 16, 1)) + 2).astype(np.float32)
    items = np.arange(20)
    g, jg = _graphs(rng, 16, 60)
    path = tmp / "predictor.npz"
    np.savez(path, series=series, items=items, src=g.src, dst=g.dst,
             weight=g.weight, num_nodes=16)
    wants = {}
    for case in (RNN_CASE, GWNET_CASE):
        ds = JDataset(series, windowing=JWindowing(**case["windowing"]))
        ds.fit_scaler(JStandardScaler(axis=(0, 1)))
        if case["model"] == "rnn":
            model, kw = JRNNModel(output_size=1, horizon=2, **case["kw"]), {}
        else:
            model = JGraphWaveNet(output_size=1, horizon=2, n_nodes=16,
                                  **case["kw"])
            kw = {"static_batch": {"supports": j_diff_conv_support(jg)},
                  "batch_to_call": lambda batch, training: (
                      (batch["x"], batch["supports"]),
                      {"training": training,
                       "node_index": batch.get("node_index")})}
        wants[case["model"]] = _jax_mesh_fit(tmp, case["model"], model, ds,
                                             items, case, **kw)
    rnn = {**RNN_CASE, "init": wants["rnn"][1]}
    gwnet = {**GWNET_CASE, "init": wants["gwnet"][1]}
    cases = [rnn, {**rnn, "bad_batch": 7}, gwnet,
             {**gwnet, "local_stats": True}]
    config = {"device": "cpu", "cases": cases}
    single = predictor_worker(0, 1, str(path), {
        "device": "cpu", "mesh": False, "cases": [gwnet]})[0]
    return {"path": str(path), "config": config, "rnn_want": wants["rnn"][0],
            "gwnet_want": wants["gwnet"][0], "gwnet_single": single}


# -- the runners -----------------------------------------------------------

def _baseline_cases(tmp):
    """Each baseline runner with ``--data-sharding batch`` on the JAX mesh,
    its initial weights recorded for the port's ranks."""
    out = {}
    init = j_predictor.Predictor.init
    for name, (mod, flags) in BASELINES.items():
        recorded = []

        def record(self, *a, **k):
            res = init(self, *a, **k)
            recorded.append(jax.tree.map(np.asarray, self.params))
            return res

        argv = BASE_ARGV + flags + ["--data-sharding", "batch"]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_predictor.Predictor, "init", record)
            mp.setattr(jax_config, "logs_dir", str(tmp / "jax"))
            want = JExperiment(mod.run_experiment,
                               j_traffic.configure_parser()).run(argv)
        init_path = tmp / f"{name}_init.pkl"
        with open(init_path, "wb") as fp:
            pickle.dump(recorded[0], fp)
        out[name] = {"argv": argv + ["--device", "cpu"], "want": want,
                     "config": {"runner": name, "init": str(init_path),
                                "logs_dir": str(tmp / "torch")}}
    return out


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Every case's inputs and JAX results, then the port's 2-rank jobs in
    one spawn and the 4-rank stratified step in another."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    strat = {name: _strat_case(rng, tmp, name) for name in STRAT_CASES}
    ev, win = _eval_case(rng, tmp), _window_case(rng, tmp)
    pred = _predictor_case(rng, tmp)
    base = _baseline_cases(tmp)
    logs = {"logs_dir": str(tmp / "torch")}
    jobs = [("stratified_worker", strat["2-dense"]["path"],
             strat["2-dense"]["config"]),
            ("eval_worker", ev["path"], ev["config"]),
            ("window_worker", win["path"], win["config"]),
            ("predictor_worker", pred["path"], pred["config"]),
            ("runner_worker", STRAT_ARGV + ["--data-sharding", "nodes"],
             logs),
            ("runner_worker", SGP_ARGV + ["--data-sharding", "batch"],
             {**logs, "runner": "traffic_sgp"})] + [
        ("runner_worker", b["argv"], b["config"]) for b in base.values()]
    two = run_ranks(jobs_worker, 2, "gloo", "cpu", jobs)
    pad = _pad_case(rng, tmp)
    four = run_ranks(jobs_worker, 4, "gloo", "cpu", [
        ("stratified_worker", strat["4-bsr"]["path"],
         strat["4-bsr"]["config"])] + [
        ("stratified_worker", pad["path"], {**pad["config"], "mode": mode})
        for mode in ("bsr", "dense")])
    by_job = list(zip(*two))     # [job][rank]
    return {"strat": strat, "eval": ev, "window": win, "pred": pred,
            "base": base, "strat_ranks": {"2-dense": by_job[0],
                                          "4-bsr": [r[0] for r in four]},
            "pad_ranks": four[0][1:],
            "eval_ranks": by_job[1], "window_ranks": by_job[2],
            "pred_ranks": by_job[3], "strat_runner": by_job[4],
            "traffic_runner": by_job[5],
            "base_ranks": dict(zip(base, by_job[6:]))}


@pytest.mark.parametrize("case", list(STRAT_CASES))
def test_sharded_stratified_step_matches_jax(dp, case):
    """One clipped Adam step with the global mean: 2 ranks on 13 nodes
    (dense supports, one padding row, global u), 4 ranks on 16 (BSR
    supports, node-level u); every rank's draws JAX's, the times shared."""
    want = dp["strat"][case]
    ranks = dp["strat_ranks"][case]
    losses, state, _ = ranks[0]
    print(f"stratified {case}: loss rel err",
          abs(losses[0] - want["loss"]) / abs(want["loss"]))
    assert abs(losses[0] - want["loss"]) <= TOL * abs(want["loss"])
    _weights_hold(state, want["want"], want["grads"])
    _replicas_equal(ranks)


def test_sharded_stratified_step_pads_nodes_on_bsr(dp):
    """4 ranks on 13 nodes (3 padding rows, drawn), the embedding sized to
    the 13 real nodes: the BSR supports' step equals the dense supports'
    (each held to JAX above) within the tolerances, finite; the padded
    draws count nowhere."""
    (l_bsr, w_bsr, _), (l_dense, w_dense, g_dense) = dp["pad_ranks"]
    assert all(np.isfinite(v).all() for v in w_bsr.values())
    assert abs(l_bsr[0] - l_dense[0]) <= TOL * abs(l_dense[0])
    _weights_hold(w_bsr, w_dense, g_dense)


def test_sharded_eval_with_supports_matches_jax(dp):
    """2 ranks on 13 nodes, per-node scaler parameters: the windows
    propagated on the fly through dense and BSR supports and the global
    mean; every rank's metrics equal."""
    ranks, want = dp["eval_ranks"], dp["eval"]["want"]
    for i, w in enumerate(want):
        assert ranks[0][i] == ranks[1][i]
        for k, v in w.items():
            assert abs(ranks[0][i][k] - float(v)) <= TOL * abs(float(v)), \
                (EVAL_VARIANTS[i], k)


def test_sharded_window_step_matches_jax(dp):
    """One clipped Adam step on 2 ranks, 4 windows each (BSR supports, both
    directions and the mean; node-level u)."""
    want = dp["window"]
    (losses, state), _ = dp["window_ranks"]
    print("window: loss rel err",
          abs(losses[0] - want["loss"]) / abs(want["loss"]))
    assert abs(losses[0] - want["loss"]) <= TOL * abs(want["loss"])
    _weights_hold(state, want["want"], want["grads"])
    _replicas_equal(dp["window_ranks"])


def test_predictor_mesh_matches_jax_with_a_ragged_tail(dp):
    """``Predictor(mesh=)`` over 2 ranks against the JAX one over 8 devices
    on the carried weights: 2 epochs of 20 windows in batches of 8 (the
    tail of 4 runs whole on every rank) and ``evaluate`` (its tail on rank
    0); both ranks end with the same metrics and weights. A loader batch
    size the ranks do not divide raises."""
    ranks, want = dp["pred_ranks"], dp["pred"]["rnn_want"]
    (got, w0), (got1, w1) = ranks[0][0], ranks[1][0]
    assert got == got1
    for name in w0:
        np.testing.assert_array_equal(w0[name], w1[name])
    print("predictor rnn: metrics max rel err", max(
        abs(got[k] - float(v)) / abs(float(v)) for k, v in want.items()))
    for k, v in want.items():
        assert abs(got[k] - float(v)) <= TOL * abs(float(v)), k
    assert "divisible" in ranks[0][1] and "divisible" in ranks[1][1]


def test_predictor_mesh_sums_batch_norm_statistics(dp):
    """GraphWaveNet (``Norm("batch")``) over 2 ranks: with the count, sums
    and squared deviations summed over the ranks the fit and ``evaluate``
    give the one-process run's metrics; left rank-local they do not."""
    ranks, single = dp["pred_ranks"], dp["pred"]["gwnet_single"][0]
    synced, local = ranks[0][2][0], ranks[0][3][0]
    print("gwnet: synced / rank-local metrics max rel err", [max(
        abs(m[k] - v) / abs(v) for k, v in single.items())
        for m in (synced, local)])
    assert synced == ranks[1][2][0]
    for k, v in single.items():
        assert abs(synced[k] - v) <= TOL * abs(v), k
    assert max(abs(local[k] - v) / abs(v) for k, v in single.items()) \
        > 100 * TOL


def test_predictor_mesh_gwnet_matches_jax(dp):
    """GraphWaveNet (``Norm("batch")``) through ``Predictor(mesh=)`` over 2
    ranks against the JAX one over 8 devices, whose GSPMD batch norm takes
    the global batch's statistics, on the carried weights: one epoch of 20
    windows in batches of 8 (the tail of 4 split over the ranks here,
    replicated there) and ``evaluate``, the metrics within 1e-5
    relative; both ranks' weights bit for bit."""
    ranks, want = dp["pred_ranks"], dp["pred"]["gwnet_want"]
    (got, w0), (_, w1) = ranks[0][2], ranks[1][2]
    print("predictor gwnet: metrics max rel err vs JAX", max(
        abs(got[k] - float(v)) / abs(float(v)) for k, v in want.items()))
    for k, v in want.items():
        assert abs(got[k] - float(v)) <= TOL * abs(float(v)), k
    for name in w0:
        np.testing.assert_array_equal(w0[name], w1[name])


@pytest.mark.parametrize("name", list(BASELINES))
def test_baseline_runner_batch_sharded_matches_jax(dp, name):
    """``--data-sharding batch`` on 2 ranks against the JAX runner on the
    8-device mesh from the same initial weights (GatedGN, ELL; the
    large-scale runner on subgraph batches): the test metrics within 1e-5,
    both ranks' results and weights equal."""
    want = dp["base"][name]["want"]
    (r0, w0), (r1, w1) = dp["base_ranks"][name]
    print(f"{name}: test metrics max rel err", max(
        abs(r0[k] - want[k]) / abs(want[k]) for k in METRICS))
    assert r0 == r1
    for k in METRICS:
        assert abs(r0[k] - want[k]) <= TOL * abs(want[k]), k
    for k in w0:
        np.testing.assert_array_equal(w0[k], w1[k])


@pytest.mark.parametrize("job", ["strat_runner", "traffic_runner"])
def test_sgp_runners_sharded_keep_replicas_equal(dp, job):
    """``run_largescale_sgp --iid-stratified true --data-sharding nodes``
    and ``run_traffic_sgp --data-sharding batch`` on 2 ranks: finite test
    metrics, the same on both ranks, the same final weights."""
    (r0, w0), (r1, w1) = dp[job]
    for k in METRICS:
        assert r0[k] == r1[k] and np.isfinite(r0[k]), k
    for k in w0:
        np.testing.assert_array_equal(w0[k], w1[k])


def test_traffic_runner_sharded_stops_early_on_rank0s_metric(tmp_path):
    """``run_traffic_sgp --data-sharding batch`` on 2 ranks with patience
    0, rank 1's validation MAE made to fall every epoch: both ranks stop
    at the epoch rank 0's metric stops at and end with the same weights
    and test metrics (a rank deciding on its own value would run on into
    a collective the other rank has left: its own spawn, so that hang
    ends at the spawn's time limit)."""
    (r0, w0, stops0), (r1, w1, stops1) = run_ranks(
        runner_worker, 2, "gloo", "cpu",
        EARLY_STOP_ARGV + ["--data-sharding", "batch"],
        {"logs_dir": str(tmp_path), "runner": "traffic_sgp",
         "skew_val_rank": 1}, timeout=120)
    assert stops0 and stops0 == stops1, (stops0, stops1)
    assert r0 == r1
    for k in w0:
        np.testing.assert_array_equal(w0[k], w1[k])


# -- one rank, in this process ----------------------------------------------

def test_stratified_step_on_one_rank_equals_unsharded(rng):
    """At one rank the sharded stratified step draws what
    ``make_fused_iid_stratified_step`` draws from the same generator and
    takes the same steps, bit for bit (BSR supports, global mean, node
    level u)."""
    n = 13
    g, _ = _graphs(rng, n)
    h, tgt, mask, u, valid = _strat_problem(rng, n, "node")
    h, tgt, mask, u = (torch.as_tensor(a) for a in (h, tgt, mask, u))
    ops = build_support_operators(g, k=K, operator_mode="bsr", device="cpu")
    scaler = ScalerParams(torch.zeros(1, 1, C), torch.full((1, 1, C), 2.0))
    kw = dict(input_size=HT * (2 + len(ops)), order=2 + len(ops),
              n_nodes=n, hidden_size=12, mlp_size=8, output_size=C,
              n_layers=2, horizon=len(H_OFF), exog_size=2)
    runs = []
    for sharded in (False, True):
        model = SGPModel(**kw, generator=torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        common = dict(global_attr=True, u=u, times_per_batch=TB,
                      nodes_per_time=4, steps_per_call=3, grad_clip=CLIP)
        step = make_sharded_iid_stratified_step(
            model, opt, h, tgt, mask, valid, H_OFF, scaler, ops,
            make_mesh(1, 1), seed=5, **common) if sharded else \
            make_fused_iid_stratified_step(model, opt, h, tgt, mask, valid,
                                           H_OFF, scaler, ops, **common)
        gen = torch.Generator().manual_seed(5)
        runs.append(([float(step(gen)) for _ in range(2)],
                     [p.detach().clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_window_step_on_one_rank_equals_unsharded(rng):
    """At one rank the sharded window step is ``make_fused_window_step``
    bit for bit, draws and steps (dense supports, a scheduler)."""
    n, cin = 10, 2
    g, _ = _graphs(rng, n, 40)
    x = torch.as_tensor(rng.standard_normal((T, n, cin)).astype(np.float32))
    tgt = torch.as_tensor(rng.standard_normal((T, n, C)).astype(np.float32))
    mask = torch.as_tensor(rng.random((T, n, C)) > 0.1)
    ops = build_support_operators(g, k=K, device="cpu")
    scaler = ScalerParams(torch.zeros(1), torch.ones(1))
    runs = []
    for sharded in (False, True):
        model = SGPModel(input_size=cin * (1 + len(ops)), order=1 + len(ops),
                         n_nodes=n, hidden_size=12, mlp_size=8,
                         output_size=C, n_layers=1, horizon=len(H_OFF),
                         generator=torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        sched = torch.optim.lr_scheduler.StepLR(opt, 2, 0.5)
        args = (model, opt, x, tgt, mask, np.arange(T - 6), np.arange(2),
                H_OFF, scaler)
        common = dict(support_ops=ops, batch_size=8, steps_per_call=3,
                      scheduler=sched)
        step = make_sharded_window_step(*args, make_mesh(1, 1), **common) \
            if sharded else make_fused_window_step(*args, **common)
        gen = torch.Generator().manual_seed(2)
        runs.append(([float(step(gen)) for _ in range(2)],
                     [p.detach().clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sharded_eval_with_supports_on_one_rank_equals_fused(rng):
    """At one rank the node-sharded eval with ``support_ops`` (BSR and the
    global mean, bf16 windows, node-level u) gives ``make_fused_eval``'s
    metrics bit for bit."""
    from sgp_tpu_torch.ops import GlobalMeanOperator
    n = 13
    g, _ = _graphs(rng, n)
    h, tgt, mask, u, valid = _strat_problem(rng, n, "node")
    h = torch.as_tensor(h).to(torch.bfloat16)
    tgt, mask, u = (torch.as_tensor(a) for a in (tgt, mask, u))
    ops = build_support_operators(g, k=K, operator_mode="bsr",
                                  device="cpu") + [GlobalMeanOperator(n)]
    scaler = ScalerParams(torch.zeros(1, n, C), torch.full((1, n, C), 2.0))
    model = SGPModel(input_size=HT * (1 + len(ops)), order=1 + len(ops),
                     n_nodes=n, hidden_size=12, mlp_size=8, output_size=C,
                     n_layers=1, horizon=len(H_OFF), exog_size=2,
                     generator=torch.Generator().manual_seed(0))
    args = (h, tgt, mask, valid[::2], np.array([0]), H_OFF, scaler,
            MaskedMetrics.forecasting())
    want = make_fused_eval(model, *args, u=u, support_ops=ops,
                           batch_size=4)()
    mesh = make_mesh(1, 1)
    got = make_sharded_iid_eval(model, *args, mesh, u=u, batch_size=4,
                                support_ops=ops, n_nodes=n)()
    assert got == want


def _strat_runner(argv):
    return Experiment(t_large_sgp.run_experiment,
                      t_large_sgp.configure_parser_largescale()).run(argv)


@pytest.mark.parametrize("runner,argv,flag", [
    ("largescale_sgp", STRAT_ARGV, "nodes"),
    ("traffic_sgp", SGP_ARGV, "batch"),
    ("traffic_baselines", BASE_ARGV + ["--adj-knn", "4", "--device",
                                       "cpu"], "batch")],
    ids=["stratified-nodes", "traffic-sgp-batch", "traffic-baselines-batch"])
def test_sharded_runner_on_one_rank_equals_unsharded(monkeypatch, tmp_path,
                                                     runner, argv, flag):
    """``--data-sharding`` on one rank (no process group): the same draws,
    steps and test metrics as the unsharded runner, bit for bit."""
    monkeypatch.setitem(torch_config, "logs_dir", str(tmp_path))
    mod, parser = {
        "largescale_sgp": (t_large_sgp,
                           t_large_sgp.configure_parser_largescale),
        "traffic_sgp": (t_traffic_sgp, t_traffic_sgp.configure_parser),
        "traffic_baselines": (t_traffic, t_traffic.configure_parser)}[runner]
    base = Experiment(mod.run_experiment, parser()).run(list(argv))
    got = Experiment(mod.run_experiment, parser()).run(
        list(argv) + ["--data-sharding", flag])
    for k in METRICS:
        assert got[k] == base[k], k


def test_shard_nodes_of_one_rank_is_the_array():
    """One rank's slab is the whole array (no padding): the sharded paths
    at one rank see the unsharded arrays."""
    a = torch.arange(12.).reshape(2, 6, 1)
    np.testing.assert_array_equal(
        shard_nodes(a, make_mesh(1, 1), "data", node_axis=1).numpy(),
        a.numpy())
