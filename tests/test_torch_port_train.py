"""The port's training machinery against the JAX package's: the data
modules bit-exact (numpy on both sides), the masked metrics, one
``Predictor`` train step of the GatedGN slice and ``evaluate``.

The train step runs on the ELL table (the 100-nn slice) and on the dense
all-pairs mask of the dataset's similarity thresholded at the PV-US
full-graph density, 14.75% (the full-graph slice), with and without band
windows; and on subgraph batches (``SubgraphLoader``), where the loss and
``evaluate`` read the roots (``target_nodes``) only. Then
``predict_loader``, ``save``/``load`` and ``fit``'s metric stream.

Tolerances: metrics 1e-6 relative (the same f32 sums); the train step's
loss and gradients 1e-5 relative to each tensor's largest value (f32, other
summation orders through the model); the parameters after clip and Adam at
atol 1e-6 on the elements whose gradient exceeds 1e-6 in magnitude (Adam's
first step is about lr * sign(g), so a gradient near zero may change sign
between summation orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sgp_tpu.data import SpatioTemporalDataset as JDataset
from sgp_tpu.data import StandardScaler as JStandardScaler
from sgp_tpu.data import WindowedLoader as JLoader
from sgp_tpu.data import Windowing as JWindowing
from sgp_tpu.data.datasets import SyntheticDiffusion as JSynthetic
from sgp_tpu.data.splitters import TemporalSplitter as JSplitter
from sgp_tpu.graph.sparse import Graph as JGraph
from sgp_tpu.graph.sparse import padded_incoming as j_padded_incoming
from sgp_tpu.models import graph_layers as j_graph_layers
from sgp_tpu.models.gated_gn import GatedGraphNetworkMLPModel as JModel
from sgp_tpu.train import MaskedMetrics as JMetrics
from sgp_tpu.train import Predictor as JPredictor
from sgp_tpu.data.scalers import ScalerParams as JScalerParams
from sgp_tpu.models import SGPModel as JSGPModel
from sgp_tpu.ops.spmm import dense_adj_mask as j_dense_adj_mask
from sgp_tpu.train import metrics as jmetrics

from sgp_tpu_torch.data import (SpatioTemporalDataset, StandardScaler,
                                TemporalSplitter, WindowedLoader, Windowing)
from sgp_tpu_torch.data.datasets import SyntheticDiffusion
from sgp_tpu_torch.graph import band_windows, padded_incoming
from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.models import (GatedGraphNetworkMLPModel, SGPModel,
                                  flax_to_torch)
from sgp_tpu_torch.models.bridge import _gated_gn_targets, targets
from sgp_tpu_torch.ops import dense_adj_mask
from sgp_tpu_torch.train import MaskedMetrics, Predictor
from sgp_tpu_torch.train import metrics as tmetrics
from sgp_tpu_torch.train.predictor import clip_by_global_norm_

torch.set_num_threads(1)

N_NODES, N_STEPS, KNN = 24, 240, 5
WIN = dict(window=12, horizon=8, horizon_lag=3)


def _pipeline(jax_side: bool):
    """The runner's data path: dataset, k-nn graph, day encoding, split,
    scaler fitted on the train windows' start steps."""
    mods = (JSynthetic, JDataset, JWindowing, JSplitter, JStandardScaler) \
        if jax_side else (SyntheticDiffusion, SpatioTemporalDataset,
                          Windowing, TemporalSplitter, StandardScaler)
    synth, dset, win, splitter, scaler = mods
    raw = synth(num_nodes=N_NODES, num_steps=N_STEPS, seed=0)
    graph = raw.get_connectivity(knn=KNN, threshold=None, include_self=False)
    ds = dset(raw.target, index=raw.index, mask=raw.mask, graph=graph,
              covariates={"u": raw.datetime_encoded("day")},
              windowing=win(**WIN))
    split = splitter(0.1, 0.2).split(ds)
    ds.fit_scaler(scaler(axis=(0, 1)), step_index=ds.indices()[split.train])
    return ds, graph, split


@pytest.fixture(scope="module")
def pipelines():
    return _pipeline(True), _pipeline(False)


def test_data_pipeline_bit_exact(pipelines):
    (jds, jg, jsplit), (tds, tg, tsplit) = pipelines
    for name in ("train", "val", "test"):
        assert np.array_equal(getattr(jsplit, name), getattr(tsplit, name))
    assert repr(jsplit) == repr(tsplit)
    jsc, tsc = jds.scalers["target"], tds.scalers["target"]
    assert np.array_equal(jsc.bias, tsc.bias)
    assert np.array_equal(jsc.scale, tsc.scale)
    assert np.array_equal(jds.input_array(), tds.input_array())
    assert np.array_equal(jds.exog_array(), tds.exog_array())
    assert len(jds) == len(tds)
    si, nm = padded_incoming(tg)
    jsi, jnm = j_padded_incoming(jg)
    assert np.array_equal(si, jsi) and np.array_equal(nm, jnm)
    assert si.shape == (N_NODES, KNN) and nm.all()
    jl = JLoader(jds, jsplit.train, batch_size=5, shuffle=True,
                 limit_batches=4, seed=3)
    tl = WindowedLoader(tds, tsplit.train, batch_size=5, shuffle=True,
                        limit_batches=4, seed=3)
    assert len(jl) == len(tl) == 4
    for _ in range(2):                     # two passes, two permutations
        for jb, tb in zip(jl, tl):
            assert set(jb) == set(tb) == {"x", "y", "mask", "u",
                                          "u_horizon"}
            for k in jb:
                assert jb[k].dtype == tb[k].dtype, k
                assert np.array_equal(jb[k], tb[k]), k
    nodes = np.array([3, 0, 7])
    jb, tb = jds.gather_batch(np.array([4, 9]), nodes), \
        tds.gather_batch(np.array([4, 9]), nodes)
    for k in jb:
        assert np.array_equal(np.asarray(jb[k]), tb[k]), k
    assert tb.x.shape == (2, 12, 3, 1)


def test_masked_metrics_match_jax():
    rng = np.random.default_rng(0)
    y_hat = rng.standard_normal((4, 3, 10, 1)).astype(np.float32)
    y = (rng.standard_normal((4, 3, 10, 1)) + 3).astype(np.float32)
    mask = rng.random((4, 3, 10, 1)) > 0.2
    th, ty, tm = (torch.as_tensor(a) for a in (y_hat, y, mask))
    for name in ("masked_mae", "masked_mse", "masked_rmse", "masked_mape",
                 "masked_mre"):
        for m_np, m_t in ((mask, tm), (None, None)):
            want = getattr(jmetrics, name)(y_hat, y, m_np)
            got = getattr(tmetrics, name)(th, ty, m_t)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       err_msg=name)
    jm = JMetrics.forecasting({"15": 0, "45": 2})
    jm.specs["mre"] = jmetrics.MetricSpec("mre")
    tmm = MaskedMetrics.forecasting({"15": 0, "45": 2})
    tmm.specs["mre"] = tmetrics.MetricSpec("mre")
    js, ts = jm.init(), tmm.init()
    for i in range(2):
        js = jm.update(js, y_hat[2 * i:2 * i + 2], y[2 * i:2 * i + 2],
                       mask[2 * i:2 * i + 2])
        ts = tmm.update(ts, th[2 * i:2 * i + 2], ty[2 * i:2 * i + 2],
                        tm[2 * i:2 * i + 2])
    want, got = jm.compute(js), tmm.compute(ts)
    assert set(want) == set(got) == {"mae", "mse", "mape", "mae_at_15",
                                     "mae_at_45", "mre"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("max_norm", [5.0, 0.05])
def test_clip_by_global_norm_is_optax(max_norm):
    rng = np.random.default_rng(1)
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in gs], optax.EmptyState())
    got = [torch.as_tensor(g.copy()) for g in gs]
    clip_by_global_norm_(got, max_norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_lr_schedule_is_optax_piecewise_constant():
    sched = optax.piecewise_constant_schedule(1e-3, {4: 0.25, 8: 0.25})
    model = torch.nn.Linear(2, 1)
    pred = Predictor(model, lr=1e-3, lr_milestones=[2, 4], lr_gamma=0.25,
                     steps_per_epoch=2, device="cpu").init(
        None, StandardScaler().params())
    for t in range(11):
        np.testing.assert_allclose(pred.optimizer.param_groups[0]["lr"],
                                   float(sched(t)), rtol=1e-6)
        pred.optimizer.step()
        pred.scheduler.step()


@pytest.mark.parametrize("milestones,steps_per_epoch", [
    ([2, 2.5, 4], 1),      # 2 and 2.5 both land on step 2
    ([1, 1.2], 3),         # 3 and 3.6 both land on step 3
    ([3, 1, 3, 0.5], 2),   # repeated and unsorted milestones
])
def test_lr_schedule_colliding_milestones_apply_gamma_once(
        milestones, steps_per_epoch):
    # the reference's schedule, built as sgp_tpu/train/predictor.py builds it
    sched = optax.piecewise_constant_schedule(
        1e-3, {int(m * steps_per_epoch): 0.25 for m in milestones})
    pred = Predictor(torch.nn.Linear(2, 1), lr=1e-3, lr_milestones=milestones,
                     lr_gamma=0.25, steps_per_epoch=steps_per_epoch,
                     device="cpu").init(None, StandardScaler().params())
    for t in range(12):
        np.testing.assert_allclose(pred.optimizer.param_groups[0]["lr"],
                                   float(sched(t)), rtol=1e-6)
        pred.optimizer.step()
        pred.scheduler.step()


def _slice_models(n_nodes):
    common = dict(input_window_size=WIN["window"], hidden_size=16,
                  output_size=1, horizon=3, n_nodes=n_nodes, enc_layers=2,
                  gnn_layers=2, positional_encoding=True, activation="silu")
    return JModel(**common), GatedGraphNetworkMLPModel(input_size=3,
                                                       **common)


def _to_call(batch, training):
    return (batch["x"],), {"u": batch.get("u"), "training": training,
                           "neigh": batch["gn_neigh"]}


def _all_pairs_call(band):
    """The runners' call on the dense mask, with the window table."""
    def to_call(batch, training):
        return (batch["x"],), {"u": batch.get("u"), "training": training,
                               "adj": batch["gn_adj"], "adj_band": band}
    return to_call


def _full_graph():
    """The pipeline's similarity thresholded at the PV-US full-graph
    density (14.75%), as in ``chip_smoke.py`` phase 7."""
    raw = SyntheticDiffusion(num_nodes=N_NODES, num_steps=N_STEPS, seed=0)
    thr = float(np.quantile(raw.get_similarity(), 1 - 0.1475))
    return raw.get_connectivity(threshold=thr, include_self=False)


def _predictors(pipelines, grad_clip, layout="ell"):
    """The JAX and port trainers, weights carried across; ``layout`` "ell"
    (the k-nn ELL table), "dense" or "band" (the full graph's mask, without
    or with windows)."""
    (jds, jg, jsplit), (tds, tg, tsplit) = pipelines
    jm, tm = _slice_models(N_NODES)
    batch = jds.gather_batch(jsplit.train[:5])
    if layout == "ell":
        to_call = _to_call
        j_static = {"gn_neigh": j_padded_incoming(jg)}
        t_static = {"gn_neigh": padded_incoming(tg)}
    else:
        g = _full_graph()
        band = None if layout == "dense" else band_windows(
            g.to_dense(), block=8, width_mult=8, uniform=False)
        to_call = _all_pairs_call(band)
        j_static = {"gn_adj": j_dense_adj_mask(
            JGraph(g.src, g.dst, g.weight, g.num_nodes))}
        t_static = {"gn_adj": dense_adj_mask(g, device="cpu")}
    jpred = JPredictor(jm, lr=1e-3, grad_clip=grad_clip,
                       batch_to_call=to_call, seed=0, static_batch=j_static)
    jpred.init(batch, jds.scaler_params())
    tpred = Predictor(tm, lr=1e-3, grad_clip=grad_clip,
                      batch_to_call=to_call, seed=0, static_batch=t_static,
                      device="cpu")
    tpred.init(batch, tds.scaler_params())
    flax_to_torch(jax.tree.map(np.asarray, jpred.params), tm)
    return jpred, tpred, batch, to_call


def _rel_close(got, want, tol, name):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (name, err)


@pytest.mark.parametrize("grad_clip,layout,kernel", [
    (5.0, "ell", "ELL_PALLAS"), (0.05, "ell", "ELL_PALLAS"),
    (5.0, "dense", "ALLPAIRS_PALLAS"), (5.0, "dense", None),
    (0.05, "band", None)],
    ids=["5.0", "0.05", "dense-pallas", "dense-xla", "band-xla"])
def test_predictor_train_step_matches_jax(pipelines, grad_clip, layout,
                                          kernel):
    """One step against the JAX trainer; ``kernel`` names the JAX layer's
    Pallas switch set for it (interpreted), None its blocked XLA math."""
    jpred, tpred, batch, to_call = _predictors(pipelines, grad_clip, layout)
    jdev = {**jpred.static_batch, **{k: jnp.asarray(v)
                                     for k, v in batch.items()}}
    sc = pipelines[0][0].scaler_params()

    def loss_j(params):
        out = jpred.model.apply(params, *to_call(jdev, True)[0],
                                **to_call(jdev, True)[1])
        v, n = jmetrics._masked_reduce(jmetrics._abs_err,
                                       sc.inverse_transform(out),
                                       jdev["y"], jdev["mask"])
        return v / jnp.maximum(n, 1.0)

    if kernel is not None:
        setattr(j_graph_layers, kernel, True)
    try:
        jgrads = jax.grad(loss_j)(jpred.params)
        new_params, _, jloss = jpred._train_step(
            jpred.params, jpred.opt_state, jdev, jax.random.PRNGKey(0))
    finally:
        if kernel is not None:
            setattr(j_graph_layers, kernel, None)

    targets = _gated_gn_targets(tpred.model)
    loss = tpred.compute_loss(tpred._place(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    flat_g = jax.tree.map(np.asarray, jgrads)["params"]
    grads = {}
    for path, (param, transpose) in targets.items():
        want = flat_g
        for k in path:
            want = want[k]
        want = want.T if transpose else want
        _rel_close(param.grad.numpy(), want, 1e-5, "/".join(path))
        grads[path] = want

    tloss = tpred.train_step(batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    flat_p = jax.tree.map(np.asarray, new_params)["params"]
    for path, (param, transpose) in targets.items():
        want = flat_p
        for k in path:
            want = want[k]
        want = want.T if transpose else want
        keep = np.abs(grads[path]) > 1e-6
        np.testing.assert_allclose(param.detach().numpy()[keep], want[keep],
                                   rtol=0, atol=1e-6,
                                   err_msg="/".join(path))


SGP_N, SGP_D, SGP_H = 9, 24, 3


def _sgp_batch(rng, iid: bool):
    """A full-graph batch ``x [b 1 n f]``, or an IID one of per-(time,
    node) samples ``x [b 1 f]`` with ``node_index [b]``."""
    b = 6
    nodes = () if iid else (SGP_N,)
    batch = {"x": rng.standard_normal((b, 1) + nodes + (SGP_D,)),
             "y": rng.standard_normal((b, SGP_H) + nodes + (1,)) * 3 + 2,
             "mask": rng.random((b, SGP_H) + nodes + (1,)) > 0.2}
    if iid:
        batch["node_index"] = rng.integers(0, SGP_N, b)
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in batch.items()}


@pytest.mark.parametrize("iid", [False, True], ids=["full-graph", "iid"])
def test_predictor_trains_sgp_model_like_jax(rng, iid):
    """One ``Predictor.train_step`` of ``SGPModel`` through the default
    call adapter (``iid=True`` for a 1-D node_index), against the JAX
    trainer on the same flax weights: the loss, the clipped gradients and
    the parameters after Adam, at the tolerances of the GatedGN step."""
    kw = dict(input_size=SGP_D, order=4, n_nodes=SGP_N, hidden_size=14,
              mlp_size=8, output_size=1, n_layers=2, horizon=SGP_H,
              resnet=True)
    batch = _sgp_batch(rng, iid)
    clip = 0.05
    jpred = JPredictor(JSGPModel(**kw), lr=1e-3, grad_clip=clip, seed=0)
    jpred.init(batch, JScalerParams(jnp.full((1,), 2.0), jnp.full((1,), 3.0)))
    tpred = Predictor(SGPModel(**kw), lr=1e-3, grad_clip=clip, seed=0,
                      device="cpu")
    tpred.init(batch, ScalerParams(torch.full((1,), 2.0),
                                   torch.full((1,), 3.0)))
    flax_to_torch(jax.tree.map(np.asarray, jpred.params), tpred.model)
    jdev = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_j(params):
        args, kwargs = jpred.batch_to_call(jdev, True)
        out = jpred.model.apply(params, *args, **kwargs)
        v, n = jmetrics._masked_reduce(jmetrics._abs_err,
                                       out * 3.0 + 2.0, jdev["y"],
                                       jdev["mask"])
        return v / jnp.maximum(n, 1.0)

    clipped, _ = optax.clip_by_global_norm(clip).update(
        jax.grad(loss_j)(jpred.params), optax.EmptyState())
    new_params, _, jloss = jpred._train_step(
        jpred.params, jpred.opt_state, jdev, jax.random.PRNGKey(0))
    tloss = tpred.train_step(batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    flat_g = jax.tree.map(np.asarray, clipped)["params"]
    flat_p = jax.tree.map(np.asarray, new_params)["params"]
    for path, (param, transpose) in targets(tpred.model).items():
        want_g, want_p = flat_g, flat_p
        for k in path:
            want_g, want_p = want_g[k], want_p[k]
        if transpose:
            want_g, want_p = want_g.T, want_p.T
        _rel_close(param.grad.numpy(), want_g, 1e-5, "/".join(path))
        keep = np.abs(want_g) > 1e-6
        np.testing.assert_allclose(param.detach().numpy()[keep],
                                   want_p[keep], rtol=0, atol=1e-6,
                                   err_msg="/".join(path))


def test_predictor_evaluate_matches_jax(pipelines):
    jpred, tpred, _, _ = _predictors(pipelines, 5.0)
    (jds, _, jsplit), (tds, _, tsplit) = pipelines
    j_graph_layers.ELL_PALLAS = True
    try:
        want = jpred.evaluate(JLoader(jds, jsplit.test, batch_size=8,
                                      limit_batches=2), prefix="test_")
    finally:
        j_graph_layers.ELL_PALLAS = None
    got = tpred.evaluate(WindowedLoader(tds, tsplit.test, batch_size=8,
                                        limit_batches=2), prefix="test_")
    assert set(got) == set(want) == {"test_mae", "test_mse", "test_mape"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    pred = tpred.predict(WindowedLoader(tds, tsplit.test[:3], batch_size=2))
    assert pred.shape == (3, 3, N_NODES, 1) and np.isfinite(pred).all()


def test_fit_restores_a_copy_of_the_best_epoch(pipelines, monkeypatch):
    """Parameters are updated in place, so fit must keep a copy: epoch 0
    has the best val score and its weights come back."""
    _, tpred, _, _ = _predictors(pipelines, 5.0)
    (_, _, _), (tds, _, tsplit) = pipelines
    loader = WindowedLoader(tds, tsplit.train, batch_size=5, shuffle=True,
                            limit_batches=1)
    scores = iter([1.0, 2.0, 3.0])
    monkeypatch.setattr(tpred, "evaluate",
                        lambda *a, **k: {"val_mae": next(scores)})
    after_epoch = []
    train_epoch = tpred.train_epoch

    def record(ld):
        out = train_epoch(ld)
        after_epoch.append(tpred._state_copy())
        return out

    monkeypatch.setattr(tpred, "train_epoch", record)
    best = tpred.fit(loader, val_loader=loader, epochs=3)
    assert best == 1.0
    final = tpred.model.state_dict()
    assert all(torch.equal(final[k], after_epoch[0][k]) for k in final)
    assert not all(torch.equal(final[k], after_epoch[2][k]) for k in final)


def _edge_call(batch, training):
    """The large-scale runner's call on a subgraph batch."""
    return (batch["x"],), {"u": batch.get("u"), "training": training,
                           "node_index": batch.get("node_index"),
                           "src": batch["sub_src"], "dst": batch["sub_dst"],
                           "edge_mask": batch["sub_weight"] != 0}


def _subgraph_predictors(pipelines, grad_clip):
    """The JAX and port trainers on subgraph batches (6 roots of the 24
    nodes, k 1, padded to 12 nodes and 80 edges), weights carried across;
    and the two loaders."""
    from sgp_tpu.data.subgraph import SubgraphLoader as JSubgraphLoader
    from sgp_tpu_torch.data import SubgraphLoader
    (jds, _, jsplit), (tds, _, tsplit) = pipelines
    kw = dict(batch_size=5, num_roots=6, k=1, max_edges=80, pad_nodes=12,
              limit_batches=2, seed=4)
    jl, tl = JSubgraphLoader(jds, jsplit.train, **kw), \
        SubgraphLoader(tds, tsplit.train, **kw)
    jm, tm = _slice_models(N_NODES)
    jpred = JPredictor(jm, lr=1e-3, grad_clip=grad_clip,
                       batch_to_call=_edge_call, seed=0)
    jpred.init(next(iter(JSubgraphLoader(jds, jsplit.train, **kw))),
               jds.scaler_params())
    tpred = Predictor(tm, lr=1e-3, grad_clip=grad_clip,
                      batch_to_call=_edge_call, seed=0, device="cpu")
    tpred.init(None, tds.scaler_params())
    flax_to_torch(jax.tree.map(np.asarray, jpred.params), tm)
    return jpred, tpred, jl, tl


@pytest.mark.parametrize("grad_clip", [5.0, 0.05])
def test_root_only_loss_matches_jax(pipelines, grad_clip):
    """One train step on a subgraph batch: the loss reads the roots
    (``target_nodes``) only, as the JAX trainer's ``slice_targets`` does.
    The loss and gradients at 1e-5 relative to each tensor's largest, the
    parameters after clip and Adam at atol 1e-6 where the gradient exceeds
    1e-6; and the loss over every node differs."""
    jpred, tpred, jl, tl = _subgraph_predictors(pipelines, grad_clip)
    jb, tb = next(iter(jl)), next(iter(tl))
    assert np.array_equal(jb["target_nodes"], tb["target_nodes"])
    assert len(tb["target_nodes"]) == 6 < tb["x"].shape[2]
    jdev = {k: jnp.asarray(v) for k, v in jb.items()}
    sc = pipelines[0][0].scaler_params()

    def loss_j(params):
        args, kwargs = _edge_call(jdev, True)
        out = jpred.model.apply(params, *args, **kwargs)
        tn = jdev["target_nodes"]
        v, n = jmetrics._masked_reduce(
            jmetrics._abs_err, sc.inverse_transform(out)[..., tn, :],
            jdev["y"][..., tn, :], jdev["mask"][..., tn, :])
        return v / jnp.maximum(n, 1.0)

    loss_j, grad_j = jax.jit(loss_j), jax.jit(jax.grad(loss_j))
    clipped, _ = optax.clip_by_global_norm(grad_clip).update(
        grad_j(jpred.params), optax.EmptyState())
    new_params, _, jloss = jpred._train_step(
        jpred.params, jpred.opt_state, jdev, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(loss_j(jpred.params)), float(jloss),
                               rtol=1e-6)
    every_node = tpred.compute_loss(tpred._place(
        {k: v for k, v in tb.items() if k != "target_nodes"})).detach()
    assert abs(float(every_node) - float(jloss)) > 1e-3 * float(jloss)
    tloss = tpred.train_step(tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    flat_g = jax.tree.map(np.asarray, clipped)["params"]
    flat_p = jax.tree.map(np.asarray, new_params)["params"]
    for path, (param, transpose) in _gated_gn_targets(tpred.model).items():
        want_g, want_p = flat_g, flat_p
        for k in path:
            want_g, want_p = want_g[k], want_p[k]
        if transpose:
            want_g, want_p = want_g.T, want_p.T
        _rel_close(param.grad.numpy(), want_g, 1e-5, "/".join(path))
        keep = np.abs(want_g) > 1e-6
        np.testing.assert_allclose(param.detach().numpy()[keep],
                                   want_p[keep], rtol=0, atol=1e-6,
                                   err_msg="/".join(path))


def test_evaluate_on_roots_matches_jax(pipelines):
    """``evaluate`` on subgraph batches reads the roots only (1e-5
    relative); ``predict_loader`` gives JAX's ``(y, y_hat, mask)`` over
    every node of each batch."""
    jpred, tpred, jl, tl = _subgraph_predictors(pipelines, 5.0)
    want = jpred.evaluate(jl, prefix="test_")
    got = tpred.evaluate(tl, prefix="test_")
    assert set(got) == set(want) == {"test_mae", "test_mse", "test_mape"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    (jy, jyh, jmask), (ty, tyh, tmask) = jpred.predict_loader(jl), \
        tpred.predict_loader(tl)
    assert np.array_equal(jy, ty) and np.array_equal(jmask, tmask)
    np.testing.assert_allclose(tyh, jyh, rtol=1e-5, atol=1e-4)
    assert tyh.shape == (10, 3, 12, 1)
    all_nodes = tpred.evaluate(
        [{k: v for k, v in b.items() if k != "target_nodes"} for b in tl],
        prefix="test_")
    assert abs(all_nodes["test_mae"] - got["test_mae"]) > \
        1e-3 * got["test_mae"]


def test_save_load_and_metric_stream(pipelines, tmp_path):
    """``save`` writes the weights as a state_dict that ``load`` brings
    back; ``fit(logdir=)`` appends one ``metrics.jsonl`` record an epoch,
    as the JAX trainer's run logger does."""
    import json
    _, tpred, _, tl = _subgraph_predictors(pipelines, 5.0)
    tpred.fit(tl, None, epochs=2, logdir=str(tmp_path))
    path = str(tmp_path / "w" / "best.pt")
    tpred.save(path)
    saved = tpred._state_copy()
    for p in tpred.model.parameters():
        p.data.add_(1.0)
    tpred.load(path)
    assert all(torch.equal(v, saved[k])
               for k, v in tpred.model.state_dict().items())
    with open(tmp_path / "metrics.jsonl") as fp:
        recs = [json.loads(line) for line in fp]
    assert [r["_step"] for r in recs] == [0, 1]
    assert all(set(r) == {"train_loss", "_time", "_step"} for r in recs)


def _bf16_predictors(batch, clip):
    kw = dict(input_size=SGP_D, order=4, n_nodes=SGP_N, hidden_size=14,
              mlp_size=8, output_size=1, n_layers=2, horizon=SGP_H,
              resnet=True)
    jpred = JPredictor(JSGPModel(**kw), lr=1e-3, grad_clip=clip, seed=0,
                       compute_dtype="bfloat16")
    jpred.init(batch, JScalerParams(jnp.full((1,), 2.0), jnp.full((1,), 3.0)))
    tpred = Predictor(SGPModel(**kw), lr=1e-3, grad_clip=clip, seed=0,
                      compute_dtype="bfloat16", device="cpu")
    tpred.init(batch, ScalerParams(torch.full((1,), 2.0),
                                   torch.full((1,), 3.0)))
    flax_to_torch(jax.tree.map(np.asarray, jpred.params), tpred.model)
    return jpred, tpred


def test_bf16_compute_dtype_matches_jax(rng):
    """``Predictor(compute_dtype="bfloat16")`` against the JAX trainer's on
    the same flax weights: the model sees bf16 inputs, the parameters and
    their gradients stay f32, the loss is f32. Both packages round every
    product to bf16, not at the same places, so (as
    ``tests/test_torch_port_iid.py::test_bf16_compute_matches_jax``): the
    first loss within 2e-3, the gradients within 5e-2 of the largest, the
    first step's weights within 1e-5 where the gradient lies beyond 5e-2
    of the largest (Adam moves a weight by lr times its gradient's sign),
    then 5 more steps' losses within 5e-3; evaluation within 5e-3."""
    clip = 5.0
    batches = [_sgp_batch(rng, False) for _ in range(6)]
    jpred, tpred = _bf16_predictors(batches[0], clip)
    jdev = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def loss_j(params):
        cast = lambda t: jax.tree.map(  # noqa: E731
            lambda a: a.astype(jnp.bfloat16)
            if getattr(a, "dtype", None) == jnp.float32 else a, t)
        args, kwargs = jpred.batch_to_call(jdev, True)
        out = jpred.model.apply(cast(params), *cast(args),
                                **cast(kwargs)).astype(jnp.float32)
        v, n = jmetrics._masked_reduce(jmetrics._abs_err, out * 3.0 + 2.0,
                                       jdev["y"], jdev["mask"])
        return v / jnp.maximum(n, 1.0)

    jgrad = jax.tree.map(np.asarray, jax.grad(loss_j)(jpred.params))
    seen = []
    tpred.model.encoder.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].dtype))
    loss = tpred.compute_loss(tpred._place(batches[0]))
    loss.backward()
    assert seen == [torch.bfloat16] and loss.dtype == torch.float32
    named = targets(tpred.model)
    for path, (param, transpose) in named.items():
        want = jgrad["params"]
        for k in path:
            want = want[k]
        assert param.dtype == param.grad.dtype == torch.float32
        _rel_close(param.grad.numpy(), want.T if transpose else want, 5e-2,
                   "/".join(path))
    params, opt_state, jloss = jpred._train_step(
        jpred.params, jpred.opt_state, jdev, jax.random.PRNGKey(0))
    tloss = tpred.train_step(batches[0])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-3)
    jp = jax.tree.map(np.asarray, params)["params"]
    for path, (param, transpose) in named.items():
        g, w = jgrad["params"], jp
        for k in path:
            g, w = g[k], w[k]
        g, w = (g.T, w.T) if transpose else (g, w)
        sure = np.abs(g) > 5e-2 * np.abs(g).max()
        diff = np.abs(param.detach().numpy() - w)
        assert diff[sure].max(initial=0) <= 1e-5, "/".join(path)
        assert diff.max() <= 2e-3 + 1e-5, "/".join(path)
    jpred.params, jpred.opt_state = params, opt_state
    for b in batches[1:]:
        jl = jpred._train_step(jpred.params, jpred.opt_state,
                               {k: jnp.asarray(v) for k, v in b.items()},
                               jax.random.PRNGKey(1))
        jpred.params, jpred.opt_state = jl[0], jl[1]
        np.testing.assert_allclose(float(tpred.train_step(b)), float(jl[2]),
                                   rtol=5e-3)
    want = jpred.evaluate(batches[:2])
    got = tpred.evaluate(batches[:2])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-3, err_msg=k)


def _stateful_predictor(seed=0, **over):
    """SGPModel with dropout (so the default generators matter) and a
    learning-rate milestone inside the run (so the schedule's state does)."""
    model = SGPModel(**{**dict(input_size=SGP_D, order=4, n_nodes=SGP_N,
                               hidden_size=14, mlp_size=8, output_size=1,
                               n_layers=2, horizon=SGP_H, resnet=True,
                               dropout=0.3), **over})
    pred = Predictor(model, lr=1e-2, grad_clip=5.0, lr_milestones=[1],
                     lr_gamma=0.1, steps_per_epoch=3, seed=seed,
                     device="cpu")
    return pred


def test_save_state_and_load_state_resume_the_run(rng, tmp_path):
    """``save_state`` -> a new ``Predictor`` -> ``load_state`` -> two more
    steps give the uninterrupted run's losses (within 1e-6) and weights;
    ``extra`` comes back; a changed hyperparameter raises ``ValueError``
    naming the field; ``load_state`` before ``init`` raises."""
    batches = [_sgp_batch(rng, False) for _ in range(4)]
    sc = ScalerParams(torch.full((1,), 2.0), torch.full((1,), 3.0))
    torch.manual_seed(11)
    run = _stateful_predictor().init(batches[0], sc)
    for b in batches[:2]:
        run.train_step(b)
    path = str(tmp_path / "ck" / "state.pt")
    run.save_state(path, epoch=3, best_metric=1.25)
    want = [float(run.train_step(b)) for b in batches[2:]]
    torch.manual_seed(99)                  # other dropout draws until load
    resumed = _stateful_predictor(seed=5)
    with pytest.raises(RuntimeError, match="init"):
        resumed.load_state(path)
    resumed.init(batches[0], sc)
    extra = resumed.load_state(path)
    assert (extra["epoch"], extra["best_metric"]) == (3, 1.25)
    got = [float(resumed.train_step(b)) for b in batches[2:]]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for (k, a), b in zip(run.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6,
                                   err_msg=k)
    other = _stateful_predictor(horizon=SGP_H + 1).init(batches[0], sc)
    with pytest.raises(ValueError, match="'horizon'"):
        other.load_state(path)
