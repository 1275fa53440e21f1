"""The port's ``models/stgn_extra.py`` against the JAX package's, on the CPU.

The same numpy inputs (from a seed) and the same weights (carried with
``models/bridge.py``) go through every class of the file: the GraphConv
GRU and LSTM cells and their stack, ``DenseDCRNNCell``,
``ConditionalTCNBlock``, ``InputEncoder``, ``STCNBlock``, the three
decoders, ``STCNModel`` and ``RNNEncGCNDecModel``, ``LinkPredictor``, ``DifferentiableBinarySampler``
and ``NRIDCRNN`` (JAX's uniform draw passed in: its stream cannot be
repeated in torch), and the three ops. The graph layers run on dense and
on BSR operators (on the CPU the BSR operator runs K1's plain version, the
JAX one ``bsr_spmm_xla``). Tolerances: outputs within TOL (1e-5) of the
largest value; gradients within TOL_GRAD (1e-4) of each parameter's
largest.

Then ``stcn`` and ``rnn2gcn`` through the traffic runner from the JAX
run's initial weights (``Predictor`` steps with the runner's call and its
operator; the test metrics within 1e-5 relative), and the
large-scale runner, which refuses both before it builds anything: the JAX
runner pairs its subgraph batches with the full graph's operator, which
raises on a shape mismatch whenever the padded subgraph has fewer nodes
than the graph.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.exp.common import Experiment as JExperiment
from sgp_tpu.exp import run_largescale_baselines as j_large
from sgp_tpu.exp import run_traffic_baselines as j_traffic
from sgp_tpu.graph import normalize_adj as j_normalize_adj
from sgp_tpu.models import stgn_extra as jse
from sgp_tpu.models.gwnet import DenseSpatialConvOrderK as JDense
from sgp_tpu.ops import build_operator as j_build_operator

from sgp_tpu_torch.exp import run_largescale_baselines as t_large
from sgp_tpu_torch.exp import run_traffic_baselines as t_traffic
from sgp_tpu_torch.exp.common import Experiment
from sgp_tpu_torch.graph import normalize_adj
from sgp_tpu_torch.models import get_model_class
from sgp_tpu_torch.models import stgn_extra as tse
from sgp_tpu_torch.ops import BSROperator, build_operator
from test_torch_port_baselines import (BASE, METRICS, SUBGRAPH, TOL_RUN,
                                       _carried_runs, _logs)  # noqa: F401
from sgp_tpu_torch.models import flax_to_torch
from test_torch_port_diffconv import compare_tree, graphs, rel_close, t

torch.set_num_threads(1)

TOL_GRAD = 1e-4
N, B, S, C, U, H = 10, 3, 4, 2, 3, 8


def operators(rng, mode):
    """The row-normalized operator of one random graph in both packages,
    as the traffic runner builds it for ``stcn`` and ``rnn2gcn``."""
    jg, g = graphs(rng)
    return (j_build_operator(j_normalize_adj(jg, "row"), mode),
            build_operator(normalize_adj(g, "row"), mode, device="cpu"))


def x_of(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def carry(jm, tm, *args, **kwargs):
    """``jm``'s weights from a jitted ``init`` on ``args``, carried into
    ``tm``; returns the flax variables. (Jitted: the JAX side's eager
    dispatch compiles each primitive at each new shape, which took most of
    this file's time.)"""
    params = jax.jit(lambda a, k: jm.init(jax.random.PRNGKey(0), *a, **k))(
        args, kwargs)
    flax_to_torch(jax.tree.map(np.asarray, params), tm)
    return params


def apply(jm, params, *args, **kwargs):
    """``jm.apply`` jitted."""
    return jax.jit(lambda p, a, k: jm.apply(p, *a, **k))(params, args, kwargs)


def grads_match(jm, tm, params, j_args, t_args, cotangent, tol=TOL_GRAD,
                j_kwargs=None, t_kwargs=None):
    """The gradient of ``sum(out * cotangent)`` for every parameter in
    both packages, each within ``tol`` of its largest value."""
    def f(p, a, k):
        return jnp.sum(jm.apply(p, *a, **k) * cotangent)
    jgrads = jax.jit(jax.grad(f))(params, j_args, j_kwargs or {})
    tm.zero_grad()
    (tm(*t_args, **(t_kwargs or {})) * t(cotangent)).sum().backward()
    compare_tree(tm, jgrads, grads=True, tol=tol)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_graph_conv_cells_match(rng, cell):
    jop, op = operators(rng, "bsr")
    x, h, c = x_of(rng, B, N, C), x_of(rng, B, N, H), x_of(rng, B, N, H)
    if cell == "gru":
        jm, tm = jse.GraphConvGRUCell(H), tse.GraphConvGRUCell(C, H)
        params = carry(jm, tm, x, h, jop)
        got = tm(t(x), t(h), op)
        rel_close(got.detach(), apply(jm, params, x, h, jop))
        grads_match(jm, tm, params, (x, h, jop), (t(x), t(h), op),
                    x_of(rng, B, N, H))
        return
    jm, tm = jse.GraphConvLSTMCell(H), tse.GraphConvLSTMCell(C, H)
    params = carry(jm, tm, x, (h, c), jop)
    got_h, (_, got_c) = tm(t(x), (t(h), t(c)), op)
    want_h, (_, want_c) = apply(jm, params, x, (h, c), jop)
    rel_close(got_h.detach(), want_h)
    rel_close(got_c.detach(), want_c)


@pytest.mark.parametrize("cell,n_layers,mode", [("gru", 2, "bsr"),
                                               ("lstm", 1, "dense")])
def test_graph_conv_rnn_matches(rng, cell, n_layers, mode):
    """The stack over the window: forward and every gradient."""
    jop, op = operators(rng, mode)
    x = x_of(rng, B, S, N, C)
    jm = jse.GraphConvRNN(H, n_layers, cell)
    tm = tse.GraphConvRNN(C, H, n_layers, cell)
    params = carry(jm, tm, x, jop)
    got = tm(t(x), op)
    assert got.shape == (B, N, H)
    rel_close(got.detach(), apply(jm, params, x, jop))
    grads_match(jm, tm, params, (x, jop), (t(x), op), x_of(rng, B, N, H))


def test_graph_conv_rnn_launches_one_product_a_gate(rng, monkeypatch):
    """On a BSR operator each gate of each layer-step is one K1 call (on
    the CPU its plain version): T x layers x gates."""
    from sgp_tpu_torch.ops import bsr_kernel
    calls = []
    plain = bsr_kernel.bsr_spmm_plain

    def counting(*a, **k):
        calls.append(1)
        return plain(*a, **k)
    monkeypatch.setattr(bsr_kernel, "bsr_spmm_plain", counting)
    _, op = operators(rng, "bsr")
    assert isinstance(op, BSROperator)
    x = t(x_of(rng, B, S, N, C))
    for cell, gates in (("gru", 3), ("lstm", 4)):
        calls.clear()
        with torch.no_grad():
            tse.GraphConvRNN(C, H, 2, cell)(x, op)
        assert len(calls) == S * 2 * gates, cell


@pytest.mark.parametrize("stacked", [True, False])
def test_dense_dcrnn_cell_matches(rng, stacked):
    """On ``compute_support``'s stacked pair and on one ``[n, n]``
    support."""
    raw = rng.random((N, N)).astype(np.float32)
    adj = np.asarray(JDense.compute_support(jnp.asarray(raw))) if stacked \
        else raw / raw.sum(1, keepdims=True)
    x, h = x_of(rng, B, N, C), x_of(rng, B, N, H)
    jm = jse.DenseDCRNNCell(H, k=2)
    tm = tse.DenseDCRNNCell(C, H, k=2, n_supports=2 if stacked else 1)
    params = carry(jm, tm, x, h, adj)
    rel_close(tm(t(x), t(h), t(adj)).detach(), apply(jm, params, x, h, adj))
    grads_match(jm, tm, params, (x, h, adj), (t(x), t(h), t(adj)),
                x_of(rng, B, N, H))


@pytest.mark.parametrize("gated,skip,dilation", [
    (False, True, 1), (True, False, 2)])
def test_conditional_tcn_block_matches(rng, gated, skip, dilation):
    x, u = x_of(rng, B, S, N, C), x_of(rng, B, S, N, U)
    jm = jse.ConditionalTCNBlock(H, kernel_size=2, dilation=dilation,
                                 gated=gated, skip_connection=skip)
    tm = tse.ConditionalTCNBlock(C, U, H, kernel_size=2, dilation=dilation,
                                 gated=gated, skip_connection=skip)
    params = carry(jm, tm, x, u)
    got = tm(t(x), t(u))
    assert got.shape == (B, S, N, H)
    rel_close(got.detach(), apply(jm, params, x, u))


@pytest.mark.parametrize("enc_type,u_ndim", [
    ("mlp", 4), ("mlp", 3), ("conditional", 3), ("conditional", 4)])
def test_input_encoder_matches(rng, enc_type, u_ndim):
    x = x_of(rng, B, S, N, C)
    u = x_of(rng, B, S, U) if u_ndim == 3 else x_of(rng, B, S, N, U)
    jm = jse.InputEncoder(H, enc_type)
    tm = tse.InputEncoder(C, H, enc_type, exog_size=U)
    params = carry(jm, tm, x, u)
    rel_close(tm(t(x), t(u)).detach(), apply(jm, params, x, u))
    if enc_type == "conditional":
        with pytest.raises(ValueError, match="needs u"):
            tm(t(x))


@pytest.mark.parametrize("width,mode", [(C, "bsr"), (H, "dense")])
def test_stcn_block_matches(rng, width, mode):
    """The skip is a Linear only where the widths differ; flax's LayerNorm
    epsilon (1e-6)."""
    jop, op = operators(rng, mode)
    x = x_of(rng, B, S, N, width)
    jm, tm = jse.STCNBlock(H, dilation=2), tse.STCNBlock(width, H,
                                                         dilation=2)
    assert (tm.skip is None) == (width == H)
    assert tm.norm.eps == 1e-6
    params = carry(jm, tm, x, jop)
    rel_close(tm(t(x), op).detach(), apply(jm, params, x, jop))
    grads_match(jm, tm, params, (x, jop), (t(x), op),
                x_of(rng, B, S, N, H))


@pytest.mark.parametrize("ndim", [3, 4])
def test_multi_horizon_mlp_decoder_matches(rng, ndim):
    h = x_of(rng, *((B, S, N, H) if ndim == 4 else (B, N, H)))
    jm = jse.MultiHorizonMLPDecoder(H, 2, horizon=4)
    tm = tse.MultiHorizonMLPDecoder(H, H, 2, horizon=4)
    params = carry(jm, tm, h)
    got = tm(t(h))
    assert got.shape == (B, 4, N, 2)
    rel_close(got.detach(), apply(jm, params, h))
    grads_match(jm, tm, params, (h,), (t(h),), x_of(rng, B, 4, N, 2))


@pytest.mark.parametrize("n_layers,ndim,mode", [(1, 3, "bsr"),
                                               (2, 4, "dense")])
def test_gcn_decoder_matches(rng, n_layers, ndim, mode):
    jop, op = operators(rng, mode)
    h = x_of(rng, *((B, S, N, C) if ndim == 4 else (B, N, C)))
    jm = jse.GCNDecoder(H, 2, 3, n_layers=n_layers)
    tm = tse.GCNDecoder(C, H, 2, 3, n_layers=n_layers)
    params = carry(jm, tm, h, jop)
    got = tm(t(h), op)
    assert got.shape == (B, 3, N, 2)
    rel_close(got.detach(), apply(jm, params, h, jop))


@pytest.mark.parametrize("axis", [1, 2])
def test_att_pool_matches(rng, axis):
    x = x_of(rng, B, S, N, C)
    jm, tm = jse.AttPool(axis), tse.AttPool(C, axis)
    params = carry(jm, tm, x)
    rel_close(tm(t(x)).detach(), apply(jm, params, x))


def _stcn_pair(n_layers):
    return (jse.STCNModel(H, 2 * H, C, 3, n_layers=n_layers),
            tse.STCNModel(C + U, H, 2 * H, C, 3, n_layers=n_layers))


def _rnn2gcn_pair(layers):
    return (jse.RNNEncGCNDecModel(H, C, 3, rec_layers=layers,
                                  gcn_layers=layers),
            tse.RNNEncGCNDecModel(C + U, H, C, 3, rec_layers=layers,
                                  gcn_layers=layers))


MODELS = {"stcn": _stcn_pair, "rnn2gcn": _rnn2gcn_pair}


@pytest.mark.parametrize("name,layers,u_ndim,mode", [
    ("stcn", 2, 3, "bsr"), ("stcn", 1, 4, "dense"), ("rnn2gcn", 1, 3, "bsr"),
    ("rnn2gcn", 2, 4, "dense")])
def test_models_match(rng, name, layers, u_ndim, mode):
    """Forward and every gradient; a ``[b s c]`` exogenous input is
    broadcast over the nodes."""
    jop, op = operators(rng, mode)
    x = x_of(rng, B, S, N, C)
    u = x_of(rng, B, S, U) if u_ndim == 3 else x_of(rng, B, S, N, U)
    jm, tm = MODELS[name](layers)
    params = carry(jm, tm, x, jop, u=u)
    got = tm(t(x), op, u=t(u))
    assert got.shape == (B, 3, N, C)
    rel_close(got.detach(), apply(jm, params, x, jop, u=u))
    grads_match(jm, tm, params, (x, jop), (t(x), op), x_of(rng, B, 3, N, C),
                j_kwargs={"u": u}, t_kwargs={"u": t(u)})


def test_registry_returns_the_ported_models():
    assert get_model_class("stcn") is tse.STCNModel
    assert get_model_class("rnn2gcn") is tse.RNNEncGCNDecModel
    with pytest.raises(KeyError):
        get_model_class("no_such_model")


def test_link_predictor_matches(rng):
    x = x_of(rng, N, 4)
    jm, tm = jse.LinkPredictor(ff_size=H, hidden_size=5), \
        tse.LinkPredictor(4, H, 5)
    params = carry(jm, tm, x)
    got = tm(t(x))
    assert got.shape == (N, N)
    rel_close(got.detach(), apply(jm, params, x))


def test_binary_sampler_matches_on_jax_draw(rng):
    """JAX's uniform draw passed in; with a generator the port draws its
    own, in [0, 1] and reproducible."""
    scores = rng.random((N, N)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    unif = np.asarray(jax.random.uniform(key, scores.shape))
    want = jse.DifferentiableBinarySampler().apply({}, scores, 0.25, key)
    sampler = tse.DifferentiableBinarySampler()
    rel_close(sampler(t(scores), 0.25, noise=t(unif)), want)
    a = sampler(t(scores), 0.25, torch.Generator().manual_seed(0))
    b = sampler(t(scores), 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and bool(((a >= 0) & (a <= 1)).all())


@pytest.mark.parametrize("sampled,n_layers", [(False, 1), (True, 2)])
def test_nri_dcrnn_matches(rng, sampled, n_layers):
    """Without an rng the mean adjacency (forward and gradients); with one,
    JAX's draw from the key (``jax.random.uniform`` on the scores' shape)
    passed as noise."""
    x = x_of(rng, B, S, N, C)
    jm = jse.NRIDCRNN(hidden_size=H, emb_size=4, n_nodes=N,
                      n_layers=n_layers, k=2)
    tm = tse.NRIDCRNN(C, H, emb_size=4, n_nodes=N, n_layers=n_layers, k=2)
    params = carry(jm, tm, x)
    key = jax.random.PRNGKey(7)
    if sampled:
        want = apply(jm, params, x, rng=key)
        noise = t(np.asarray(jax.random.uniform(key, (N, N))))
        got = tm(t(x), noise=noise)
    else:
        want, got = apply(jm, params, x), tm(t(x))
    assert got.shape == (B, N, H)
    rel_close(got.detach(), want)
    if not sampled:
        grads_match(jm, tm, params, (x,), (t(x),), x_of(rng, B, N, H))


def test_ops_match(rng):
    x = x_of(rng, B, S, N, C)
    y = x_of(rng, B, S, N, U)
    rel_close(tse.Lambda(torch.tanh)(t(x)),
              jse.Lambda(jnp.tanh).apply({}, x))
    rel_close(tse.Concatenate(-1)([t(x), t(y)]),
              jse.Concatenate(-1).apply({}, [x, y]))
    rel_close(tse.Select(2, 3)(t(x)), jse.Select(2, 3).apply({}, x))


@pytest.mark.parametrize("model", ["stcn", "rnn2gcn"])
def test_traffic_runner_matches_jax_runner(monkeypatch, model):
    """The runner's operator (``build_operator(normalize_adj(g, "row"))``,
    dense by ``auto``) and flags, from the JAX run's initial weights."""
    argv = BASE + ["--model-name", model, "--adj-knn", "4"]
    want, got, _ = _carried_runs(monkeypatch, "traffic", argv)
    for k in METRICS:
        assert np.isfinite(got[k]) and np.isfinite(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=TOL_RUN, err_msg=k)


@pytest.mark.parametrize("model", ["stcn", "rnn2gcn"])
def test_largescale_runner_refuses(monkeypatch, model):
    """The JAX large-scale runner sends these models the full graph's
    operator with subgraph batches: on 2 roots (padded to 8 of 16 nodes)
    the product raises on the node count. The port refuses before any
    data is made, with either loader."""
    argv = BASE + ["--model-name", model, "--num-subgraph-nodes", "2",
                   "--subgraph-k", "1", "--max-edges", "64"]
    with pytest.raises(ValueError, match="does not match"):
        JExperiment(j_large.run_experiment,
                    j_traffic.configure_parser()).run(argv)

    def no_data(*a, **k):
        raise AssertionError("the check must come before the data")

    monkeypatch.setattr(t_large, "get_dataset", no_data)
    for flags in (SUBGRAPH, ["--subgraph-k", "0"]):
        with pytest.raises(ValueError, match="full graph's operator"):
            Experiment(t_large.run_experiment,
                       t_traffic.configure_parser()).run(
                BASE + ["--model-name", model] + flags + ["--device", "cpu"])
