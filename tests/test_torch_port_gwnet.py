"""The port's temporal convolutions and GraphWaveNet against the JAX
package's, on the CPU.

The same numpy inputs (from a seed) and the same weights (carried with
``models/bridge.py``) go through both: ``TemporalConv`` and
``TemporalConvNet`` (gated, causal, dilated, exponential dilation),
``Norm`` (batch, with and without ``time_mask``; layer),
``DenseSpatialConvOrderK``, ``GraphWaveNetModel`` in every parameter
layout of the JAX model (blocks scanned along a stacked axis, one block,
one layer a block when ``dilation_mod`` does not divide ``n_layers``, and
``scan_layers=False``), with and without ``node_index``, and a
``Predictor`` step. Tolerance: TOL (1e-5) relative to the largest value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.models import graph_layers as jgl
from sgp_tpu.models import gwnet as jgw
from sgp_tpu.models import tcn as jtcn

from sgp_tpu_torch.models import (DenseSpatialConvOrderK, GraphWaveNetModel,
                                  Norm, TemporalConv, TemporalConvNet,
                                  diff_conv_support,
                                  diff_conv_support_from_arrays,
                                  flax_to_torch)
from test_torch_port_diffconv import (carry, graphs, predictor_step_matches,
                                      rel_close, t)

torch.set_num_threads(1)

N, B, S, C, U, H = 9, 2, 7, 3, 2, 8


@pytest.mark.parametrize("kernel,dilation,causal,gated", [
    (2, 1, True, False), (3, 2, True, True), (2, 3, False, False),
    (3, 1, False, True)])
def test_temporal_conv_matches(rng, kernel, dilation, causal, gated):
    x = rng.standard_normal((B, S, N, C)).astype(np.float32)
    jm = jtcn.TemporalConv(H, kernel, dilation, causal, gated)
    tm = TemporalConv(C, H, kernel, dilation, causal, gated)
    params = carry(jm, tm, x)
    got = tm(t(x))
    want = jm.apply(params, x)
    assert got.shape == want.shape
    rel_close(got.detach(), want)


@pytest.mark.parametrize("gated,exponential,dropout", [
    (False, True, 0.0), (True, False, 0.0), (False, False, 0.5)])
def test_temporal_conv_net_matches(rng, gated, exponential, dropout):
    """Dropout is off outside training in both."""
    x = rng.standard_normal((B, S, N, C)).astype(np.float32)
    jm = jtcn.TemporalConvNet(H, 2, dilation=2, n_layers=3, gated=gated,
                              exponential_dilation=exponential,
                              dropout=dropout)
    tm = TemporalConvNet(C, H, 2, dilation=2, n_layers=3, gated=gated,
                         exponential_dilation=exponential,
                         dropout=dropout).eval()
    params = carry(jm, tm, x)
    rel_close(tm(t(x)).detach(), jm.apply(params, x))


@pytest.mark.parametrize("kind,masked", [("batch", False), ("batch", True),
                                         ("layer", False), ("none", False)])
def test_norm_matches(rng, kind, masked):
    """The stateless batch norm: statistics over the valid steps only, in
    f32, the same in training and evaluation."""
    x = (rng.standard_normal((B, S, N, H)) * 3 + 1).astype(np.float32)
    mask = np.arange(S) >= 3 if masked else None
    jm, tm = jtcn.Norm(kind), Norm(kind, H)
    params = jm.init(jax.random.PRNGKey(0), x, time_mask=mask)
    if params:   # give the affine parameters values the test can see
        params = jax.tree.map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
            params)
        flax_to_torch(jax.tree.map(np.asarray, params), tm)
    want = jm.apply(params, x, time_mask=mask)
    m = None if mask is None else t(mask)
    rel_close(tm.train()(t(x), time_mask=m).detach(), want)
    rel_close(tm.eval()(t(x), time_mask=m).detach(), want)


@pytest.mark.parametrize("stacked", [False, True])
def test_dense_spatial_conv_matches(rng, stacked):
    x = rng.standard_normal((B, S, N, C)).astype(np.float32)
    raw = rng.random((N, N)).astype(np.float32)
    jadj = jgw.DenseSpatialConvOrderK.compute_support(jnp.asarray(raw)) \
        if stacked else jnp.asarray(raw / raw.sum(1, keepdims=True))
    adj = DenseSpatialConvOrderK.compute_support(t(raw)) if stacked \
        else t(np.asarray(jadj))
    rel_close(adj, jadj)
    jm = jgw.DenseSpatialConvOrderK(H, order=2)
    tm = DenseSpatialConvOrderK(C, H, order=2, n_supports=2 if stacked else 1)
    params = carry(jm, tm, x, jadj)
    rel_close(tm(t(x), adj).detach(), jm.apply(params, x, jadj))


def _supports(rng):
    jg, g = graphs(rng, N, 30)
    return (jgl.diff_conv_support(jg, operator_mode="coo"),
            diff_conv_support(g, operator_mode="coo", device="cpu"))


# (n_layers, dilation_mod, scan_layers, window): the configs' 8 layers
# scanned in 4 blocks (stacked), 4 layers with scan_layers off, one block
# of 2, 3 layers mod 2 (one layer a block), and a window shorter than the
# receptive field (left-padded)
LAYOUTS = [(8, 2, True, S), (4, 2, False, S), (2, 2, True, S),
           (3, 2, True, S), (4, 2, True, 3)]


@pytest.mark.parametrize("n_layers,mod,scan,window", LAYOUTS,
                         ids=["8-scanned", "4-unscanned", "2-one-block",
                              "3-per-layer", "short-window"])
@pytest.mark.parametrize("with_index", [False, True])
def test_gwnet_forward_matches(rng, n_layers, mod, scan, window,
                               with_index):
    """``with_index``: a 6-node subgraph batch, its supports from its edge
    arrays and the learned adjacency sliced by ``node_index``."""
    if with_index:
        n, idx = 6, rng.permutation(N)[:6]
        src, dst = (rng.integers(0, n, 20).astype(np.int32)
                    for _ in range(2))
        w = (rng.random(20) + 0.1).astype(np.float32)
        jsup = jgl.diff_conv_support_from_arrays(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), n)
        sup = diff_conv_support_from_arrays(t(src), t(dst), t(w), n)
    else:
        (jsup, sup), n, idx = _supports(rng), N, None
    x = rng.standard_normal((B, window, n, C)).astype(np.float32)
    u = rng.standard_normal((B, window, U)).astype(np.float32)
    kw = dict(n_layers=n_layers, dilation_mod=mod, n_nodes=N, emb_size=4,
              scan_layers=scan)
    jm = jgw.GraphWaveNetModel(H, H, C, 3, **kw)
    tm = GraphWaveNetModel(C + U, H, H, C, 3, **kw)
    params = carry(jm, tm, x, jsup, u=u, node_index=idx)
    got = tm(t(x), sup, u=t(u), node_index=None if idx is None else t(idx))
    assert got.shape == (B, 3, n, C)
    rel_close(got.detach(), jm.apply(params, x, jsup, u=u, node_index=idx))


def test_gwnet_without_learned_adjacency_matches(rng):
    jsup, sup = _supports(rng)
    x = rng.standard_normal((B, S, N, C)).astype(np.float32)
    kw = dict(n_layers=4, learned_adjacency=False, norm="none")
    jm = jgw.GraphWaveNetModel(H, H, C, 3, **kw)
    tm = GraphWaveNetModel(C, H, H, C, 3, **kw)
    params = carry(jm, tm, x, jsup)
    rel_close(tm(t(x), sup).detach(), jm.apply(params, x, jsup))


@pytest.mark.parametrize("n_layers", [4, 3])
def test_gwnet_predictor_step_matches(rng, n_layers):
    """A ``Predictor`` step of ``GraphWaveNetModel`` (dropout 0) on the
    runners' call, in a scanned and a one-layer-a-block layout."""
    jsup, sup = _supports(rng)

    def call(batch, training):
        return (batch["x"], batch["supports"]), {
            "u": batch.get("u"), "node_index": batch.get("node_index"),
            "training": training}
    batch = {"x": rng.standard_normal((B, S, N, C)).astype(np.float32),
             "u": rng.standard_normal((B, S, U)).astype(np.float32),
             "y": rng.standard_normal((B, 3, N, C)).astype(np.float32),
             "mask": rng.random((B, 3, N, C)) > 0.2}
    kw = dict(n_layers=n_layers, n_nodes=N, emb_size=4)
    tpred = predictor_step_matches(
        jgw.GraphWaveNetModel(H, H, C, 3, **kw),
        GraphWaveNetModel(C + U, H, H, C, 3, **kw), batch, call, call,
        {"supports": jsup}, {"supports": sup})
    # the last layer's diffusion branch does not reach the loss: its
    # weights take a zero gradient, as optax gives them
    last = tpred.model.layers[-1].diff.linear.weight
    assert last.grad is not None and not last.grad.any()
