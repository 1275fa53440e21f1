"""The port's attention stack (``sgp_tpu_torch/models/attention.py``) and
attention graph layers (``GATConv``, ``SpatioTemporalAttention`` in
``models/graph_layers.py``) against the JAX package's, on the CPU, with the
flax parameters carried across by ``models/bridge.py``; and one
``Predictor`` step of ``TransformerModel`` against the JAX trainer.

Inputs come from a numpy seed and go to both sides, at small sizes (a few
steps and nodes, widths <= 16).

Tolerances: the positional table bit-equal (both build it in numpy);
module outputs 1e-5 of the largest value (f32, the same products summed in
another order; flax's LayerNorm takes the variance as ``E[x^2] - E[x]^2``,
torch's in two passes); the train step's loss 1e-5 relative and clipped
gradients 1e-5 of each gradient's largest value; but the key projection's
bias has a gradient of 0 in exact arithmetic (a softmax does not see a
shift of all its logits), so both sides hold only rounding noise there, and
it is held to 1e-6 of the model's largest gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.data import SpatioTemporalDataset as JDataset
from sgp_tpu.data import StandardScaler as JStandardScaler
from sgp_tpu.data import Windowing as JWindowing
from sgp_tpu.data.datasets import SyntheticDiffusion as JSynthetic
from sgp_tpu.data.splitters import TemporalSplitter as JSplitter
from sgp_tpu.models import attention as jatt
from sgp_tpu.models import graph_layers as jgl
from sgp_tpu.train import Predictor as JPredictor
from sgp_tpu.train import metrics as jmetrics

from sgp_tpu_torch.data import (SpatioTemporalDataset, StandardScaler,
                                TemporalSplitter, Windowing)
from sgp_tpu_torch.data.datasets import SyntheticDiffusion
from sgp_tpu_torch.models import attention as tatt
from sgp_tpu_torch.models import graph_layers as tgl
from sgp_tpu_torch.models.bridge import flax_to_torch, targets, \
    to_torch_layout
from sgp_tpu_torch.train import Predictor

torch.set_num_threads(1)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _check(jmod, tmod, *inputs, tol=1e-5, **kw):
    """Init ``jmod`` on ``inputs``, carry its parameters into ``tmod`` and
    compare the two outputs."""
    params = jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs),
                       **kw)
    want = np.asarray(jmod.apply(params, *map(jnp.asarray, inputs), **kw))
    flax_to_torch(jax.tree.map(np.asarray, params), tmod)
    tmod.eval()
    with torch.no_grad():
        got = tmod(*map(torch.as_tensor, inputs), **kw).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= tol, _rel(got, want)
    return got


@pytest.mark.parametrize("shape", [(2, 7, 3, 8), (2, 7, 6)])
def test_positional_encoding_is_bit_equal(shape):
    x = _normal(np.random.default_rng(0), shape)
    want = np.asarray(jatt.PositionalEncoding().apply({}, jnp.asarray(x)))
    got = tatt.PositionalEncoding()(torch.as_tensor(x)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("axis", ["time", "nodes"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 5, 4, 6), (3, 5, 6)])
def test_multi_head_attention(axis, causal, shape):
    x = _normal(np.random.default_rng(1), shape)
    _check(jatt.MultiHeadAttention(8, 2, axis, causal),
           tatt.MultiHeadAttention(8, 2, axis, causal, input_size=6), x)


def test_multi_head_attention_distinct_key_value():
    rng = np.random.default_rng(2)
    q, k = _normal(rng, (2, 5, 3, 8)), _normal(rng, (2, 5, 3, 8))
    _check(jatt.MultiHeadAttention(8, 4, "nodes"),
           tatt.MultiHeadAttention(8, 4, "nodes"), q, k, k)


@pytest.mark.parametrize("activation", [None, "relu"])
def test_attention_encoder(activation):
    x = _normal(np.random.default_rng(3), (2, 6, 3, 5))
    _check(jatt.AttentionEncoder(8, 2, "time", activation),
           tatt.AttentionEncoder(8, 2, "time", activation, input_size=5), x)


@pytest.mark.parametrize("shape", [(2, 6, 5), (2, 6, 3, 5)])
def test_causal_linear_attention(shape):
    x = _normal(np.random.default_rng(4), shape)
    _check(jatt.CausalLinearAttention(8, 2),
           tatt.CausalLinearAttention(8, 2, input_size=5), x)


@pytest.mark.parametrize("axis,in_size", [("time", 5), ("nodes", 8)])
def test_transformer_layer(axis, in_size):
    """With (5 -> 8) and without an input projection."""
    x = _normal(np.random.default_rng(5), (2, 6, 3, in_size))
    _check(jatt.TransformerLayer(8, 16, 2, axis),
           tatt.TransformerLayer(8, 16, 2, axis, input_size=in_size), x)


def test_spatio_temporal_transformer_layer():
    x = _normal(np.random.default_rng(6), (2, 6, 4, 8))
    _check(jatt.SpatioTemporalTransformerLayer(8, 16, 2, activation="relu"),
           tatt.SpatioTemporalTransformerLayer(8, 16, 2, activation="relu"),
           x)


@pytest.mark.parametrize("axis,u_dims,n_layers", [
    ("time", 3, 1), ("both", 4, 2), ("nodes", 3, 2)])
def test_transformer_model(axis, u_dims, n_layers):
    rng = np.random.default_rng(7)
    x = _normal(rng, (2, 6, 4, 1))
    u = _normal(rng, (2, 6, 2) if u_dims == 3 else (2, 6, 4, 2))
    jm = jatt.TransformerModel(hidden_size=8, ff_size=16, output_size=1,
                               horizon=3, n_layers=n_layers, n_heads=2,
                               axis=axis)
    tm = tatt.TransformerModel(input_size=3, hidden_size=8, ff_size=16,
                               output_size=1, horizon=3, n_layers=n_layers,
                               n_heads=2, axis=axis)
    got = _check(jm, tm, x, u)
    assert got.shape == (2, 3, 4, 1)


def _ring(n):
    """A directed graph on n nodes with in-degrees 0..3 (node 0 has none)."""
    src = np.concatenate([np.arange(1, n), np.arange(2, n), [0, 0]])
    dst = np.concatenate([np.arange(0, n - 1), np.arange(0, n - 2), [3, 5]])
    keep = dst != 0
    return src[keep].astype(np.int32), dst[keep].astype(np.int32)


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_gat_conv(concat, lead):
    n = 9
    src, dst = _ring(n)
    x = _normal(np.random.default_rng(8), lead + (n, 5))
    got = _check(jgl.GATConv(4, heads=3, concat=concat),
                 tgl.GATConv(5, 4, heads=3, concat=concat), x, src, dst)
    assert got.shape == lead + (n, 12 if concat else 4)
    assert not got[..., 0, :].any()          # node 0 has no in-edge


@pytest.mark.parametrize("in_size", [5, 8])
def test_spatio_temporal_attention(in_size):
    x = _normal(np.random.default_rng(9), (2, 5, 3, in_size))
    _check(jgl.SpatioTemporalAttention(8, 2),
           tgl.SpatioTemporalAttention(8, 2, input_size=in_size), x)


def test_bridge_raises_on_a_tree_that_does_not_fit():
    tm = tatt.MultiHeadAttention(8, 2)
    params = jatt.MultiHeadAttention(8, 2).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 2, 8)))
    tree = jax.tree.map(np.asarray, params)["params"]
    del tree["out"]
    with pytest.raises(KeyError):
        flax_to_torch(tree, tm)


# -- one Predictor step of TransformerModel ------------------------------

N_NODES, N_STEPS = 10, 200
WIN = dict(window=12, horizon=8, horizon_lag=3)


def _pipeline(jax_side: bool):
    """The runner's data path: dataset, day encoding, split, scaler."""
    mods = (JSynthetic, JDataset, JWindowing, JSplitter, JStandardScaler) \
        if jax_side else (SyntheticDiffusion, SpatioTemporalDataset,
                          Windowing, TemporalSplitter, StandardScaler)
    synth, dset, win, splitter, scaler = mods
    raw = synth(num_nodes=N_NODES, num_steps=N_STEPS, seed=0)
    ds = dset(raw.target, index=raw.index, mask=raw.mask,
              covariates={"u": raw.datetime_encoded("day")},
              windowing=win(**WIN))
    split = splitter(0.1, 0.2).split(ds)
    ds.fit_scaler(scaler(axis=(0, 1)), step_index=ds.indices()[split.train])
    return ds, split


@pytest.mark.parametrize("grad_clip", [100.0, 0.05])  # no clip, clip
def test_transformer_predictor_step_matches_jax(grad_clip):
    """``--model-name transformer``'s defaults at small widths: loss and
    clipped gradients of one step against the JAX Predictor on one batch."""
    (jds, jsplit), (tds, _) = _pipeline(True), _pipeline(False)
    batch = jds.gather_batch(jsplit.train[:5])
    horizon = jds.windowing.horizon_steps
    u_size = batch["u"].shape[-1]
    jm = jatt.TransformerModel(hidden_size=16, ff_size=16, output_size=1,
                               horizon=horizon)
    tm = tatt.TransformerModel(input_size=1 + u_size, hidden_size=16,
                               ff_size=16, output_size=1, horizon=horizon)
    jpred = JPredictor(jm, lr=1e-3, grad_clip=grad_clip, seed=0)
    jpred.init(batch, jds.scaler_params())
    tpred = Predictor(tm, lr=1e-3, grad_clip=grad_clip, seed=0, device="cpu")
    tpred.init(batch, tds.scaler_params())
    flax_to_torch(jax.tree.map(np.asarray, jpred.params), tm)

    jdev = {k: jnp.asarray(v) for k, v in batch.items()}
    sc = jds.scaler_params()

    def loss_j(params):
        out = jm.apply(params, jdev["x"], u=jdev["u"], training=True)
        v, n = jmetrics._masked_reduce(jmetrics._abs_err,
                                       sc.inverse_transform(out), jdev["y"],
                                       jdev["mask"])
        return v / jnp.maximum(n, 1.0)

    jloss, jgrads = jax.value_and_grad(loss_j)(jpred.params)
    norm = float(jnp.sqrt(sum(jnp.sum(g ** 2)
                              for g in jax.tree.leaves(jgrads))))
    clip = min(1.0, grad_clip / norm)
    tloss = tpred.train_step(batch)           # clips the grads in place
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    flat = jax.tree.map(np.asarray, jgrads)["params"]
    wants = {}
    for path, (param, how) in targets(tm).items():
        want = flat
        for key in path:
            want = want[key]
        wants[path] = to_torch_layout(want, how) * clip
    top = max(float(np.abs(w).max()) for w in wants.values())
    for path, (param, _) in targets(tm).items():
        got = param.grad.numpy()
        if path[-2:] == ("k", "bias"):        # 0 in exact arithmetic
            assert max(np.abs(got).max(), np.abs(wants[path]).max()) \
                <= 1e-6 * top, "/".join(path)
        else:
            assert _rel(got, wants[path]) <= 1e-5, "/".join(path)
    assert (grad_clip < norm) == (grad_clip == 0.05), norm
