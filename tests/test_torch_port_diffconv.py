"""The port's diffusion layers against the JAX package's, on the CPU.

The same numpy inputs (from a seed) and the same weights (carried with
``models/bridge.py``) go through both: ``MLPDecoder``, the supports of
``diff_conv_support`` in dense, COO and BSR modes (on the CPU the BSR
operator runs K1's plain version; the JAX operator ``bsr_spmm_xla``),
``diff_conv_support_from_arrays`` with padding edges kept and left out,
``DiffConv`` forward and gradient, ``ConditionalBlock``, ``GraphConv``, and
a ``Predictor`` step of ``DCRNNModel``. Tolerances: TOL (1e-5) relative to
the largest value, for f32 products summed in another order.

:func:`predictor_step_matches` is shared with the GraphWaveNet and
recurrent-model tests.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.data.scalers import ScalerParams as JScalerParams
from sgp_tpu.graph.sparse import Graph as JGraph
from sgp_tpu.graph.sparse import coalesce as j_coalesce
from sgp_tpu.models import graph_layers as jgl
from sgp_tpu.models.blocks import MLPDecoder as JMLPDecoder
from sgp_tpu.models.dcrnn import DCRNNModel as JDCRNNModel
from sgp_tpu.train import Predictor as JPredictor
from sgp_tpu.train import metrics as jmetrics

from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.graph import Graph, coalesce
from sgp_tpu_torch.models import (ConditionalBlock, DCRNNModel, DiffConv,
                                  GraphConv, MLPDecoder, diff_conv_support,
                                  diff_conv_support_from_arrays,
                                  flax_to_torch)
from sgp_tpu_torch.models.bridge import _flatten, targets, to_torch_layout
from sgp_tpu_torch.ops import BSROperator, COOOperator, DenseOperator
from sgp_tpu_torch.train import Predictor

torch.set_num_threads(1)

TOL = 1e-5
ZERO_GRAD = 1e-6
N, B, S, C, U, H = 10, 3, 5, 2, 3, 8


def rel_close(got, want, tol=TOL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (name, err)


def graphs(rng, n=N, e=40):
    """The same random weighted graph in both packages (coalesced)."""
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32) + 0.1
    return (j_coalesce(JGraph(src, dst, w, n)),
            coalesce(Graph(src, dst, w, n)))


def carry(jmodule, tmodule, *args, **kwargs):
    """``jmodule``'s weights from ``init`` on ``args``, carried into
    ``tmodule``; returns the flax variables."""
    params = jmodule.init(jax.random.PRNGKey(0), *args, **kwargs)
    flax_to_torch(jax.tree.map(np.asarray, params), tmodule)
    return params


def t(a):
    return torch.as_tensor(np.array(a))


def torch_tree(model, grads: bool = False) -> dict:
    """flax path -> list of torch arrays in the flax tree's order (one per
    block of a stacked path): the weights, or their gradients."""
    view = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(model.parameters(), view.parameters()):
            q.copy_(p.grad if grads and p.grad is not None
                    else torch.zeros_like(p) if grads else p)
    out = {}
    for path, target in targets(view).items():
        pairs = target if isinstance(target, list) else [target]
        out[path] = [(p.detach().numpy().copy(), how) for p, how in pairs]
    return out


def compare_tree(model, jax_tree, grads: bool, tol=TOL, keep=None,
                 atol=None):
    """``model``'s weights (or gradients) against the flax tree, each
    tensor relative to its largest value; with ``keep`` (path -> bool
    mask) only the kept entries, within ``atol``. A gradient whose largest
    value lies under ZERO_GRAD of the model's largest gradient is 0 in
    exact arithmetic (the bias of a layer that a batch norm follows):
    rounding noise in both, held relative to the model's largest
    gradient."""
    flat = _flatten(jax.tree.map(np.asarray, jax_tree)["params"])
    top = max(float(np.abs(a).max()) for a in flat.values())
    for path, entries in torch_tree(model, grads).items():
        stacked = len(entries) > 1 or flat[path].ndim > entries[0][0].ndim
        for i, (got, how) in enumerate(entries):
            want = to_torch_layout(flat[path][i] if stacked else flat[path],
                                   how)
            name = "/".join(path)
            if grads and np.abs(want).max() < ZERO_GRAD * top:
                assert np.abs(got - want).max() <= tol * top, name
            elif keep is None:
                rel_close(got, want, tol, name)
            else:
                m = keep[path][i]
                np.testing.assert_allclose(got[m], want[m], rtol=0,
                                           atol=atol, err_msg=name)


def predictor_step_matches(jm, tm, batch, j_call, t_call, j_static=None,
                           t_static=None, grad_clip=5.0):
    """One ``Predictor`` train step of the JAX model ``jm`` and its port
    ``tm`` from the same weights on the same batch (dropout 0): the loss
    within TOL relative, each gradient within TOL of its largest value,
    and after the Adam step each weight whose gradient exceeds 1e-6 in
    magnitude within 1e-6 (an Adam step moves a weight by about lr =
    1e-3 whatever its gradient's size, so a gradient that is 0 in exact
    arithmetic may step either way from rounding)."""
    rng = np.random.default_rng(1)
    bias = rng.standard_normal((1, 1, batch["y"].shape[2], 1)) \
        .astype(np.float32)
    scale = (rng.random((1, 1, batch["y"].shape[2], 1)) + 0.5) \
        .astype(np.float32)
    jpred = JPredictor(jm, lr=1e-3, grad_clip=grad_clip, batch_to_call=j_call,
                       seed=0, static_batch=j_static)
    jpred.init(batch, JScalerParams(jnp.asarray(bias), jnp.asarray(scale)))
    tpred = Predictor(tm, lr=1e-3, grad_clip=grad_clip, batch_to_call=t_call,
                      seed=0, static_batch=t_static, device="cpu")
    tpred.init(batch, ScalerParams(t(bias), t(scale)))
    flax_to_torch(jax.tree.map(np.asarray, jpred.params), tm)
    jdev = {**(jpred.static_batch or {}),
            **{k: jnp.asarray(v) for k, v in batch.items()}}

    def loss_j(params):
        a, k = j_call(jdev, True)
        out = jm.apply(params, *a, **k)
        v, n = jmetrics._masked_reduce(jmetrics._abs_err,
                                       out * scale + bias, jdev["y"],
                                       jdev["mask"])
        return v / jnp.maximum(n, 1.0)

    jgrads = jax.grad(loss_j)(jpred.params)
    new_params, _, jloss = jpred._train_step(jpred.params, jpred.opt_state,
                                             jdev, jax.random.PRNGKey(0))
    loss = tpred.compute_loss(tpred._place(batch))
    loss.backward()
    rel_close(loss.item(), float(jloss), name="loss")
    compare_tree(tm, jgrads, grads=True)
    keep = {p: [np.abs(g) > 1e-6 for g, _ in e]
            for p, e in torch_tree(tm, grads=True).items()}
    tloss = tpred.train_step(batch)
    rel_close(float(tloss), float(jloss), name="loss")
    compare_tree(tm, new_params, grads=False, keep=keep, atol=1e-6)
    return tpred


@pytest.mark.parametrize("receptive_field,n_layers,ndim", [
    (1, 1, 4), (2, 2, 4), (1, 1, 3)])
def test_mlp_decoder_matches(rng, receptive_field, n_layers, ndim):
    shape = (B, S, N, C) if ndim == 4 else (B, N, C)
    h = rng.standard_normal(shape).astype(np.float32)
    jm = JMLPDecoder(H, 2, horizon=3, receptive_field=receptive_field,
                     n_layers=n_layers)
    tm = MLPDecoder(C, H, 2, horizon=3, receptive_field=receptive_field,
                    n_layers=n_layers)
    params = carry(jm, tm, h)
    got = tm(t(h))
    assert got.shape == (B, 3, N, 2)
    rel_close(got.detach(), jm.apply(params, h))


@pytest.mark.parametrize("mode", ["dense", "coo", "bsr"])
def test_diff_conv_support_matches(rng, mode):
    """Each support ``@ x`` against the JAX operator's (BSR: K1's plain
    version against ``bsr_spmm_xla``), built on the CPU when asked."""
    jg, g = graphs(rng)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    want = jgl.diff_conv_support(jg, operator_mode=mode)
    got = diff_conv_support(g, operator_mode=mode, device="cpu")
    kind = {"dense": DenseOperator, "coo": COOOperator, "bsr": BSROperator}
    assert len(got) == 2 and all(isinstance(op, kind[mode]) for op in got)
    for jop, op in zip(want, got):
        rel_close(op @ t(x), jop @ jnp.asarray(x))
    one = diff_conv_support(g, add_backward=False, operator_mode=mode,
                            device="cpu")
    assert len(one) == 1


def test_diff_conv_support_lives_on_the_given_device(rng, monkeypatch):
    """The supports are built where they run: a CPU run holds no CUDA
    tensor (a trainer moves tensors, not operators), and no device means
    the card, which raises without one."""
    _, g = graphs(rng)
    for mode in ("dense", "coo", "bsr"):
        for op in diff_conv_support(g, operator_mode=mode, device="cpu"):
            tensors = [v for v in vars(op).values()
                       if isinstance(v, torch.Tensor)]
            assert tensors and all(v.device.type == "cpu" for v in tensors)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diff_conv_support(g)


def _padded_arrays(rng, n=N, e=30, pad=14):
    """A subgraph batch's edge arrays: ``e`` real edges, then ``pad``
    padding edges ``0 -> 0`` of weight 0."""
    src = np.concatenate([rng.integers(0, n, e), np.zeros(pad, np.int64)])
    dst = np.concatenate([rng.integers(0, n, e), np.zeros(pad, np.int64)])
    w = np.concatenate([rng.random(e) + 0.1, np.zeros(pad)]).astype(
        np.float32)
    return src.astype(np.int32), dst.astype(np.int32), w


def test_support_from_arrays_matches_with_padding_kept_and_left_out(rng):
    """The JAX supports of the padded arrays; the port's of the padded
    arrays and of the real edges alone (as the large-scale runner builds
    them) give the same products."""
    src, dst, w = _padded_arrays(rng)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    want = [op @ jnp.asarray(x) for op in jgl.diff_conv_support_from_arrays(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), N)]
    real = w != 0
    for keep in (np.ones_like(real), real):
        ops = diff_conv_support_from_arrays(t(src[keep]), t(dst[keep]),
                                            t(w[keep]), N)
        assert len(ops) == 2
        for op, ref in zip(ops, want):
            rel_close(op @ t(x), ref)
    assert len(diff_conv_support_from_arrays(t(src), t(dst), t(w), N,
                                             add_backward=False)) == 1


def _supports(rng, mode):
    jg, g = graphs(rng)
    if mode == "arrays":
        src, dst, w = _padded_arrays(rng)
        return (jgl.diff_conv_support_from_arrays(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), N),
            diff_conv_support_from_arrays(t(src), t(dst), t(w), N))
    return (jgl.diff_conv_support(jg, operator_mode=mode),
            diff_conv_support(g, operator_mode=mode, device="cpu"))


@pytest.mark.parametrize("mode", ["dense", "coo", "bsr", "arrays"])
@pytest.mark.parametrize("root_weight", [True, False])
def test_diff_conv_forward_and_gradient_match(rng, mode, root_weight):
    jsup, sup = _supports(rng, mode)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    g_out = rng.standard_normal((B, N, H)).astype(np.float32)
    jm = jgl.DiffConv(H, 2, root_weight)
    tm = DiffConv(C, H, 2, root_weight)
    params = carry(jm, tm, jnp.asarray(x), jsup)
    xt = t(x).requires_grad_(True)
    out = tm(xt, sup)
    rel_close(out.detach(), jm.apply(params, jnp.asarray(x), jsup))
    (out * t(g_out)).sum().backward()
    jgp, jgx = jax.grad(lambda p, v: (jm.apply(p, v, jsup) * g_out).sum(),
                        argnums=(0, 1))(params, jnp.asarray(x))
    rel_close(xt.grad, jgx, name="dx")
    compare_tree(tm, jgp, grads=True)


def test_diff_conv_shared_hops_are_the_same_values(rng):
    """``hops=`` short-circuits the products with the same values."""
    _, sup = _supports(rng, "coo")
    x = t(rng.standard_normal((B, N, C)).astype(np.float32))
    tm = DiffConv(C, H, 2)
    torch.testing.assert_close(tm(x, sup, hops=DiffConv.hops(x, sup, 2)),
                               tm(x, sup), rtol=0, atol=0)


@pytest.mark.parametrize("skip", [False, True])
def test_conditional_block_matches(rng, skip):
    x = rng.standard_normal((B, S, N, C)).astype(np.float32)
    u = rng.standard_normal((B, S, N, U)).astype(np.float32)
    jm = jgl.ConditionalBlock(H, skip_connection=skip)
    tm = ConditionalBlock(C, U, H, skip_connection=skip)
    params = carry(jm, tm, x, u)
    rel_close(tm(t(x), t(u)).detach(), jm.apply(params, x, u))


@pytest.mark.parametrize("root_weight,use_bias", [(True, True),
                                                  (False, False)])
def test_graph_conv_matches(rng, root_weight, use_bias):
    jg, g = graphs(rng)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    jop = jgl.build_operator(jgl.normalize_adj(jg, "row"), "coo")
    op = diff_conv_support(g, False, "coo", device="cpu")[0]
    jm = jgl.GraphConv(H, root_weight, use_bias)
    tm = GraphConv(C, H, root_weight, use_bias)
    params = jm.init(jax.random.PRNGKey(0), x, jop)
    # flax draws no bias value: give it one so the test sees it
    if use_bias:
        params = jax.tree.map(lambda a: a, params)
        params["params"]["bias"] = jnp.asarray(
            rng.standard_normal(H).astype(np.float32))
    flax_to_torch(jax.tree.map(np.asarray, params), tm)
    rel_close(tm(t(x), op).detach(), jm.apply(params, x, jop))


def _dcrnn_batch(rng, window=S):
    return {"x": rng.standard_normal((B, window, N, C)).astype(np.float32),
            "u": rng.standard_normal((B, window, U)).astype(np.float32),
            "y": rng.standard_normal((B, 3, N, C)).astype(np.float32),
            "mask": rng.random((B, 3, N, C)) > 0.2}


@pytest.mark.parametrize("exog,mode", [(True, "bsr"), (False, "dense"),
                                       (True, "arrays")])
def test_dcrnn_model_forward_matches(rng, exog, mode):
    jsup, sup = _supports(rng, mode)
    batch = _dcrnn_batch(rng)
    u = batch["u"] if exog else None
    jm = JDCRNNModel(H, H, C, 3, n_layers=2, exog_size=U if exog else 0)
    tm = DCRNNModel(C, H, H, C, 3, n_layers=2, exog_size=U if exog else 0)
    params = carry(jm, tm, batch["x"], jsup, u=u)
    got = tm(t(batch["x"]), sup, u=None if u is None else t(u))
    assert got.shape == (B, 3, N, C)
    rel_close(got.detach(), jm.apply(params, batch["x"], jsup, u=u))


def test_dcrnn_predictor_step_matches(rng):
    """A ``Predictor`` step of ``DCRNNModel`` on the runners' call, BSR
    supports (K1's plain version on the CPU)."""
    jsup, sup = _supports(rng, "bsr")

    def call(batch, training):
        return (batch["x"], batch["supports"]), {"u": batch.get("u"),
                                                 "training": training}
    predictor_step_matches(
        JDCRNNModel(H, H, C, 3, exog_size=U), DCRNNModel(C, H, H, C, 3,
                                                         exog_size=U),
        _dcrnn_batch(rng), call, call, {"supports": jsup},
        {"supports": sup})
