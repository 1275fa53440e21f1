"""The port's fused IID training and fused evaluation against the JAX
package's, on the same numpy inputs and the same flax weights
(``flax_to_torch``).

Sampling streams cannot match across the frameworks, so the port's
gather-and-loss core takes the JAX package's (time, node) draws.

Tolerances: packing bit for bit (``uint16`` views) against a numpy
reference, and against the JAX package everywhere but at the low halves
that read as a bf16 NaN, whose payload the JAX package's CPU backend
replaces by the canonical NaN (so its targets lose up to 63 f32 ulps
there; the port keeps every bit). The loss and gradients of a step at 1e-5
relative to each tensor's largest value; the parameters after 4 clipped
Adam steps at 1e-5 absolute (lr 1e-3); the fused evaluation's metrics at
1e-5 relative. With ``compute_dtype=torch.bfloat16`` both packages round
every product and activation to bf16 (2^-8 relative), not at the same
places: the first loss at 2e-3 relative (measured 2.2e-4) and its
gradients at 5e-2 of each tensor's largest value (measured 1.9e-2); the
weights after that step at 1e-5 where the gradient lies beyond 5e-2 of its
tensor's largest, and within one step the other way (2 lr) elsewhere (an
Adam step moves a weight by about lr times its gradient's sign); the
losses of 6 more steps at 5e-3 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sgp_tpu.data.scalers import ScalerParams as JScalerParams
from sgp_tpu.models import SGPModel as JSGPModel
from sgp_tpu.train.fused_window import make_fused_eval as j_fused_eval
from sgp_tpu.train.iid import make_fused_iid_multi_step as j_multi_step
from sgp_tpu.train.iid import make_fused_iid_step as j_step
from sgp_tpu.train.iid import pack_iid_data as j_pack
from sgp_tpu.train.iid import unpack_iid_rows as j_unpack
from sgp_tpu.train.metrics import MaskedMetrics as JMetrics

from sgp_tpu_torch.data import SpatioTemporalDataset, Windowing
from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.models import SGPModel, flax_to_torch
from sgp_tpu_torch.models.bridge import targets
from sgp_tpu_torch.train import MaskedMetrics
from sgp_tpu_torch.train.fused_window import (make_fused_eval,
                                              make_offset_gather,
                                              pad_eval_items)
from sgp_tpu_torch.train.iid import (fused_iid_inputs,
                                     make_fused_iid_multi_step,
                                     make_fused_iid_step, pack_iid_data,
                                     unpack_iid_rows)

torch.set_num_threads(1)

T, N, D, C = 40, 12, 8, 1
H_OFF = np.array([1, 3, 5])
BATCH = 24
CLIP = 0.5
TOL = 1e-5


def _targets(rng):
    """Targets with negative values, subnormals, zeros under the mask,
    and low halves that read as bf16 NaNs."""
    y = (rng.standard_normal((T, N, C)) * 20).astype(np.float32)
    y.flat[::17] = np.float32(1e-40)                  # subnormal
    y.flat[5::23] = -np.float32(3e-39)
    bits = y.view(np.uint32)
    bits.flat[3::11] = (bits.flat[3::11] & 0xFFFF0000) | 0x7FA5
    mask = rng.random((T, N, C)) > 0.25
    return np.where(mask, y, np.float32(0)), mask


def _numpy_pack(enc_bf16_bits, y, mask):
    """The packed layout from its definition, in numpy: the f32 bits split
    into high and low halves, the mask as bf16 1.0 (0x3F80) or 0."""
    ys = np.stack([np.roll(y, -int(h), 0) for h in H_OFF], axis=2)
    ms = np.stack([np.roll(mask, -int(h), 0) for h in H_OFF], axis=2)
    v = ys.view(np.uint32).reshape(T, N, -1)
    return np.concatenate(
        [enc_bf16_bits, (v >> 16).astype(np.uint16),
         (v & 0xFFFF).astype(np.uint16),
         np.where(ms.reshape(T, N, -1), 0x3F80, 0).astype(np.uint16)], -1)


def _u16(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _bf16_nan(u):
    return ((u & 0x7F80) == 0x7F80) & ((u & 0x7F) != 0)


def test_pack_and_unpack_bit_exact(rng):
    y, mask = _targets(rng)
    enc = rng.standard_normal((T, N, D)).astype(np.float32)
    got = pack_iid_data(torch.as_tensor(enc), torch.as_tensor(y),
                        torch.as_tensor(mask), H_OFF)
    enc_bits = _u16(torch.as_tensor(enc).to(torch.bfloat16))
    want = _numpy_pack(enc_bits, y, mask)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_array_equal(_u16(got), want)
    # JAX packs the same bits, but for the NaN-patterned low halves
    jax_bits = _u16(j_pack(jnp.asarray(enc), jnp.asarray(y),
                           jnp.asarray(mask), H_OFF))
    differ = jax_bits != want
    assert _bf16_nan(want[differ]).all()
    assert differ.sum() <= _bf16_nan(want).sum()
    # every row unpacks to the exact f32 targets and the mask
    rows = got.reshape(T * N, -1)
    x, yy, mm = unpack_iid_rows(rows, D, len(H_OFF), C)
    ys = np.stack([np.roll(y, -int(h), 0) for h in H_OFF], 2)
    ms = np.stack([np.roll(mask, -int(h), 0) for h in H_OFF], 2)
    np.testing.assert_array_equal(
        yy.numpy().view(np.uint32), ys.reshape(T * N, -1, C).view(np.uint32))
    np.testing.assert_array_equal(mm.numpy(), ms.reshape(T * N, -1, C))
    np.testing.assert_array_equal(_u16(x), enc_bits.reshape(T * N, D))
    # and JAX's unpack of the port's rows reads the same targets
    _, jy, jm = j_unpack(jnp.asarray(_u16(rows)).view(jnp.bfloat16), D,
                         len(H_OFF), C)
    np.testing.assert_array_equal(np.asarray(jy).view(np.uint32),
                                  yy.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jm), mm.numpy())


def test_index_nodes_iid_matches_jax(rng):
    bias = rng.standard_normal((1, N, C)).astype(np.float32)
    scale = rng.random((1, N, C)).astype(np.float32) + 0.5
    n = rng.integers(0, N, BATCH)
    for b, s in ((bias, scale), (bias[:, :1], scale[:, :1])):
        jp = JScalerParams(jnp.asarray(b), jnp.asarray(s)).index_nodes_iid(
            jnp.asarray(n))
        tp = ScalerParams(torch.as_tensor(b), torch.as_tensor(s)
                          ).index_nodes_iid(torch.as_tensor(n))
        np.testing.assert_array_equal(tp.bias.numpy(), np.asarray(jp.bias))
        np.testing.assert_array_equal(tp.scale.numpy(),
                                      np.asarray(jp.scale))


def _problem(rng, u_kind):
    y, mask = _targets(rng)
    y = np.where(np.isfinite(y) & (np.abs(y) < 1e3), y, 0).astype(np.float32)
    enc = rng.standard_normal((T, N, D)).astype(np.float32)
    enc = torch.as_tensor(enc).to(torch.bfloat16).float().numpy()
    u = {"none": None,
         "node": rng.standard_normal((T, N, 2)).astype(np.float32),
         "global": rng.standard_normal((T, 3)).astype(np.float32)}[u_kind]
    bias = (rng.standard_normal((1, N, C)) * 5).astype(np.float32)
    scale = (rng.random((1, N, C)) * 10 + 5).astype(np.float32)
    valid = np.arange(T - int(H_OFF[-1]) - 1)
    return enc, y, mask, u, bias, scale, valid


def _models(u, seed=0):
    kw = dict(input_size=D, order=4, n_nodes=N, hidden_size=12,
              mlp_size=8, output_size=C, n_layers=2, horizon=len(H_OFF),
              resnet=True, exog_size=0 if u is None else u.shape[-1])
    jm = JSGPModel(**kw)
    key = jax.random.PRNGKey(seed)
    params = jm.init({"params": key, "dropout": key}, jnp.zeros((4, D)),
                     node_index=jnp.zeros(4, jnp.int32), iid=True,
                     **({} if u is None else
                        {"u": jnp.zeros((4, u.shape[-1]))}))
    tm = SGPModel(**kw)
    flax_to_torch(jax.tree.map(np.asarray, params), tm)
    return jm, params, tm


def _draws(key, valid, n_range, count):
    """The JAX step's draws from its key."""
    rng_t, rng_n = jax.random.split(key, 3)[:2]
    t = jax.random.choice(rng_t, jnp.asarray(valid), (count,))
    n = jax.random.randint(rng_n, (count,), 0, n_range)
    return (torch.as_tensor(np.array(t), dtype=torch.long),
            torch.as_tensor(np.array(n), dtype=torch.long))


def _rel(got, want, tol, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (name, err)


LAYOUTS = [
    dict(packed=False, u="node"),
    dict(packed=True, u="node"),
    dict(packed=True, u="global", gather_block=2),
    dict(packed=True, u="none", gather_block=3, node_perm=True),
]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: "-".join(
    f"{k}={v}" for k, v in lay.items()))
def test_fused_step_matches_jax(rng, layout):
    """One step's loss and gradients on the JAX step's draws, then the
    parameters after 4 clipped Adam steps."""
    enc, y, mask, u, bias, scale, valid = _problem(rng, layout["u"])
    g = layout.get("gather_block", 1)
    perm = rng.permutation(N) if layout.get("node_perm") else None
    jm, params, tm = _models(u)
    if perm is None:
        arrays = (enc, y, mask, u)
    else:   # the packed layout's node axis in perm's order
        arrays = (enc[:, perm], y[:, perm], mask[:, perm], u)
    common = dict(batch_size=BATCH, packed=layout["packed"],
                  gather_block=g, node_perm=perm)
    jopt = optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(1e-3))
    jstep = j_step(jm, jopt, jnp.asarray(arrays[0], jnp.bfloat16),
                   jnp.asarray(arrays[1]), jnp.asarray(arrays[2]),
                   jnp.asarray(valid), jnp.asarray(H_OFF),
                   JScalerParams(jnp.asarray(bias), jnp.asarray(scale)),
                   u=None if u is None else jnp.asarray(u), **common)
    topt = torch.optim.Adam(tm.parameters(), lr=1e-3, eps=1e-8)
    tstep = make_fused_iid_step(
        tm, topt, torch.as_tensor(arrays[0]).to(torch.bfloat16),
        torch.as_tensor(arrays[1]), torch.as_tensor(arrays[2]), valid,
        H_OFF, ScalerParams(torch.as_tensor(bias), torch.as_tensor(scale)),
        u=None if u is None else torch.as_tensor(u), grad_clip=CLIP,
        **common)
    assert tstep.packed == layout["packed"]

    key = jax.random.PRNGKey(7)
    snl = jstep.sample_and_loss
    sampled = snl.sample(key, jstep.data)
    jloss, jgrad = jax.value_and_grad(
        lambda p: snl.loss(p, sampled, key))(params)
    t, n = _draws(key, valid, N // g, BATCH // g)
    tloss = tstep.sample_and_loss.loss(t, n)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=TOL)
    jgrad = jax.tree.map(np.asarray, jgrad)["params"]
    named = targets(tm)
    for path, (param, transpose) in named.items():
        want = jgrad
        for k in path:
            want = want[k]
        _rel(param.grad.numpy(), want.T if transpose else want, TOL,
             "/".join(path))

    opt_state = jopt.init(params)
    for i in range(4):
        k = jax.random.PRNGKey(100 + i)
        params, opt_state, _ = jstep(params, opt_state, k)
        tstep.train_on(*_draws(k, valid, N // g, BATCH // g))
    jp = jax.tree.map(np.asarray, params)["params"]
    for path, (param, transpose) in named.items():
        want = jp
        for k in path:
            want = want[k]
        np.testing.assert_allclose(
            param.detach().numpy(), want.T if transpose else want,
            rtol=0, atol=TOL, err_msg="/".join(path))


def test_multi_step_is_the_mean_of_single_steps(rng):
    enc, y, mask, u, bias, scale, valid = _problem(rng, "node")
    losses = []
    for steps in (1, 3):
        _, _, tm = _models(u)
        opt = torch.optim.Adam(tm.parameters(), lr=1e-3, eps=1e-8)
        args = (tm, opt, torch.as_tensor(enc).to(torch.bfloat16),
                torch.as_tensor(y), torch.as_tensor(mask), valid, H_OFF,
                ScalerParams(torch.as_tensor(bias), torch.as_tensor(scale)))
        kw = dict(u=torch.as_tensor(u), batch_size=BATCH, packed=True,
                  grad_clip=CLIP)
        gen = torch.Generator().manual_seed(3)
        if steps == 1:
            step = make_fused_iid_step(*args, **kw)
            losses.append([float(step(gen)) for _ in range(3)])
        else:
            multi = make_fused_iid_multi_step(*args, steps_per_call=3, **kw)
            losses.append(float(multi(gen)))
            assert multi.packed
    np.testing.assert_allclose(losses[1], np.mean(losses[0]), rtol=1e-6)


def test_step_options_refused(rng):
    enc, y, mask, u, bias, scale, valid = _problem(rng, "none")
    _, _, tm = _models(None)
    opt = torch.optim.Adam(tm.parameters())
    args = (tm, opt, torch.as_tensor(enc).to(torch.bfloat16),
            torch.as_tensor(y), torch.as_tensor(mask), valid, H_OFF,
            ScalerParams(torch.as_tensor(bias), torch.as_tensor(scale)))
    with pytest.raises(ValueError, match="packed"):
        make_fused_iid_step(*args, gather_block=2)
    with pytest.raises(ValueError, match="divide"):
        make_fused_iid_step(*args, packed=True, gather_block=5)
    with pytest.raises(ValueError, match="node_perm"):
        make_fused_iid_step(*args, node_perm=np.arange(N))
    # an f32 encoding is not packed (packing would round it to bf16)
    f32 = make_fused_iid_step(tm, opt, torch.as_tensor(enc), *args[3:],
                              packed=True)
    assert not f32.packed


def _path_value(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_bf16_compute_matches_jax(rng, multi):
    """``compute_dtype=torch.bfloat16`` on the fused step and the
    multi-step call, on the JAX package's bf16 steps' draws and the same
    weights: the decoder sees bf16 inputs, the parameters and their
    gradients stay f32. The first step's loss, gradients and weights, then
    2 calls of 3 steps (or 6 single steps), against the JAX package's."""
    enc, y, mask, u, bias, scale, valid = _problem(rng, "node")
    jm, params, tm = _models(u)
    per_call = 3 if multi else 1
    common = dict(batch_size=BATCH, packed=True)
    jopt = optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(1e-3))
    jargs = (jnp.asarray(enc, jnp.bfloat16), jnp.asarray(y),
             jnp.asarray(mask), jnp.asarray(valid), jnp.asarray(H_OFF),
             JScalerParams(jnp.asarray(bias), jnp.asarray(scale)))
    jsingle = j_step(jm, jopt, *jargs, u=jnp.asarray(u),
                     compute_dtype=jnp.bfloat16, **common)
    jcall = j_multi_step(jm, jopt, *jargs, u=jnp.asarray(u),
                         compute_dtype=jnp.bfloat16, steps_per_call=per_call,
                         **common) if multi else jsingle
    topt = torch.optim.Adam(tm.parameters(), lr=1e-3, eps=1e-8)
    targs = (torch.as_tensor(enc).to(torch.bfloat16), torch.as_tensor(y),
             torch.as_tensor(mask), valid, H_OFF,
             ScalerParams(torch.as_tensor(bias), torch.as_tensor(scale)))
    kw = dict(u=torch.as_tensor(u), grad_clip=CLIP,
              compute_dtype=torch.bfloat16, **common)
    if multi:
        call = make_fused_iid_multi_step(tm, topt, *targs,
                                         steps_per_call=per_call, **kw)
        tstep = call.single
    else:
        tstep = make_fused_iid_step(tm, topt, *targs, **kw)
    seen = []
    tm.encoder.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].dtype))

    # the first step from the same weights on the same draws
    key = jax.random.PRNGKey(7)
    snl = jsingle.sample_and_loss
    sampled = snl.sample(key, jsingle.data)
    jloss, jgrad = jax.value_and_grad(
        lambda p: snl.loss(p, sampled, key))(params)
    draws = _draws(key, valid, N, BATCH)
    tloss = tstep.sample_and_loss.loss(*draws)
    tloss.backward()
    assert seen == [torch.bfloat16] and tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=2e-3)
    jgrad = jax.tree.map(np.asarray, jgrad)["params"]
    named = targets(tm)
    for path, (param, transpose) in named.items():
        want = _path_value(jgrad, path)
        assert param.dtype == param.grad.dtype == torch.float32
        _rel(param.grad.numpy(), want.T if transpose else want, 5e-2,
             "/".join(path))
    tstep.train_on(*draws)
    params, opt_state, _ = jsingle(params, jopt.init(params), key)
    # Adam's first step moves a weight by lr times its gradient's sign: the
    # same step where the gradient lies beyond the gradients' tolerance of
    # 0, at most one step the other way elsewhere
    jp = jax.tree.map(np.asarray, params)["params"]
    for path, (param, transpose) in named.items():
        g, w = _path_value(jgrad, path), _path_value(jp, path)
        g, w = (g.T, w.T) if transpose else (g, w)
        sure = np.abs(g) > 5e-2 * np.abs(g).max()
        diff = np.abs(param.detach().numpy() - w)
        assert diff[sure].max(initial=0) <= TOL, "/".join(path)
        assert diff.max() <= 2e-3 + TOL, "/".join(path)

    for c in range(6 // per_call):
        k = jax.random.PRNGKey(100 + c)
        params, opt_state, jl = jcall(params, opt_state, k)
        keys = jax.random.split(k, per_call) if multi else [k]
        tl = torch.stack([tstep.train_on(*_draws(kk, valid, N, BATCH))
                          for kk in keys]).mean()
        np.testing.assert_allclose(float(tl), float(jl), rtol=5e-3)


@pytest.mark.parametrize("x_slice", [False, True], ids=["encoding",
                                                        "packed-rows"])
@pytest.mark.parametrize("u_kind", ["node", "global"])
def test_fused_eval_matches_jax(rng, x_slice, u_kind):
    """22 items in batches of 8: the last batch padded with 2 slots that
    must drop out of every metric."""
    enc, y, mask, u, bias, scale, valid = _problem(rng, u_kind)
    jm, params, tm = _models(u)
    items = np.arange(3, 25)
    w_off = np.array([0])
    x_full = pack_iid_data(torch.as_tensor(enc), torch.as_tensor(y),
                           torch.as_tensor(mask), H_OFF) \
        if x_slice else torch.as_tensor(enc)
    jx = jnp.asarray(_u16(x_full)).view(jnp.bfloat16) if x_slice \
        else jnp.asarray(enc)
    want = j_fused_eval(
        jm, jx, jnp.asarray(y), jnp.asarray(mask), items, jnp.asarray(w_off),
        jnp.asarray(H_OFF), JScalerParams(jnp.asarray(bias),
                                          jnp.asarray(scale)),
        JMetrics.forecasting(), u=jnp.asarray(u), batch_size=8,
        x_slice=D if x_slice else None)(params)
    got = make_fused_eval(
        tm, x_full, torch.as_tensor(y), torch.as_tensor(mask), items, w_off,
        H_OFF, ScalerParams(torch.as_tensor(bias), torch.as_tensor(scale)),
        MaskedMetrics.forecasting(), u=torch.as_tensor(u), batch_size=8,
        x_slice=D if x_slice else None)()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)


def test_eval_helpers():
    starts, valid = pad_eval_items(np.arange(5, 12), 3)
    assert starts.tolist() == [[5, 6, 7], [8, 9, 10], [11, 5, 5]]
    assert valid.tolist() == [[True] * 3, [True] * 3, [True, False, False]]
    arr = torch.arange(20).reshape(10, 2)
    g = make_offset_gather([0, 2])
    assert g(arr, torch.tensor([1, 3])).tolist() == [[[2, 3], [6, 7]],
                                                     [[6, 7], [10, 11]]]


def test_fused_iid_inputs(rng):
    y = rng.standard_normal((T, N, C)).astype(np.float32)
    ds = SpatioTemporalDataset(y, covariates={"u": rng.standard_normal(
        (T, 2)).astype(np.float32)}, windowing=Windowing(horizon=6,
                                                         horizon_lag=2))
    ds.add_covariate("encoded_x", rng.standard_normal((T, N, D)))
    ds.set_input_keys(["encoded_x"])
    enc, tgt, mask, valid, h_off, u = fused_iid_inputs(ds, device="cpu")
    assert enc.shape == (T, N, D) and enc.dtype == torch.float32
    np.testing.assert_array_equal(tgt.numpy(), y)
    assert mask.dtype == torch.bool and u.shape == (T, 2)
    np.testing.assert_array_equal(valid.numpy(), ds.indices())
    np.testing.assert_array_equal(h_off.numpy(), H_OFF)
