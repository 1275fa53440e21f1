"""The port's multi-trial fused IID training against the JAX package's, on
the CPU, at ``tests/test_multi_trial.py``'s sizes (60 steps, 10 nodes, 6
features, horizon 2, batch 16, 3 steps a call).

K = 4 trials (2 lr x 2 seeds) start from the JAX package's stacked initial
weights (``flax_trials_to_torch``) and take its (time, node) draws.
Tolerances: each trial's mean loss at 1e-5 relative and its weights at
1e-5 absolute (lr up to 1e-2); the port's trials against K single-trial
port steps at 1e-5 relative and 1e-6 absolute (``torch.optim.Adam``
divides by ``sqrt(nu) / sqrt(1 - b2^t)`` where optax takes ``sqrt(nu / (1
- b2^t))``: 2e-7 apart after 3 steps at lr 1e-2); ``eval_trials`` against a
per-trial ``make_fused_eval`` at 1e-6 relative. With
``compute_dtype=torch.bfloat16`` (the forward and backward in bf16, f32
master weights and gradients) both packages round every product and
activation to bf16 (2^-8 relative), but not at the same places, and an
Adam step moves a weight by about lr whatever the size of its gradient:
the losses at 5e-3 relative (measured 6.3e-4), and each weight tensor's
distance from the JAX package's at most 0.2 of its distance from the
initial weights (measured 0.085; an f32 run lies as far from the JAX bf16
run, so the test also checks that the decoder ran in bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.data import ScalerParams as JScalerParams
from sgp_tpu.models import SGPModel as JSGPModel
from sgp_tpu.train.multi_trial import init_trial_params as j_init
from sgp_tpu.train.multi_trial import \
    make_fused_iid_multi_trial_step as j_step

from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.models import SGPModel
from sgp_tpu_torch.models.bridge import flax_trials_to_torch
from sgp_tpu_torch.train import MaskedMetrics
from sgp_tpu_torch.train.fused_window import make_fused_eval
from sgp_tpu_torch.train.iid import make_fused_iid_step
from sgp_tpu_torch.train.multi_trial import (best_trial, eval_trials,
                                             init_trial_params, load_trial,
                                             make_fused_iid_multi_trial_step,
                                             take_trial)

torch.set_num_threads(1)

T, N, D, H = 60, 10, 6, 2
BATCH, STEPS = 16, 3
LRS, SEEDS = (1e-2, 1e-3), (0, 1)
TRIALS = [(lr, s) for lr in LRS for s in SEEDS]
TOL = 1e-5
TOL_BF16_LOSS, TOL_BF16_MOVE = 5e-3, 0.2
KW = dict(input_size=D, order=2, n_nodes=N, hidden_size=12, mlp_size=8,
          output_size=1, n_layers=1, horizon=H, positional_encoding=True)


def _data(rng):
    enc = rng.standard_normal((T, N, D)).astype(np.float32)
    enc = torch.as_tensor(enc).to(torch.bfloat16).float().numpy()
    tgt = rng.standard_normal((T, N, 1)).astype(np.float32)
    msk = rng.random((T, N, 1)) > 0.1
    return enc, tgt, msk, np.arange(T - H - 1), 1 + np.arange(H)


def _jax_stack():
    ex = {"x": jnp.zeros((4, D)), "node_index": jnp.zeros(4, jnp.int32),
          "iid": True}
    return j_init(JSGPModel(**KW), [s for _, s in TRIALS], ex)


def _draws(key, valid):
    """The JAX multi-trial step's draws a call: ``split(key, steps)`` step
    keys, each split into (t, n, dropout)."""
    out = []
    for step_key in jax.random.split(key, STEPS):
        rng_t, rng_n = jax.random.split(step_key, 3)[:2]
        t = jax.random.choice(rng_t, jnp.asarray(valid), (BATCH,))
        n = jax.random.randint(rng_n, (BATCH,), 0, N)
        out.append((torch.as_tensor(np.array(t), dtype=torch.long),
                    torch.as_tensor(np.array(n), dtype=torch.long)))
    return out


def _steps(rng, packed, compute_dtype=None):
    enc, tgt, msk, valid, h_off = _data(rng)
    jstack = _jax_stack()
    jenc = jnp.asarray(enc, jnp.bfloat16 if packed else jnp.float32)
    jstep = j_step(JSGPModel(**KW), jenc, jnp.asarray(tgt), jnp.asarray(msk),
                   jnp.asarray(valid), jnp.asarray(h_off),
                   JScalerParams(jnp.zeros(1), 2.0 * jnp.ones(1)),
                   [lr for lr, _ in TRIALS], batch_size=BATCH,
                   steps_per_call=STEPS, packed=packed,
                   compute_dtype=None if compute_dtype is None
                   else jnp.bfloat16)
    model = SGPModel(**KW)
    stack = flax_trials_to_torch(jax.tree.map(np.asarray, jstack), model)
    tenc = torch.as_tensor(enc).to(torch.bfloat16 if packed
                                   else torch.float32)
    tstep = make_fused_iid_multi_trial_step(
        model, tenc, torch.as_tensor(tgt), torch.as_tensor(msk), valid,
        h_off, ScalerParams(torch.zeros(1), 2.0 * torch.ones(1)),
        [lr for lr, _ in TRIALS], batch_size=BATCH, steps_per_call=STEPS,
        packed=packed, compute_dtype=compute_dtype)
    return jstep, jstack, tstep, stack, model, valid


def _jax_trial_params(jstack, model, k):
    """Trial k's JAX weights in the port's names."""
    one = jax.tree.map(lambda a: np.asarray(a)[k:k + 1], jstack)
    return take_trial(flax_trials_to_torch(one, model), 0)


def _run_both(rng, packed, compute_dtype=None, calls=2):
    """``calls`` calls of both steps: ``([(jax losses, port losses)] a
    call, the JAX stack, the port's stack, the port's model)``."""
    jstep, jstack, tstep, stack, model, valid = _steps(rng, packed,
                                                       compute_dtype)
    jopt, opt = jstep.init_opt(jstack), tstep.init_opt(stack)
    out = []
    for c in range(calls):
        key = jax.random.PRNGKey(20 + c)
        jstack, jopt, jl = jstep(jstack, jopt, key)
        losses = []
        for t, n in _draws(key, valid):
            stack, opt, loss_k = tstep.train_on(stack, opt, t, n)
            losses.append(loss_k)
        out.append((np.asarray(jl), torch.stack(losses).mean(0).numpy()))
    return out, jstack, stack, model


@pytest.mark.parametrize("packed", [False, True])
def test_multi_trial_matches_jax(rng, packed):
    """Two calls of 3 steps: each trial's mean loss a call, then its
    weights, against the JAX package's vmapped step."""
    calls, jstack, stack, model = _run_both(rng, packed)
    for jl, tl in calls:
        assert tl.shape == (len(TRIALS),)
        np.testing.assert_allclose(tl, jl, rtol=TOL)
    for k in range(len(TRIALS)):
        want = _jax_trial_params(jstack, model, k)
        for name, v in want.items():
            np.testing.assert_allclose(stack[name][k].numpy(), v.numpy(),
                                       rtol=0, atol=TOL,
                                       err_msg=f"trial {k} {name}")


def test_multi_trial_bf16_compute_matches_jax(rng):
    """``compute_dtype=torch.bfloat16``: the decoder sees bf16 inputs and
    weights; the stacked weights and the Adam moments stay f32; losses and
    weights within a bf16 tolerance of the JAX package's bf16 step."""
    calls, jstack, stack, model = _run_both(rng, True, torch.bfloat16)
    _, _, tstep, init, fresh, valid = _steps(np.random.default_rng(0),
                                             True, torch.bfloat16)
    seen = []
    fresh.encoder.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].dtype))
    tstep.train_on(init, tstep.init_opt(init), *_draws(
        jax.random.PRNGKey(0), valid)[0])
    assert seen == [torch.bfloat16]
    for jl, tl in calls:
        np.testing.assert_allclose(tl, jl, rtol=TOL_BF16_LOSS)
    assert all(v.dtype == torch.float32 for v in stack.values())
    for k in range(len(TRIALS)):
        want = _jax_trial_params(jstack, model, k)
        for name, v in want.items():
            moved = float((v - init[name][k]).norm())
            off = float((stack[name][k] - v).norm())
            assert off <= TOL_BF16_MOVE * moved, (k, name, off / moved)


@pytest.mark.parametrize("packed", [False, True])
def test_multi_trial_matches_single_trials(rng, packed):
    """Trial k of the multi-trial step equals the single-trial step with
    clip + Adam(lr_k) from the same weights on the same draws."""
    enc, tgt, msk, valid, h_off = _data(rng)
    tenc = torch.as_tensor(enc).to(torch.bfloat16 if packed
                                   else torch.float32)
    args = (tenc, torch.as_tensor(tgt), torch.as_tensor(msk), valid, h_off,
            ScalerParams(torch.zeros(1), 2.0 * torch.ones(1)))
    stack = init_trial_params(lambda g: SGPModel(**KW, generator=g),
                              [s for _, s in TRIALS])
    step = make_fused_iid_multi_trial_step(
        SGPModel(**KW), *args, [lr for lr, _ in TRIALS], batch_size=BATCH,
        steps_per_call=STEPS, packed=packed)
    gen = torch.Generator().manual_seed(9)
    draws = [step.sample_and_loss.sample(gen) for _ in range(STEPS)]
    p, opt = stack, step.init_opt(stack)
    losses = []
    for t, n in draws:
        p, opt, loss_k = step.train_on(p, opt, t, n)
        losses.append(loss_k)
    losses = torch.stack(losses).mean(0)
    for k, (lr, seed) in enumerate(TRIALS):
        m = SGPModel(**KW, generator=torch.Generator().manual_seed(seed))
        single = make_fused_iid_step(
            m, torch.optim.Adam(m.parameters(), lr=lr, eps=1e-8), *args,
            batch_size=BATCH, packed=packed, grad_clip=5.0)
        ls = [float(single.train_on(t, n)) for t, n in draws]
        np.testing.assert_allclose(float(losses[k]), np.mean(ls), rtol=TOL)
        for name, v in m.named_parameters():
            np.testing.assert_allclose(p[name][k].numpy(),
                                       v.detach().numpy(), rtol=TOL,
                                       atol=1e-6, err_msg=name)


def test_packed_and_unpacked_trials_agree(rng):
    """On bf16 rows with a node-level u, the packed and the unpacked input
    give the port's trials the same losses and weights bit for bit (the
    same features, targets and masks; the same sums)."""
    enc, tgt, msk, valid, h_off = _data(rng)
    u = torch.as_tensor(rng.standard_normal((T, N, 1)).astype(np.float32))
    kw = dict(KW, exog_size=1)
    stack = init_trial_params(lambda g: SGPModel(**kw, generator=g), [0, 1])
    gen = torch.Generator().manual_seed(2)
    out = []
    for packed in (False, True):
        step = make_fused_iid_multi_trial_step(
            SGPModel(**kw), torch.as_tensor(enc).to(torch.bfloat16),
            torch.as_tensor(tgt), torch.as_tensor(msk), valid, h_off,
            ScalerParams(torch.zeros(1), torch.ones(1)), [1e-2, 1e-3],
            u=u, batch_size=BATCH, steps_per_call=STEPS, packed=packed)
        if not out:
            draws = [step.sample_and_loss.sample(gen) for _ in range(4)]
        p, opt = stack, step.init_opt(stack)
        losses = []
        for t, n in draws:
            p, opt, loss_k = step.train_on(p, opt, t, n)
            losses.append(loss_k)
        out.append((torch.stack(losses), p))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(out[0][1][k], out[1][1][k]) for k in stack)


def test_multi_trial_call_and_inputs(rng):
    """A call draws its own batches and returns each trial's mean loss;
    the step never changes the stacked tensors it is given."""
    enc, tgt, msk, valid, h_off = _data(rng)
    stack = init_trial_params(lambda g: SGPModel(**KW, generator=g), [0, 1])
    before = {k: v.clone() for k, v in stack.items()}
    step = make_fused_iid_multi_trial_step(
        SGPModel(**KW), torch.as_tensor(enc), torch.as_tensor(tgt),
        torch.as_tensor(msk), valid, h_off,
        ScalerParams(torch.zeros(1), torch.ones(1)), [1e-2, 1e-3],
        batch_size=BATCH, steps_per_call=STEPS)
    p, opt, losses = step(stack, step.init_opt(stack),
                          torch.Generator().manual_seed(0))
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    assert int(opt["count"]) == STEPS
    assert all(torch.equal(before[k], stack[k]) for k in stack)
    assert all(not torch.equal(p[k], stack[k]) for k in stack)


def test_init_trial_params_matches_per_seed():
    seeds = [3, 7, 11]
    stack = init_trial_params(lambda g: SGPModel(**KW, generator=g), seeds)
    for k, s in enumerate(seeds):
        ref = SGPModel(**KW, generator=torch.Generator().manual_seed(s))
        got = take_trial(stack, k)
        for name, v in ref.named_parameters():
            assert torch.equal(got[name], v.detach()), name


def test_eval_trials_matches_per_trial_eval(rng):
    enc, tgt, msk, valid, h_off = _data(rng)
    stack = init_trial_params(lambda g: SGPModel(**KW, generator=g), [4, 5])
    model = SGPModel(**KW)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    ev = make_fused_eval(model, torch.as_tensor(enc), torch.as_tensor(tgt),
                         torch.as_tensor(msk), np.arange(40), np.array([0]),
                         h_off, ScalerParams(torch.zeros(1),
                                             2.0 * torch.ones(1)),
                         MaskedMetrics.forecasting(), batch_size=8)
    got = eval_trials(ev, model, stack)
    assert got["mae"].shape == (2,)
    assert all(torch.equal(v, saved[k])
               for k, v in model.state_dict().items())
    for k in range(2):
        load_trial(model, stack, k)
        want = ev()
        for name in want:
            np.testing.assert_allclose(got[name][k], want[name], rtol=1e-6,
                                       err_msg=name)
    assert best_trial(got, "mae") == int(np.argmin(got["mae"]))
    assert best_trial(got, "mae", minimize=False) == int(
        np.argmax(got["mae"]))
