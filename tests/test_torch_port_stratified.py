"""The port's stratified IID trainer against the JAX package's, on the
CPU: ``make_fused_iid_stratified_step`` on the same numpy inputs, the same
flax weights (``flax_to_torch``) and the JAX step's (time, node) draws.

Sizes are those of ``tests/test_iid_fused.py``'s stratified tests: 60
steps, 12 nodes, a temporal embedding of 6 channels (bf16, as the runner
keeps it, unless a case says f32), supports ``A`` and ``A^2`` of a random
graph and the global mean, 3 times x 5 nodes a batch.

Tolerances: the losses of 4 clipped Adam steps at 1e-5 relative and the
weights after them at 1e-5 absolute (lr 1e-3), also with ``support_dtype``
bf16 (both round the supports and the embedding to bf16, multiply exactly
and sum in f32, in another order). The assembled features: the JAX step's
dtype exactly, and every value within one bf16 ulp of the JAX step's (the
hops are f32 sums, in another order, rounded to bf16); against the port's
precompute layout (``apply_support``) within 1e-5 in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sgp_tpu.data.scalers import ScalerParams as JScalerParams
from sgp_tpu.data.sgp_loader import build_support_operators as j_supports
from sgp_tpu.graph import Graph as JGraph
from sgp_tpu.graph import coalesce as j_coalesce
from sgp_tpu.models import SGPModel as JSGPModel
from sgp_tpu.train.iid import make_fused_iid_stratified_step as j_step

from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.data.sgp_loader import (apply_support,
                                           build_support_operators)
from sgp_tpu_torch.graph import Graph, coalesce
from sgp_tpu_torch.models import SGPModel, flax_to_torch
from sgp_tpu_torch.models.bridge import targets
from sgp_tpu_torch.ops import GlobalMeanOperator
from sgp_tpu_torch.train.iid import make_fused_iid_stratified_step

torch.set_num_threads(1)

T, N, HT, C = 60, 12, 6, 1
H_OFF = np.array([1, 2])
TB, P = 3, 5
CLIP = 0.5
TOL = 1e-5


def _graphs(rng):
    src, dst = rng.integers(0, N, 50), rng.integers(0, N, 50)
    w = rng.random(50).astype(np.float32)
    return coalesce(Graph(src, dst, w, N)), j_coalesce(JGraph(src, dst, w, N))


def _problem(rng, u_kind, h_dtype):
    h = rng.standard_normal((T, N, HT)).astype(np.float32)
    if h_dtype == "bfloat16":
        h = torch.as_tensor(h).to(torch.bfloat16).float().numpy()
    y = (rng.standard_normal((T, N, C)) * 10).astype(np.float32)
    mask = rng.random((T, N, C)) > 0.2
    u = {"none": None,
         "node": rng.standard_normal((T, N, 2)).astype(np.float32),
         "global": rng.standard_normal((T, 3)).astype(np.float32)}[u_kind]
    bias = (rng.standard_normal((1, N, C)) * 2).astype(np.float32)
    scale = (rng.random((1, N, C)) * 5 + 2).astype(np.float32)
    valid = np.arange(T - int(H_OFF[-1]) - 1)
    return h, y, mask, u, bias, scale, valid


def _models(d_total, u):
    kw = dict(input_size=d_total, order=4, n_nodes=N, hidden_size=12,
              mlp_size=8, output_size=C, n_layers=2, horizon=len(H_OFF),
              resnet=True, exog_size=0 if u is None else u.shape[-1])
    jm = JSGPModel(**kw)
    key = jax.random.PRNGKey(0)
    params = jm.init({"params": key, "dropout": key},
                     jnp.zeros((4, d_total)),
                     node_index=jnp.zeros(4, jnp.int32), iid=True,
                     **({} if u is None else
                        {"u": jnp.zeros((4, u.shape[-1]))}))
    tm = SGPModel(**kw)
    flax_to_torch(jax.tree.map(np.asarray, params), tm)
    return jm, params, tm


def _draws(key, valid):
    """The JAX step's draws from its call key: the call splits it into
    ``steps_per_call`` step keys, and a step key into (t, n, dropout)."""
    step_key = jax.random.split(key, 1)[0]
    rng_t, rng_n = jax.random.split(step_key, 3)[:2]
    t = jax.random.choice(rng_t, jnp.asarray(valid), (TB,))
    n = jax.random.randint(rng_n, (TB, P), 0, N)
    return (torch.as_tensor(np.array(t), dtype=torch.long),
            torch.as_tensor(np.array(n), dtype=torch.long))


class _Recorder:
    """Stands in for the flax model in the JAX step: records the features
    it is called with (their dtype at trace time, their values through
    ``jax.debug.callback``) and applies the real model."""

    def __init__(self, model):
        self.model, self.dtypes, self.xs = model, [], []

    def apply(self, params, x, **kwargs):
        self.dtypes.append(x.dtype)
        jax.debug.callback(lambda v: self.xs.append(np.asarray(v)), x)
        return self.model.apply(params, x, **kwargs)


def _steps(rng, case):
    """The JAX and the port's stratified steps on one problem."""
    h, y, mask, u, bias, scale, valid = _problem(
        rng, case.get("u", "none"), case.get("h", "bfloat16"))
    g, jg = _graphs(rng)
    mode = case.get("mode", "dense")
    ops = build_support_operators(g, k=2, operator_mode=mode, device="cpu")
    jops = j_supports(jg, k=2, operator_mode=mode)
    d_total = HT * (1 + len(ops) + 1)
    jm, params, tm = _models(d_total, u)
    jdt = jnp.bfloat16 if case.get("h", "bfloat16") == "bfloat16" \
        else jnp.float32
    tdt = torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32
    sdt = case.get("support_dtype")
    common = dict(global_attr=True, times_per_batch=TB, nodes_per_time=P,
                  scale_target=case.get("scale_target", False),
                  steps_per_call=1, assembly=case.get("assembly",
                                                      "gather_rows"))
    jopt = optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(1e-3))
    rec = _Recorder(jm)
    jstep = j_step(rec, jopt, jnp.asarray(h, jdt), jnp.asarray(y),
                   jnp.asarray(mask), jnp.asarray(valid), jnp.asarray(H_OFF),
                   JScalerParams(jnp.asarray(bias), jnp.asarray(scale)),
                   jops, u=None if u is None else jnp.asarray(u),
                   support_dtype=jnp.bfloat16 if sdt else None, **common)
    topt = torch.optim.Adam(tm.parameters(), lr=1e-3, eps=1e-8)
    tstep = make_fused_iid_stratified_step(
        tm, topt, torch.as_tensor(h).to(tdt), torch.as_tensor(y),
        torch.as_tensor(mask), valid, H_OFF,
        ScalerParams(torch.as_tensor(bias), torch.as_tensor(scale)), ops,
        u=None if u is None else torch.as_tensor(u), grad_clip=CLIP,
        support_dtype=torch.bfloat16 if sdt else None, **common)
    return jstep, jopt, params, tstep, tm, valid, rec


CASES = [
    dict(assembly="gather_rows"),
    dict(assembly="gather_rows", u="node", scale_target=True),
    dict(assembly="full_prop", u="global"),
    dict(assembly="full_prop", mode="bsr", u="node"),
    dict(assembly="gather_rows", mode="bsr", u="global", scale_target=True),
    dict(assembly="gather_rows", h="float32", u="node"),
    dict(assembly="gather_rows", support_dtype=True, u="global"),
    dict(assembly="full_prop", support_dtype=True),
]


def _case_id(case):
    return "-".join(f"{k}={v}" for k, v in case.items())


def _within_bf16_ulp(got: np.ndarray, want: np.ndarray):
    mag = np.maximum(np.abs(got), np.abs(want)).clip(min=1e-30)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_stratified_step_matches_jax(rng, case):
    """4 clipped Adam steps on the JAX step's draws: the rows the JAX step
    hands its model at the first step against the port's ``step.features``
    (the same dtype: bf16 for a bf16 embedding on every operator route; the
    same values to a bf16 ulp), each step's loss, then the weights."""
    jstep, jopt, params, tstep, tm, valid, rec = _steps(rng, case)
    opt_state = jopt.init(params)
    for i in range(4):
        key = jax.random.PRNGKey(100 + i)
        params, opt_state, jloss = jstep(params, opt_state, key)
        draws = _draws(key, valid)
        if i == 0:
            jax.effects_barrier()
            got = tstep.features(*draws)
            assert str(got.dtype) == f"torch.{rec.dtypes[-1]}"
            assert str(rec.dtypes[-1]) == case.get("h", "bfloat16")
            assert got.shape == rec.xs[-1].shape == (TB * P, HT * 4)
            _within_bf16_ulp(got.float().numpy(),
                             np.asarray(rec.xs[-1], np.float32))
        tloss = tstep.train_on(*draws)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL,
                                   err_msg=f"step {i}")
    jp = jax.tree.map(np.asarray, params)["params"]
    for path, (param, transpose) in targets(tm).items():
        w = jp
        for k in path:
            w = w[k]
        np.testing.assert_allclose(param.detach().numpy(),
                                   w.T if transpose else w, rtol=0, atol=TOL,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("assembly", ["gather_rows", "full_prop"])
@pytest.mark.parametrize("mode", ["dense", "bsr"])
def test_stratified_features_match_precompute(rng, assembly, mode):
    """In f32, the step's assembly ``[h, A h, A^2 h, mean(h)]`` at the
    sampled (time, node) pairs equals the precompute path's layout
    (``apply_support`` with the supports and the global mean)."""
    h, y, mask, u, bias, scale, valid = _problem(rng, "none", "float32")
    g, _ = _graphs(rng)
    ops = build_support_operators(g, k=2, operator_mode=mode, device="cpu")
    model = SGPModel(input_size=HT * 4, order=4, n_nodes=N, hidden_size=12,
                     mlp_size=8, output_size=C, n_layers=1,
                     horizon=len(H_OFF))
    step = make_fused_iid_stratified_step(
        model, torch.optim.Adam(model.parameters()), torch.as_tensor(h),
        torch.as_tensor(y), torch.as_tensor(mask), valid, H_OFF,
        ScalerParams(torch.zeros(1), torch.ones(1)), ops,
        times_per_batch=TB, nodes_per_time=P, assembly=assembly)
    t, n = step.sample(torch.Generator().manual_seed(3))
    got = step.features(t, n).reshape(TB, P, -1)
    full = apply_support(torch.as_tensor(h), ops + [GlobalMeanOperator(N)])
    want = full[t[:, None], n]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_stratified_call_is_the_mean_of_its_steps(rng):
    """``steps_per_call`` steps a call: the mean of the same steps taken
    one a call from the same generator stream, and the weights move."""
    h, y, mask, u, bias, scale, valid = _problem(rng, "node", "bfloat16")
    g, _ = _graphs(rng)
    ops = build_support_operators(g, k=2, device="cpu")
    losses = []
    for per_call in (1, 3):
        torch.manual_seed(0)
        model = SGPModel(input_size=HT * 4, order=4, n_nodes=N,
                         hidden_size=12, mlp_size=8, output_size=C,
                         n_layers=1, horizon=len(H_OFF), exog_size=2,
                         generator=torch.Generator().manual_seed(0))
        before = [p.detach().clone() for p in model.parameters()]
        step = make_fused_iid_stratified_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-2),
            torch.as_tensor(h).to(torch.bfloat16), torch.as_tensor(y),
            torch.as_tensor(mask), valid, H_OFF,
            ScalerParams(torch.as_tensor(bias), torch.as_tensor(scale)),
            ops, u=torch.as_tensor(u), times_per_batch=TB,
            nodes_per_time=P, steps_per_call=per_call, grad_clip=CLIP)
        gen = torch.Generator().manual_seed(4)
        calls = [step(gen) for _ in range(3 // per_call)]
        losses.append(float(torch.stack(calls).mean()))
        assert all(not torch.equal(a, b) for a, b in
                   zip(before, model.parameters()))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)


def test_stratified_options_refused(rng):
    h, y, mask, u, bias, scale, valid = _problem(rng, "none", "float32")
    g, _ = _graphs(rng)
    ops = build_support_operators(g, k=2, device="cpu")
    model = SGPModel(input_size=HT * 4, order=4, n_nodes=N, hidden_size=12,
                     mlp_size=8, output_size=C, n_layers=1,
                     horizon=len(H_OFF))
    args = (model, torch.optim.Adam(model.parameters()), torch.as_tensor(h),
            torch.as_tensor(y), torch.as_tensor(mask), valid, H_OFF,
            ScalerParams(torch.zeros(1), torch.ones(1)), ops)
    with pytest.raises(ValueError, match="assembly"):
        make_fused_iid_stratified_step(*args, assembly="rows")
    with pytest.raises(ValueError, match="support_dtype"):
        make_fused_iid_stratified_step(*args, support_dtype=torch.float16)
