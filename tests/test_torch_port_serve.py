"""The serving slice as a whole, at small width: the port's
``OnlineForecaster`` against the JAX one on the same raw series, graph,
reservoir seed and decoder weights (carried by the bridge), through
``warm_up`` and then single steps. With ``operator_mode="bsr"`` the JAX
operators run the Pallas kernel (interpret mode) and the port its plain
version. Tolerances: f32 rtol/atol 2e-5 (as ``tests/test_serve.py``);
a bf16 feature store 1e-2 of the largest forecast (a feature that lands
on a bf16 rounding boundary may round the other way)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgp_tpu.graph as jg
from sgp_tpu.data import ScalerParams as JScaler
from sgp_tpu.encode import SGPEncoder as JEncoder
from sgp_tpu.models import SGPModel as JModel
from sgp_tpu.encode import GESNEncoder as JGESNEncoder
from sgp_tpu.serve import OnlineForecaster as JForecaster
from sgp_tpu.serve import OnlineGESNForecaster as JGESNForecaster
from sgp_tpu.train import closed_form_readout as j_readout

import sgp_tpu_torch.graph as tg
from sgp_tpu_torch.data import ScalerParams
from sgp_tpu_torch.encode import GESNEncoder, SGPEncoder
from sgp_tpu_torch.models import SGPModel, flax_to_torch
from sgp_tpu_torch.serve import OnlineForecaster, OnlineGESNForecaster

torch.set_num_threads(1)

N, C, T_WARM, T_STEP, EXOG = 30, 1, 10, 6, 2


def _setup(rng, mode, n_streams, store, with_u):
    src, dst = rng.integers(0, N, 6 * N), rng.integers(0, N, 6 * N)
    w = rng.random(6 * N).astype(np.float32)
    jgr = jg.coalesce(jg.Graph(src, dst, w, N))
    tgr = tg.coalesce(tg.Graph(src, dst, w, N))
    enc_kw = dict(input_size=C, reservoir_size=6, reservoir_layers=3,
                  leaking_rate=1.0, spectral_radius=0.99, alpha_decay=True,
                  receptive_field=2, global_attr=True, seed=2,
                  operator_mode=mode)
    je, te = JEncoder(**enc_kw), SGPEncoder(**enc_kw, device="cpu")
    order = je.output_size // 6
    exog = EXOG if with_u else 0
    m_kw = dict(input_size=je.output_size, order=order, n_nodes=N,
                hidden_size=20, mlp_size=8, output_size=C, n_layers=2,
                horizon=4, resnet=True, exog_size=exog)
    jm, tm = JModel(**m_kw), SGPModel(**m_kw)
    params = jm.init(jax.random.PRNGKey(1),
                     jnp.zeros((1, N, je.output_size)),
                     **({"u": jnp.zeros((1, 1, exog))} if with_u else {}))
    flax_to_torch(jax.tree.map(np.asarray, params), tm)
    bias, scale = np.full((1, 1, C), 1.5, np.float32), \
        np.full((1, 1, C), 3.0, np.float32)
    jfc = JForecaster(je, jgr, jm, params,
                      JScaler(jnp.asarray(bias), jnp.asarray(scale)),
                      store_dtype=store, n_streams=n_streams)
    if mode == "bsr":
        for op in jfc._ops:
            op._variant = "pallas"
    tfc = OnlineForecaster(te, tgr, tm, ScalerParams(
        torch.as_tensor(bias), torch.as_tensor(scale)),
        store_dtype=store, n_streams=n_streams, device="cpu")
    return jfc, tfc


CASES = [("bsr", None, None, False), ("bsr", 2, None, False),
         ("bsr", None, "bfloat16", False), ("dense", None, None, True),
         ("dense", 2, "bfloat16", True), ("dense", 2, None, False)]


@pytest.mark.parametrize("mode,n_streams,store,with_u", CASES)
def test_online_forecaster_matches_jax(rng, mode, n_streams, store, with_u):
    jfc, tfc = _setup(rng, mode, n_streams, store, with_u)
    lead = () if n_streams is None else (n_streams,)
    hist = (rng.standard_normal((T_WARM,) + lead + (N, C)) * 3 + 1
            ).astype(np.float32)
    obs = (rng.standard_normal((T_STEP,) + lead + (N, C)) * 3 + 1
           ).astype(np.float32)
    u = rng.standard_normal((T_STEP,) + lead + (EXOG,)).astype(np.float32)

    jfc.warm_up(hist)
    tfc.warm_up(hist)
    for a, b in zip(jfc.state, tfc.state):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   rtol=1e-5, atol=1e-6)
    for t in range(T_STEP):
        ut = u[t] if with_u else None
        ref = np.asarray(jfc.step(obs[t], None if ut is None
                                  else jnp.asarray(ut)))
        got = tfc.step(obs[t], None if ut is None else torch.as_tensor(ut))
        assert got.shape == ref.shape == lead + (4, N, C)
        if store is None:
            np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5,
                                       atol=2e-5, err_msg=f"t={t}")
        else:
            assert np.abs(got.numpy() - ref).max() \
                <= 1e-2 * np.abs(ref).max(), f"t={t}"
    tfc.reset()
    assert not any(h.any() for h in tfc.state)



def _gesn_setup(rng, mode):
    """Both packages' GESN encoders on the same graph and layers (the same
    seed), the scaler, and JAX's per-lag closed-form readouts fitted on its
    own encoding, carried across as numpy ``(W, b)``."""
    src, dst = rng.integers(0, N, 4 * N), rng.integers(0, N, 4 * N)
    w = rng.random(4 * N).astype(np.float32)
    jgr = jg.coalesce(jg.Graph(src, dst, w, N))
    tgr = tg.coalesce(tg.Graph(src, dst, w, N))
    kw = dict(input_size=C, reservoir_size=5, reservoir_layers=2,
              alpha_decay=True, seed=4, operator_mode=mode)
    je, te = JGESNEncoder(**kw), GESNEncoder(**kw, device="cpu")
    bias, scale = np.full((1, 1, C), -0.5, np.float32), \
        np.full((1, 1, C), 2.0, np.float32)
    xs = (rng.standard_normal((30, N, C)) - bias) / scale
    enc = np.asarray(je(jnp.asarray(xs, jnp.float32), jgr))
    d, lags = enc.shape[-1], 3
    tr = np.arange(30 - lags)
    readouts = [(np.asarray(a), np.asarray(b)) for a, b in j_readout(
        enc[tr].reshape(-1, d), [xs[tr + 1 + lag].reshape(-1, C)
                                 for lag in range(lags)], alpha=0.3)]
    return (je, jgr, JScaler(jnp.asarray(bias), jnp.asarray(scale))), \
        (te, tgr, ScalerParams(torch.as_tensor(bias),
                               torch.as_tensor(scale))), readouts


@pytest.mark.parametrize("mode,n_streams", [("dense", None), ("bsr", None),
                                            ("bsr", 3), ("dense", 3)])
def test_online_gesn_forecaster_matches_jax(rng, mode, n_streams):
    """``warm_up``, single steps (``[L, N, C]``, or ``[S, L, N, C]`` with
    ``n_streams``) and ``reset`` against JAX's forecaster (f32, rtol/atol
    2e-5 as ``tests/test_serve.py``; BSR on the JAX side through its Pallas
    kernel, interpreted); with streams, each stream also against a
    single-stream forecaster of its own."""
    (je, jgr, jsc), (te, tgr, tsc), readouts = _gesn_setup(rng, mode)
    jfc = JGESNForecaster(je, jgr, readouts, jsc, n_streams=n_streams)
    if mode == "bsr":
        jfc._op._variant = "pallas"
    tfc = OnlineGESNForecaster(te, tgr, readouts, tsc, n_streams=n_streams,
                               device="cpu")
    lead = () if n_streams is None else (n_streams,)
    hist = (rng.standard_normal((T_WARM,) + lead + (N, C)) * 2 - 0.5
            ).astype(np.float32)
    obs = (rng.standard_normal((T_STEP,) + lead + (N, C)) * 2 - 0.5
           ).astype(np.float32)
    jfc.warm_up(hist)
    tfc.warm_up(hist)
    for a, b in zip(jfc.state, tfc.state):
        assert b.shape == lead + (N, 5)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    singles = [OnlineGESNForecaster(te, tgr, readouts, tsc, device="cpu")
               for _ in range(n_streams or 0)]
    for i, fc in enumerate(singles):
        fc.warm_up(hist[:, i])
    for t in range(T_STEP):
        ref = np.asarray(jfc.step(obs[t]))
        got = tfc.step(obs[t])
        assert got.shape == ref.shape == lead + (3, N, C)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5,
                                   err_msg=f"t={t}")
        for i, fc in enumerate(singles):
            np.testing.assert_allclose(fc.step(obs[t, i]).numpy(),
                                       got[i].numpy(), rtol=2e-5, atol=2e-5,
                                       err_msg=f"t={t} stream={i}")
    tfc.reset()
    assert not any(h.any() for h in tfc.state)
    assert [h.shape for h in tfc.state] == [lead + (N, 5)] * 2
