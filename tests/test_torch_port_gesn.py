"""The port's graph echo-state network (DynGESN) against the JAX package on
the same numpy inputs: the same seed gives bit-identical layers, and the
scan, a step and ``GESNEncoder`` agree with JAX's over the dense operator
and over BSR (the JAX side on its Pallas kernel, interpreted; the port on
its plain version). Tolerance: 1e-6 absolute on states bounded by 1 (the
same f32 arithmetic in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgp_tpu.graph as jg
from sgp_tpu.encode import GESNEncoder as JGESNEncoder
from sgp_tpu.encode import GraphESN as JGraphESN
from sgp_tpu.ops import build_operator as j_build_operator

import sgp_tpu_torch.graph as tg
from sgp_tpu_torch.encode import GESNEncoder, GraphESN, get_encoder_class
from sgp_tpu_torch.ops import build_operator

torch.set_num_threads(1)

N, F, H, L, T = 140, 3, 8, 3, 12   # N spans two 128-node block rows
KW = dict(input_size=F, hidden_size=H, num_layers=L, leaking_rate=0.9,
          spectral_radius=0.9, density=1.0, input_scaling=0.5,
          alpha_decay=True, seed=5)
TOL = 1e-6


def _graphs(rng):
    src, dst = rng.integers(0, N, 5 * N), rng.integers(0, N, 5 * N)
    w = rng.random(5 * N).astype(np.float32)
    return jg.coalesce(jg.Graph(src, dst, w, N)), \
        tg.coalesce(tg.Graph(src, dst, w, N))


def _ops(rng, mode):
    """The JAX and port operators of the self-looped, row-normalized
    graph; BSR on the JAX side through its Pallas kernel."""
    jgr, tgr = _graphs(rng)
    jop = j_build_operator(jg.normalize_adj(jg.add_self_loops(jgr), "row"),
                           mode)
    if mode == "bsr":
        jop._variant = "pallas"
    top = build_operator(tg.normalize_adj(tg.add_self_loops(tgr), "row"),
                         mode, device="cpu")
    return jop, top


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol)


def _layer_arrays(gesn):
    return [{"w_ih": np.asarray(p.w_ih), "w_hh": np.asarray(p.w_hh),
             "b_ih": None if p.b_ih is None else np.asarray(p.b_ih),
             "alpha": p.alpha} for p in gesn.layers]


@pytest.mark.parametrize("over", [{}, dict(alpha_decay=False),
                                  dict(density=0.7, bias=False),
                                  dict(num_layers=8, leaking_rate=0.5)])
def test_same_seed_gives_bit_identical_layers(over):
    jr, tr = JGraphESN(**{**KW, **over}), \
        GraphESN(**{**KW, **over}, device="cpu")
    assert len(jr.layers) == len(tr.layers)
    for a, b in zip(_layer_arrays(jr), _layer_arrays(tr)):
        for k in ("w_ih", "w_hh", "b_ih"):
            assert (a[k] is None) == (b[k] is None), k
            if a[k] is not None:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["alpha"] == b["alpha"]
    assert jr.output_size == tr.output_size


def test_from_arrays_carries_the_jax_layers():
    jr = JGraphESN(**KW)
    tr = GraphESN.from_arrays(_layer_arrays(jr), device="cpu")
    assert (tr.num_layers, tr.hidden_size, tr.input_size) == (L, H, F)
    for a, b in zip(_layer_arrays(jr), _layer_arrays(tr)):
        np.testing.assert_array_equal(a["w_hh"], b["w_hh"])
        assert a["alpha"] == b["alpha"]


@pytest.mark.parametrize("mode", ["dense", "bsr"])
def test_scan_matches_jax(rng, mode):
    """The whole scan, its split with ``h0``/``with_state``, and
    ``return_last_state``."""
    jop, top = _ops(rng, mode)
    jr, tr = JGraphESN(**KW), GraphESN(**KW, device="cpu")
    x = rng.standard_normal((T, N, F)).astype(np.float32)
    want = np.asarray(jr(jnp.asarray(x), jop))
    got = tr(torch.as_tensor(x), top)
    assert got.shape == (T, N, L * H) and got.dtype == torch.float32
    _close(got, want)
    o1, h1 = tr(torch.as_tensor(x[:5]), top, with_state=True)
    o2, h2 = tr(torch.as_tensor(x[5:]), top, h0=h1, with_state=True)
    _close(torch.cat([o1, o2]), want)
    _close(torch.cat(h2, -1), want[-1])
    _close(tr(torch.as_tensor(x), top, return_last_state=True), want[-1])
    bf = tr(torch.as_tensor(x), top, out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(),
                                  got.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("mode", ["dense", "bsr", "coo"])
def test_step_with_a_stream_axis_matches_jax(rng, mode):
    """``step`` on ``[S, N, *]`` states: JAX's step, and the port's step on
    each stream alone (BSR folds the streams into the columns)."""
    jop, top = _ops(rng, mode)
    jr, tr = JGraphESN(**KW), GraphESN(**KW, device="cpu")
    s = 3
    h = [rng.standard_normal((s, N, H)).astype(np.float32) for _ in range(L)]
    x = rng.standard_normal((s, N, F)).astype(np.float32)
    want = jr.step([jnp.asarray(a) for a in h], jop, jnp.asarray(x))
    got = tr.step([torch.as_tensor(a) for a in h], top, torch.as_tensor(x))
    for a, b in zip(got, want):
        assert a.shape == (s, N, H)
        _close(a, b)
    for i in range(s):
        one = tr.step([torch.as_tensor(a[i]) for a in h], top,
                      torch.as_tensor(x[i]))
        for a, b in zip(one, got):
            _close(a, b[i])


@pytest.mark.parametrize("mode", ["dense", "bsr"])
def test_gesn_encoder_matches_jax(rng, mode):
    jgr, tgr = _graphs(rng)
    kw = dict(input_size=F, reservoir_size=H, reservoir_layers=2,
              alpha_decay=True, density=1.0, seed=3, operator_mode=mode)
    je, te = JGESNEncoder(**kw), GESNEncoder(**kw, device="cpu")
    assert te.output_size == je.output_size == 2 * H
    x = rng.standard_normal((T, N, F)).astype(np.float32)
    _close(te(torch.as_tensor(x), tgr), je(jnp.asarray(x), jgr))


def test_encoder_registry_and_default_device():
    assert get_encoder_class("gesn") is GESNEncoder
    if torch.cuda.is_available():
        assert GESNEncoder(input_size=F).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GESNEncoder(input_size=F)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GraphESN(**KW)
