"""The port's echo-state reservoir against the JAX package: the same seed
gives bit-identical weights, and ``step`` and the scan agree with
``Reservoir.step`` and ``reservoir_scan`` (f32, rtol 1e-5 / atol 1e-6:
the same arithmetic in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.encode.reservoir import Reservoir as JReservoir
from sgp_tpu.encode.reservoir import reservoir_scan as j_scan

from sgp_tpu_torch.encode.reservoir import Reservoir, reservoir_scan

torch.set_num_threads(1)

KW = dict(input_size=3, hidden_size=8, num_layers=3, leaking_rate=0.9,
          spectral_radius=0.95, density=0.7, input_scaling=0.5,
          alpha_decay=True, seed=7)


def _pair(**over):
    kw = {**KW, **over}
    return JReservoir(**kw), Reservoir(**kw, device="cpu")


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("over", [{}, dict(bias=False), dict(density=1.0),
                                  dict(num_layers=8, hidden_size=16,
                                       input_size=1, leaking_rate=1.0,
                                       spectral_radius=0.99)])
def test_same_seed_gives_bit_identical_weights(over):
    jr, tr = _pair(**over)
    assert len(jr.layers) == len(tr.layers)
    for a, b in zip(jr.layers, tr.layers):
        np.testing.assert_array_equal(np.asarray(a.w_ih), b.w_ih.numpy())
        np.testing.assert_array_equal(np.asarray(a.w_hh), b.w_hh.numpy())
        assert (a.b_ih is None) == (b.b_ih is None)
        if a.b_ih is not None:
            np.testing.assert_array_equal(np.asarray(a.b_ih),
                                          b.b_ih.numpy())
        assert a.alpha == b.alpha
    assert jr.output_size == tr.output_size


@pytest.mark.parametrize("activation", ["tanh", "relu", "identity",
                                        "self_norm"])
def test_step_matches(rng, activation):
    jr, tr = _pair(activation=activation)
    h = [rng.standard_normal((5, 8)).astype(np.float32) for _ in range(3)]
    x = rng.standard_normal((5, 3)).astype(np.float32)
    ja = jr.step([jnp.asarray(a) for a in h], jnp.asarray(x))
    ta = tr.step([torch.as_tensor(a) for a in h], torch.as_tensor(x))
    for a, b in zip(ja, ta):
        _close(a, b)


@pytest.mark.parametrize("batch", [(6,), (2, 5)])
def test_scan_matches(rng, batch):
    jr, tr = _pair()
    x = rng.standard_normal((20,) + batch + (3,)).astype(np.float32)
    _close(jr(jnp.asarray(x)), tr(torch.as_tensor(x)))
    _close(jr(jnp.asarray(x), return_last_state=True),
           tr(torch.as_tensor(x), return_last_state=True))


def test_scan_with_state_chunks_and_out_dtype(rng):
    """``with_state`` carries the state across chunks; ``out_dtype``
    casts each step's output (bf16: compared after the same rounding)."""
    jr, tr = _pair()
    x = rng.standard_normal((16, 6, 3)).astype(np.float32)
    h0 = [rng.standard_normal((6, 8)).astype(np.float32) for _ in range(3)]
    jo, jh = j_scan(tuple(jr.layers), "tanh", jnp.asarray(x[:9]),
                    [jnp.asarray(a) for a in h0], with_state=True)
    to, th = reservoir_scan(tr.layers, "tanh", torch.as_tensor(x[:9]),
                            [torch.as_tensor(a) for a in h0],
                            with_state=True)
    _close(jo, to)
    jo2 = jr(jnp.asarray(x[9:]), h0=jh, out_dtype=jnp.bfloat16)
    to2 = tr(torch.as_tensor(x[9:]), h0=th, out_dtype=torch.bfloat16)
    assert to2.dtype == torch.bfloat16
    np.testing.assert_allclose(np.asarray(jo2, np.float32),
                               to2.float().numpy(), rtol=1e-2, atol=1e-2)
    # stepping equals the scan
    h = [torch.as_tensor(a) for a in h0]
    for t in range(9):
        h = tr.step(h, torch.as_tensor(x[t]))
    for a, b in zip(h, th):
        _close(a, b)
