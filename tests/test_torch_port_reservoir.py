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


@pytest.mark.parametrize("t", [7, 255, 256, 257, 300])
def test_wavefront_scan_matches_jax_and_sequential(rng, t):
    """``mode="wavefront"`` against JAX's wavefront scan and the port's
    sequential one (atol 1e-5, as ``tests/test_encode.py``), whole, split
    with the state carried, and its last state. T 255 / 257 / 300 take a
    ragged last chunk or a divisor chunk of the 256-step target."""
    jr, tr = JReservoir(input_size=5, hidden_size=16, num_layers=3,
                        seed=3), \
        Reservoir(input_size=5, hidden_size=16, num_layers=3, seed=3,
                  device="cpu")
    x = rng.standard_normal((t, 4, 5)).astype(np.float32)
    tx = torch.as_tensor(x)
    seq = reservoir_scan(tr.layers, "tanh", tx, mode="sequential")
    wav = reservoir_scan(tr.layers, "tanh", tx, mode="wavefront")
    want = j_scan(tuple(jr.layers), "tanh", jnp.asarray(x), mode="wavefront")
    np.testing.assert_allclose(wav.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(wav.numpy(), seq.numpy(), atol=1e-5)
    s1, h1 = reservoir_scan(tr.layers, "tanh", tx[:t // 2], with_state=True,
                            mode="wavefront")
    s2, h2 = reservoir_scan(tr.layers, "tanh", tx[t // 2:], h0=h1,
                            with_state=True, mode="wavefront")
    np.testing.assert_allclose(torch.cat([s1, s2]).numpy(), seq.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(torch.cat(h2, -1).numpy(), seq[-1].numpy(),
                               atol=1e-5)
    last = reservoir_scan(tr.layers, "tanh", tx, return_last_state=True,
                          mode="wavefront")
    np.testing.assert_allclose(last.numpy(), seq[-1].numpy(), atol=1e-5)


def test_wavefront_scan_out_dtype_and_wide_input(rng):
    """An input wider than the state (F > H: the layers' inputs padded to
    F), no bias, and a bf16 output rounded from the f32 states."""
    tr = Reservoir(input_size=12, hidden_size=6, num_layers=2, bias=False,
                   seed=1, device="cpu")
    x = torch.as_tensor(rng.standard_normal((40, 5, 12)).astype(np.float32))
    seq = reservoir_scan(tr.layers, "tanh", x)
    wav = reservoir_scan(tr.layers, "tanh", x, mode="wavefront",
                         out_dtype=torch.bfloat16)
    assert wav.dtype == torch.bfloat16
    np.testing.assert_allclose(wav.float().numpy(), seq.numpy(), atol=1e-2)
    with pytest.raises(ValueError, match="unknown scan mode"):
        reservoir_scan(tr.layers, "tanh", x, mode="pipelined")
