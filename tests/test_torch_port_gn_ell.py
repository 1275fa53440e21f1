"""The port's plain GatedGN ELL forward and backward (``ops/gn_ell.py``, the
CPU side of kernel K4) against the JAX ``gn_ell_aggregate`` run through the
Pallas interpreter, on the same numpy inputs.

Tolerances as in ``tests/test_gn_ell.py``: forward 2e-5, gradients 5e-5
(f32, the same products summed in another order); bf16 inputs 0.05 against
the f32 oracle. bf16 against the JAX kernel with bf16 inputs: both round
t and dmt at the same places, so they agree to a bf16 ulp or two (2e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.ops.gn_ell import gn_ell_aggregate as j_aggregate
from sgp_tpu.ops.gn_ell import gn_ell_reference as j_reference

from sgp_tpu_torch.ops import gn_ell

torch.set_num_threads(1)


def _setup(seed, n=20, b=2, d=5, h2=8, h=16, mask_p=0.85, empty_row=None):
    rng = np.random.default_rng(seed)
    arrs = dict(
        p_i=rng.standard_normal((b, n, h2)).astype(np.float32),
        pjn=rng.standard_normal((b, n, d, h2)).astype(np.float32),
        nmask=(rng.random((n, d)) < mask_p).astype(np.float32),
        w2=(rng.standard_normal((h2, h)) * 0.4).astype(np.float32),
        b2=(rng.standard_normal(h) * 0.1).astype(np.float32),
        wg=(rng.standard_normal((h, 1)) * 0.4).astype(np.float32),
        bg=(rng.standard_normal(1) * 0.1).astype(np.float32))
    if empty_row is not None:
        arrs["nmask"][empty_row] = 0.0
    return arrs


_ORDER = ("p_i", "pjn", "nmask", "w2", "b2", "wg", "bg")


def _jax_args(arrs, dtype=jnp.float32):
    return [jnp.asarray(arrs[k], dtype if k in ("p_i", "pjn") else None)
            for k in _ORDER]


def _torch_args(arrs, dtype=torch.float32, grad=False):
    out = []
    for k in _ORDER:
        t = torch.tensor(arrs[k])
        if k in ("p_i", "pjn"):
            t = t.to(dtype)
        if grad and k != "nmask":
            t.requires_grad_(True)
        out.append(t)
    return out


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=name)


@pytest.mark.parametrize("activation", ["silu", "tanh", "relu", "elu"])
def test_forward_matches_jax_kernel(activation):
    arrs = _setup(0)
    want = j_aggregate(*_jax_args(arrs), activation, True)
    got = gn_ell.gn_ell_aggregate(*_torch_args(arrs), activation)
    assert got.shape == (2, 20, 16) and got.dtype == torch.float32
    _close(got, want, 2e-5)
    _close(gn_ell.gn_ell_reference(*_torch_args(arrs), activation),
           j_reference(*_jax_args(arrs), activation=activation), 2e-5)


def test_forward_padding_and_empty_row():
    arrs = _setup(1, n=13, d=7, empty_row=5)
    want = j_aggregate(*_jax_args(arrs), "silu", True)
    got = gn_ell.gn_ell_aggregate(*_torch_args(arrs))
    _close(got, want, 2e-5)
    assert not got[:, 5].any()


@pytest.mark.parametrize("activation", ["silu", "tanh", "relu", "elu"])
def test_forward_plain_on_pair_batch_slots(activation):
    """Rows holding 0, 1, 15, 16, 17, 33 and 40 valid slots of D 40, where
    the card's 16-pair batches end empty, one short, full, one over and at
    the row's end: the plain forward, the oracle the card kernel is held
    to, against the JAX kernel."""
    n, d, counts = 21, 40, (0, 1, 15, 16, 17, 33, 40)
    arrs = _setup(11, n=n, d=d)
    rng = np.random.default_rng(11)
    arrs["nmask"] = np.zeros((n, d), np.float32)
    for i in range(n):
        arrs["nmask"][i, rng.choice(d, counts[i % 7], replace=False)] = 1.0
    want = j_aggregate(*_jax_args(arrs), activation, interpret=True)
    got = gn_ell.gn_ell_fwd_plain(*_torch_args(arrs), activation)
    assert got.shape == (2, n, 16) and got.dtype == torch.float32
    _close(got, want, 2e-5)
    assert not got[:, ::7].any()


def _loss(out):
    return (out * torch.cos(out)).sum()


@pytest.mark.parametrize("activation", ["silu", "tanh", "relu", "elu"])
def test_gradients_match_jax_kernel(activation):
    arrs = _setup(2, n=12, b=1, d=6, empty_row=3)
    jargs = _jax_args(arrs)

    def loss_j(p_i, pjn, w2, b2, wg, bg):
        out = j_aggregate(p_i, pjn, jargs[2], w2, b2, wg, bg, activation,
                          True)
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(loss_j, argnums=tuple(range(6)))(
        *jargs[:2], *jargs[3:])
    targs = _torch_args(arrs, grad=True)
    _loss(gn_ell.gn_ell_aggregate(*targs, activation)).backward()
    got = [t.grad for i, t in enumerate(targs) if i != 2]
    for g, w, name in zip(got, want, ["p_i", "pjn", "w2", "b2", "wg", "bg"]):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, 5e-5, name)
    assert not got[1][0, 3].any()          # padded slots: zero cotangent


def test_plain_backward_matches_autograd_of_reference():
    """The recompute backward against autograd through the unfused
    oracle, at a shape with a padded row and odd widths."""
    arrs = _setup(3, n=9, b=3, d=4, h2=5, h=11, empty_row=0)
    a = _torch_args(arrs, grad=True)
    r = _torch_args(arrs, grad=True)
    _loss(gn_ell.gn_ell_aggregate(*a, "elu")).backward()
    _loss(gn_ell.gn_ell_reference(*r, "elu")).backward()
    for i in (0, 1, 3, 4, 5, 6):
        _close(a[i].grad, r[i].grad.numpy(), 5e-5, _ORDER[i])


def test_bf16_inputs():
    arrs = _setup(4, n=16, d=6)
    got = gn_ell.gn_ell_aggregate(*_torch_args(arrs, torch.bfloat16))
    assert got.dtype == torch.float32
    _close(got, j_reference(*_jax_args(arrs)), 0.05)
    want = j_aggregate(*_jax_args(arrs, jnp.bfloat16), "silu", True)
    _close(got, want, 2e-2)


def test_bf16_gradients_match_jax_kernel():
    arrs = _setup(5, n=10, b=2, d=5)
    jargs = _jax_args(arrs, jnp.bfloat16)

    def loss_j(p_i, pjn, w2, b2, wg, bg):
        out = j_aggregate(p_i, pjn, jargs[2], w2, b2, wg, bg, "silu", True)
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(loss_j, argnums=tuple(range(6)))(*jargs[:2], *jargs[3:])
    targs = _torch_args(arrs, torch.bfloat16, grad=True)
    _loss(gn_ell.gn_ell_aggregate(*targs)).backward()
    got = [t.grad for i, t in enumerate(targs) if i != 2]
    assert got[1].dtype == torch.bfloat16 and got[0].dtype == torch.bfloat16
    for g, w, name in zip(got, want, ["p_i", "pjn", "w2", "b2", "wg", "bg"]):
        scale = max(float(jnp.abs(w.astype(jnp.float32)).max()), 1.0)
        _close(g / scale, np.asarray(w.astype(jnp.float32)) / scale, 2e-2,
               name)


def test_counters_stay_zero_on_cpu():
    before = (gn_ell.gn_ell_fwd.launches, gn_ell.gn_ell_bwd.launches)
    targs = _torch_args(_setup(6, n=6, d=3), grad=True)
    gn_ell.gn_ell_aggregate(*targs).sum().backward()
    assert (gn_ell.gn_ell_fwd.launches, gn_ell.gn_ell_bwd.launches) == before


def test_wrapper_rejects_bad_inputs():
    targs = _torch_args(_setup(7, n=6, d=3))
    with pytest.raises(ValueError):
        gn_ell.gn_ell_fwd(*targs, activation="gelu")
    bad = list(targs)
    bad[2] = bad[2][:, :2]
    with pytest.raises(ValueError):
        gn_ell.gn_ell_fwd(*bad)
    bad = list(targs)
    bad[1] = bad[1].double()
    with pytest.raises(TypeError):
        gn_ell.gn_ell_fwd(*bad)
