"""The port's plain GatedGN all-pairs forward and backward
(``ops/gn_allpairs.py``, the CPU side of kernel K3) against the JAX
``gn_allpairs_aggregate`` run through the Pallas interpreter and against
``gn_allpairs_reference``, on the same numpy inputs.

Tolerances as in ``tests/test_gn_allpairs.py``: forward 2e-5, gradients 5e-5
(f32, the same products summed in another order). bf16 inputs: 0.05 against
the f32 oracle; against the JAX kernel with bf16 inputs, which rounds at the
same places, 2e-2 (a bf16 ulp or two).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.ops.gn_allpairs import gn_allpairs_aggregate as j_aggregate
from sgp_tpu.ops.gn_allpairs import gn_allpairs_reference as j_reference

from sgp_tpu_torch.graph import band_windows
from sgp_tpu_torch.ops import gn_allpairs

torch.set_num_threads(1)

ACTS = ["silu", "tanh", "relu", "elu"]
_ORDER = ("p_i", "p_j", "mask", "w2", "b2", "wg", "bg")
_GRADS = ("p_i", "p_j", "w2", "b2", "wg", "bg")


def _setup(seed, n=20, b=2, h2=8, h=16, density=0.3, empty_row=None):
    """An asymmetric random mask (``mask[i, j]`` independent of
    ``mask[j, i]``) and the JAX tests' weight scales."""
    rng = np.random.default_rng(seed)
    arrs = dict(
        p_i=rng.standard_normal((b, n, h2)).astype(np.float32),
        p_j=rng.standard_normal((b, n, h2)).astype(np.float32),
        mask=(rng.random((n, n)) < density).astype(np.float32),
        w2=(rng.standard_normal((h2, h)) * 0.4).astype(np.float32),
        b2=(rng.standard_normal(h) * 0.1).astype(np.float32),
        wg=(rng.standard_normal((h, 1)) * 0.4).astype(np.float32),
        bg=(rng.standard_normal(1) * 0.1).astype(np.float32))
    if empty_row is not None:
        arrs["mask"][empty_row] = 0.0
    return arrs


def _jax_args(arrs, dtype=jnp.float32):
    return [jnp.asarray(arrs[k], dtype if k in ("p_i", "p_j") else None)
            for k in _ORDER]


def _torch_args(arrs, dtype=torch.float32, grad=False):
    out = []
    for k in _ORDER:
        t = torch.tensor(arrs[k])
        if k in ("p_i", "p_j"):
            t = t.to(dtype)
        if grad and k != "mask":
            t.requires_grad_(True)
        out.append(t)
    return out


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=name)


def _loss(out):
    return (out * torch.cos(out)).sum()


def _grads(targs):
    return [t.grad for i, t in enumerate(targs) if i != 2]


@pytest.mark.parametrize("activation", ACTS)
def test_forward_matches_jax_kernel(activation):
    arrs = _setup(0)
    want = j_aggregate(*_jax_args(arrs), activation, True)
    got = gn_allpairs.gn_allpairs_aggregate(*_torch_args(arrs), activation)
    assert got.shape == (2, 20, 16) and got.dtype == torch.float32
    _close(got, want, 2e-5)
    _close(got, j_reference(*_jax_args(arrs), activation=activation), 2e-5)
    _close(gn_allpairs.gn_allpairs_reference(*_torch_args(arrs), activation),
           j_reference(*_jax_args(arrs), activation=activation), 2e-5)


def test_forward_padding_and_empty_row():
    """N = 13 is no multiple of the Pallas kernel's 128; row 5 is empty."""
    arrs = _setup(1, n=13, empty_row=5)
    want = j_aggregate(*_jax_args(arrs), "silu", True)
    got = gn_allpairs.gn_allpairs_aggregate(*_torch_args(arrs))
    assert got.shape == (2, 13, 16)
    _close(got, want, 2e-5)
    assert not got[:, 5].any()


@pytest.mark.parametrize("activation", ACTS)
def test_forward_plain_on_pair_batch_edges(activation):
    """Rows holding 0, 1, 15, 16, 17 and 33 set entries, where the card's
    16-pair batches end empty, one short, full and one over: the plain
    forward, the oracle the card kernel is held to, against the JAX
    kernel."""
    n, degrees = 48, (0, 1, 15, 16, 17, 33)
    arrs = _setup(10, n=n)
    rng = np.random.default_rng(10)
    arrs["mask"] = np.zeros((n, n), np.float32)
    for i in range(n):
        arrs["mask"][i, rng.choice(n, degrees[i % 6], replace=False)] = 1.0
    want = j_aggregate(*_jax_args(arrs), activation, interpret=True)
    got = gn_allpairs.gn_allpairs_fwd_plain(*_torch_args(arrs), activation)
    assert got.shape == (2, n, 16) and got.dtype == torch.float32
    _close(got, want, 2e-5)
    assert not got[:, ::6].any()


@pytest.mark.parametrize("activation", ACTS)
def test_gradients_match_jax_kernel(activation):
    arrs = _setup(2, n=13, b=2, empty_row=3)
    jargs = _jax_args(arrs)

    def loss_j(p_i, p_j, w2, b2, wg, bg):
        out = j_aggregate(p_i, p_j, jargs[2], w2, b2, wg, bg, activation,
                          True)
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(loss_j, argnums=tuple(range(6)))(*jargs[:2], *jargs[3:])
    targs = _torch_args(arrs, grad=True)
    _loss(gn_allpairs.gn_allpairs_aggregate(*targs, activation)).backward()
    for g, w, name in zip(_grads(targs), want, _GRADS):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, 5e-5, name)


def test_plain_backward_matches_autograd_of_reference():
    """The recompute backward against autograd through the unfused oracle,
    at odd widths with an empty row and an asymmetric mask."""
    arrs = _setup(3, n=9, b=3, h2=5, h=11, density=0.5, empty_row=0)
    assert not np.array_equal(arrs["mask"], arrs["mask"].T)
    a = _torch_args(arrs, grad=True)
    r = _torch_args(arrs, grad=True)
    _loss(gn_allpairs.gn_allpairs_aggregate(*a, "elu")).backward()
    _loss(gn_allpairs.gn_allpairs_reference(*r, "elu")).backward()
    for i in (0, 1, 3, 4, 5, 6):
        _close(a[i].grad, r[i].grad.numpy(), 5e-5, _ORDER[i])


def _banded(seed, n=40, reach=5):
    """A mask whose edges lie within ``reach`` of the diagonal, one way more
    than the other (asymmetric)."""
    arrs = _setup(seed, n=n, b=2)
    i, j = np.indices((n, n))
    arrs["mask"] *= ((j - i >= -reach) & (j - i <= reach // 2))
    return arrs


@pytest.mark.parametrize("uniform", [True, False])
def test_band_windows_equal_the_full_sweep(uniform):
    arrs = _banded(4)
    band = band_windows(arrs["mask"], block=8, width_mult=8, uniform=uniform)
    widths = band[1] if isinstance(band[1], tuple) else (band[1],)
    assert max(widths) < 40                   # the windows cut columns
    full = _torch_args(arrs, grad=True)
    windowed = _torch_args(arrs, grad=True)
    out_full = gn_allpairs.gn_allpairs_aggregate(*full, "silu")
    out_band = gn_allpairs.gn_allpairs_aggregate(*windowed, "silu", band)
    _close(out_band, out_full.detach().numpy(), 1e-6)
    _loss(out_full).backward()
    _loss(out_band).backward()
    for g, w, name in zip(_grads(windowed), _grads(full), _GRADS):
        _close(g, w.numpy(), 1e-5, name)


def test_band_windows_ignore_entries_outside():
    """Mask entries outside a window are not edges, in both halves."""
    arrs = _banded(5)
    band = (8, (16,) * 5, (0, 0, 8, 16, 24))
    inside = np.zeros_like(arrs["mask"])
    for k, lo in enumerate(band[2]):
        inside[8 * k:8 * k + 8, lo:lo + 16] = 1.0
    outside = dict(arrs, mask=arrs["mask"] + (1.0 - inside))
    clipped = dict(arrs, mask=arrs["mask"] * inside)
    a = _torch_args(outside, grad=True)
    r = _torch_args(clipped, grad=True)
    _loss(gn_allpairs.gn_allpairs_aggregate(*a, "tanh", band)).backward()
    _loss(gn_allpairs.gn_allpairs_aggregate(*r, "tanh")).backward()
    for g, w, name in zip(_grads(a), _grads(r), _GRADS):
        _close(g, w.numpy(), 1e-5, name)


def test_bf16_inputs():
    arrs = _setup(6, n=16)
    got = gn_allpairs.gn_allpairs_aggregate(*_torch_args(arrs, torch.bfloat16))
    assert got.dtype == torch.float32
    _close(got, j_reference(*_jax_args(arrs)), 0.05)
    want = j_aggregate(*_jax_args(arrs, jnp.bfloat16), "silu", True)
    _close(got, want, 2e-2)


def test_bf16_gradients_match_jax_kernel():
    arrs = _setup(7, n=10, b=2)
    jargs = _jax_args(arrs, jnp.bfloat16)

    def loss_j(p_i, p_j, w2, b2, wg, bg):
        out = j_aggregate(p_i, p_j, jargs[2], w2, b2, wg, bg, "silu", True)
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(loss_j, argnums=tuple(range(6)))(*jargs[:2], *jargs[3:])
    targs = _torch_args(arrs, torch.bfloat16, grad=True)
    _loss(gn_allpairs.gn_allpairs_aggregate(*targs)).backward()
    got = _grads(targs)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.bfloat16
    for g, w, name in zip(got, want, _GRADS):
        scale = max(float(jnp.abs(w.astype(jnp.float32)).max()), 1.0)
        _close(g / scale, np.asarray(w.astype(jnp.float32)) / scale, 2e-2,
               name)


def test_row_blocks_follow_the_jax_layer():
    """Without a window table the plain math takes the JAX layer's block of
    dst rows, ``max(128, min(N, 2^28 / (N h itemsize)))``, over all
    columns; with one, the table's blocks."""
    for n, h, itemsize in ((13, 16, 4), (5016, 64, 4), (5016, 64, 2),
                           (40000, 64, 4)):
        blocks = list(gn_allpairs.row_blocks(n, h, itemsize))
        blk = max(128, min(n, int(2 ** 28 / (n * h * itemsize))))
        assert blocks[0] == (0, min(blk, n), 0, n)
        assert blocks[-1][1] == n and len(blocks) == -(-n // blk)
    assert list(gn_allpairs.row_blocks(10, 16, 4, (4, (3, 2, 5), (0, 6, 5)))
                ) == [(0, 4, 0, 3), (4, 8, 6, 8), (8, 10, 5, 10)]


def test_counters_stay_zero_on_cpu():
    before = (gn_allpairs.gn_allpairs_fwd.launches,
              gn_allpairs.gn_allpairs_bwd.launches)
    targs = _torch_args(_setup(8, n=6), grad=True)
    gn_allpairs.gn_allpairs_aggregate(*targs).sum().backward()
    assert (gn_allpairs.gn_allpairs_fwd.launches,
            gn_allpairs.gn_allpairs_bwd.launches) == before


def test_wrapper_rejects_bad_inputs():
    targs = _torch_args(_setup(9, n=6))
    with pytest.raises(ValueError):
        gn_allpairs.gn_allpairs_fwd(*targs, activation="gelu")
    bad = list(targs)
    bad[2] = bad[2][:, :5]
    with pytest.raises(ValueError):
        gn_allpairs.gn_allpairs_fwd(*bad)
    bad = list(targs)
    bad[0] = bad[0].double()
    with pytest.raises(TypeError):
        gn_allpairs.gn_allpairs_fwd(*bad)
    for band in ((4, 8, (0, 0)), (4, (4, 4), (0, 3)), (4, 4, (0,))):
        with pytest.raises(ValueError):         # windows past N, or too few
            gn_allpairs.gn_allpairs_fwd(*targs, band=band)
