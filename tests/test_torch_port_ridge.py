"""The port's closed-form ridge readout against the JAX package's
``train/ridge.py`` on the same numpy inputs (well-conditioned designs: the
f32 Gram's rounding moves the solution by ~cond x 6e-8, so 2e-5 of the
largest weight), and its fallback solve: at alpha = 0 on a rank-deficient
design Cholesky fails in both packages and both return the minimum-norm
least-squares solution (JAX's ``jnp.linalg.lstsq``, the port's SVD
pseudo-inverse), held to each other and to numpy's float64 ``lstsq``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.train import ridge as jridge

from sgp_tpu_torch.train import ridge

torch.set_num_threads(1)

TOL = 2e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, \
        np.abs(got - want).max() / scale


def _problem(rng, n=600, d=17, c=3):
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (x @ rng.standard_normal((d, c)) + 0.1 * rng.standard_normal((n, c))
         + 2.0).astype(np.float32)
    return x, y


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_ridge_regression_matches_jax_chunked_or_not(rng, fit_intercept):
    x, y = _problem(rng)
    jw, jb = jridge.ridge_regression(x, y, alpha=0.7,
                                     fit_intercept=fit_intercept)
    w, b = ridge.ridge_regression(x, y, alpha=0.7,
                                  fit_intercept=fit_intercept, device="cpu")
    assert w.shape == (17, 3) and b.shape == (3,)
    _close(w, jw)
    if fit_intercept:
        _close(b, jb)
    else:
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    # the two-pass chunked branch (a ragged last chunk) gives the same fit
    w2, b2 = ridge.ridge_regression(x, y, alpha=0.7,
                                    fit_intercept=fit_intercept, chunk=128,
                                    device="cpu")
    _close(w2, w, 1e-5)
    if fit_intercept:
        _close(b2, b, 1e-5)


def test_closed_form_readout_matches_jax(rng):
    x, y = _problem(rng)
    ys = [y, y * 0.5 - 1.0, np.roll(y, 3, 0)]
    want = jridge.closed_form_readout(x, ys, alpha=0.3)
    got = ridge.closed_form_readout(x, ys, alpha=0.3, device="cpu")
    assert len(got) == len(want) == 3
    for (w, b), (jw, jb) in zip(got, want):
        _close(w, jw)
        _close(b, jb)


def _series(rng, t=40, n=6, c=2):
    """A feature series in two parts (f32 and bf16, as the device-resident
    route keeps them) and targets."""
    a = rng.standard_normal((t, n, c)).astype(np.float32)
    e = rng.standard_normal((t, n, 5)).astype(np.float32)
    e = np.asarray(torch.as_tensor(e).to(torch.bfloat16).float())
    return a, e


@pytest.mark.parametrize("steps_kind", ["contiguous", "gathered"])
@pytest.mark.parametrize("parts", [1, 2])
def test_streaming_readout_matches_jax(rng, steps_kind, parts):
    """Contiguous and gathered train steps, a ragged last chunk (23 steps
    in chunks of 8), one or two feature parts (concatenated per chunk); the
    same fit as the one-shot readout on the flattened design."""
    a, e = _series(rng)
    horizon = 3
    steps = np.arange(2, 25) if steps_kind == "contiguous" else \
        np.sort(rng.choice(36, 23, replace=False))
    feats = [a, e] if parts == 2 else [np.concatenate([a, e], -1)]
    want = jridge.closed_form_readout_streaming(
        [jnp.asarray(p) for p in feats], jnp.asarray(a), steps, horizon,
        alpha=0.5, chunk=8)
    got = ridge.closed_form_readout_streaming(
        [torch.as_tensor(p) for p in feats] if parts == 2
        else torch.as_tensor(feats[0]), torch.as_tensor(a), steps, horizon,
        alpha=0.5, chunk=8)
    design = np.concatenate(feats, -1)[steps].reshape(-1, 7)
    flat = ridge.closed_form_readout(
        design, [a[steps + lag].reshape(-1, 2)
                 for lag in range(1, horizon + 1)], alpha=0.5, device="cpu")
    for (w, b), (jw, jb), (fw, fb) in zip(got, want, flat):
        assert w.shape == (7, 2) and b.shape == (2,)
        _close(w, jw)
        _close(b, jb)
        _close(w, fw)
        _close(b, fb)


def test_take_steps_and_gather_feat_parts(rng):
    a, e = _series(rng)
    ta, te = torch.as_tensor(a), torch.as_tensor(e).to(torch.bfloat16)
    for steps in (np.array([4]), np.arange(3, 9), np.array([1, 5, 2])):
        np.testing.assert_array_equal(ridge.take_steps(ta, steps).numpy(),
                                      a[steps])
        got = ridge.gather_feat_parts([ta, te], steps)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), np.concatenate([a[steps], e[steps]], -1))
    # a contiguous run is a view of the resident array, not a copy
    assert ridge.take_steps(ta, np.arange(3, 9)).data_ptr() == \
        ta[3].data_ptr()


def _rank_deficient(rng, n=80, d=6, c=2):
    """A design with a zero column and two equal ones, centred: its Gram
    has an exact zero row and column, so Cholesky fails at alpha = 0."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, 2] = 0.0
    x[:, 4] = x[:, 1]
    x -= x.mean(0)
    y = rng.standard_normal((n, c)).astype(np.float32)
    return x, y


def test_fallback_solve_is_the_minimum_norm_lstsq(rng):
    x, y = _rank_deficient(rng)
    g, m = x.T @ x, x.T @ y
    chol, info = torch.linalg.cholesky_ex(torch.as_tensor(g))
    assert int(info) != 0            # the port takes the fallback
    want = np.asarray(jridge.solve_ridge_normal(jnp.asarray(g),
                                                jnp.asarray(m), 0.0))
    assert np.isfinite(want).all()   # JAX took its lstsq fallback too
    got = ridge.solve_ridge_normal(torch.as_tensor(g), torch.as_tensor(m),
                                   0.0)
    _close(got, want, 1e-4)
    ref = np.linalg.lstsq(g.astype(np.float64), m.astype(np.float64),
                          rcond=None)[0]
    _close(got, ref, 1e-4)
    # the minimum-norm solution: nothing on the zero column, the two equal
    # columns share their weight
    np.testing.assert_allclose(got.numpy()[2], 0.0, atol=1e-5)
    np.testing.assert_allclose(got.numpy()[1], got.numpy()[4], rtol=1e-3)


def test_fallback_on_an_indefinite_system(rng):
    """A negative alpha makes the system indefinite: Cholesky fails, and
    the fallback solves the full-rank system exactly."""
    x, y = _problem(rng, n=50, d=5, c=2)
    g, m = x.T @ x, x.T @ y
    alpha = -float(np.linalg.eigvalsh(g.astype(np.float64))[0]) - 1.0
    want = np.asarray(jridge.solve_ridge_normal(jnp.asarray(g),
                                                jnp.asarray(m), alpha))
    got = ridge.solve_ridge_normal(torch.as_tensor(g), torch.as_tensor(m),
                                   alpha)
    ref = np.linalg.solve(g.astype(np.float64) + alpha * np.eye(5),
                          m.astype(np.float64))
    _close(got, ref, 1e-3)
    _close(got, want, 1e-3)


def test_positive_alpha_solves_by_cholesky(rng):
    x, y = _problem(rng, n=50, d=5, c=2)
    g, m = torch.as_tensor(x.T @ x), torch.as_tensor(x.T @ y)
    a = g + 0.4 * torch.eye(5)
    want = torch.cholesky_solve(m, torch.linalg.cholesky(a))
    assert torch.equal(ridge.solve_ridge_normal(g, m, 0.4), want)
