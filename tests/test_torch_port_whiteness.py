"""The port's AZ-whiteness test and residual monitor against the JAX
package's, on the CPU.

The same residuals (numpy, from a seed) go through
``sgp_tpu.analysis.az_whiteness_test`` and the port's float64 tensor
version: univariate and multivariate, per channel, masked, with
``remove_median``, scalar and array edge weights, a fixed and an ``auto``
temporal weight, one step. The statistics agree within TOL (1e-9
relative) where the edge weights are exact in float32 sums (unit, or a
scalar); with an array of weights the JAX test sums the squared float32
weights in float32 and the port in float64, so there within TOL_F32
(1e-6). The p-values within the same tolerances (absolute 1e-12 beside).
Then ``ResidualWhitenessMonitor``: its arguments' checks and messages, and
a stream of residuals (white, then correlated along the edges; with masks
and a ``Graph``'s weights) whose results match the JAX monitor's step by
step.
"""
import numpy as np
import pytest
import torch

from sgp_tpu.analysis import az_whiteness_test as j_az
from sgp_tpu.graph import Graph as JGraph
from sgp_tpu.obs import ResidualWhitenessMonitor as JMonitor

from sgp_tpu_torch.analysis import (AZWhitenessMultiTestResult,
                                    az_whiteness_test, prepare_edges)
from sgp_tpu_torch.graph import Graph
from sgp_tpu_torch.obs import ResidualWhitenessMonitor

TOL = 1e-9
TOL_F32 = 1e-6
T, N, F = 24, 12, 3


def ring_edges(n=N, extra=6, seed=0):
    """A ring with both directions of a few chords, a duplicate and a
    self-loop (the symmetrization's cases)."""
    r = np.random.default_rng(seed)
    src = np.concatenate([np.arange(n), r.integers(0, n, extra), [2, 5]])
    dst = np.concatenate([(np.arange(n) + 1) % n, r.integers(0, n, extra),
                          [3, 5]])
    return np.stack([src, dst])


def same(got, want, tol):
    assert type(got).__name__ == type(want).__name__
    for a, b in ((got.statistic, want.statistic),
                 (got.pvalue, want.pvalue)):
        assert np.isfinite(a), (a, b)
        assert abs(a - b) <= tol * abs(b) + 1e-12, (a, b)
    if hasattr(want, "componentwise_tests"):
        assert isinstance(got, AZWhitenessMultiTestResult)
        assert len(got.componentwise_tests) == len(want.componentwise_tests)
        for g, w in zip(got.componentwise_tests, want.componentwise_tests):
            same(g, w, tol)


def case(rng, kind):
    """``(x, kwargs, tol)`` for one case of the test."""
    x = rng.standard_normal((T, N, F))
    mask = rng.random((T, N, F)) > 0.25
    mask[..., 0] = True      # no residual with every channel masked
    weights = (0.2 + rng.random(ring_edges().shape[1])) * 2
    cases = {
        "univariate": (x[..., :1], {}, TOL),
        "univariate-2d": (x[..., 0], {}, TOL),
        "multivariate": (x, {"multivariate": True}, TOL),
        "per-channel": (x, {}, TOL),
        "masked": (x, {"mask": mask}, TOL),
        "masked-multivariate": (x, {"mask": mask, "multivariate": True}, TOL),
        "remove-median": (x, {"remove_median": True}, TOL),
        "remove-median-masked": (x, {"remove_median": True, "mask": mask},
                                 TOL),
        "scalar-weight": (x, {"edge_weight": 2.5}, TOL),
        "array-weight": (x, {"edge_weight": weights}, TOL_F32),
        "array-weight-masked": (x, {"edge_weight": weights, "mask": mask},
                                TOL_F32),
        "temporal-weight": (x, {"edge_weight_temporal": 0.7, "lamb": 0.3},
                            TOL),
        "auto": (x[..., :1], {"edge_weight_temporal": "auto"}, TOL),
        "one-step": (x[:1], {}, TOL),
        "correlated": (np.repeat(rng.standard_normal((T, 1, 1)), N, 1)
                       + 0.05 * x[..., :1], {}, TOL),
    }
    return cases[kind]


KINDS = ["univariate", "univariate-2d", "multivariate", "per-channel",
         "masked", "masked-multivariate", "remove-median",
         "remove-median-masked", "scalar-weight", "array-weight",
         "array-weight-masked", "temporal-weight", "auto", "one-step",
         "correlated"]


@pytest.mark.parametrize("kind", KINDS)
def test_az_whiteness_matches(rng, kind):
    """numpy in, as the JAX test takes it; and the same residuals as a
    tensor (with a tensor mask) give the same result."""
    x, kwargs, tol = case(rng, kind)
    ei = ring_edges()
    want = j_az(x, ei, **kwargs)
    same(az_whiteness_test(x, ei, **kwargs), want, tol)
    tk = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
          for k, v in kwargs.items()}
    same(az_whiteness_test(torch.as_tensor(x), torch.as_tensor(ei), **tk),
         want, tol)


def test_exact_zeros_have_no_sign(rng):
    """Masked entries are zeroed before the products: their sign is 0 in
    both, whatever the masked values were."""
    x, _, _ = case(rng, "univariate")
    mask = np.ones_like(x, bool)
    mask[:, :4] = False
    x2 = x.copy()
    x2[:, :4] = 1e6
    ei = ring_edges()
    want = j_az(x, ei, mask=mask)
    same(az_whiteness_test(x2, ei, mask=mask), want, TOL)
    same(az_whiteness_test(x, ei, mask=mask), want, TOL)


def test_all_channels_masked_gives_nan_with_remove_median(rng):
    """A residual whose channels are all masked has no median: the JAX
    test's result is NaN with ``remove_median``, and so is the port's."""
    x, _, _ = case(rng, "per-channel")
    mask = np.ones_like(x, bool)
    mask[3, 5] = False
    kw = {"mask": mask, "remove_median": True, "multivariate": True}
    with np.errstate(invalid="ignore"), pytest.warns(RuntimeWarning):
        want = j_az(x, ring_edges(), **kw)
    got = az_whiteness_test(x, ring_edges(), **kw)
    assert np.isnan(want.statistic) and np.isnan(got.statistic)


def test_prepared_edges_give_the_same_result(rng):
    """``prepare_edges`` once (as the monitor does) or the edge list each
    call: the same statistic; non-positive weights are refused."""
    x, _, _ = case(rng, "per-channel")
    ei = ring_edges()
    w = np.linspace(0.5, 2.0, ei.shape[1])
    edges = prepare_edges(ei, w)
    assert edges.index.dtype == torch.int64
    assert edges.weight.dtype == torch.float32
    a = az_whiteness_test(x, edges)
    b = az_whiteness_test(x, ei, edge_weight=w)
    assert a.statistic == b.statistic and a.pvalue == b.pvalue
    with pytest.raises(AssertionError):
        prepare_edges(ei, -w)


@pytest.mark.parametrize("window,min_steps,match", [
    (4, 8, "never run a test"), (16, 1, "min_steps must be >= 2")])
def test_monitor_checks_its_arguments(window, min_steps, match):
    ei = ring_edges()
    for cls in (JMonitor, ResidualWhitenessMonitor):
        with pytest.raises(ValueError, match=match):
            cls(ei, window=window, min_steps=min_steps)


@pytest.mark.parametrize("graph,masked", [(False, False), (True, True)])
def test_monitor_matches_jax_monitor(rng, graph, masked):
    """A residual stream, white then correlated along the edges, through
    both monitors: every step's result (None before ``min_steps``), its
    ``flagged``; then ``reset``."""
    ei = ring_edges()
    if graph:
        w = (0.5 + rng.random(ei.shape[1])).astype(np.float32)
        jm = JMonitor(JGraph(ei[0], ei[1], w, N), window=16, min_steps=6,
                      alpha=0.01)
        tm = ResidualWhitenessMonitor(Graph(ei[0], ei[1], w, N), window=16,
                                      min_steps=6, alpha=0.01)
        tol = TOL_F32
    else:
        jm = JMonitor(ei, window=16, min_steps=6, alpha=0.01)
        tm = ResidualWhitenessMonitor(ei, window=16, min_steps=6,
                                      alpha=0.01)
        tol = TOL
    flags = []
    for step in range(40):
        r = rng.standard_normal((N, 2))
        if step >= 20:
            r = r * 0.05 + rng.standard_normal()
        m = (rng.random((N, 2)) > 0.2) if masked and step % 3 else None
        want = jm.update(r, m)
        got = tm.update(torch.as_tensor(r) if step % 2 else r, m)
        if want is None:
            assert got is None and tm.last_result is None
            continue
        same(got, want, tol)
        assert got.flagged == want.flagged
        flags.append(got.flagged)
    assert not flags[0] and flags[-1]
    tm.reset()
    assert tm.update(rng.standard_normal((N, 2))) is None
