"""The port's similarity functions against the JAX package's, on the CPU.

- The gaussian kernels and the haversine distance stay numpy: equal, the
  haversine within 1e-9 relative.
- ``pearson_similarity`` (f32), ``corrcoef`` (float64, ``np.corrcoef(x,
  rowvar=False)``) and ``correntropy`` (f32 RBF per window, float64 sums)
  run on the device named (here the CPU): within 1e-6 of the JAX
  functions at periods of 12-24 steps, with and without a mask, with NaNs,
  and with a length that ends exactly on a window (dropped, as JAX drops
  it). Without ``device`` they ask for the card. (At longer periods f32's
  rounding of ``sq_i + sq_j - 2 x_i . x_j`` alone exceeds 1e-6 in either
  package: ``test_torch_port_datasets.py::_close_correntropy`` holds the
  weekly period by that bound.)
- ``get_connectivity`` graphs built from them, with k-nn: ``top_k`` runs on
  the f32 similarity, so two packages one rounding apart may swap a row's
  k-th and (k+1)-th neighbour. Rows whose k-th and (k+1)-th values lie
  further apart than TOL_SIM are held edge for edge; the others are
  excused and counted.
"""
import numpy as np
import pytest
import torch

import sgp_tpu.graph.similarities as j_sim
from sgp_tpu.data.datasets.base import TabularDataset as JTabular

import sgp_tpu_torch.graph.similarities as t_sim
from sgp_tpu_torch.data.datasets.base import TabularDataset

torch.set_num_threads(1)

TOL_SIM = 1e-6


def test_gaussian_kernels_equal(rng):
    x = rng.random((9, 9)) * 10
    for theta, threshold, on_input in ((None, None, False), (2.0, 0.3, False),
                                       (3.0, 4.0, True)):
        np.testing.assert_array_equal(
            t_sim.thresholded_gaussian_kernel(x, theta, threshold, on_input),
            j_sim.thresholded_gaussian_kernel(x, theta, threshold, on_input))


@pytest.mark.parametrize("to_rad", [True, False])
def test_geographical_distance(rng, to_rad):
    latlon = np.stack([rng.uniform(25, 48, 40), rng.uniform(-125, -70, 40)],
                      axis=1)
    if not to_rad:
        latlon = np.radians(latlon)
    got = t_sim.geographical_distance(latlon, to_rad=to_rad)
    assert got.dtype == np.float64
    np.testing.assert_allclose(
        got, j_sim.geographical_distance(latlon, to_rad=to_rad), rtol=1e-9)


def test_pearson_similarity_matches_jax(rng):
    x = rng.standard_normal((12, 200)).astype(np.float32)
    x[3] = x[1] * 2 + 0.01 * x[3]
    got = t_sim.pearson_similarity(x, device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, j_sim.pearson_similarity(x), rtol=0,
                               atol=TOL_SIM)


def test_corrcoef_is_numpys(rng):
    x = rng.standard_normal((300, 15)).astype(np.float32)
    got = t_sim.corrcoef(x, device="cpu")
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, np.corrcoef(x, rowvar=False), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("t,period,masked", [
    (200, 12, False), (145, 24, True), (193, 16, True), (120, 24, False)],
    ids=["period12", "period24-masked", "period16-masked", "ends-on-window"])
def test_correntropy_matches_jax(rng, t, period, masked):
    n = 14
    x = rng.standard_normal((t, n)).astype(np.float32)
    x[:, 5] = x[:, 2] + 0.05 * x[:, 5]
    mask = None
    if masked:
        mask = rng.random((t, n)) > 0.01
    else:
        x[7, 3] = np.nan                      # a window with a NaN
    got = t_sim.correntropy(x, period, mask=mask, device="cpu")
    want = j_sim.correntropy(x, period, mask=mask)
    assert got.dtype == np.float64 and got.shape == (n, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_SIM)
    # float64 input: the same formula in float64
    exact = t_sim.correntropy(x.astype(np.float64), period, mask=mask,
                              device="cpu")
    np.testing.assert_allclose(got, exact, rtol=0, atol=TOL_SIM)


def test_correntropy_takes_tensors_and_defaults_to_the_card(monkeypatch):
    x = torch.randn(50, 4, generator=torch.Generator().manual_seed(0))
    got = t_sim.correntropy(x, 12, device="cpu")
    np.testing.assert_allclose(got, j_sim.correntropy(x.numpy(), 12),
                               rtol=0, atol=TOL_SIM)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, args in ((t_sim.correntropy, (x, 12)),
                     (t_sim.pearson_similarity, (x.T,)),
                     (t_sim.corrcoef, (x,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)


def _datasets(x, period):
    """One dataset class per package over the same series, its similarity
    the package's correntropy."""
    def make(base, corr):
        class Series(base):
            similarity_options = {"correntropy"}

            def load(self):
                self.target = x[..., None]

            def compute_similarity(self, method, **kwargs):
                return corr(x, period, **{k: v for k, v in kwargs.items()
                                          if k == "device"})
        return Series(root="unused")
    return make(TabularDataset, t_sim.correntropy), make(JTabular,
                                                         j_sim.correntropy)


def held_graphs(got, want, sim, k: int, tol: float = TOL_SIM) -> int:
    """Hold two k-nn graphs edge for edge on the rows whose k-th and
    (k+1)-th similarity (self excluded) lie further apart than ``tol``;
    returns the count of rows excused."""
    s = np.array(sim, np.float32)
    np.fill_diagonal(s, -np.inf)
    top = -np.sort(-s, axis=1)
    clear = (top[:, k - 1] - top[:, k]) > tol
    a, b = got.to_dense(), np.asarray(want.to_dense())
    np.testing.assert_array_equal(a[clear] != 0, b[clear] != 0)
    np.testing.assert_allclose(a[clear], b[clear], rtol=0, atol=tol)
    return int((~clear).sum())


def test_knn_graph_matches_jax_away_from_ties(rng):
    t, n, period, k = 400, 60, 24, 8
    season = np.sin(2 * np.pi * np.arange(t) / period)[:, None]
    x = (season * rng.random(n) + 0.5 * rng.standard_normal((t, n))).astype(
        np.float32)
    port, jax_ds = _datasets(x, period)
    g = port.get_connectivity(knn=k, include_self=False, device="cpu")
    jg = jax_ds.get_connectivity(knn=k, include_self=False)
    excused = held_graphs(g, jg, t_sim.correntropy(x, period, device="cpu"),
                          k)
    print(f"rows excused as near ties: {excused} of {n}")
    assert excused < n // 4
    assert g.num_edges == n * k
