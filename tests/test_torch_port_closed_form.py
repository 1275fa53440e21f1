"""The port's closed-form runner (``exp/run_closed_form.py``) against the
JAX runner on the same command line, both routes, at 2 x 16 reservoir
units on 16 synthetic nodes x 200 steps, horizon 3.

The two packages' GESN layers are bit-identical and their encodings agree
to ~1e-6, but the ridge solve is ill-conditioned (cond(G + aI) ~1.6e4
here): each package's f32 Gram rounds differently, and the test MAE of an
f32 fit moves by up to ~2.4e-4 (of 5.2) against a float64 fit of the same
design. So each run is repeated with its readout in float64 (Gram and
solve), and:

- the float64 runs of the two packages agree within 1e-5 relative (this
  holds the encode, the design matrix and the evaluation);
- the f32 runs agree within max(1e-5 relative, 3 x the larger of the two
  packages' f32-vs-float64 gaps), metric by metric.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgp_tpu.train.ridge as j_ridge
from sgp_tpu.exp import run_closed_form as j_runner
from sgp_tpu.exp.common import Experiment as JExperiment
from sgp_tpu.utils.config import config as jax_config

import sgp_tpu_torch.exp.run_closed_form as runner
from sgp_tpu_torch.exp.common import Experiment
from sgp_tpu_torch.utils.config import config as torch_config

torch.set_num_threads(1)

ARGS = ["--dataset-name", "synthetic", "--synthetic-nodes", "16",
        "--synthetic-steps", "200", "--reservoir-size", "16",
        "--reservoir-layers", "2", "--horizon", "3", "--seed", "0"]
KEYS = {f"{s}_{m}" for s in ("val", "test") for m in ("mae", "mse", "mape")}
REL = 1e-5


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setitem(torch_config, "logs_dir", str(tmp_path / "torch"))
    monkeypatch.setattr(jax_config, "logs_dir", str(tmp_path / "jax"))


def _f64_fit(design, ys, alpha):
    """sklearn's centred ridge in float64: ``[(W, b)]`` a lag."""
    x = np.asarray(design, np.float64)
    xm = x.mean(0)
    xc = x - xm
    g = xc.T @ xc + alpha * np.eye(x.shape[1])
    out = []
    for y in ys:
        y = np.asarray(y, np.float64)
        ym = y.mean(0)
        w = np.linalg.solve(g, xc.T @ (y - ym))
        out.append((w.astype(np.float32), (ym - xm @ w).astype(np.float32)))
    return out


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().cpu().numpy()
    return np.asarray(a, np.float32)


def _f64_streaming(as_array):
    """A float64 stand-in for ``closed_form_readout_streaming``: the
    design of the train steps from the parts, each lag's targets."""
    def fit(feats, targets, train_steps, horizon, alpha=1.0, chunk=256):
        parts = feats if isinstance(feats, (list, tuple)) else [feats]
        host = [_host(p) for p in parts]
        tgt = _host(targets)
        design = np.concatenate([p[train_steps] for p in host], -1)
        c = tgt.shape[-1]
        sol = _f64_fit(design.reshape(-1, design.shape[-1]),
                       [tgt[train_steps + lag].reshape(-1, c)
                        for lag in range(1, horizon + 1)], alpha)
        return [(as_array(w), as_array(b)) for w, b in sol]
    return fit


def _run(monkeypatch, port: bool, resident: bool, f64: bool):
    argv = ARGS + ["--device-resident", str(resident).lower()]
    with monkeypatch.context() as m:
        if port:
            argv = argv + ["--device", "cpu"]
            if f64:
                m.setattr(runner, "closed_form_readout",
                          lambda x, ys, alpha, device: [
                              (torch.as_tensor(w), torch.as_tensor(b))
                              for w, b in _f64_fit(x, ys, alpha)])
                m.setattr(runner, "closed_form_readout_streaming",
                          _f64_streaming(torch.as_tensor))
            return Experiment(runner.run_experiment,
                              runner.configure_parser()).run(argv)
        if f64:
            m.setattr(j_runner, "closed_form_readout",
                      lambda x, ys, alpha: [
                          (jnp.asarray(w), jnp.asarray(b))
                          for w, b in _f64_fit(x, ys, alpha)])
            m.setattr(j_ridge, "closed_form_readout_streaming",
                      _f64_streaming(jnp.asarray))
        return JExperiment(j_runner.run_experiment,
                           j_runner.configure_parser()).run(argv)


@pytest.mark.parametrize("resident", [False, True],
                         ids=["host", "device-resident"])
def test_runner_matches_jax_runner(monkeypatch, resident):
    res = {(port, f64): _run(monkeypatch, port, resident, f64)
           for port in (False, True) for f64 in (False, True)}
    for r in res.values():
        assert set(r) == KEYS
        assert all(np.isfinite(v) for v in r.values()), r
    for k in KEYS:
        want, got = res[False, True][k], res[True, True][k]
        assert abs(got - want) <= REL * abs(want), (k, got, want)
        gap = max(abs(res[p, False][k] - res[p, True][k])
                  for p in (False, True))
        tol = max(REL * abs(res[False, False][k]), 3 * gap)
        diff = abs(res[True, False][k] - res[False, False][k])
        assert diff <= tol, (k, diff, tol, gap)


def test_runner_defaults_to_the_card(monkeypatch):
    """No ``--device``: the runner asks for ``cuda:0`` and raises without a
    card instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment(runner.run_experiment, runner.configure_parser()).run(
            list(ARGS))
