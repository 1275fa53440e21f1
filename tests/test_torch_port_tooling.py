"""The port's tooling against the JAX package's: the trial search
(``exp/hyperopt.py``), the supervisor (``exp/supervise.py``), the roofline
(``obs/roofline.py``: the same bytes and products at the card's rates, K1's
floor the function's own), the
timers and traces (``obs/profiling.py``) and the package logger."""
import importlib
import json
import logging
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sgp_tpu.exp import hyperopt as jhyperopt
from sgp_tpu.obs import roofline as jroof

from sgp_tpu_torch.exp import hyperopt, supervise
from sgp_tpu_torch.obs import roofline, profiling
from sgp_tpu_torch.obs import StepTimer, Throughput, profile_trace, time_fn

ROOT = Path(__file__).resolve().parents[1]

# -- hyperopt ---------------------------------------------------------------

SPACE = {"lr": [1e-2, 1e-3, 1e-4], "hidden_size": [16, 32],
         "dropout": [0.0, 0.1, 0.3, 0.5]}


def test_grid_trials_match_jax():
    assert hyperopt.grid_trials(SPACE) == jhyperopt.grid_trials(SPACE)


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_random_trials_match_jax(seed):
    assert hyperopt.random_trials(SPACE, 9, seed) == \
        jhyperopt.random_trials(SPACE, 9, seed)


def _run_fn(cfg):
    """A pure-Python trial: a score from the config; one config fails."""
    if cfg["hidden_size"] == 32 and cfg["dropout"] == 0.5:
        raise RuntimeError("out of memory (trial)")
    time.sleep(0.01)
    return {"test_mae": abs(np.log10(cfg["lr"]) + 3) + cfg["dropout"]
            + cfg["hidden_size"] / 100 + cfg["base"],
            "val_mae": cfg["dropout"]}


@pytest.mark.parametrize("mode", ["grid", "random"])
@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("minimize", [True, False])
def test_run_search_matches_jax(tmp_path, mode, workers, minimize):
    kw = dict(base_config={"base": 0.5}, space=SPACE, mode=mode,
              n_trials=12, seed=3, minimize=minimize, n_workers=workers)
    got = hyperopt.run_search(_run_fn, out_path=str(tmp_path / "p.json"),
                              **kw)
    ref = jhyperopt.run_search(_run_fn, out_path=str(tmp_path / "j.json"),
                               **kw)
    assert got == ref
    assert any("error" in t for t in got["trials"])
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


# -- supervise --------------------------------------------------------------

RUNNER_WORKER = r"""
import json, sys
from sgp_tpu_torch.exp.common import Experiment
from sgp_tpu_torch.exp.run_largescale_sgp import (
    configure_parser_largescale, run_experiment)
res = Experiment(run_experiment,
                 configure_parser_largescale()).run(sys.argv[1:])
print("RESULT " + json.dumps(
    {k: v for k, v in res.items() if isinstance(v, (int, float))}))
"""

# tests/test_supervise.py's sizes, on the CPU
BASE = ["--dataset-name", "synthetic", "--synthetic-nodes", "12",
        "--synthetic-steps", "160", "--epochs", "4",
        "--batches-epoch", "2", "--reservoir-size", "4",
        "--mlp-size", "8", "--hidden-size", "16", "--batch-size", "8",
        "--seed", "0", "--patience", "5", "--device", "cpu"]


def test_with_resume_dedups():
    assert supervise._with_resume(["a", "--x", "1"]) == \
        ["a", "--x", "1", "--resume", "true"]
    assert supervise._with_resume(["a", "--resume", "false", "--x", "1"]) == \
        ["a", "--x", "1", "--resume", "true"]
    assert supervise._with_resume(["a", "--resume", "--x"]) == \
        ["a", "--x", "--resume", "true"]


def _script(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return [sys.executable, str(path)]


def test_supervisor_restarts_crash_until_success(tmp_path):
    cmd = _script(tmp_path, "flaky.py", "import sys\n"
                  "sys.exit(0 if '--resume' in sys.argv else 7)\n")
    assert supervise.supervise(cmd, max_restarts=2, hang_timeout=0,
                               restart_delay=0,
                               require_checkpoint=False) == 0


def test_supervisor_gives_up_after_max_restarts(tmp_path, capsys):
    cmd = _script(tmp_path, "dead.py",
                  "import sys\nprint('attempt', flush=True)\nsys.exit(3)\n")
    assert supervise.supervise(cmd, max_restarts=1, hang_timeout=0,
                               restart_delay=0,
                               require_checkpoint=False) == 3
    assert capsys.readouterr().out.count("attempt") == 2


def test_supervisor_requires_checkpoint_path():
    with pytest.raises(ValueError, match="checkpoint-path"):
        supervise.supervise([sys.executable, "-c", "pass"], max_restarts=1,
                            hang_timeout=0, restart_delay=0)
    with pytest.raises(SystemExit):
        supervise.main(["--", sys.executable, "-c", "pass"])


def test_supervisor_kills_a_hung_group(tmp_path):
    """No output past the hang timeout: the child's process group is
    killed by its id (a grandchild in the group too) and the failure
    surfaces."""
    pid_file = tmp_path / "grandchild.pid"
    cmd = _script(tmp_path, "hang.py", (
        "import subprocess, sys, time\n"
        "p = subprocess.Popen([sys.executable, '-c', "
        "'import time; time.sleep(300)'])\n"
        f"open({str(pid_file)!r}, 'w').write(str(p.pid))\n"
        "print('up', flush=True)\ntime.sleep(300)\n"))
    t0 = time.time()
    rc = supervise.supervise(cmd, max_restarts=0, hang_timeout=1.0,
                             restart_delay=0, require_checkpoint=False)
    assert rc != 0
    assert time.time() - t0 < 60
    grandchild = int(pid_file.read_text())
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            os.kill(grandchild, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        pytest.fail("the hung child's group outlived the supervisor")


def test_supervisor_recovers_runner_crash(tmp_path, capsys, monkeypatch):
    """End to end on the CPU: the fault hook kills the port's large-scale
    runner at epoch 2; the supervisor restarts it with --resume, and the
    recovered run's test MAE is the uninterrupted run's."""
    from sgp_tpu_torch.exp.common import Experiment
    from sgp_tpu_torch.exp.run_largescale_sgp import (
        configure_parser_largescale, run_experiment)
    full = Experiment(run_experiment,
                      configure_parser_largescale()).run(list(BASE))
    ck = str(tmp_path / "state.ckpt")
    marker = tmp_path / "fault_fired"
    cmd = _script(tmp_path, "worker.py", RUNNER_WORKER) + BASE + [
        "--checkpoint-every", "1", "--checkpoint-path", ck]
    monkeypatch.setenv("SGP_TPU_FAULT", f"epoch:2,marker:{marker}")
    old = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH", str(ROOT) + (
        os.pathsep + old if old else ""))
    capsys.readouterr()
    rc = supervise.supervise(cmd, max_restarts=2, hang_timeout=0,
                             restart_delay=0)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert marker.read_text() == "2"          # the fault really fired
    assert "FAULT INJECTION" in out and "resumed from" in out
    results = [json.loads(line.split("RESULT ", 1)[1])
               for line in out.splitlines() if line.startswith("RESULT ")]
    assert len(results) == 1, out
    np.testing.assert_allclose(results[0]["test_mae"], full["test_mae"],
                               rtol=1e-6)


# -- roofline ---------------------------------------------------------------

def _products(bound, precision):
    """The matrix products a port bound was priced for."""
    rate = {"default": roofline.BF16_FLOPS,
            "highest": roofline.TF32_FLOPS / roofline.TF32_PASSES,
            "fma": roofline.FFMA_FLOPS}[precision]
    return bound.math_seconds * rate


def _jax_products(bound, precision):
    passes = jroof.F32_MXU_PASSES if precision == "highest" else 1
    return bound.mxu_seconds * jroof.PEAK_BF16_FLOPS / passes


def _same_count(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-12)


@pytest.mark.parametrize("n, f", [(207, 64), (5016, 128), (5016, 8192),
                                  (40960, 7)])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_dense_spmm_bound_counts_as_jax(n, f, itemsize, precision):
    got = roofline.dense_spmm_bound(n, f, itemsize, precision)
    ref = jroof.dense_spmm_bound(n, f, itemsize, precision)
    _same_count(got.bytes_seconds * roofline.HBM_BYTES_PER_S,
                ref.hbm_seconds * jroof.HBM_BW_BYTES_S)
    _same_count(_products(got, precision), _jax_products(ref, precision))
    assert got.seconds == max(got.bytes_seconds, got.math_seconds)
    assert got.pipe == "tensor"


@pytest.mark.parametrize("n, e, f", [(300, 2000, 128), (1000, 6000, 200),
                                     (129, 900, 7)])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_bsr_spmm_bound_counts_the_function(n, e, f, precision):
    """K1's floor counts the function's own work, each input read once and
    the output written once, where the JAX module counts its kernel's walk
    of the block store (no floor on the card)."""
    from sgp_tpu_torch.graph import Graph, coalesce
    from sgp_tpu_torch.ops import build_operator
    rng = np.random.default_rng(n)
    g = coalesce(Graph(rng.integers(0, n, e), rng.integers(0, n, e),
                       rng.random(e).astype(np.float32), n))
    op = build_operator(g, "bsr", precision=precision, device="cpu")
    x = torch.zeros((n, f))
    nnzb, n_br = op.blocks.shape[0], op.row_ptr.numel() - 1
    nonzeros = int((op.blocks != 0).sum())
    got = roofline.bsr_spmm_bound(
        nnzb, n_br, f, blk_itemsize=op.blocks.element_size(), n=n,
        nonzeros=nonzeros)
    inputs = sum(t.numel() * t.element_size() for t in (
        op.blocks, op.block_cols, op.row_ptr, op.block_rows, x))
    _same_count(got.bytes, inputs + n * f * 4)
    _same_count(got.bytes_seconds * roofline.HBM_BYTES_PER_S, got.bytes)
    _same_count(got.flops, 2.0 * nonzeros * f)
    _same_count(_products(got, precision), got.flops)
    assert got.seconds == max(got.bytes_seconds, got.math_seconds)
    # every stored entry, and the block rows' span, by default
    full = roofline.bsr_spmm_bound(nnzb, n_br, f,
                                   blk_itemsize=op.blocks.element_size())
    _same_count(full.flops, 2.0 * nnzb * 128 * 128 * f)
    assert full.bytes - got.bytes == (n_br * 128 - n) * f * 8
    # its flops equal the JAX count at F a multiple of 128, its bytes fewer
    ref = jroof.bsr_spmm_bound(nnzb, n_br, 128 * f,
                               blk_itemsize=op.blocks.element_size())
    full = roofline.bsr_spmm_bound(nnzb, n_br, 128 * f,
                                   blk_itemsize=op.blocks.element_size())
    _same_count(full.flops, ref.mxu_seconds * jroof.PEAK_BF16_FLOPS)
    assert full.bytes < ref.hbm_seconds * jroof.HBM_BW_BYTES_S


def test_chip_smoke_k1_bound_is_the_roofline(monkeypatch):
    import chip_smoke
    from sgp_tpu_torch.graph import Graph, coalesce
    from sgp_tpu_torch.ops import build_operator
    monkeypatch.setattr(chip_smoke, "MUFU_RATE", 1.0)
    rng = np.random.default_rng(0)
    g = coalesce(Graph(rng.integers(0, 300, 3000),
                       rng.integers(0, 300, 3000),
                       rng.random(3000).astype(np.float32), 300))
    op = build_operator(g, "bsr", device="cpu")
    x = torch.zeros((300, 64))
    b = roofline.bsr_spmm_bound(
        op.blocks.shape[0], op.row_ptr.numel() - 1, 64, blk_itemsize=4,
        n=300, nonzeros=int((op.blocks != 0).sum()))
    row = chip_smoke.k1_bound(op, x)
    assert row["bytes"] == b.bytes and row["flops"] == b.flops
    np.testing.assert_allclose(row["bound_ms"], b.seconds * 1e3,
                               rtol=1e-12)
    assert row["bound_pipe"] == b.limiter == "bytes"


@pytest.mark.parametrize("edges, n, f", [(501_600, 5016, 128),
                                         (3_000, 207, 64), (819_200, 40960,
                                                            512)])
def test_coo_spmm_bound_counts_as_jax(edges, n, f):
    got = roofline.coo_spmm_bound(edges, n, f)
    ref = jroof.coo_spmm_bound(edges, n, f)
    _same_count(got.bytes_seconds * roofline.HBM_BYTES_PER_S,
                ref.hbm_seconds * jroof.HBM_BW_BYTES_S)
    _same_count(_products(got, "fma"), _jax_products(ref, "default"))
    assert got.pipe == "fma" and got.limiter == "bytes"


@pytest.mark.parametrize("batch, row_bytes, flops, params, block", [
    (4096, 1024, 3.1e9, 12_000_000, 1), (4096, 960, 2.2e10, 4_000_000, 8),
    (64, 256, 1e6, 1000, 1)])
def test_iid_step_bound_counts_as_jax(monkeypatch, batch, row_bytes, flops,
                                      params, block):
    args = (batch, row_bytes, flops, params, block)
    lat = roofline.ROW_GATHER_LAT_S
    got, ref = roofline.iid_step_bound(*args), jroof.iid_step_bound(*args)
    _same_count(got["t_math_bound_s"] * roofline.TF32_FLOPS
                / roofline.TF32_PASSES,
                ref["t_mxu_bound_s"] * jroof.PEAK_BF16_FLOPS)
    _same_count(got["t_adam_bound_s"] * roofline.HBM_BYTES_PER_S,
                ref["t_adam_bound_s"] * jroof.HBM_BW_BYTES_S)
    assert got["math_pipe"] == "tensor"
    parts = (got["t_gather_bound_s"], got["t_math_bound_s"],
             got["t_adam_bound_s"])
    assert got["floor_overlap_s"] == max(parts)
    assert got["floor_serial_s"] == parts[0] + parts[1] + parts[2]
    assert got["t_gather_bound_s"] >= batch // block * lat
    # the gather's bytes alone, and its draws alone
    monkeypatch.setattr(roofline, "ROW_GATHER_LAT_S", 0.0)
    monkeypatch.setattr(jroof, "ROW_GATHER_LAT_S", 0.0)
    _same_count(roofline.iid_step_bound(*args)["t_gather_bound_s"]
                * roofline.HBM_BYTES_PER_S,
                jroof.iid_step_bound(*args)["t_gather_bound_s"]
                * jroof.HBM_BW_BYTES_S)
    monkeypatch.setattr(roofline, "ROW_GATHER_LAT_S", 1.0)
    monkeypatch.setattr(jroof, "ROW_GATHER_LAT_S", 1.0)
    _same_count(roofline.iid_step_bound(*args)["t_gather_bound_s"],
                jroof.iid_step_bound(*args)["t_gather_bound_s"])


@pytest.mark.parametrize("parts, limiter", [
    ((2.0, 1.0), "bytes"), ((1.0, 2.0), "tensor"), ((1.0, 1.0), "bytes"),
    ((0.0, 0.0), "bytes")])
def test_bound_limiter_and_share(parts, limiter):
    b = roofline.Bound(max(parts), *parts)
    assert b.limiter == limiter
    assert b.pct_of(2 * max(parts)) == pytest.approx(0.5 if max(parts)
                                                     else 0.0)
    fma = roofline.Bound(2.0, 1.0, 2.0, pipe="fma")
    assert fma.limiter == "fma"


def test_products_time_picks_the_cheaper_pipe():
    assert roofline.products_time(1e12, "highest") == (
        3e12 / roofline.TF32_FLOPS, "tensor")
    assert roofline.products_time(1e12, "default") == (
        1e12 / roofline.BF16_FLOPS, "tensor")
    assert roofline.products_time(1e12, "fma") == (
        1e12 / roofline.FFMA_FLOPS, "fma")
    with pytest.raises(ValueError, match="precision"):
        roofline.products_time(1.0, "tf32")


def test_no_tpu_constant_in_the_port():
    """The v5e's rates, its six-pass f32 products and the two latency
    floors measured on the TPU stay out of the port's roofline."""
    text = (ROOT / "sgp_tpu_torch/obs/roofline.py").read_text()
    for word in ("819e9", "197e12", "6.5e-7", "5.0e-8", "5e-8", "MXU",
                 "mxu", "v5e"):
        assert word not in text, word
    values = {v for k, v in vars(roofline).items()
              if k.isupper() and isinstance(v, (int, float))}
    for tpu in (jroof.HBM_BW_BYTES_S, jroof.PEAK_BF16_FLOPS,
                jroof.F32_MXU_PASSES, jroof.BSR_BLOCK_LAT_S,
                jroof.ROW_GATHER_LAT_S):
        assert tpu not in values, tpu
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.FFMA_FLOPS == 67e12 and roofline.TF32_FLOPS == 495e12


def test_chip_smoke_bound_reads_the_roofline():
    import chip_smoke
    for name in ("HBM_BYTES_PER_S", "FFMA_FLOPS", "TF32_FLOPS"):
        assert getattr(chip_smoke, name) is getattr(roofline, name)


# -- profiling and the logger -----------------------------------------------

def test_step_timer_summary():
    timer = StepTimer()
    x = torch.ones(4)
    for _ in range(3):
        with timer.time("step", sync=True, result=x):
            x.mul_(2)
    timer.record("load", 0.5)
    timer.record("load", 1.5)
    s = timer.summary()
    assert set(s) == {"step", "load"}
    assert set(s["step"]) == {"mean_s", "total_s", "count"}
    assert s["step"]["count"] == 3 and s["step"]["total_s"] > 0
    assert s["load"] == {"mean_s": 1.0, "total_s": 2.0, "count": 2}
    timer.log_summary()


def test_throughput_and_time_fn():
    tp = Throughput()
    assert tp.rate() == 0.0
    tp.start()
    tp.add(1000)
    time.sleep(0.01)
    assert 0 < tp.rate() < 1000 / 0.01
    calls = []
    a = torch.randn(64, 64)

    def fn(m):
        calls.append(1)
        return {"out": [m @ m]}
    assert time_fn(fn, a, iters=5, warmup=2) > 0
    assert len(calls) == 7


def test_profile_trace_writes_a_trace(tmp_path):
    a = torch.randn(128, 128)
    with profile_trace(str(tmp_path / "trace")) as prof:
        for _ in range(3):
            a = torch.tanh(a @ a)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = [e.get("name", "") for e in trace["traceEvents"]]
    assert sum("aten::mm" in n for n in names) == 3
    assert any("aten::mm" in e.key for e in prof.key_averages())


def test_package_logger():
    import sgp_tpu_torch
    from sgp_tpu.utils.logging import logger as jax_logger
    from sgp_tpu_torch.utils import logging as port_logging
    log = logging.getLogger("sgp_tpu_torch")
    assert sgp_tpu_torch.logger is log is port_logging.logger
    importlib.reload(port_logging)     # a second import adds no handler
    assert len(log.handlers) == 1 and log.propagate is False
    assert log.level == logging.INFO
    handler = log.handlers[0]
    assert type(handler) is logging.StreamHandler
    assert handler.formatter._fmt == jax_logger.handlers[0].formatter._fmt
    # the modules' loggers reach that handler and nothing above it
    child = logging.getLogger("sgp_tpu_torch.train.predictor")
    while not child.handlers:
        assert child.propagate
        child = child.parent
    assert child is log
    assert profiling.logger is supervise.logger is hyperopt.logger is log
