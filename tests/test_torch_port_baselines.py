"""The port's baseline runners against the JAX package's, on the CPU.

Both runners run at ``tests/test_runners.py``'s baseline size (16 nodes,
160 steps, window 4, horizon 3, hidden 8, batch 8, 2 epochs of 2 batches;
the large-scale runner with 6 roots, ``--subgraph-k 1`` and
``--max-edges 64``) with GatedGN on ``--gn-aggregation`` edges, ell and
dense, and with DCRNN, GraphWaveNet, the GRU and LSTM models, FC-LSTM and
the TCN, the port's runner starting from the JAX run's initial weights
(carried with ``flax_to_torch``). The loaders draw the same batches from the same seed,
so both take the same run: the test metrics agree within TOL_RUN relative
(f32 sums in other orders through 4 Adam steps; measured at most 2.7e-6,
FC-LSTM on the traffic runner, and 8.1e-7 on the large-scale one). The TCN
runs at its model's 3 layers: at ``--n-layers 1`` one horizon step's
decoder bias has a gradient that is 0 in exact arithmetic (its residual
signs cancel), and the first Adam step turns the packages' rounding noise
in it into a step of lr / 2 (``test_torch_port_rnn.py`` holds that
layer's Predictor step with the rule for such gradients).

Also: the untrained runs (``--epochs 0``) agree, the port's runner writes
``best.pt`` and ``metrics.jsonl``, a graph model on node-subset batches
(``--subgraph-k 0``) raises before any step, the options not ported
raise by name, and a real dataset whose files are absent raises naming
them.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import sgp_tpu.train.predictor as j_predictor
from sgp_tpu.exp.common import Experiment as JExperiment
from sgp_tpu.exp import run_largescale_baselines as j_large
from sgp_tpu.exp import run_traffic_baselines as j_traffic
from sgp_tpu.utils.config import config as jax_config

import sgp_tpu_torch.train.predictor as t_predictor
from sgp_tpu_torch.exp import run_largescale_baselines as t_large
from sgp_tpu_torch.exp import run_traffic_baselines as t_traffic
from sgp_tpu_torch.exp.common import Experiment
from sgp_tpu_torch.models import flax_to_torch
from sgp_tpu_torch.utils.config import config as torch_config

torch.set_num_threads(1)

BASE = ["--dataset-name", "synthetic", "--synthetic-nodes", "16",
        "--synthetic-steps", "160", "--epochs", "2", "--batches-epoch", "2",
        "--hidden-size", "8", "--ff-size", "8", "--batch-size", "8",
        "--window", "4", "--horizon", "3", "--seed", "0", "--patience", "5"]
SUBGRAPH = ["--num-subgraph-nodes", "6", "--subgraph-k", "1",
            "--max-edges", "64"]
TOL_RUN = 1e-5
METRICS = ("test_mae", "test_mse", "test_mape")


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setitem(torch_config, "logs_dir", str(tmp_path / "torch"))
    monkeypatch.setattr(jax_config, "logs_dir", str(tmp_path / "jax"))


def _carried_runs(monkeypatch, runner: str, argv):
    """The JAX runner, then the port's from the JAX run's initial weights;
    returns both results and the port's log directory."""
    j_mod, t_mod = (j_large, t_large) if runner == "largescale" \
        else (j_traffic, t_traffic)
    params = []
    j_init, t_init = j_predictor.Predictor.init, t_predictor.Predictor.init

    def record(self, *a, **k):
        out = j_init(self, *a, **k)
        params.append(jax.tree.map(np.asarray, self.params))
        return out

    def carry(self, *a, **k):
        out = t_init(self, *a, **k)
        flax_to_torch(params[-1], self.model)
        return out

    logdirs = []

    def run_port(args):
        logdirs.append(args.logdir)
        return t_mod.run_experiment(args)

    monkeypatch.setattr(j_predictor.Predictor, "init", record)
    monkeypatch.setattr(t_predictor.Predictor, "init", carry)
    want = JExperiment(j_mod.run_experiment,
                       j_traffic.configure_parser()).run(list(argv))
    got = Experiment(run_port, t_traffic.configure_parser()).run(
        list(argv) + ["--device", "cpu"])
    return want, got, logdirs[-1]


# (runner, model, --gn-aggregation or None, further flags); the diffusion
# models train on their runners' supports (the large-scale runner's COO
# supports from each subgraph batch), rnn and fc_rnn with both cells
CASES = [("largescale", "gatedgn", agg, []) for agg in ("edges", "ell",
                                                       "dense")] \
    + [("largescale", "gatedgn_conv", "ell", []),
       ("traffic", "gatedgn", "edges", []), ("traffic", "gatedgn", "ell", []),
       ("traffic", "gatedgn", "dense", []),
       ("traffic", "gatedgn_conv", "edges", []),
       ("largescale", "dcrnn", None, []), ("largescale", "gwnet", None, []),
       ("traffic", "dcrnn", None, []),
       # traffic/gwnet.yaml's weight decay (AdamW)
       ("traffic", "gwnet", None, ["--l2-reg", "0.0001"]),
       ("traffic", "rnn", None, ["--cell-type", "gru"]),
       ("traffic", "rnn", None, ["--cell-type", "lstm"]),
       ("traffic", "fc_rnn", None, ["--cell-type", "lstm"]),
       ("traffic", "tcn", None, ["--n-layers", "3"])]


@pytest.mark.parametrize("runner,model,agg,flags", CASES, ids=[
    "-".join([r, m] + ([a] if a else []) + f[1:]) for r, m, a, f in CASES])
def test_runner_matches_jax_runner(monkeypatch, runner, model, agg, flags):
    argv = BASE + ["--model-name", model] + flags
    if agg is not None:
        argv += ["--gn-aggregation", agg]
    argv += SUBGRAPH if runner == "largescale" else ["--adj-knn", "4"]
    want, got, logdir = _carried_runs(monkeypatch, runner, argv)
    assert set(got) == set(want)
    for k in METRICS:
        assert np.isfinite(got[k]) and np.isfinite(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=TOL_RUN, err_msg=k)
    print(f"{runner} {model} {agg} {flags}: test metrics max rel diff", max(
        abs(got[k] - want[k]) / abs(want[k]) for k in METRICS))
    assert os.path.exists(os.path.join(logdir, "best.pt"))
    with open(os.path.join(logdir, "metrics.jsonl")) as fp:
        logs = [json.loads(line) for line in fp]
    assert [r["_step"] for r in logs] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in logs)


@pytest.mark.parametrize("runner", ["largescale", "traffic"])
def test_untrained_runner_matches_jax_runner(monkeypatch, runner):
    """``--epochs 0``: the initial weights' test metrics, the init batch
    drawn from the train loader as in a trained run."""
    argv = BASE + ["--model-name", "gatedgn", "--gn-aggregation", "ell",
                   "--epochs", "0"]
    argv += SUBGRAPH if runner == "largescale" else ["--adj-knn", "4"]
    want, got, _ = _carried_runs(monkeypatch, runner, argv)
    print(f"{runner} untrained: test metrics max rel diff", max(
        abs(got[k] - want[k]) / abs(want[k]) for k in METRICS))
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL_RUN, err_msg=k)


def test_transformer_on_node_subsets_runs():
    """A model without a graph on SubsetLoader batches stays legal."""
    res = Experiment(t_large.run_experiment, t_traffic.configure_parser()).run(
        BASE + ["--model-name", "transformer", "--subgraph-k", "0",
                "--device", "cpu"])
    assert all(np.isfinite(res[k]) for k in METRICS)


@pytest.mark.parametrize("model", ["gatedgn", "gatedgn_conv", "dcrnn",
                                   "gwnet"])
def test_graph_model_on_node_subsets_raises(monkeypatch, model):
    """``--subgraph-k 0`` would pair node-subset batches with the full
    graph's edges: the port refuses before building anything."""
    def no_data(*a, **k):
        raise AssertionError("the check must come before the data")

    monkeypatch.setattr(t_large, "get_dataset", no_data)
    with pytest.raises(ValueError, match="subgraph-k 0"):
        Experiment(t_large.run_experiment, t_traffic.configure_parser()).run(
            BASE + ["--model-name", model, "--subgraph-k", "0",
                    "--device", "cpu"])


@pytest.mark.parametrize("argv,error,match", [
    # the METR-LA loader reads local files only: none are in the
    # repository, so it names the paths it expected
    (["--dataset-name", "la"], FileNotFoundError,
     "metr_la.h5 and .*metr_la_dist.npy"),
    # ported (the SGP runner's model); the baseline runners, as the JAX
    # ones, do not take it
    (["--model-name", "esn"], ValueError, "not available"),
    (["--model-name", "sgp"], ValueError, "not available"),
    # --data-sharding batch runs (tests/test_torch_port_dp.py); the
    # baseline runners, as the JAX ones, take no node sharding
    (["--model-name", "gatedgn", "--data-sharding", "nodes"],
     SystemExit, "2")],
    ids=["dataset-la", "esn", "sgp", "data-sharding"])
def test_options_not_ported_raise(argv, error, match):
    with pytest.raises(error, match=match):
        Experiment(t_traffic.run_experiment, t_traffic.configure_parser()).run(
            BASE + argv + ["--device", "cpu"])


def test_runners_default_to_the_card(monkeypatch):
    """No ``--device``: the runner asks for ``cuda:0`` and raises without a
    card instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment(t_large.run_experiment, t_traffic.configure_parser()).run(
            BASE + SUBGRAPH + ["--model-name", "gatedgn"])
