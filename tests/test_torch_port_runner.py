"""The port's large-scale SGP runner against the JAX package's, and its
scaffolding: the flat config reader, flag merging, checkpoint and resume,
and the branches that are not ported.

The done criterion (``test_runner_matches_jax_runner``) runs both runners
at ``tests/test_runners.py``'s ``BASE`` size (12 nodes, 160 steps,
reservoir 4, hidden 16, MLP 8, batch 8) for 16 epochs of 4 steps, the
port's on the JAX run's initial weights (``flax_to_torch``) and (time,
node) draws, so that both take the same run: the test MAEs agree within
TOL_RUN relative. Measured on this size: 6.5e-7 on the streaming-packed
path (f32 sums in another order), 8.5e-5 on the ``encode_dataset`` path,
where one of the 15,360 bf16 features rounds the other way and the MAE's
kinks carry it through 64 steps. Both runners' test MAE lies below that
of the untrained model. Without the carried weights and draws,
four seeds gave runs whose MAEs differ by 6-28% between the packages and
by as much between seeds of one package: the tiny runs pick their best
epoch by the loss of 8 samples.
"""
import argparse
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sgp_tpu.exp.common import Experiment as JExperiment
from sgp_tpu.exp.run_largescale_sgp import \
    configure_parser_largescale as j_parser
from sgp_tpu.exp.run_largescale_sgp import run_experiment as j_run
from sgp_tpu.models import SGPModel as JSGPModel

import sgp_tpu_torch.exp.run_largescale_sgp as runner
from sgp_tpu_torch.exp.common import Experiment, load_config
from sgp_tpu_torch.models import flax_to_torch
from sgp_tpu_torch.utils.config import config as torch_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--dataset-name", "synthetic", "--synthetic-nodes", "12",
        "--synthetic-steps", "160", "--epochs", "2",
        "--batches-epoch", "2", "--reservoir-size", "4",
        "--mlp-size", "8", "--hidden-size", "16", "--batch-size", "8",
        "--seed", "0", "--patience", "5"]
RUN = ["--epochs", "16", "--batches-epoch", "4"]
TOL_RUN = 5e-4


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setitem(torch_config, "logs_dir", str(tmp_path / "log"))


def _port(argv):
    return Experiment(runner.run_experiment,
                      runner.configure_parser_largescale()).run(
        argv + ["--device", "cpu"])


def _jax(argv):
    return JExperiment(j_run, j_parser()).run(argv)


def _carry_jax_run(monkeypatch, seed: int):
    """Make the port's runner start from the JAX runner's initial weights
    and take its (time, node) draws: the JAX runner's key stream
    (``key, k = split(key)`` an epoch, ``split(k, steps)`` a step,
    ``split(step_key, 3)[:2]`` for t and n)."""
    make_step, make_model = runner.make_fused_iid_multi_step, \
        runner.SGPModel

    def model(**kw):
        tm = make_model(**kw)
        jm = JSGPModel(**{k: v for k, v in kw.items() if k != "generator"})
        x_size, u_size = kw["input_size"], kw["exog_size"]
        key = jax.random.PRNGKey(seed)
        params = jm.init(
            {"params": key, "dropout": key}, jnp.zeros((4, x_size)),
            node_index=jnp.zeros(4, jnp.int32), iid=True,
            **({"u": jnp.zeros((4, u_size))} if u_size else {}))
        return flax_to_torch(jax.tree.map(np.asarray, params), tm)

    def multi_step(*args, **kw):
        ms = make_step(*args, **kw)
        valid = jnp.asarray(args[5])
        n_nodes = ms.data[0].shape[1]
        key = [jax.random.PRNGKey(seed)]

        def run(generator):
            key[0], k = jax.random.split(key[0])
            losses = []
            for step_key in jax.random.split(k, kw["steps_per_call"]):
                rng_t, rng_n = jax.random.split(step_key, 3)[:2]
                t = jax.random.choice(rng_t, valid, (kw["batch_size"],))
                n = jax.random.randint(rng_n, (kw["batch_size"],), 0,
                                       n_nodes)
                losses.append(ms.single.train_on(
                    torch.as_tensor(np.array(t), dtype=torch.long),
                    torch.as_tensor(np.array(n), dtype=torch.long)))
            return torch.stack(losses).mean()
        return run

    monkeypatch.setattr(runner, "SGPModel", model)
    monkeypatch.setattr(runner, "make_fused_iid_multi_step", multi_step)


@pytest.mark.parametrize("extra", [[], ["--packed-gather", "false"]],
                         ids=["streaming-packed", "encode_dataset"])
def test_runner_matches_jax_runner(monkeypatch, extra):
    argv = BASE + RUN + extra
    want = _jax(argv)
    untrained = _jax(argv + ["--epochs", "0"])
    _carry_jax_run(monkeypatch, seed=0)
    got = _port(argv)
    got_untrained = _port(argv + ["--epochs", "0"])
    for res in (want, got):
        assert all(np.isfinite(res[f"test_{k}"])
                   for k in ("mae", "mse", "mape"))
    np.testing.assert_allclose(got["test_mae"], want["test_mae"],
                               rtol=TOL_RUN)
    np.testing.assert_allclose(got_untrained["test_mae"],
                               untrained["test_mae"], rtol=TOL_RUN)
    assert want["test_mae"] < untrained["test_mae"]
    assert got["test_mae"] < got_untrained["test_mae"]


def test_runner_trains_on_its_own_draws():
    """Without carried weights or draws: finite metrics, below the
    untrained model's MAE, and the same run twice gives the same MAE."""
    argv = BASE + RUN
    a, b = _port(argv), _port(argv)
    untrained = _port(argv + ["--epochs", "0"])
    assert np.isfinite(a["test_mae"]) and a["test_mae"] == b["test_mae"]
    assert a["test_mae"] < untrained["test_mae"]


def test_checkpoint_resume_reproduces_the_run(tmp_path):
    """A run interrupted after 2 epochs and resumed to 4 ends exactly where
    the uninterrupted run does (the generator's stream, the optimizer
    state and the best-so-far weights come back)."""
    ck = str(tmp_path / "state.ckpt")
    full = _port(BASE + ["--epochs", "4"])
    _port(BASE + ["--epochs", "2", "--checkpoint-every", "1",
                  "--checkpoint-path", ck])
    resumed = _port(BASE + ["--epochs", "4", "--checkpoint-every", "1",
                            "--checkpoint-path", ck, "--resume", "true"])
    assert resumed["test_mae"] == full["test_mae"]
    with pytest.raises(ValueError, match="train config mismatch"):
        _port(BASE + ["--epochs", "5", "--checkpoint-path", ck,
                      "--resume", "true", "--lr", "0.01"])
    with pytest.raises(ValueError, match="model config mismatch"):
        _port(BASE + ["--epochs", "5", "--checkpoint-path", ck,
                      "--resume", "true", "--hidden-size", "24"])


def test_checkpoint_resume_reproduces_the_run_with_dropout(tmp_path):
    """With dropout on, the resumed run also continues torch's default
    generator, which dropout draws from (the runner seeds it afresh at its
    start, so a resume that did not restore it would drop other units)."""
    ck = str(tmp_path / "state.ckpt")
    argv = BASE + ["--dropout", "0.3"]
    full = _port(argv + ["--epochs", "4"])
    _port(argv + ["--epochs", "2", "--checkpoint-every", "1",
                  "--checkpoint-path", ck])
    resumed = _port(argv + ["--epochs", "4", "--checkpoint-every", "1",
                            "--checkpoint-path", ck, "--resume", "true"])
    assert resumed["test_mae"] == full["test_mae"]


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "configs", "*", "*.yaml"))))
def test_flat_config_reader_equals_yaml(path):
    with open(os.path.join(ROOT, path)) as fp:
        want = yaml.safe_load(fp)
    got = load_config(os.path.join(ROOT, path))
    assert got == want
    assert [type(v) for v in got.values()] == \
        [type(v) for v in want.values()]


@pytest.mark.parametrize("text", [
    "a: 1\nb:\n  c: 2\n", "a: {b: 1}\n", "a: [1, 2]\n", "- 1\n",
    "a:\n- b: 1\n"])
def test_flat_config_reader_refuses_nesting(tmp_path, text):
    path = tmp_path / "c.yaml"
    path.write_text(text)
    with pytest.raises(ValueError):
        load_config(str(path))


def test_flat_config_reader_scalars(tmp_path):
    text = ("a: 1\nb: -2.5\nc: yes\nd: off\ne: ~\nf: 'x: y'\ng: 1_000\n"
            "h: 1e-3\ni: .5\nj: text # comment\nk:\nl:\n  - 3\n  - 4\n")
    path = tmp_path / "c.yaml"
    path.write_text(text)
    assert load_config(str(path)) == yaml.safe_load(text)


def test_experiment_flag_beats_config_beats_default(monkeypatch):
    """A config value beats the parser's default; a flag typed on the
    command line (also as a prefix abbreviation) beats the config."""
    seen = {}

    def run_fn(args):
        seen.update(vars(args))

    parser = runner.configure_parser_largescale()
    Experiment(run_fn, parser).run(
        ["--config", "largescale_100nn/sgp_pv.yaml", "--dataset-name",
         "synthetic", "--epoch", "3", "--device", "cpu"])
    cfg = load_config("largescale_100nn/sgp_pv.yaml")
    assert seen["epochs"] == 3 and seen["dataset_name"] == "synthetic"
    assert seen["reservoir_layers"] == cfg["reservoir_layers"] == 8
    assert seen["hidden_size"] == cfg["hidden_size"]
    assert os.path.exists(os.path.join(seen["logdir"], "exp_config.json"))
    bad = argparse.ArgumentParser()
    bad.add_argument("--config")
    with pytest.raises(ValueError, match="not a known flag"):
        Experiment(run_fn, bad).run(["--config",
                                     "largescale_100nn/sgp_pv.yaml"])


@pytest.mark.parametrize("flags,match", [
    (["--iid-stratified", "true"], "A7"),
    (["--search-lr", "0.01"], "A7"),
    (["--data-sharding", "nodes"], "A10"),
    (["--num-processes", "2"], "A10"),
    (["--encoder-name", "gesn"], "A8"),
    (["--dataset-name", "pv"], "not in the repository"),
])
def test_unported_branches_raise(flags, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        _port(BASE + flags)
