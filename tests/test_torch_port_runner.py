"""The port's large-scale SGP runner against the JAX package's, and its
scaffolding: the flat config reader, flag merging, checkpoint and resume
(also on the stratified route), and the branches that raise.

The done criterion (``test_runner_matches_jax_runner``) runs both runners
at ``tests/test_runners.py``'s ``BASE`` size (12 nodes, 160 steps,
reservoir 4, hidden 16, MLP 8, batch 8) for 16 epochs of 4 steps, the
port's on the JAX run's initial weights (``flax_to_torch``) and (time,
node) draws, so that both take the same run: the test MAEs agree within
TOL_RUN relative. Measured on this size: 6.5e-7 on the streaming-packed
path (f32 sums in another order), 8.5e-5 on the ``encode_dataset`` path,
where one of the 15,360 bf16 features rounds the other way and the MAE's
kinks carry it through 64 steps; 2.0e-6 on the stratified route, with
dense supports and with ``operator_mode = "bsr"`` (K1's plain version on
the CPU). The trial search (``--search-lr 0.01,0.001 --search-seeds
0,1``) picks the JAX runner's trial with its test MAE 4.8e-7 and every
trial's validation MAE 3.8e-6 away on the streaming-packed input.
Both runners' test MAE lies below that of the untrained model. Without
the carried weights and draws,
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
import sgp_tpu.exp.run_largescale_sgp as j_runner
from sgp_tpu.models import SGPModel as JSGPModel
from sgp_tpu.train.multi_trial import init_trial_params as j_init_trials

import sgp_tpu_torch.exp.run_largescale_sgp as runner
from sgp_tpu_torch.exp.common import Experiment, load_config
from sgp_tpu_torch.models import flax_to_torch
from sgp_tpu_torch.models.bridge import flax_trials_to_torch
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


def _port(argv, run_fn=None):
    return Experiment(run_fn or runner.run_experiment,
                      runner.configure_parser_largescale()).run(
        argv + ["--device", "cpu"])


def _jax(argv):
    return JExperiment(j_run, j_parser()).run(argv)


def _example(kw):
    """``model.init``'s example inputs for the JAX decoder of ``kw``."""
    x_size, u_size = kw["input_size"], kw["exog_size"]
    return {"x": jnp.zeros((4, x_size)),
            "node_index": jnp.zeros(4, jnp.int32), "iid": True,
            **({"u": jnp.zeros((4, u_size))} if u_size else {})}


def _jax_draws(key, steps: int, valid, n_nodes: int, t_shape, n_shape):
    """A call's draws from the JAX runner's epoch key: ``split(k, steps)``
    step keys, ``split(step_key, 3)[:2]`` for t and n."""
    for step_key in jax.random.split(key, steps):
        rng_t, rng_n = jax.random.split(step_key, 3)[:2]
        t = jax.random.choice(rng_t, valid, t_shape)
        n = jax.random.randint(rng_n, n_shape, 0, n_nodes)
        yield (torch.as_tensor(np.array(t), dtype=torch.long),
               torch.as_tensor(np.array(n), dtype=torch.long))


def _carry_jax_run(monkeypatch, seed: int):
    """Make the port's runner start from the JAX runner's initial weights
    and take its (time, node) draws: the JAX runner's key stream
    (``key, k = split(key)`` an epoch, ``split(k, steps)`` a step,
    ``split(step_key, 3)[:2]`` for t and n), on the precompute route, the
    stratified route and the trial search."""
    make_step, make_model = runner.make_fused_iid_multi_step, \
        runner.SGPModel
    make_strat = runner.make_fused_iid_stratified_step
    make_trials = runner.make_fused_iid_multi_trial_step
    seen = {}

    def model(**kw):
        tm = make_model(**kw)
        seen["kw"] = {k: v for k, v in kw.items() if k != "generator"}
        jm = JSGPModel(**seen["kw"])
        key = jax.random.PRNGKey(seed)
        params = jm.init({"params": key, "dropout": key}, **_example(kw))
        return flax_to_torch(jax.tree.map(np.asarray, params), tm)

    def trial_params(make, seeds):
        stacked = j_init_trials(JSGPModel(**seen["kw"]), seeds,
                                _example(seen["kw"]))
        return flax_trials_to_torch(jax.tree.map(np.asarray, stacked),
                                    make_model(**seen["kw"]))

    def stratified(*args, **kw):
        st = make_strat(*args, **kw)
        valid = jnp.asarray(args[5])
        n_nodes = args[2].shape[1]
        tb, p = kw["times_per_batch"], kw["nodes_per_time"]
        key = [jax.random.PRNGKey(seed)]

        def run(generator):
            key[0], k = jax.random.split(key[0])
            return torch.stack([st.train_on(t, n) for t, n in _jax_draws(
                k, kw["steps_per_call"], valid, n_nodes, (tb,),
                (tb, p))]).mean()
        return run

    def trials(*args, **kw):
        st = make_trials(*args, **kw)
        valid = jnp.asarray(args[4])
        n_nodes = st.data[0].shape[1]
        key = [jax.random.PRNGKey(seed)]

        def run(params, opt_state, generator):
            key[0], k = jax.random.split(key[0])
            losses = []
            for t, n in _jax_draws(k, kw["steps_per_call"], valid, n_nodes,
                                   (kw["batch_size"],),
                                   (kw["batch_size"],)):
                params, opt_state, loss_k = st.train_on(params, opt_state,
                                                        t, n)
                losses.append(loss_k)
            return params, opt_state, torch.stack(losses).mean(0)
        run.init_opt = st.init_opt
        return run

    def multi_step(*args, **kw):
        ms = make_step(*args, **kw)
        valid = jnp.asarray(args[5])
        n_nodes = ms.data[0].shape[1]
        key = [jax.random.PRNGKey(seed)]

        def run(generator):
            key[0], k = jax.random.split(key[0])
            return torch.stack([ms.single.train_on(t, n) for t, n in
                                _jax_draws(k, kw["steps_per_call"], valid,
                                           n_nodes, (kw["batch_size"],),
                                           (kw["batch_size"],))]).mean()
        return run

    monkeypatch.setattr(runner, "SGPModel", model)
    monkeypatch.setattr(runner, "make_fused_iid_multi_step", multi_step)
    monkeypatch.setattr(runner, "make_fused_iid_stratified_step", stratified)
    monkeypatch.setattr(runner, "init_trial_params", trial_params)
    monkeypatch.setattr(runner, "make_fused_iid_multi_trial_step", trials)


def _bsr_supports(args):
    """The port's runner with ``operator_mode = "bsr"`` on the namespace
    (the supports on K1's route; the JAX runner builds ``auto``: dense)."""
    args.operator_mode = "bsr"
    return runner.run_experiment(args)


@pytest.mark.parametrize("extra,run_fn", [
    ([], None), (["--packed-gather", "false"], None),
    (["--iid-stratified", "true"], None),
    (["--iid-stratified", "true"], _bsr_supports),
    (["--encoder-name", "gesn"], None)],
    ids=["streaming-packed", "encode_dataset", "stratified",
         "stratified-bsr", "gesn-encode_dataset"])
def test_runner_matches_jax_runner(monkeypatch, extra, run_fn):
    argv = BASE + RUN + extra
    want = _jax(argv)
    untrained = _jax(argv + ["--epochs", "0"])
    _carry_jax_run(monkeypatch, seed=0)
    got = _port(argv, run_fn)
    got_untrained = _port(argv + ["--epochs", "0"], run_fn)
    for res in (want, got):
        assert all(np.isfinite(res[f"test_{k}"])
                   for k in ("mae", "mse", "mape"))
    np.testing.assert_allclose(got["test_mae"], want["test_mae"],
                               rtol=TOL_RUN)
    np.testing.assert_allclose(got_untrained["test_mae"],
                               untrained["test_mae"], rtol=TOL_RUN)
    assert want["test_mae"] < untrained["test_mae"]
    assert got["test_mae"] < got_untrained["test_mae"]


def _carry_jax_encoding(monkeypatch):
    """Record the JAX runner's precomputed encoding (``encode_dataset``'s,
    as ``fused_iid_inputs`` hands it to the step) and give it to the
    port's runner in place of its own."""
    seen = {}
    j_inputs, t_inputs = j_runner.fused_iid_inputs, runner.fused_iid_inputs

    def record(ds, *args, **kw):
        out = j_inputs(ds, *args, **kw)
        seen["enc"] = np.array(out[0].astype(jnp.float32))
        return out

    def replace(ds, *args, **kw):
        enc, *rest = t_inputs(ds, *args, **kw)
        return (torch.as_tensor(seen["enc"], device=enc.device), *rest)
    monkeypatch.setattr(j_runner, "fused_iid_inputs", record)
    monkeypatch.setattr(runner, "fused_iid_inputs", replace)


SEARCH = ["--search-lr", "0.01,0.001", "--search-seeds", "0,1"]
TOL_CHAOS = 5e-2


def test_search_matches_jax_runner(monkeypatch):
    """``--search-lr 0.01,0.001 --search-seeds 0,1`` on the streaming
    packed input: the four trials from the JAX runner's stacked initial
    weights on its draws pick the JAX runner's best trial (the lrs a
    decade apart: no near tie), with each trial's validation MAE and the
    best trial's test MAE within TOL_RUN."""
    argv = BASE + RUN + SEARCH
    want = _jax(argv)
    _carry_jax_run(monkeypatch, seed=0)
    got = _port(argv)
    assert got["trials"] == want["trials"] == [
        {"lr": lr, "seed": s} for lr in (0.01, 0.001) for s in (0, 1)]
    assert (got["best_lr"], got["best_seed"]) == (want["best_lr"],
                                                   want["best_seed"])
    np.testing.assert_allclose(got["val_mae_per_trial"],
                               want["val_mae_per_trial"], rtol=TOL_RUN)
    np.testing.assert_allclose(got["test_mae"], want["test_mae"],
                               rtol=TOL_RUN)
    vals = sorted(want["val_mae_per_trial"])
    assert vals[1] - vals[0] > 10 * TOL_RUN * vals[0], vals


def test_search_on_precomputed_input_matches_jax_runner(monkeypatch):
    """The same search on the precompute input (``--packed-gather
    false``), the port also taking the JAX run's encoding: the JAX
    runner's best trial, the lr 0.001 trials' validation MAE within
    TOL_RUN, the lr 0.01 trials' and the test MAE within TOL_CHAOS.

    Why the second bound: on these rows the JAX package's unpacked trial
    step (node-level u) ends 4 steps 7e-6 away from its own packed step,
    which the port's unpacked and packed steps both equal
    (``tests/test_torch_port_multi_trial.py``): an Adam step moves a weight
    whose gradient rounds near 0 by lr in either direction. 64 steps at lr
    0.01 and batch 8 grow that to 2.8e-2 of the MAE (measured; 1.1-3.0e-3
    after 16 steps), and at lr 0.001 to 4e-4."""
    argv = BASE + RUN + SEARCH + ["--packed-gather", "false"]
    _carry_jax_encoding(monkeypatch)
    want = _jax(argv)
    _carry_jax_run(monkeypatch, seed=0)
    got = _port(argv)
    assert (got["best_lr"], got["best_seed"]) == (want["best_lr"],
                                                   want["best_seed"])
    np.testing.assert_allclose(got["val_mae_per_trial"][2:],
                               want["val_mae_per_trial"][2:], rtol=TOL_RUN)
    np.testing.assert_allclose(got["val_mae_per_trial"][:2],
                               want["val_mae_per_trial"][:2],
                               rtol=TOL_CHAOS)
    np.testing.assert_allclose(got["test_mae"], want["test_mae"],
                               rtol=TOL_CHAOS)


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


def test_stratified_checkpoint_resume_reproduces_the_run(tmp_path):
    """The stratified route through the same restartable fit: a run
    interrupted after 2 epochs and resumed to 4 ends where the
    uninterrupted run does."""
    ck = str(tmp_path / "state.ckpt")
    base = BASE + ["--iid-stratified", "true"]
    full = _port(base + ["--epochs", "4"])
    _port(base + ["--epochs", "2", "--checkpoint-every", "1",
                  "--checkpoint-path", ck])
    resumed = _port(base + ["--epochs", "4", "--checkpoint-every", "1",
                            "--checkpoint-path", ck, "--resume", "true"])
    assert np.isfinite(full["test_mae"])
    assert resumed["test_mae"] == full["test_mae"]
    assert resumed["train_mae"] == full["train_mae"]


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
    (["--iid-stratified", "true", "--search-lr", "0.01"], "not supported"),
    (["--search-lr", "0.01", "--checkpoint-every", "1"], "not supported"),
    # --data-sharding nodes and --num-processes run, the stratified
    # trainer's too (tests/test_torch_port_{parallel,dp}.py); the trial
    # search refuses the sharding, with or without a process count of one
    (["--data-sharding", "nodes", "--search-lr", "0.01"], "not supported"),
    (["--num-processes", "1", "--data-sharding", "nodes",
      "--search-lr", "0.01"], "not supported"),
    (["--dataset-name", "pv"], "not in the repository"),
])
def test_unported_branches_raise(flags, match):
    # a real dataset's loader raises FileNotFoundError: its files are not
    # in the repository
    with pytest.raises((NotImplementedError, ValueError, FileNotFoundError),
                       match=match):
        _port(BASE + flags)
