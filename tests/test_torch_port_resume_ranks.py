"""Checkpoint and resume of ``run_largescale_sgp --data-sharding nodes`` over
2 gloo ranks on the CPU, for the IID branch and the stratified one.

The runner's fault injection (``SGP_TPU_FAULT``) kills both ranks at the
start of epoch 2; the resumed run (``--resume true``: weights and optimizer
state from rank 0's file, each rank's own generator states) ends with the
uninterrupted run's test metrics and final weights, bit for bit, on every
rank. A checkpoint of 2 ranks refuses a resume under 1. A killed rank
ends its process, so the file spawns 4 worlds of 2 ranks: both
uninterrupted runs, each branch's faulted run, both resumed runs.
"""
import numpy as np
import pytest
import torch

from sgp_tpu_torch.parallel import run_ranks
from sgp_tpu_torch.parallel.workers import jobs_worker, runner_worker
from sgp_tpu_torch.train.checkpoint import restore_run_state

torch.set_num_threads(1)

ARGV = ["--dataset-name", "synthetic", "--synthetic-nodes", "13",
        "--synthetic-steps", "160", "--reservoir-size", "4",
        "--hidden-size", "16", "--mlp-size", "8", "--batch-size", "8",
        "--epochs", "4", "--batches-epoch", "3", "--device", "cpu",
        "--seed", "0", "--data-sharding", "nodes"]
BRANCHES = {"iid": [],
            "stratified": ["--iid-stratified", "true", "--times-per-batch",
                           "2"]}


def test_resume_over_two_ranks_equals_uninterrupted(tmp_path):
    cfg = {"logs_dir": str(tmp_path / "logs")}
    ckpt = {name: ["--checkpoint-every", "1", "--checkpoint-path",
                   str(tmp_path / f"{name}.ckpt")] for name in BRANCHES}
    full = run_ranks(jobs_worker, 2, "gloo", "cpu", [
        ("runner_worker", ARGV + flags, cfg) for flags in BRANCHES.values()])
    env = {}
    for name, flags in BRANCHES.items():
        marker = tmp_path / f"{name}.fault"
        env[name] = {**cfg, "env": {
            "SGP_TPU_FAULT": f"epoch:2,marker:{marker}"}}
        with pytest.raises(RuntimeError, match=r"died \(exit codes \[13"):
            run_ranks(runner_worker, 2, "gloo", "cpu",
                      ARGV + flags + ckpt[name], env[name])
        assert marker.read_text() == "2"
    resumed = run_ranks(jobs_worker, 2, "gloo", "cpu", [
        ("runner_worker", ARGV + flags + ckpt[name] + ["--resume", "true"],
         env[name]) for name, flags in BRANCHES.items()])
    for rank in range(2):
        for i, name in enumerate(BRANCHES):
            (res, w), (ref, w_ref) = resumed[rank][i], full[rank][i]
            for k in ref:
                if k.startswith("test_"):
                    assert res[k] == ref[k], (name, rank, k)
            assert w.keys() == w_ref.keys()
            for k in w_ref:
                np.testing.assert_array_equal(w[k], w_ref[k],
                                              err_msg=f"{name} {k}")

    # the 2-rank file refuses one rank, naming both sizes
    state = torch.load(tmp_path / "iid.ckpt", weights_only=False)
    assert state["world_size"] == 2 and len(state["ranks"]) == 2
    assert not torch.equal(state["ranks"][0]["rng"],
                           state["ranks"][1]["rng"])
    with pytest.raises(ValueError, match=r"written by 2 rank\(s\).* has 1"):
        restore_run_state(str(tmp_path / "iid.ckpt"), None, None, None)
