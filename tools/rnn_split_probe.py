#!/usr/bin/env python3
"""The LSTM runner's first step against the port on the CPU, on another
train split.

Runs ``chip_smoke.py`` phase 13's ``rnn`` runner case (``traffic/rnn.yaml``
on 5,016 synthetic nodes; the CPU step on a 1,001-node set of the same
command) with ``--test-len 0.1``: a larger train split, so another first
batch. The first step's row prints the gradients' errors beside the relu
units and the masked MAE's signs that the card and the CPU take the other
way; the script exits non-zero when the check fails. On a machine with the
card, from the repository root:

    python3 tools/rnn_split_probe.py
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main():
    print(cs.phase0_card())
    device = torch.device("cuda", 0)
    tag, runner, config, flags = next(
        case for case in cs.DIFF_RUNNER_CASES if case[0] == "rnn")
    with cs.cached_datasets("rnn split"):
        torch.cuda.empty_cache()
        cs.runner_run(f"{tag} --test-len 0.1", runner, config,
                      flags + ["--test-len", "0.1"], (), device,
                      phase="rnn split", cpu_nodes=cs.DIFF_CPU_NODES)
    print("[rnn split] the first-step check holds with --test-len 0.1")


if __name__ == "__main__":
    main()
