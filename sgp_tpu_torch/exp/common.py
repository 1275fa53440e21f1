"""Experiment scaffolding: flags, config merge, run setup.

Counterpart of ``sgp_tpu/exp/common.py``: the argparse flag surface, a
config file merged over the defaults (every key must be a flag, and a flag
typed on the command line beats the file), seeding, a per-run log
directory holding the run's config and results, and the dataset and
splitter registries.

The configs under ``configs/`` are flat ``key: value`` files (a value may
be a block list of scalars), so :func:`load_config` reads them without
PyYAML (``utils/config.py::read_flat_yaml``) and raises on anything
nested. ``--device`` is the port's: where
the run goes (default ``cuda:0``; ``cpu`` for the CPU).
"""
from __future__ import annotations

import argparse
import datetime
import inspect
import json
import logging
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch

from sgp_tpu_torch.data.splitters import (AtTimeStepSplitter, Splitter,
                                          TemporalSplitter)
from sgp_tpu_torch.utils.config import config as global_config
from sgp_tpu_torch.utils.config import read_flat_yaml
from sgp_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

def load_config(path: str) -> dict:
    """Read a flat config (:func:`read_flat_yaml`). Relative paths that do
    not exist from the working directory are looked up under
    ``configs/``."""
    if not os.path.isabs(path) and not os.path.exists(path):
        path = os.path.join(global_config["config_dir"], path)
    return read_flat_yaml(path)


def get_dataset(name: str, **kwargs):
    """The paper's four datasets, read from ``config["data_dir"]``, or the
    synthetic ones."""
    from sgp_tpu_torch.data.datasets import (CEREn, MetrLA, PemsBay, PvUS,
                                             SyntheticDiffusion)
    if name == "la":
        return MetrLA()
    if name == "bay":
        return PemsBay(mask_zeros=True)
    if name == "pv":
        return PvUS(mask_zeros=True)
    if name == "cer":
        return CEREn()
    if name == "synthetic":
        return SyntheticDiffusion(**kwargs)
    if name == "synthetic_large":
        return SyntheticDiffusion(num_nodes=kwargs.pop("num_nodes", 1024),
                                  num_steps=kwargs.pop("num_steps", 4000),
                                  **kwargs)
    raise ValueError(f"Dataset {name} not available.")


def get_splitter(dataset_name: str, val_len: float = 0.1,
                 test_len: float = 0.2) -> Splitter:
    """The traffic datasets split at the paper's timestamps
    (``run_traffic_sgp.py:52-60``); everything else splits temporally."""
    if dataset_name == "la":
        return AtTimeStepSplitter(first_val_ts=(2012, 5, 25, 16, 0),
                                  last_val_ts=(2012, 6, 4, 3, 20),
                                  first_test_ts=(2012, 6, 4, 4, 20))
    if dataset_name == "bay":
        return AtTimeStepSplitter(first_val_ts=(2017, 5, 11, 7, 20),
                                  last_val_ts=(2017, 5, 25, 17, 40),
                                  first_test_ts=(2017, 5, 25, 18, 40))
    return TemporalSplitter(val_len=val_len, test_len=test_len)


class Experiment:
    """Parse flags, merge the config file, seed, create the log
    directory, run."""

    def __init__(self, run_fn: Callable, parser: argparse.ArgumentParser):
        self.run_fn = run_fn
        self.parser = parser

    def _given_flags(self, tokens) -> set:
        """The flags typed on the command line: a re-parse with every
        default suppressed (it sees argparse's prefix abbreviations, which
        matching the option strings would miss)."""
        saved = [(a, a.default) for a in self.parser._actions]
        saved_defaults = dict(self.parser._defaults)
        try:
            for a in self.parser._actions:
                a.default = argparse.SUPPRESS
            self.parser._defaults.clear()
            shadow, _ = self.parser.parse_known_args(tokens)
            return set(vars(shadow))
        finally:
            for a, d in saved:
                a.default = d
            self.parser._defaults.update(saved_defaults)

    def run(self, argv: Optional[list] = None):
        args = self.parser.parse_args(argv)
        if getattr(args, "config", None):
            cfg = load_config(args.config)
            given = self._given_flags(
                list(sys.argv[1:] if argv is None else argv))
            for key, value in cfg.items():
                if not hasattr(args, key):
                    raise ValueError(
                        f"config key {key!r} is not a known flag")
                if key not in given:
                    setattr(args, key, value)
        if getattr(args, "seed", -1) < 0:
            args.seed = int(np.random.randint(1e9))
        np.random.seed(args.seed)
        torch.manual_seed(args.seed)
        logger.info(f"SEED: {args.seed}")
        if getattr(args, "num_processes", None) or \
                os.environ.get("WORLD_SIZE"):
            # one process a rank: the flags, or torchrun's environment;
            # NCCL on the card, gloo on the CPU
            from sgp_tpu_torch.parallel import init_distributed
            device = resolve_device(getattr(args, "device", None))
            backend = "nccl" if device.type == "cuda" else "gloo"
            n = init_distributed(
                backend, coordinator_address=args.coordinator_address,
                num_processes=args.num_processes,
                process_id=args.process_id, device=device)
            logger.info(f"distributed: {n} process(es) on {backend}")
        from sgp_tpu_torch.parallel import process_rank
        rank = process_rank()
        if rank > 0:
            # only rank 0 logs and writes the run's files
            for name in ("", "sgp_tpu_torch"):   # root, the package's
                logging.getLogger(name).setLevel(logging.WARNING)

        exp_name = (datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
                    + f"_{args.seed}")
        logdir = os.path.join(global_config["logs_dir"],
                              getattr(args, "dataset_name", "run"),
                              getattr(args, "model_name", "model"),
                              exp_name)
        if rank == 0:
            os.makedirs(logdir, exist_ok=True)
            with open(os.path.join(logdir, "exp_config.json"), "w") as fp:
                json.dump(vars(args), fp, indent=2, sort_keys=True)
        args.logdir = logdir
        result = self.run_fn(args)
        if result is not None and rank == 0:
            with open(os.path.join(logdir, "results.json"), "w") as fp:
                json.dump(result, fp, indent=2, default=float)
            logger.info(f"results: {json.dumps(result, default=float)}")
        return result


def add_common_args(parser: argparse.ArgumentParser):
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--seed", type=int, default=-1)
    parser.add_argument("--device", type=str, default=None,
                        help="where the run goes (default cuda:0)")
    parser.add_argument("--dataset-name", type=str, default="synthetic")
    parser.add_argument("--window", type=int, default=1)
    parser.add_argument("--horizon", type=int, default=12)
    parser.add_argument("--horizon-lag", type=int, default=1)
    parser.add_argument("--stride", type=int, default=1)
    parser.add_argument("--val-len", type=float, default=0.1)
    parser.add_argument("--test-len", type=float, default=0.2)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--batch-inference", type=int, default=None)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--use-lr-schedule", type=str2bool, default=True)
    parser.add_argument("--lr-milestones", type=int, nargs="*",
                        default=[25, 50, 100])
    parser.add_argument("--lr-gamma", type=float, default=0.25)
    parser.add_argument("--l2-reg", type=float, default=0.0)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--patience", type=int, default=50)
    parser.add_argument("--batches-epoch", type=int, default=-1)
    parser.add_argument("--grad-clip-val", type=float, default=5.0)
    parser.add_argument("--scale-target", type=str2bool, default=False)
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--adj-knn", type=int, default=None)
    parser.add_argument("--adj-threshold", type=float, default=0.1)
    parser.add_argument("--synthetic-nodes", type=int, default=64)
    parser.add_argument("--synthetic-steps", type=int, default=2000)
    parser.add_argument("--coordinator-address", type=str, default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    return parser


def dp_mesh(args):
    """``--data-sharding batch``: the data-parallel ``parallel.Mesh`` over
    the process group's ranks (one rank when the process joined none) for
    ``Predictor(mesh=)``; ``None`` otherwise."""
    if getattr(args, "data_sharding", "none") != "batch":
        return None
    from sgp_tpu_torch.parallel import local_mesh
    mesh = local_mesh(1)
    logger.info(f"data-sharding=batch over {mesh.size('data')} ranks "
                f"(Predictor DP)")
    return mesh


def dataset_kwargs(args) -> dict:
    if getattr(args, "dataset_name", "").startswith("synthetic"):
        return {"num_nodes": args.synthetic_nodes,
                "num_steps": args.synthetic_steps}
    return {}


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("yes", "true", "t", "1")


def filter_kwargs(cls_or_fn, args: dict) -> dict:
    """Route flags to constructors by signature."""
    sig = inspect.signature(cls_or_fn)
    return {k: v for k, v in args.items() if k in sig.parameters}
