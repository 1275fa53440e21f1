"""Hyperparameter search, sequential or on a thread pool.

Counterpart of ``sgp_tpu/exp/hyperopt.py`` (the reference's test_tube
multi-trial harness, ``tsl/utils/experiment.py:54-83``): trial
configurations drawn from per-flag option lists (a grid, or random draws
from numpy's ``default_rng``, the JAX module's draws), run by
``run_fn(config) -> metrics``, a trial's ``RuntimeError`` (a CUDA
out-of-memory error is one) logged and skipped, and the best trial by a
monitored metric. ``n_workers > 1`` runs trials on threads: PyTorch
releases the interpreter lock inside its operators, so the trials' host
work overlaps and their kernels share the card. ``run_fn`` must then draw
from its own generators, not from PyTorch's global one.

For lr and seed spaces on the fused IID path, the vmapped search trains
every trial in one program on shared batches
(``sgp_tpu_torch/train/multi_trial.py``; ``--search-lr/--search-seeds`` on
``run_largescale_sgp``).
"""
from __future__ import annotations

import itertools
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from sgp_tpu_torch.utils.logging import logger


def grid_trials(space: Dict[str, Sequence]) -> List[Dict]:
    keys = list(space)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(space[k] for k in keys))]


def random_trials(space: Dict[str, Sequence], n_trials: int,
                  seed: int = 0) -> List[Dict]:
    rng = np.random.default_rng(seed)
    return [{k: v[rng.integers(len(v))] for k, v in space.items()}
            for _ in range(n_trials)]


def run_search(run_fn: Callable[[Dict], Dict],
               base_config: Dict,
               space: Dict[str, Sequence],
               mode: str = "random",
               n_trials: int = 10,
               monitor: str = "test_mae",
               minimize: bool = True,
               seed: int = 0,
               n_workers: int = 1,
               out_path: Optional[str] = None) -> Dict:
    """Run trials of ``run_fn(config) -> metrics dict``; returns
    ``{"best_config", "best_metrics", "trials"}``, the trials in their
    drawn order, and writes it as JSON to ``out_path`` when given."""
    trials = (grid_trials(space) if mode == "grid"
              else random_trials(space, n_trials, seed))
    sign = 1.0 if minimize else -1.0

    def one_trial(i_overrides):
        i, overrides = i_overrides
        cfg = {**base_config, **overrides}
        logger.info(f"trial {i + 1}/{len(trials)}: {overrides}")
        try:
            return {"config": overrides, "metrics": run_fn(cfg)}
        except RuntimeError as e:  # the reference skips a failed trial
            logger.warning(f"trial {i} failed: {e}")
            return {"config": overrides, "error": str(e)}

    if n_workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            results = list(pool.map(one_trial, enumerate(trials)))
    else:
        results = [one_trial(item) for item in enumerate(trials)]

    best = None
    for rec in results:
        if "metrics" not in rec:
            continue
        score = sign * rec["metrics"][monitor]
        if best is None or score < best[0]:
            best = (score, rec["config"], rec["metrics"])
    out = {"best_config": best[1] if best else None,
           "best_metrics": best[2] if best else None,
           "trials": results}
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as fp:
            json.dump(out, fp, indent=2, default=float)
    return out
