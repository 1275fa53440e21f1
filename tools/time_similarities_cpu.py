"""Time the port's correntropy and float64 Pearson on the host CPU at
CER-En's width.

CER-En: 6,435 meters over 25,728 half-hours (536 days), the weekly window
336 steps (76 windows), ~1% of the readings missing in runs (a quarter of
the meters lose one run each): the series ``chip_smoke.py``'s phase 19
draws on the card, drawn here from the same kind of seeded generator on
the CPU (a shared daily course scaled 0.95-1.05 per meter, plus noise),
standardized as ``CEREn.compute_similarity`` does. ``--windows`` cuts the
series to that many weekly windows (the time scales with it).

    python tools/time_similarities_cpu.py [--windows 76] [--threads 0]

Host torch only; the numbers are the machine's it runs on.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sgp_tpu_torch.data.datasets.pv_us import standardize  # noqa: E402
from sgp_tpu_torch.graph.similarities import (corrcoef,  # noqa: E402
                                              correntropy)

METERS, PERIOD, NOISE, MISSING = 6435, 336, 0.2, 0.01


def series(n_steps: int, seed: int = 0):
    """``(x [T, N] f32 with the missing readings zeroed, mask [T, N])``."""
    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(n_steps, dtype=torch.float32)
    amp = 0.95 + 0.1 * torch.rand(METERS, generator=gen)
    x = 1.0 + torch.sin(2 * np.pi * t / 48)[:, None] * amp[None, :]
    x += NOISE * torch.randn(n_steps, METERS, generator=gen)
    mask = torch.ones_like(x, dtype=torch.bool)
    run = int(MISSING * 4 * n_steps)
    meters = torch.nonzero(torch.rand(METERS, generator=gen) < 0.25)[:, 0]
    starts = torch.randint(0, n_steps - run, (len(meters),), generator=gen)
    for m, s in zip(meters.tolist(), starts.tolist()):
        mask[s:s + run, m] = False
    return x * mask, mask


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--windows", type=int, default=76)
    parser.add_argument("--threads", type=int, default=0,
                        help="torch threads (0: torch's default)")
    args = parser.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    x, mask = series(args.windows * PERIOD + 1)
    t0 = time.perf_counter()
    xs = standardize(x, "cpu")
    sim = correntropy(xs, PERIOD, mask=mask, device="cpu")
    corr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pearson = corrcoef(x, device="cpu")
    pearson_s = time.perf_counter() - t0
    print(json.dumps({
        "meters": METERS, "steps": int(x.shape[0]), "period": PERIOD,
        "windows": args.windows, "correntropy_s": corr_s,
        "pearson_float64_s": pearson_s,
        "finite": bool(np.isfinite(sim).all() and np.isfinite(pearson).all()),
        "torch_threads": torch.get_num_threads(), "cpus": os.cpu_count(),
        "cpu": platform.processor() or platform.machine(),
        "torch": torch.__version__}))


if __name__ == "__main__":
    main()
