"""Timing and trace hooks.

Counterpart of ``sgp_tpu/obs/profiling.py`` with PyTorch's own tools: wall
time per named phase (:class:`StepTimer`), units a second
(:class:`Throughput`), the mean seconds of a call (:func:`time_fn`) and a
``torch.profiler`` trace of the host and the card (:func:`profile_trace`).
CUDA launches return before the card has finished, so every timer here
that takes a result or a function synchronizes the device it ran on.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from sgp_tpu_torch.utils.logging import logger


def synchronize(result) -> None:
    """Wait for the CUDA device of every tensor in ``result`` (a tensor, or
    a list, tuple or dict of them, nested); a host result needs no wait."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            synchronize(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            synchronize(v)


class StepTimer:
    """Accumulates wall-clock seconds per named phase.

    Usage::

        timer = StepTimer()
        with timer.time("train_step", sync=True, result=loss):
            loss = step(batch)   # the block fills the tensor ``loss``
        timer.summary()  # {'train_step': {'mean_s': ..., 'count': ...}}

    With ``sync=True`` the block's time runs until the device of
    ``result`` has finished: pass a tensor that the block writes into.
    """

    def __init__(self):
        self._times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def time(self, name: str, sync: bool = False, result=None):
        t0 = time.perf_counter()
        yield
        if sync and result is not None:
            synchronize(result)
        self._times.setdefault(name, []).append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self._times.setdefault(name, []).append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"mean_s": sum(v) / len(v), "total_s": sum(v),
                       "count": len(v)}
                for name, v in self._times.items()}

    def log_summary(self):
        for name, s in self.summary().items():
            logger.info(f"{name}: {s['mean_s']*1e3:.2f} ms/call "
                        f"x {s['count']}")


class Throughput:
    """Units (edges, samples, batches) a second since :meth:`start`."""

    def __init__(self):
        self._start: Optional[float] = None
        self._units = 0.0

    def start(self):
        self._start = time.perf_counter()
        self._units = 0.0

    def add(self, units: float):
        self._units += units

    def rate(self) -> float:
        if self._start is None:
            return 0.0
        return self._units / max(time.perf_counter() - self._start, 1e-12)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1,
            **kwargs) -> float:
    """Mean wall-clock seconds per call of ``fn(*args, **kwargs)`` over
    ``iters`` calls after ``warmup`` calls, the device of the output
    synchronized before the clock starts and before it stops."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    synchronize(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    synchronize(out)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the block with ``torch.profiler`` (the host's and, where
    there is a card, CUDA's activities) and write a Chrome trace,
    ``trace.json`` in ``logdir``, viewable in Perfetto or
    ``chrome://tracing``. Yields the profiler, whose ``key_averages()``
    sums the events by name."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
