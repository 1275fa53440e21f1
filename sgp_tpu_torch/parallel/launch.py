"""Run a function on ``world`` ranks of one machine, one process each.

``run_ranks(fn, world, backend, device, *args)`` starts the processes with
the ``spawn`` method, joins them into one process group through a
``FileStore`` in a fresh temporary directory, calls ``fn(rank, world,
*args)`` on each and returns the ranks' results in rank order. ``fn`` must
be importable by name (a module-level function of an installed module),
as spawned processes import it afresh. A rank that raises or dies makes
the call raise with its traceback; every process is gone when it returns.
The tests (gloo on the CPU) and ``chip_smoke.py`` (NCCL, or gloo for
several ranks on one card) share it.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def _worker(rank, world, backend, device, store_path, fn, args, results):
    try:
        # the ranks share one machine's cores
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world,
                                device_id=dev if backend == "nccl" else None)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:       # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, backend: str, device, *args,
              timeout: float = 600.0) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    on its own process in one ``backend`` group (``"gloo"`` or
    ``"nccl"``), every rank on ``device`` (a CUDA device given without an
    index means ``cuda:rank``); each rank runs one torch thread. Raises
    ``RuntimeError`` naming the rank that failed, or on ``timeout``
    seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="sgp_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = []
        for rank in range(world):
            dev = torch.device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", rank)
            p = ctx.Process(target=_worker, args=(
                rank, world, backend, str(dev), store, fn, args, results))
            p.start()
            procs.append(p)
        out, errors = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(out) + len(errors) < world:
                left = deadline - time.monotonic()
                try:
                    rank, ok, value = results.get(timeout=max(0.1, min(
                        left, 1.0)))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if not p.is_alive() and p.exitcode != 0
                            and r not in out]
                    if dead or left <= 0:
                        errors.append(
                            f"ranks {dead} died (exit codes "
                            f"{[procs[r].exitcode for r in dead]})" if dead
                            else f"timed out after {timeout} s")
                        break
                    continue
                if ok:
                    out[rank] = value
                else:
                    errors.append(f"rank {rank} failed:\n{value}")
                    break
        finally:
            for p in procs:
                p.join(timeout=10 if not errors else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [out[r] for r in range(world)]
