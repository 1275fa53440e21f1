#!/usr/bin/env python3
"""K2 (the block-sampled SDDMM, ``sgp_tpu_torch/csrc/sddmm.cu``) on the
card at the attention slice's shapes, beside an earlier K2 source of the
same C interface.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tools/k2_probe.py [--old build/sddmm_old.cu ...]

It builds the current source (printing ``ptxas``'s registers, shared
memory and spills of each instantiation) and, with ``--old``, each given
source into ``build/``, named by its file's stem (write it out first with ``git show
<rev>:sgp_tpu_torch/csrc/sddmm.cu > build/sddmm_old.cu``; the card's
machine has no git). On the 100-nn graph of ``chip_smoke.py`` (5,016
nodes, natural and RCM order) at D 64 and 16, f32 and bf16, it holds each
kernel to the plain version (max and mean error of the largest output,
two calls' bits) and times them in the order old, new, new, old (each
earlier source in turn): CUDA events around a CUDA graph of 20 launches,
so that the host's cost of a call does not hide a short kernel. It prints
quartiles of each and the bytes bound.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from sgp_tpu_torch.ops import _build, sddmm  # noqa: E402


def build_old(source: Path):
    """The earlier source as its own library, bound like ``sddmm.build``."""
    lib_path = _build.BUILD_DIR / f"{source.stem}_probe.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC), "-o", str(lib_path), str(source)],
                         capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("sgp_sddmm_f32", "sgp_sddmm_bf16"):
        _build.bind(lib, name, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    return lib, log.stdout + log.stderr


def call(lib, q, k, st):
    """One launch of ``lib``'s K2 into a new ``torch.empty`` tile array."""
    nnzb = st.block_rows.numel()
    out = torch.empty((nnzb, 128, 128), dtype=torch.float32, device=q.device)
    fn = lib.sgp_sddmm_bf16 if q.dtype == torch.bfloat16 \
        else lib.sgp_sddmm_f32
    err = fn(q.data_ptr(), k.data_ptr(), st.block_rows.data_ptr(),
             st.block_cols.data_ptr(), out.data_ptr(), nnzb, q.shape[0],
             q.shape[1], q.stride(0), k.stride(0),
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"launch failed: CUDA error {err}"
    return out


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms a call of ``fn``: a CUDA graph of ``iters`` calls, replayed
    once to warm up and once between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, action="append", default=[],
                    help="an earlier sddmm.cu (repeatable)")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    t0 = time.perf_counter()
    built = _build.compile_all(["sddmm"])
    libs = {"new": sddmm.build()[0]}
    logs = {"new": built.get("sddmm", (0, ""))[1]}
    for source in args.old:
        libs[source.stem], logs[source.stem] = build_old(source)
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for tag, log in logs.items():
        for ln in log.splitlines():
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
                print(f"[{tag}] {ln.strip()}")

    device = torch.device("cuda", 0)
    chip_smoke.MUFU_RATE = float("inf")   # K2 runs no transcendentals
    ds, graph, _ = chip_smoke.slice_setup(chip_smoke.N_NODES,
                                          chip_smoke.N_STEPS, device)
    from sgp_tpu_torch.graph import permute_nodes, rcm_order
    rcm = permute_nodes(graph, rcm_order(graph))
    rng = np.random.default_rng(0)
    for name, g in (("slice", graph), ("rcm", rcm)):
        st = sddmm.bsr_attention_structure(g, device=device)
        idx = (st.block_rows, st.block_cols, st.n_block_rows)
        for d in (64, 16):
            for dtype in (torch.float32, torch.bfloat16):
                q, k = (torch.as_tensor(rng.standard_normal(
                    (g.num_nodes, d)).astype(np.float32), device=device
                ).to(dtype) for _ in range(2))
                ref = sddmm.bsr_sddmm_plain(q, k, *idx)
                row = dict(case=name, d=d, nnzb=st.block_rows.numel(),
                           dtype=str(dtype).replace("torch.", ""),
                           **{key: chip_smoke.sddmm_bound(q, k, len(
                               st.block_rows))[key] for key in ("bound_ms",)})
                fns = {tag: (lambda lib=lib: call(lib, q, k, st))
                       for tag, lib in libs.items()}
                for tag, fn in fns.items():
                    got, again = fn(), fn()
                    torch.cuda.synchronize()
                    top = ref.abs().max().item()
                    row[f"{tag}_rel_err"] = (got - ref).abs().max().item() / top
                    row[f"{tag}_mean_err"] = (got - ref).mean().item() / top
                    row[f"{tag}_bitwise_repeat"] = torch.equal(got, again)
                samples = {tag: [] for tag in fns}
                olds = [tag for tag in fns if tag != "new"]
                order = olds + ["new", "new"] + olds[::-1]
                for _ in range(args.rounds):
                    for tag in order:
                        samples[tag].append(graph_ms(fns[tag]))
                for tag, v in samples.items():
                    qs = chip_smoke.quartiles(v)
                    row[f"{tag}_ms"] = qs["median"]
                    row[f"{tag}_q1_q3"] = [qs["q1"], qs["q3"]]
                print(json.dumps(row))


if __name__ == "__main__":
    main()
