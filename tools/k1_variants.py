#!/usr/bin/env python3
"""Time variants of the block SpMM kernel (K1, ``sgp_tpu_torch/csrc/bsr_spmm.cu``)
against each other on one NVIDIA GPU, to see what holds the kernel back.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tools/k1_variants.py [--old PATH] [--widths 16,64,128,512]

Each variant is the kernel's source with some of its text replaced
(``VARIANTS`` below): another warp layout, or a part of the work taken out
(the products, the copies of x and A, the join pass) so that the rest can be
timed alone. The variants are built in parallel, one ``nvcc`` each, into
``build/k1_variants/``, and swapped in turn under ``bsr_spmm``'s wrapper. At
the SGP slice's shapes (the 100-nn graph on 5,016 synthetic nodes, 1,600
tiles) and each width F, f32 and bf16 tiles, it prints one JSON line per
variant: the max and mean error against the plain version (meaningless for
the variants that skip work), the CUDA-event time of back-to-back calls,
and the time of the same calls replayed from a CUDA graph (device time
without the host). Rounds run in the order of the variants and back.

``--old PATH`` adds a K1 source of an earlier commit with the first C
interface (five pointers, three ints and the stream; no workspace), e.g.
``git show <rev>:sgp_tpu_torch/csrc/bsr_spmm.cu > old.cu``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from sgp_tpu_torch.encode import prepare_propagation_graphs  # noqa: E402
from sgp_tpu_torch.ops import _build, bsr_kernel, build_operator  # noqa: E402
from sgp_tpu_torch.ops.bsr_kernel import bsr_spmm, bsr_spmm_plain  # noqa: E402

OUT = ROOT / "build" / "k1_variants"
VARIANTS = {
    "kernel": [],
    # 32 x 32 warp tiles, 16 warps an SM at <= 128 registers (at BN = 128
    # one CTA of 512 threads)
    "warps_32x32": [("constexpr int kWarpCols = 64;", "constexpr int kWarpCols = 32;"),
                    ("constexpr int kResidentThreads = 256;",
                     "constexpr int kResidentThreads = 512;")],
    # the products skipped: copies, split, barriers, flushes and join left
    "no_products": [("      products_bf16<BN>(", "      if (n < 0) products_bf16<BN>("),
                    ("      products_f32<BN>(", "      if (n < 0) products_f32<BN>(")],
    # the cp.async copies made empty: the products on whatever shared
    # memory holds
    "no_copies": [('"cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"', '""')],
    # the join pass not launched
    "no_join": [("  if (join > 0)\n", "  if (join < 0)\n")],
}


def build(name: str, source: str):
    path = _build.CSRC / f"_variant_{name}.cu"     # beside the headers
    path.write_text(source)
    return path, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
         str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def load(name: str, old: bool):
    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    ints = 3 if old else 5
    for fn in ("sgp_bsr_spmm_f32", "sgp_bsr_spmm_bf16"):
        _build.bind(lib, fn, [ctypes.c_void_p] * (5 if old else 6)
                    + [ctypes.c_int] * ints + [ctypes.c_void_p])
    if not old:
        for fn in ("sgp_bsr_spmm_workspace_f32", "sgp_bsr_spmm_workspace_bf16"):
            getattr(lib, fn).argtypes = [ctypes.c_int] * 2
            getattr(lib, fn).restype = ctypes.c_longlong
    return lib


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms of one call: ``iters`` calls captured in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cs.cuda_ms(graph.replay, 5, 1) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="a K1 source with the first C interface")
    ap.add_argument("--widths", default="16,64,128,512")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants: needs a CUDA card")
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "bsr_spmm.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for a, b in subs:
            assert a in text, (name, a)
            text = text.replace(a, b)
        procs[name] = build(name, text)
    if args.old:
        procs["old"] = build("old", Path(args.old).read_text())
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        path.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log[-3000:]}")
        libs[name] = load(name, name == "old")
        cs.BUILD_LOGS[name] = log
        cs.spilling("k1_variants", name, "bsr_spmm_kernel")

    def call(name, blocks, cols, ptr, rows, x):
        if name != "old":
            bsr_kernel.build = lambda: (libs[name], 0.0, "")
            return bsr_spmm(blocks, cols, ptr, rows, x)
        out = torch.empty(x.shape, dtype=blocks.dtype, device=x.device)
        xk = x.to(blocks.dtype).contiguous()
        fn = (libs["old"].sgp_bsr_spmm_bf16 if blocks.dtype == torch.bfloat16
              else libs["old"].sgp_bsr_spmm_f32)
        fn(blocks.data_ptr(), cols.data_ptr(), ptr.data_ptr(), xk.data_ptr(),
           out.data_ptr(), ptr.numel() - 1, x.shape[0], x.shape[1],
           torch.cuda.current_stream().cuda_stream)
        return out.to(x.dtype)

    dev = torch.device("cuda", 0)
    _, graph, _ = cs.slice_setup(cs.N_NODES, cs.N_STEPS, dev)
    g = prepare_propagation_graphs(graph)[0]
    rng = np.random.default_rng(cs.SEED)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    for f in (int(v) for v in args.widths.split(",")):
        x = torch.as_tensor(rng.standard_normal((g.num_nodes, f)).astype(
            np.float32), device=dev)
        for precision in ("highest", "default"):
            op = build_operator(g, "bsr", precision=precision, device=dev)
            ops = (op.blocks, op.block_cols, op.row_ptr, op.block_rows)
            ref = bsr_spmm_plain(op.blocks, op.block_cols, op.block_rows,
                                 op.row_ptr.numel() - 1, x).float()
            fns = {name: (lambda name=name: call(name, *ops, x))
                   for name in libs}
            rows = {}
            for name, fn in fns.items():
                got = fn().float()
                torch.cuda.synchronize()
                rows[name] = dict(
                    variant=name, f=f, dtype=str(op.blocks.dtype)[6:],
                    rel_err=cs.rel_err(got, ref)[1],
                    out_mean_err=((got - ref).mean()
                                  / ref.abs().max()).item(),
                    ms=[], graph_ms=[])
            for _ in range(2):
                for name in list(fns) + list(fns)[::-1]:
                    rows[name]["ms"].append(cs.cuda_ms(fns[name], 20, 2))
                    rows[name]["graph_ms"].append(graph_ms(fns[name]))
            for row in rows.values():
                row["ms"] = float(np.median(row["ms"]))
                row["graph_ms"] = float(np.median(row["graph_ms"]))
                print(json.dumps(row))


if __name__ == "__main__":
    main()
