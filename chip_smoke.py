#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sgp_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

It drives the port's serving path, ``OnlineForecaster`` with the BSR
propagation operator, at the widths of ``configs/largescale_100nn/
sgp_pv.yaml`` on 5,016 nodes (synthetic data and random weights from a
seed), in phases; any failure raises and the exit code is not 0:

0. the card: ``nvidia-smi`` name and power limit, versions, TF32 off;
1. build the BSR SpMM kernel (``sgp_tpu_torch/csrc/bsr_spmm.cu``);
2. the kernel against its plain PyTorch version on the card, at the
   slice's shapes and on ragged / empty-block-row graphs, f32 and bf16,
   with CUDA-event times of both;
3. the slice: warm-up, single-stream and 4-stream steps through the BSR
   kernel, checked for shape, finiteness and launch counts, and held
   against a dense-operator forecaster with the same weights and against
   the port on the CPU.

The line before the last is a JSON object of the kernels; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "largescale_100nn" / "sgp_pv.yaml"
N_NODES = 5016
KNN = 100
N_STEPS = 640           # synthetic series length
WARMUP = 576            # history replayed through the scan
STEPS = 16              # single-stream serving steps
STREAMS = 4
STREAM_STEPS = 4
STREAM_OFFSET = 8       # stream s sees the series shifted by s * 8 steps
CPU_STEPS = 2           # steps also run by the port on the CPU
SEED = 0

# stated tolerances (relative to the reference's max |value|)
TOL_F32 = 1e-5          # kernel vs plain, f32 tiles: order of summation
TOL_BF16 = 1e-2         # kernel vs plain, bf16 tiles: one bf16 ulp (2^-8)
                        # after a different f32 summation order
TOL_SLICE = 1e-4        # BSR-kernel forecaster vs dense / CPU forecaster


def read_flat_yaml(path: Path) -> dict:
    """The configs are flat ``key: value`` files; read them without
    PyYAML."""
    out = {}
    for line in path.read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        key, value = (s.strip() for s in line.split(":", 1))
        if value in ("true", "false"):
            out[key] = value == "true"
        else:
            for cast in (int, float, str):
                try:
                    out[key] = cast(value)
                    break
                except ValueError:
                    pass
    return out


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    got, ref = got.float(), ref.float()
    abs_err = (got - ref).abs().max().item()
    return abs_err, abs_err / max(ref.abs().max().item(), 1e-30)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase0_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this test runs only on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip()
    print(f"[phase 0] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    import sgp_tpu_torch  # noqa: F401  (sets the TF32 flags)
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on"
    assert not torch.backends.cudnn.allow_tf32, "TF32 cuDNN is on"
    print("[phase 0] TF32 off in matmul and cuDNN")
    return smi


def phase1_build():
    from sgp_tpu_torch.ops import bsr_kernel
    _, seconds, log = bsr_kernel.build()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[phase 1] nvcc built bsr_spmm.cu in {seconds:.2f} s")
    for ln in ptxas:
        print(f"[phase 1]   {ln}")


def slice_setup(n_nodes: int, n_steps: int, device):
    """Dataset, graph and scaler of the slice."""
    from sgp_tpu_torch.data import RobustScaler
    from sgp_tpu_torch.data.datasets import SyntheticDiffusion
    t0 = time.perf_counter()
    ds = SyntheticDiffusion(num_nodes=n_nodes, num_steps=n_steps, seed=SEED)
    graph = ds.get_connectivity(knn=min(KNN, n_nodes - 1), threshold=None,
                                include_self=False)
    scaler = RobustScaler(axis=(0, 1), quantile_range=(10., 90.)).fit(
        ds.target[:WARMUP], mask=ds.mask[:WARMUP])
    print(f"[setup] SyntheticDiffusion({n_nodes}, {n_steps}) and its "
          f"{KNN}-nn graph ({graph.num_edges} edges) in "
          f"{time.perf_counter() - t0:.1f} s")
    return ds, graph, scaler


def phase2_kernel(graph, device) -> dict:
    """Kernel vs plain version on the card; returns the slice-shape row."""
    from sgp_tpu_torch.encode import prepare_propagation_graphs
    from sgp_tpu_torch.graph import Graph, coalesce, normalize_adj
    from sgp_tpu_torch.ops import bsr_spmm, bsr_spmm_plain, build_operator
    rng = np.random.default_rng(SEED)
    slice_g = prepare_propagation_graphs(graph)[0]
    # edges only among the first 300 of 1,000 nodes: block rows 3..7 are
    # empty, and N = 1,000 is not a multiple of 128
    m = 300
    ragged_g = normalize_adj(coalesce(Graph(
        rng.integers(0, m, 20 * m), rng.integers(0, m, 20 * m),
        rng.random(20 * m).astype(np.float32), 1000)))
    cases = [("slice", slice_g, 128), ("slice", slice_g, STREAMS * 128),
             ("ragged+empty rows", ragged_g, 200)]
    rows = []
    for name, g, f in cases:
        x = torch.as_tensor(rng.standard_normal(
            (g.num_nodes, f)).astype(np.float32), device=device)
        for precision, tol in (("highest", TOL_F32), ("default", TOL_BF16)):
            op = build_operator(g, "bsr", precision=precision, device=device)
            args = (op.blocks, op.block_cols, op.row_ptr, op.block_rows)
            n_br = op.row_ptr.numel() - 1
            got = bsr_spmm(*args, x)
            ref = bsr_spmm_plain(op.blocks, op.block_cols, op.block_rows,
                                 n_br, x)
            torch.cuda.synchronize()
            abs_err, rel = rel_err(got, ref)
            ms = cuda_ms(lambda: bsr_spmm(*args, x))
            plain_ms = cuda_ms(lambda: bsr_spmm_plain(
                op.blocks, op.block_cols, op.block_rows, n_br, x))
            row = dict(case=name, n=g.num_nodes, f=f, nnzb=op.blocks.shape[0],
                       dtype=str(op.blocks.dtype).replace("torch.", ""),
                       max_abs_err=abs_err, rel_err=rel, tol=tol, ms=ms,
                       plain_ms=plain_ms)
            print(f"[phase 2] {json.dumps(row)}")
            assert got.shape == ref.shape and torch.isfinite(got).all()
            assert rel <= tol, f"kernel disagrees with plain: {row}"
            rows.append(row)
    return next(r for r in rows if r["case"] == "slice" and r["f"] == 128
                and r["dtype"] == "float32")


def build_slice(graph, scaler, mode: str, device, n_nodes: int):
    """The sgp_pv.yaml encoder and decoder widths; same seeds, so every
    call gives the same reservoir and decoder weights."""
    from sgp_tpu_torch.data import Windowing
    from sgp_tpu_torch.encode import SGPEncoder
    from sgp_tpu_torch.models import SGPModel
    cfg = read_flat_yaml(CONFIG)
    # The serving path scales one raw observation [N, C] and has no
    # node-level exogenous input, so the yaml's datetime lanes
    # (preprocess_exogenous, keep_raw) cannot pass: input_size=1,
    # exog_size=0.
    enc = SGPEncoder(
        input_size=1, reservoir_size=cfg["reservoir_size"],
        reservoir_layers=cfg["reservoir_layers"],
        leaking_rate=cfg["leaking_rate"],
        spectral_radius=cfg["spectral_radius"], density=cfg["density"],
        receptive_field=cfg["receptive_field"],
        bidirectional=cfg["bidirectional"], alpha_decay=cfg["alpha_decay"],
        global_attr=cfg["global_attr"], add_self_loops=cfg["add_self_loops"],
        undirected=cfg["undirected"], seed=SEED, operator_mode=mode,
        device=device)
    order = enc.output_size // enc.reservoir.hidden_size
    horizon = Windowing(window=cfg["window"], horizon=cfg["horizon"],
                        horizon_lag=cfg["horizon_lag"]).horizon_steps
    model = SGPModel(
        input_size=enc.output_size, order=order, n_nodes=n_nodes,
        hidden_size=cfg["hidden_size"], mlp_size=cfg["mlp_size"],
        output_size=1, n_layers=cfg["n_layers"], horizon=horizon,
        positional_encoding=cfg["positional_encoding"],
        emb_size=cfg["emb_size"], exog_size=0, resnet=cfg["resnet"],
        fully_connected=cfg["fully_connected"], dropout=cfg["dropout"],
        generator=torch.Generator().manual_seed(SEED)).to(device)
    return enc, model, scaler.params(device=device)


def serve(fc, history, obs, device):
    """warm_up then one step per observation; returns forecasts and the
    per-step latencies (host clock, synchronized)."""
    from sgp_tpu_torch.ops import bsr_spmm
    fc.warm_up(history)
    outs, lat, launches = [], [], []
    for x in obs:
        x = torch.as_tensor(x, device=device)
        before = bsr_spmm.launches
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fc.step(x)
        if device.type == "cuda":
            torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        launches.append(bsr_spmm.launches - before)
        outs.append(y)
    return outs, lat, launches


def phase3_slice(ds, graph, scaler, device, n_nodes: int) -> dict:
    from sgp_tpu_torch.ops import bsr_spmm
    from sgp_tpu_torch.serve import OnlineForecaster
    target = ds.target                                     # [T, N, 1]
    hist1, obs1 = target[:WARMUP], target[WARMUP:WARMUP + STEPS]
    hist4 = np.stack([target[s * STREAM_OFFSET:s * STREAM_OFFSET + WARMUP
                             - STREAMS * STREAM_OFFSET]
                      for s in range(STREAMS)], axis=1)    # [T, S, N, 1]
    t4 = hist4.shape[0]
    obs4 = np.stack([target[s * STREAM_OFFSET + t4:
                            s * STREAM_OFFSET + t4 + STREAM_STEPS]
                     for s in range(STREAMS)], axis=1)     # [K, S, N, 1]

    fcs = {}
    for mode in ("bsr", "dense"):
        enc, model, sp = build_slice(graph, scaler, mode, device, n_nodes)
        fcs[mode] = (OnlineForecaster(enc, graph, model, sp, device=device),
                     OnlineForecaster(enc, graph, model, sp,
                                      n_streams=STREAMS, device=device))
    k_hops = fcs["bsr"][0]._k * len(fcs["bsr"][0]._ops)

    bsr_spmm.launches = 0                                  # main path
    y1, lat1, l1 = serve(fcs["bsr"][0], hist1, obs1, device)
    y4, lat4, l4 = serve(fcs["bsr"][1], hist4, obs4, device)
    launches = bsr_spmm.launches
    print(f"[phase 3] bsr_spmm launches on the main path: {launches} "
          f"(per step: single {sorted(set(l1))}, {STREAMS} streams "
          f"{sorted(set(l4))}; {k_hops} hops per step)")
    if device.type == "cuda":
        assert min(l1 + l4) >= k_hops, "a step did not launch the kernel"

    yd1, latd1, _ = serve(fcs["dense"][0], hist1, obs1, device)
    yd4, latd4, _ = serve(fcs["dense"][1], hist4, obs4, device)
    horizon = fcs["bsr"][0].model.horizon
    worst = 0.0
    for a, b, shape in [(y1, yd1, (horizon, n_nodes, 1)),
                        (y4, yd4, (STREAMS, horizon, n_nodes, 1))]:
        for ya, yb in zip(a, b):
            assert tuple(ya.shape) == shape, (tuple(ya.shape), shape)
            assert torch.isfinite(ya).all(), "non-finite forecast"
            worst = max(worst, rel_err(ya, yb)[1])
    print(f"[phase 3] BSR-kernel vs dense forecaster: max rel err {worst:.3e}"
          f" (tol {TOL_SLICE})")
    assert worst <= TOL_SLICE

    if device.type == "cuda":   # the same slice run by the port on the CPU
        cpu = torch.device("cpu")
        enc, model, sp = build_slice(graph, scaler, "bsr", cpu, n_nodes)
        yc, _, _ = serve(OnlineForecaster(enc, graph, model, sp, device=cpu),
                         hist1, obs1[:CPU_STEPS], cpu)
        cpu_err = max(rel_err(ya.cpu(), yb)[1] for ya, yb in zip(y1, yc))
        print(f"[phase 3] card vs CPU port, {CPU_STEPS} steps: max rel err "
              f"{cpu_err:.3e} (tol {TOL_SLICE})")
        assert cpu_err <= TOL_SLICE

    med = {name: float(np.median(v) * 1e3) for name, v in (
        ("bsr_step_ms", lat1), ("dense_step_ms", latd1),
        (f"bsr_{STREAMS}streams_step_ms", lat4),
        (f"dense_{STREAMS}streams_step_ms", latd4))}
    print(f"[phase 3] median step latency: {json.dumps(med)}")
    return dict(launches=launches, **med)


def main():
    smi = phase0_card()
    device = torch.device("cuda", 0)
    phase1_build()
    ds, graph, scaler = slice_setup(N_NODES, N_STEPS, device)
    k1 = phase2_kernel(graph, device)
    res = phase3_slice(ds, graph, scaler, device, N_NODES)
    print(json.dumps({"kernels": [{
        "name": "bsr_spmm", "route": "cuda",
        "source": "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "replaces": "sgp_tpu/ops/bsr_kernel.py:39",
        "launches": res["launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
