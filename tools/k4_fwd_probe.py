#!/usr/bin/env python3
"""Probe the GatedGN ELL kernels (K4, ``sgp_tpu_torch/csrc/gn_ell.cu``) on
the inputs the 100-nn training slice really gives them, on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tools/k4_fwd_probe.py [--lib NAME=DIR ...] [--seeds 4]

Two parts, on ``chip_smoke.py``'s phase-5 data and model (5,016 synthetic
nodes, ``configs/largescale_100nn/gatedgn_pv.yaml``):

1. The inputs of the layers' ``gn_ell_aggregate`` calls in the first train
   step are kept. Each forward (the kernel, the plain f32 version that is
   its oracle, the f32 reference that ``chip_smoke.py``'s plain-ELL run
   trains with) is held against the chain evaluated in float64, and each
   backward (the kernel's, the plain one) against float64 autograd for a
   normal cotangent. One JSON line a layer: each version's max and mean
   signed error over the largest value, and the inputs' magnitudes.
2. Phase 5's training run (8 steps) in variants, each held to the
   plain-ELL run as phase 5 holds the kernel run: the kernel forward and
   backward; each backward beside the plain forward and beside the plain
   forward times 1 + 1e-7 * a normal draw (``--seeds`` seeds), to see how
   far the check's verdict hangs on rounding; then the plain-ELL run
   once more (the check's floor). One JSON line a variant: each step's
   loss error, after each step the parameters' max difference on the
   elements phase 5 holds, and at the end the tensors whose elements
   differ by more than its tolerance.

``--lib NAME=DIR`` adds a K4 source with the same C interface (``DIR``
holds a ``gn_ell.cu`` and the headers it includes: an earlier commit's, or
a variant), built with the same flags and swapped in under the wrapper:
part 1 holds its forward and backward to float64 too, part 2 runs it
whole and its backward under the plain and the noisy plain forward. The
card's machine has no git, so write an earlier commit's sources out first::

    mkdir -p build/k4_old && for f in gn_ell.cu gated_pair.cuh mma_common.cuh
    do git show <rev>:sgp_tpu_torch/csrc/$f > build/k4_old/$f; done
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
DEVICE = "cuda:0"
NOISE = 1e-7   # the relative noise of the "noise" forward

import chip_smoke as cs  # noqa: E402
from sgp_tpu_torch.graph import padded_incoming  # noqa: E402
from sgp_tpu_torch.models import graph_layers  # noqa: E402
from sgp_tpu_torch.ops import _build, gn_ell  # noqa: E402
from sgp_tpu_torch.ops.activations import ACTIVATIONS  # noqa: E402

GRADS = ("d_pi", "d_pjn", "dw2", "db2", "dwg", "dbg")


def build_libs(specs) -> dict:
    """``{name: (lib, 0, "")}`` for each ``NAME=DIR``: ``DIR/gn_ell.cu``
    built (one ``nvcc`` each, in parallel) and bound as ``gn_ell.build``
    binds the current one."""
    procs = {}
    for spec in specs:
        name, src = spec.split("=", 1)
        out = ROOT / "build" / f"k4_{name}.so"
        out.parent.mkdir(exist_ok=True)
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
             str(Path(src) / "gn_ell.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        spills = sum("spill" in ln and " 0 bytes spill stores" not in ln
                     for ln in log.splitlines())
        print(f"[lib] {name}: built; ptxas lines with a spill: {spills}",
              flush=True)
        lib = ctypes.CDLL(str(out))
        _build.bind(lib, "sgp_gn_ell_blocks", [ci, ci, ci, ctypes.POINTER(ci)])
        _build.bind(lib, "sgp_gn_ell_fwd", [ci, ci] + [vp] * 8 + [ci] * 6 + [vp])
        _build.bind(lib, "sgp_gn_ell_bwd", [ci, ci] + [vp] * 12 + [ci] * 6 + [vp])
        libs[name] = (lib, 0.0, "")
    return libs


@contextlib.contextmanager
def library(lib):
    """``gn_ell``'s wrapper on ``lib`` in place of the current build."""
    build, blocks = gn_ell.build, gn_ell._blocks
    gn_ell.build = lambda: lib
    gn_ell._blocks = gn_ell._blocks.__wrapped__
    try:
        yield
    finally:
        gn_ell.build, gn_ell._blocks = build, blocks


@contextlib.contextmanager
def halves(fwd=None, bwd=None, seed=0):
    """The autograd Function's forward and backward on other versions:
    ``"plain"``, ``"noise"`` (the plain forward times 1 + NOISE * a normal
    draw from ``seed``, for the forward only), a library (the wrapper on it)
    or None (the current kernel)."""
    kept = gn_ell.gn_ell_fwd, gn_ell.gn_ell_bwd
    gen = torch.Generator(DEVICE).manual_seed(seed)

    def noisy(*args):
        out = gn_ell.gn_ell_fwd_plain(*args)
        return out * (1 + NOISE * torch.randn(out.shape, device=out.device,
                                              generator=gen))

    def on(fn, version, plain):
        if version is None:
            return fn
        if version == "plain":
            return plain
        if version == "noise":
            return noisy

        def call(*args):
            with library(version):
                return fn(*args)
        call.launches = 0       # the wrapper counts on its module's name
        return call

    gn_ell.gn_ell_fwd = on(kept[0], fwd, gn_ell.gn_ell_fwd_plain)
    gn_ell.gn_ell_bwd = on(kept[1], bwd, gn_ell.gn_ell_bwd_plain)
    try:
        yield
    finally:
        gn_ell.gn_ell_fwd, gn_ell.gn_ell_bwd = kept


def errors(got, truth) -> dict:
    scale = truth.abs().max().item()
    d = got.double().reshape(truth.shape) - truth
    return {"max": d.abs().max().item() / scale,
            "mean": d.mean().item() / scale}


def against_float64(calls, libs):
    """Part 1: each version's forward and backward on the kept inputs
    against float64."""
    for layer, args in enumerate(calls):
        p_i, pjn, nmask, w2, b2, wg, bg, act = args
        act_fn = ACTIVATIONS[act][0]
        leaves = [t.double().requires_grad_(True)
                  for t in (p_i, pjn, w2, b2, wg, bg)]
        s = leaves[0].unsqueeze(-2) + leaves[1]
        mb = act_fn(act_fn(s) @ leaves[2] + leaves[3])
        g = torch.sigmoid(mb @ leaves[4].reshape(-1, 1) + leaves[5])
        out = (g * mb * (nmask != 0).double().unsqueeze(-1)).sum(-2)
        ghat = torch.randn(out.shape, dtype=torch.float64, device=out.device,
                           generator=torch.Generator(out.device
                                                     ).manual_seed(0))
        want = torch.autograd.grad((out * ghat).sum(), leaves)
        truth = out.detach()
        row = {"layer": layer, "activation": act,
               "max_abs": {"p_i": p_i.abs().max().item(),
                           "pjn": pjn.abs().max().item(),
                           "s": s.detach().abs().max().item(),
                           "out": truth.abs().max().item()},
               "rms_out": truth.pow(2).mean().sqrt().item()}
        del s, mb, g, out, leaves
        fwds = {"kernel": gn_ell.gn_ell_fwd, "plain": gn_ell.gn_ell_fwd_plain,
                "reference_f32": gn_ell.gn_ell_reference}
        bwds = {"kernel": gn_ell.gn_ell_bwd, "plain": gn_ell.gn_ell_bwd_plain}
        versions = [(n, contextlib.nullcontext, fwds[n], bwds.get(n))
                    for n in fwds]
        versions += [(n, lambda lib=lib: library(lib), gn_ell.gn_ell_fwd,
                      gn_ell.gn_ell_bwd) for n, lib in libs.items()]
        for name, ctx, fwd, bwd in versions:
            with ctx(), torch.no_grad():
                row[name] = {"out": errors(fwd(*args), truth)}
                if bwd is not None:
                    got = bwd(*args[:7], ghat.float(), act)
                    row[name].update({k: errors(x, w) for k, x, w in
                                      zip(GRADS, got, want)})
        torch.cuda.synchronize()
        print(f"[float64] {json.dumps(row)}", flush=True)


def run(cfg, ds, split, static, device, init_state):
    """Phase 5's training steps; returns the losses, the first step's
    clipped gradients and the parameters after each step."""
    pred = cs.gn_predictor(cfg, ds, static, device, init_state)
    snaps, inner = [], pred.train_step

    def step(batch):
        loss = inner(batch)
        snaps.append({k: v.detach().clone()
                      for k, v in pred.model.named_parameters()})
        return loss

    pred.train_step = step
    losses, _, grads0 = cs.train_steps(pred, cs.loaders(cfg, ds, split)[0],
                                       device)
    return losses, grads0, snaps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", action="append", default=[],
                    help="NAME=DIR: a directory holding a gn_ell.cu and its "
                         "headers")
    ap.add_argument("--seeds", type=int, default=4,
                    help="seeds of the noisy plain forward")
    a = ap.parse_args()
    print(cs.phase0_card(), flush=True)
    device = torch.device(DEVICE)
    libs = build_libs(a.lib)
    ds, graph, _ = cs.slice_setup(cs.N_NODES, cs.N_STEPS, device)
    cfg, ds, split = cs.gn_data(ds, graph)
    src_idx, nmask = padded_incoming(graph)
    static = {"gn_neigh": (src_idx, nmask)}

    # 1. the first step's inputs, each version against float64
    calls, kernel = [], graph_layers.gn_ell_aggregate

    def keep(*args):
        if len(calls) < cfg["gnn_layers"]:
            calls.append(tuple(t.detach().clone() if torch.is_tensor(t)
                               else t for t in args))
        return kernel(*args)

    pred = cs.gn_predictor(cfg, ds, static, device)
    init_state = {k: v.detach().clone()
                  for k, v in pred.model.state_dict().items()}
    graph_layers.gn_ell_aggregate = keep
    try:
        batch = next(iter(cs.loaders(cfg, ds, split, 1)[0]))
        float(pred.train_step(batch))
    finally:
        graph_layers.gn_ell_aggregate = kernel
    against_float64(calls, libs)
    del calls, pred

    # 2. training variants against the plain-ELL run
    with cs.plain_ell():
        p_losses, _, p_snaps = run(cfg, ds, split, static, device,
                                   init_state)
    variants = {"kernel": {}, "kernel_fwd_plain_bwd": {"bwd": "plain"}}
    variants.update({name: {"fwd": lib, "bwd": lib}
                     for name, lib in libs.items()})
    for bwd_name, bwd in [("kernel", None), ("plain", "plain"),
                          *libs.items()]:
        variants[f"plain_fwd_{bwd_name}_bwd"] = {"fwd": "plain", "bwd": bwd}
        variants.update({f"noise{k}_fwd_{bwd_name}_bwd": {
            "fwd": "noise", "bwd": bwd, "seed": k} for k in range(a.seeds)})
    for name, where in [*variants.items(), ("plain_ell_again", None)]:
        with (cs.plain_ell() if where is None else halves(**where)):
            losses, grads0, snaps = run(cfg, ds, split, static, device,
                                        init_state)
        steps = []      # after each step: the held elements' max diff
        for snap, ref in zip(snaps, p_snaps):
            diff = {k: (snap[k] - ref[k]).abs().cpu()[
                grads0[k].abs() > cs.GRAD_FLOOR] for k in snap}
            steps.append({"max": max(d.max().item() for d in diff.values()),
                          "over_tol": {k: int((d > cs.TOL_PARAM).sum())
                                       for k, d in diff.items()
                                       if (d > cs.TOL_PARAM).any()}})
        loss_err = [abs(x - y) / abs(y) for x, y in zip(losses, p_losses)]
        row = {"variant": name, "loss_rel_err": loss_err,
               "param_max_abs_diff_by_step": [x["max"] for x in steps],
               "params_over_tol_at_end": steps[-1]["over_tol"],
               "holds": steps[-1]["max"] <= cs.TOL_PARAM
               and max(loss_err) <= cs.TOL_LOSS}
        print(f"[train] {json.dumps(row)}", flush=True)


if __name__ == "__main__":
    main()
