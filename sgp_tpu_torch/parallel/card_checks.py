"""Rank functions that check the node-sharded path on one machine's card.

``chip_smoke.py`` runs them through :func:`~sgp_tpu_torch.parallel.launch.
run_ranks` (2 or 4 gloo ranks sharing ``cuda:0``; NCCL refuses two ranks
on one GPU); on the CPU they run as they are, at small sizes, to rehearse.
Each takes ``(rank, world, path, config)`` with its inputs in the ``.npz``
file ``path`` and returns plain values: errors against the single-device
port, K1's launches in the sharded run, CUDA-event times (host clock on
the CPU) and each rank's peak memory. Rank 0 computes the single-device
references on the same device.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from sgp_tpu_torch.graph.sparse import Graph
from sgp_tpu_torch.ops import bsr_kernel
from sgp_tpu_torch.ops.bsr_kernel import bsr_spmm, bsr_spmm_plain
from sgp_tpu_torch.ops.spmm import build_operator
from sgp_tpu_torch.parallel import collectives
from sgp_tpu_torch.parallel.halo import (_flat_exchange, build_halo_spec,
                                         gather_nodes, halo_khop,
                                         shard_nodes)
from sgp_tpu_torch.parallel.mesh import make_mesh


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms(fn, device, iters: int, warmup: int = 2) -> float:
    """ms a call: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    _sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def _peak_mib(device) -> float:
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 2 ** 20


def _graph(d: dict, prefix: str = "") -> Graph:
    return Graph(d[prefix + "src"], d[prefix + "dst"], d[prefix + "weight"],
                 int(d[prefix + "num_nodes"]))


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30))


def probe_gloo_cuda(device) -> dict:
    """Which raw collectives this torch build's gloo takes on CUDA tensors
    of the types the sharded path sends: ``{name: "ok" or the first
    error}`` (empty off the card)."""
    if device.type != "cuda" or dist.get_backend() != "gloo":
        return {}
    world = dist.get_world_size()

    def gather(t):
        dist.all_gather_into_tensor(
            t.new_empty((world * t.shape[0],) + t.shape[1:]), t)

    calls = {
        "all_to_all": (lambda t: dist.all_to_all_single(
            torch.empty_like(t), t),
            (torch.float32, torch.bfloat16, torch.int8)),
        "all_reduce": (dist.all_reduce, (torch.float32,)),
        "all_gather": (gather, (torch.float32, torch.int64)),
        "broadcast": (lambda t: dist.broadcast(t, 0), (torch.float32,)),
    }
    out = {}
    for name, (call, dtypes) in calls.items():
        out[name] = "ok"
        for dt in dtypes:
            try:
                call(torch.ones(world * 2, 3, device=device).to(dt))
            except RuntimeError as e:      # the build refuses the tensor
                out[name] = f"{dt}: {str(e).splitlines()[0][:120]}"
            dist.barrier()
            if out[name] != "ok":
                break
    return out


def _hops(op, x: torch.Tensor, k: int) -> torch.Tensor:
    """``[x, Ax, ..., A^k x]`` through a single-device operator."""
    outs = [x]
    for _ in range(k):
        outs.append(op @ outs[-1])
    return torch.cat(outs, dim=-1)


def _k1_row(spec, plan, x_fold, device, iters) -> dict:
    """K1 on one shard's stored tiles at the width the halo folds to: the
    kernel against its plain version, their times, the dense matmul of
    the same block (the library call) and the counts for the bound."""
    blocks, cols, ptr, rows = plan["local"]
    n_br = spec.nodes_per_shard // 128
    got = bsr_spmm(blocks, cols, ptr, rows, x_fold)
    plain = bsr_spmm_plain(blocks, cols, rows, n_br, x_fold)
    dense = torch.zeros(spec.nodes_per_shard, spec.nodes_per_shard,
                        device=device)
    br = rows.long()[:, None, None] * 128 + torch.arange(128, device=device
                                                          )[None, :, None]
    bc = cols.long()[:, None, None] * 128 + torch.arange(128, device=device
                                                          )[None, None, :]
    dense[br.expand_as(blocks), bc.expand_as(blocks)] = blocks.float()
    lib = dense @ x_fold
    return {
        "max_abs_err": float((got - plain).abs().max()),
        "rel_err": _rel(got, plain), "library_rel_err": _rel(lib, plain),
        "ms": _ms(lambda: bsr_spmm(blocks, cols, ptr, rows, x_fold),
                  device, iters),
        "plain_ms": _ms(lambda: bsr_spmm_plain(blocks, cols, rows, n_br,
                                               x_fold), device, iters),
        "library_ms": _ms(lambda: dense @ x_fold, device, iters),
        "nnzb": int(blocks.shape[0]), "n_block_rows": n_br,
        "n": int(x_fold.shape[0]), "f": int(x_fold.shape[1]),
        "nonzeros": int((blocks != 0).sum()),
        "blk_itemsize": blocks.element_size(),
        "x_itemsize": x_fold.element_size()}


def _halo_cases(rank, world, d, config, device) -> dict:
    """(a) ``halo_khop`` in ``bsr`` mode for each (depth, payload) of
    ``config["halo_cases"]`` against the single-device dense operator's
    hops (rank 0), K1's launches in each sharded run, the exchange's ms a
    hop and bytes, and K1 on rank 0's tiles."""
    mesh = make_mesh(1, world)
    g = _graph(d)
    x = torch.as_tensor(d["x"], device=device)
    k = config["k"]
    ref = None
    if rank == 0:
        ref = _hops(build_operator(g, "dense", device=device), x, k)
    out = {"cases": []}
    plans = {}
    for depth, payload in config["halo_cases"]:
        if depth not in plans:
            plans[depth] = build_halo_spec(g, world, mode="bsr", depth=depth)
        # the wire format changes no array of the plan
        spec = dataclasses.replace(plans[depth], payload_dtype=payload)
        xs = shard_nodes(x, mesh, "model", spec=spec)
        spec.shard(mesh.index["model"], device)      # plan on the device
        _sync(device)
        bsr_kernel.bsr_spmm.launches = 0
        y = halo_khop(spec, xs, mesh, k=k, axis="model", concat=True)
        _sync(device)
        row = {"depth": depth, "payload": payload,
               "launches": bsr_kernel.bsr_spmm.launches,
               "bytes_per_hop": spec.bytes_per_hop(x.shape[-1] * x.shape[0]),
               "dense_gather_bytes": spec.dense_gather_bytes(
                   x.shape[-1] * x.shape[0]),
               "b_max": spec.b_max, "tiles": spec.bsr_tiles.tolist()}
        whole = gather_nodes(y, mesh, "model", spec=spec)
        if rank == 0:
            row["max_abs_err"] = float((whole - ref).abs().max())
            row["rel_err"] = _rel(whole, ref)
        if depth == 1 and payload == "float32":
            plan = spec.shard(mesh.index["model"], device)
            row["exchange_ms"] = _ms(lambda: _flat_exchange(
                xs, plan["send_idx"], mesh.group("model"), payload),
                device, config["iters"])
            row["khop_ms"] = _ms(lambda: halo_khop(
                spec, xs, mesh, k=k, axis="model"), device, config["iters"])
            dist.barrier()
            if rank == 0:       # alone on the card while the others wait
                x2 = xs.movedim(-2, 0)
                out["k1"] = _k1_row(spec, plan, x2.reshape(x2.shape[0], -1),
                                    device, config["iters"])
            dist.barrier()
        out["cases"].append(row)
    return out


def _encode(rank, world, d, config, device):
    """(c) ``encode_series_sharded`` against ``streaming_encode`` of the
    whole series (rank 0, f32 both); returns the rank's slab and the whole
    encoding (gathered on every rank)."""
    from sgp_tpu_torch.encode import SGPEncoder, streaming_encode
    from sgp_tpu_torch.parallel.encode import encode_series_sharded
    mesh = make_mesh(world, 1)
    enc = SGPEncoder(**config["encoder"], device=device)
    sp = enc.spatial
    x = torch.as_tensor(d["x_series"], device=device)
    g = _graph(d, "g_")
    t0 = time.perf_counter()
    slab = encode_series_sharded(
        enc.reservoir, x, g, mesh, k=sp.receptive_field, axis="data",
        undirected=sp.undirected, add_loops=sp.add_self_loops,
        bidirectional=sp.bidirectional, global_attr=sp.global_attr)
    _sync(device)
    row = {"wall_s": time.perf_counter() - t0,
           "shape": list(slab.shape)}
    whole = gather_nodes(slab, mesh, "data", node_axis=1,
                         num_nodes=g.num_nodes)
    if rank == 0:
        ref = streaming_encode(enc, x, g, time_chunk=64,
                               out_dtype=torch.float32)
        row["max_abs_err"] = float((whole - ref).abs().max())
        row["rel_err"] = _rel(whole, ref)
    return row, mesh, slab, whole


def _step_and_eval(rank, world, d, config, device, mesh, slab, whole):
    """(d) one node-sharded IID step from each rank's own draws, against
    the single-device step on the union of the draws (rank 0); every
    rank's weights bit for bit; then steps timed; the sharded eval
    against the fused eval of the whole packed rows (rank 0)."""
    from sgp_tpu_torch.data.scalers import ScalerParams
    from sgp_tpu_torch.models import SGPModel
    from sgp_tpu_torch.parallel.sharding import (make_sharded_iid_eval,
                                                 make_sharded_iid_step,
                                                 rank_generator)
    from sgp_tpu_torch.train import MaskedMetrics
    from sgp_tpu_torch.train.fused_window import make_fused_eval
    from sgp_tpu_torch.train.iid import make_fused_iid_step, pack_iid_data
    h_off = d["h_off"]
    n = whole.shape[1]
    tgt, mask, u = (torch.as_tensor(d[k], device=device)
                    for k in ("target", "mask", "u"))
    tgt_s, mask_s, u_s = (shard_nodes(a, mesh, "data", node_axis=1)
                          for a in (tgt, mask, u))
    packed_s = pack_iid_data(slab.to(torch.bfloat16), tgt_s, mask_s, h_off)
    scaler = ScalerParams(torch.as_tensor(d["bias"], device=device),
                          torch.as_tensor(d["scale"], device=device))

    def model_at_init():
        return SGPModel(**config["model"], generator=torch.Generator(
        ).manual_seed(config["seed"])).to(device)

    model = model_at_init()
    opt = torch.optim.Adam(model.parameters(), lr=config["lr"],
                           betas=(0.9, 0.999), eps=1e-8)
    step = make_sharded_iid_step(
        model, opt, None, tgt_s, mask_s, d["valid"], h_off, scaler, mesh,
        u=u_s, batch_size=config["batch"], axis="data", packed=packed_s,
        grad_clip=config["grad_clip"], n_nodes=n)
    gen = rank_generator(config["seed"], rank, device)
    t, n_loc = step.sample_and_loss.sample(gen)
    loss = float(step.train_on(t, n_loc))
    group = mesh.group("data")
    t_all = collectives.all_gather(t, group)
    n_all = collectives.all_gather(mesh.index["data"] * step.n_local
                                   + n_loc, group)
    flat = torch.cat([p.detach().reshape(1, -1) for p in model.parameters()],
                     dim=1)
    replicas = collectives.all_gather(flat, group)
    out = {"loss": loss, "replicas_equal": bool(
        (replicas == replicas[:1]).all())}
    packed_w = None
    if rank == 0:
        packed_w = pack_iid_data(whole.to(torch.bfloat16), tgt, mask, h_off)
        ref = model_at_init()
        ref_opt = torch.optim.Adam(ref.parameters(), lr=config["lr"],
                                   betas=(0.9, 0.999), eps=1e-8)
        ref_step = make_fused_iid_step(
            ref, ref_opt, None, tgt, mask, d["valid"], h_off, scaler, u=u,
            batch_size=config["batch"], packed=packed_w,
            grad_clip=config["grad_clip"])
        ref_loss = float(ref_step.train_on(t_all, n_all))
        g_top = max(float(p.grad.abs().max()) for p in ref.parameters())
        p_top = max(float(p.detach().abs().max()) for p in ref.parameters())
        worst_beyond, worst = 0.0, 0.0
        for p, q in zip(model.parameters(), ref.parameters()):
            err = (p - q).abs()
            beyond = q.grad.abs() > config["grad_floor"] * g_top
            if beyond.any():
                worst_beyond = max(worst_beyond, float(err[beyond].max()))
            worst = max(worst, float(err.max()))
        out.update(ref_loss=ref_loss,
                   loss_rel_err=abs(loss - ref_loss) / abs(ref_loss),
                   param_err_beyond_floor=worst_beyond / p_top,
                   param_err_max=worst, two_lr=2 * config["lr"])
    # steps timed: every rank's sample, gather, forward, backward and the
    # summed gradients, from a common start
    _sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(config["time_steps"]):
        step(gen)
    _sync(device)
    out["step_ms"] = (time.perf_counter() - t0) * 1e3 / config["time_steps"]
    metrics = MaskedMetrics.forecasting()
    w_off, items = np.array([0]), d["items"]
    x_slice = slab.shape[-1]
    ev = make_sharded_iid_eval(
        model, packed_s, None, None, items, w_off, h_off, scaler, metrics,
        mesh, u=u_s, axis="data", batch_size=config["eval_batch"],
        x_slice=x_slice, unpack_targets=True, n_nodes=n)
    _sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    out["eval"] = ev()
    out["eval_s"] = time.perf_counter() - t0
    if rank == 0:
        ref_eval = make_fused_eval(
            model, packed_w, tgt, mask, items, w_off, h_off, scaler,
            metrics, u=u, batch_size=config["eval_batch"], x_slice=x_slice)()
        out["ref_eval"] = ref_eval
        out["eval_rel_err"] = max(abs(out["eval"][k] - v) / abs(v)
                                  for k, v in ref_eval.items())
    return out


def pair_worker(rank, world, path, config):
    """Phase 21's (a), (c) and (d) on one world: the gloo probe, the halo
    K-hop through K1, the sharded encode, the sharded IID step and
    eval. Returns the rank's rows and its peak memory (MiB)."""
    device = torch.device(config["device"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    d = dict(np.load(path))
    out = {"probe": probe_gloo_cuda(device)}
    t0 = time.perf_counter()
    out["halo"] = _halo_cases(rank, world, d, config, device)
    out["halo_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["encode"], mesh, slab, whole = _encode(rank, world, d, config,
                                               device)
    out["encode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["step"] = _step_and_eval(rank, world, d, config, device, mesh, slab,
                                 whole)
    out["step_s"] = time.perf_counter() - t0
    out["peak_mib"] = _peak_mib(device)
    return out


def band_worker(rank, world, path, config):
    """Phase 21's (b): the K-hop with ``auto``'s plan (bsr past 4,096 rows
    a shard) against the single-device BSR operator's hops (rank 0), K1's
    launches in the sharded run, the exchange's ms a hop and bytes."""
    device = torch.device(config["device"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    d = dict(np.load(path))
    mesh = make_mesh(1, world)
    g = _graph(d)
    x = torch.as_tensor(d["x"], device=device)
    spec = build_halo_spec(g, world)
    xs = shard_nodes(x, mesh, "model", spec=spec)
    plan = spec.shard(mesh.index["model"], device)
    _sync(device)
    bsr_kernel.bsr_spmm.launches = 0
    y = halo_khop(spec, xs, mesh, k=config["k"], axis="model", concat=True)
    _sync(device)
    out = {"mode": spec.mode, "nodes_per_shard": spec.nodes_per_shard,
           "launches": bsr_kernel.bsr_spmm.launches, "b_max": spec.b_max,
           "tiles": spec.bsr_tiles.tolist() if spec.bsr_tiles is not None
           else None, "bytes_per_hop": spec.bytes_per_hop(x.shape[-1]),
           "dense_gather_bytes": spec.dense_gather_bytes(x.shape[-1])}
    whole = gather_nodes(y, mesh, "model", spec=spec)
    if rank == 0:
        ref = _hops(build_operator(g, "bsr", device=device), x, config["k"])
        out["max_abs_err"] = float((whole - ref).abs().max())
        out["rel_err"] = _rel(whole, ref)
    out["exchange_ms"] = _ms(lambda: _flat_exchange(
        xs, plan["send_idx"], mesh.group("model"), spec.payload_dtype),
        device, config["iters"])
    out["khop_ms"] = _ms(lambda: halo_khop(spec, xs, mesh, k=config["k"],
                                           axis="model"), device,
                         config["iters"])
    out["peak_mib"] = _peak_mib(device)
    return out
