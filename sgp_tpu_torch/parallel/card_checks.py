"""Rank functions that check the multi-device paths on one machine's card.

``chip_smoke.py`` runs them through :func:`~sgp_tpu_torch.parallel.launch.
run_ranks` (2 or 4 gloo ranks sharing ``cuda:0``; NCCL refuses two ranks
on one GPU); on the CPU they run as they are, at small sizes, to rehearse.
Phase 23's :func:`multi_device_worker` runs 4 ranks as a ``(host,
chip)`` grid. Each takes ``(rank, world, path, config)`` with its inputs
in the ``.npz`` file ``path`` and returns plain values: errors against the single-device
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
from sgp_tpu_torch.parallel.mesh import make_hier_mesh, make_mesh


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
    kernel against its plain version, their times, the library call
    (torch's BSR product of the same tiles, ``torch.sparse_bsr_tensor @
    x``) beside the dense matmul of the block, and the counts for the
    bound."""
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
    npad = n_br * 128
    bsr = torch.sparse_bsr_tensor(ptr, cols, blocks, size=(npad, npad))
    return {
        "max_abs_err": float((got - plain).abs().max()),
        "rel_err": _rel(got, plain), "dense_rel_err": _rel(lib, plain),
        "library_rel_err": _rel(bsr @ x_fold, plain),
        "ms": _ms(lambda: bsr_spmm(blocks, cols, ptr, rows, x_fold),
                  device, iters),
        "plain_ms": _ms(lambda: bsr_spmm_plain(blocks, cols, rows, n_br,
                                               x_fold), device, iters),
        "library_ms": _ms(lambda: bsr @ x_fold, device, iters),
        "dense_ms": _ms(lambda: dense @ x_fold, device, iters),
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


def _union(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``[Tb, P_l]`` draws side by side: ``[Tb, S * P_l]``."""
    return collectives.all_gather(t.T.contiguous(), group).T.contiguous()


def _replicas_equal(model, group) -> bool:
    flat = torch.cat([p.detach().reshape(1, -1) for p in model.parameters()],
                     dim=1)
    every = collectives.all_gather(flat, group)
    return bool((every == every[:1]).all())


def _held(model, ref, floor: float, lr: float) -> dict:
    """``model``'s weights after one step against ``ref``'s (the same step
    on one device, its gradients still on it): the worst error where the
    gradient lies beyond ``floor`` of the largest, relative to the largest
    weight, and the worst anywhere beside two steps of lr."""
    g_top = max(float(p.grad.abs().max()) for p in ref.parameters())
    p_top = max(float(p.detach().abs().max()) for p in ref.parameters())
    worst_beyond, worst = 0.0, 0.0
    for p, q in zip(model.parameters(), ref.parameters()):
        err = (p - q).abs()
        beyond = q.grad.abs() > floor * g_top
        if beyond.any():
            worst_beyond = max(worst_beyond, float(err[beyond].max()))
        worst = max(worst, float(err.max()))
    return {"param_err_beyond_floor": worst_beyond / p_top,
            "param_err_max": worst, "two_lr": 2 * lr}


def _step_ms(step, gen, device, n: int, barrier: bool = True) -> dict:
    """The median and quartiles of ``n`` synchronized steps' ms (host
    clock), from a common start of every rank unless ``barrier`` is
    False (one rank timing alone)."""
    _sync(device)
    if barrier:
        dist.barrier()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        step(gen)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3)}


def _strat_routes(rank, world, d, config, device) -> dict:
    """(a) The sharded stratified step (2 supports and the global mean)
    from each rank's draws (the starts shared) against the single-device
    step on their union (rank 0), on each of ``config["modes"]``'
    supports: the loss, the weights, the replicas' bits, K1's launches in
    the sharded step, steps timed; (b) the sharded eval with the supports
    and the global mean against ``make_fused_eval`` (rank 0), K1's
    launches in it."""
    from sgp_tpu_torch.data.scalers import ScalerParams
    from sgp_tpu_torch.data.sgp_loader import build_support_operators
    from sgp_tpu_torch.encode import Reservoir
    from sgp_tpu_torch.models import SGPModel
    from sgp_tpu_torch.ops import GlobalMeanOperator
    from sgp_tpu_torch.parallel.sharding import (
        make_sharded_iid_eval, make_sharded_iid_stratified_step)
    from sgp_tpu_torch.train import MaskedMetrics
    from sgp_tpu_torch.train.fused_window import make_fused_eval
    from sgp_tpu_torch.train.iid import make_fused_iid_stratified_step
    mesh = make_mesh(world, 1)
    group = mesh.group("data")
    c = config["strat"]
    t0 = time.perf_counter()
    h = Reservoir(**c["reservoir"], device=device)(
        torch.as_tensor(d["x_series"], device=device),
        out_dtype=torch.bfloat16)
    _sync(device)
    encode_s = time.perf_counter() - t0
    tgt, mask, u = (torch.as_tensor(d[k], device=device)
                    for k in ("target", "mask", "u"))
    n = h.shape[1]
    h_s, tgt_s, mask_s, u_s = (shard_nodes(a, mesh, "data", node_axis=1)
                               for a in (h, tgt, mask, u))
    scaler = ScalerParams(torch.as_tensor(d["bias"], device=device),
                          torch.as_tensor(d["scale"], device=device))
    g = _graph(d, "g_")

    def model_at_init():
        return SGPModel(**c["model"], generator=torch.Generator(
        ).manual_seed(config["seed"])).to(device)

    common = dict(global_attr=True, times_per_batch=c["times_per_batch"],
                  grad_clip=config["grad_clip"])
    out = {"encode_s": encode_s}
    for mode in c["modes"]:
        ops = build_support_operators(g, k=c["k"], operator_mode=mode,
                                      device=device)
        model = model_at_init()
        opt = torch.optim.Adam(model.parameters(), lr=config["lr"],
                               betas=(0.9, 0.999), eps=1e-8)
        step = make_sharded_iid_stratified_step(
            model, opt, h_s, tgt_s, mask_s, d["valid"], d["h_off"], scaler,
            ops, mesh, u=u_s, nodes_per_time=c["nodes_per_time"],
            seed=config["seed"], n_nodes=n, **common)
        gen = torch.Generator(device=device).manual_seed(config["seed"])
        t, n_loc = step.sample(gen)
        _sync(device)
        bsr_kernel.bsr_spmm.launches = 0
        loss = float(step.train_on(t, n_loc))
        row = {"mode": mode, "loss": loss,
               "k1_launches_step": bsr_kernel.bsr_spmm.launches,
               "replicas_equal": _replicas_equal(model, group)}
        n_all = _union(mesh.index["data"] * step.n_local + n_loc, group)
        if rank == 0:
            ref = model_at_init()
            ref_opt = torch.optim.Adam(ref.parameters(), lr=config["lr"],
                                       betas=(0.9, 0.999), eps=1e-8)
            ref_step = make_fused_iid_stratified_step(
                ref, ref_opt, h, tgt, mask, d["valid"], d["h_off"], scaler,
                ops, u=u, nodes_per_time=n_all.shape[1], **common)
            ref_loss = float(ref_step.train_on(t, n_all))
            row.update(ref_loss=ref_loss,
                       loss_rel_err=abs(loss - ref_loss) / abs(ref_loss),
                       **_held(model, ref, config["grad_floor"],
                               config["lr"]))
            # the single-device step at the whole batch, alone on the card
            row["single_step_ms"] = _step_ms(
                ref_step, torch.Generator(device=device).manual_seed(
                    config["seed"]), device, config["time_steps"], False)
            del ref, ref_opt, ref_step
        row["step_ms"] = _step_ms(step, gen, device, config["time_steps"])
        eval_ops = list(ops) + [GlobalMeanOperator(n)]
        metrics = MaskedMetrics.forecasting()
        ev = make_sharded_iid_eval(
            model, h_s, tgt_s, mask_s, d["items"], np.array([0]),
            d["h_off"], scaler, metrics, mesh, u=u_s,
            batch_size=c["eval_batch"], support_ops=eval_ops, n_nodes=n)
        _sync(device)
        dist.barrier()
        bsr_kernel.bsr_spmm.launches = 0
        t0 = time.perf_counter()
        row["eval"] = ev()
        row["eval_s"] = time.perf_counter() - t0
        row["k1_launches_eval"] = bsr_kernel.bsr_spmm.launches
        if rank == 0:
            ref_eval = make_fused_eval(
                model, h, tgt, mask, d["items"], np.array([0]), d["h_off"],
                scaler, metrics, u=u, support_ops=eval_ops,
                batch_size=c["eval_batch"])()
            row["eval_rel_err"] = max(abs(row["eval"][k] - v) / abs(v)
                                      for k, v in ref_eval.items())
        out[mode] = row
        del model, opt, step, ev
    return out


def _window_route(rank, world, d, config, device) -> dict:
    """(d) The data-parallel window step on the BSR supports of the
    traffic graph from each rank's own starts against the single-device
    step on their union (rank 0): the loss, the weights, the replicas'
    bits, K1's launches, steps timed."""
    from sgp_tpu_torch.data.scalers import ScalerParams
    from sgp_tpu_torch.data.sgp_loader import build_support_operators
    from sgp_tpu_torch.models import SGPModel
    from sgp_tpu_torch.parallel.sharding import (make_sharded_window_step,
                                                 rank_generator)
    from sgp_tpu_torch.train.fused_window import make_fused_window_step
    mesh = make_mesh(world, 1)
    group = mesh.group("data")
    c = config["window"]
    x, tgt, mask, u = (torch.as_tensor(d[k], device=device)
                       for k in ("la_x", "la_target", "la_mask", "la_u"))
    scaler = ScalerParams(torch.as_tensor(d["la_bias"], device=device),
                          torch.as_tensor(d["la_scale"], device=device))
    ops = build_support_operators(_graph(d, "la_"), operator_mode="bsr",
                                  device=device, **c["supports"])

    def model_at_init():
        return SGPModel(**c["model"], generator=torch.Generator(
        ).manual_seed(config["seed"])).to(device)

    args = (x, tgt, mask, d["la_starts"], np.array([0]), d["la_h_off"],
            scaler)
    common = dict(u=u, support_ops=ops, grad_clip=config["grad_clip"])
    model = model_at_init()
    opt = torch.optim.Adam(model.parameters(), lr=config["lr"],
                           betas=(0.9, 0.999), eps=1e-8)
    step = make_sharded_window_step(model, opt, *args, mesh,
                                    batch_size=c["batch"], **common)
    gen = rank_generator(config["seed"], mesh.index["data"], device)
    items = step.sample(gen)
    _sync(device)
    bsr_kernel.bsr_spmm.launches = 0
    loss = float(step.train_on(items))
    row = {"loss": loss, "k1_launches_step": bsr_kernel.bsr_spmm.launches,
           "replicas_equal": _replicas_equal(model, group),
           "supports": len(ops)}
    every = collectives.all_gather(items, group)
    if rank == 0:
        ref = model_at_init()
        ref_opt = torch.optim.Adam(ref.parameters(), lr=config["lr"],
                                   betas=(0.9, 0.999), eps=1e-8)
        ref_step = make_fused_window_step(
            ref, ref_opt, *args, batch_size=c["batch"], **common)
        ref_loss = float(ref_step.train_on(every))
        row.update(ref_loss=ref_loss,
                   loss_rel_err=abs(loss - ref_loss) / abs(ref_loss),
                   **_held(model, ref, config["grad_floor"], config["lr"]))
        row["single_step_ms"] = _step_ms(
            ref_step, torch.Generator(device=device).manual_seed(
                config["seed"]), device, config["time_steps"], False)
    row["step_ms"] = _step_ms(step, gen, device, config["time_steps"])
    return row


def _runner_pair(rank, world, argv, config, device) -> dict:
    """(e) ``run_traffic_baselines --data-sharding batch`` over the ranks
    (K4's launches on each), then, on rank 0 alone, the same command
    unsharded: the test metrics of both."""
    from sgp_tpu_torch.ops import gn_ell
    from sgp_tpu_torch.parallel.workers import runner_worker
    for fn in (gn_ell.gn_ell_fwd, gn_ell.gn_ell_bwd):
        fn.launches = 0
    t0 = time.perf_counter()
    res, _ = runner_worker(rank, world, argv + ["--data-sharding", "batch"],
                           {"runner": "traffic_baselines",
                            "logs_dir": config["logs_dir"]})
    row = {"sharded": res, "sharded_s": time.perf_counter() - t0,
           "launches": {fn.__name__: fn.launches for fn in (
               gn_ell.gn_ell_fwd, gn_ell.gn_ell_bwd)}}
    dist.barrier()
    if rank == 0:
        t0 = time.perf_counter()
        row["unsharded"] = runner_worker(rank, world, argv, {
            "runner": "traffic_baselines",
            "logs_dir": config["logs_dir"]})[0]
        row["unsharded_s"] = time.perf_counter() - t0
        row["rel_err"] = max(abs(res[k] - v) / abs(v)
                             for k, v in row["unsharded"].items()
                             if np.isfinite(v))
    return row


def dp_worker(rank, world, path, config):
    """Phase 22's rank function (2 gloo ranks sharing the card): (a), (b)
    the sharded stratified step and eval, (d) the window step, (e) the
    baseline runner over the ranks and GraphWaveNet's ``Predictor(mesh=)``
    against one process. Returns the rank's rows and its peak memory
    (MiB)."""
    from sgp_tpu_torch.parallel.workers import predictor_worker
    device = torch.device(config["device"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    d = dict(np.load(path))
    out = {}
    t0 = time.perf_counter()
    out["strat"] = _strat_routes(rank, world, d, config, device)
    out["strat_s"] = time.perf_counter() - t0
    out["strat_peak_mib"] = _peak_mib(device)
    t0 = time.perf_counter()
    out["window"] = _window_route(rank, world, d, config, device)
    out["window_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["runner"] = _runner_pair(rank, world, config["runner_argv"], config,
                                 device)
    out["runner_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gw = config["gwnet"]
    out["gwnet"] = predictor_worker(rank, world, gw["path"], gw)[0]
    dist.barrier()
    if rank == 0:
        out["gwnet_single"] = predictor_worker(
            0, 1, gw["path"], {**gw, "mesh": False})[0]
    out["gwnet_s"] = time.perf_counter() - t0
    out["peak_mib"] = _peak_mib(device)
    return out


def _hier_cases(rank, world, d, config, device) -> dict:
    """Phase 23 (1), (2): the two-level K-hop in ``bsr`` mode on the
    ``(host, chip)`` grid for each (depth, payload) of
    ``config["halo_cases"]``, against the single-device dense operator's
    hops (rank 0) and the flat exchange of the same plan over every rank:
    the two exchanges' recv buffers at every slot a halo entry reads (the
    same bits), the K-hops (the halo blocks' ``index_add_`` sums in the
    order of the card's atomics, so the flat K-hop run twice differs as
    much); K1's launches in each two-level run; the flat and two-level
    exchanges' ms a hop with their bytes; K1 on rank 0's tiles."""
    from sgp_tpu_torch.parallel.halo import _hier_exchange
    hosts = config["hosts"]
    chips = world // hosts
    both = ("host", "chip")
    hier_mesh = make_hier_mesh(hosts, chips)
    flat_mesh = make_mesh(1, world)
    g = _graph(d)
    x = torch.as_tensor(d["x"], device=device)
    feat = x.shape[0] * x.shape[-1]
    k = config["k"]
    ref = None
    if rank == 0:
        ref = _hops(build_operator(g, "dense", device=device), x, k)
    out = {"cases": [], "case_s": []}
    plans = {}
    for depth, payload in config["halo_cases"]:
        t0 = time.perf_counter()
        if depth not in plans:
            plans[depth] = build_halo_spec(g, world, mode="bsr", depth=depth,
                                           chips_per_host=chips)
        spec = dataclasses.replace(plans[depth], payload_dtype=payload)
        xs = shard_nodes(x, hier_mesh, both, spec=spec)
        plan = spec.shard(hier_mesh.index[both], device)
        _sync(device)
        bsr_kernel.bsr_spmm.launches = 0
        y = halo_khop(spec, xs, hier_mesh, k=k, axis=both, concat=True)
        _sync(device)
        launches = bsr_kernel.bsr_spmm.launches
        flat, flat2 = (halo_khop(spec, xs, flat_mesh, k=k, axis="model",
                                 concat=True) for _ in range(2))
        i = hier_mesh.index[both]
        used = torch.as_tensor(np.concatenate([
            np.arange(j * spec.b_max, j * spec.b_max
                      + spec.boundary_counts[i, j])
            for j in range(world) if j != i]), device=device)
        groups = (hier_mesh.group("host"), hier_mesh.group("chip"))
        bufs = (_hier_exchange(xs, plan["hier"], *groups, payload),
                _flat_exchange(xs, plan["send_idx"],
                               flat_mesh.group("model"), payload))
        _, _, _, c, h, b_intra, b_cross = spec.hier
        row = {"depth": depth, "payload": payload, "launches": launches,
               "exchange_bitwise": bool(torch.equal(
                   *(b.index_select(-2, used) for b in bufs))),
               "slots_read": int(used.numel()),
               "flat_rel_diff": _rel(y, flat),
               "flat_repeat_rel_diff": _rel(flat2, flat),
               "b_max": spec.b_max, "b_intra": b_intra, "b_cross": b_cross,
               "hosts": h, "chips": c,
               "bytes_per_hop": spec.bytes_per_hop(feat),
               "dcn_bytes_per_hop": spec.dcn_bytes_per_hop(feat),
               "dense_gather_bytes": spec.dense_gather_bytes(feat),
               "tiles": spec.bsr_tiles.tolist()}
        whole = gather_nodes(y, hier_mesh, both, spec=spec)
        if rank == 0:
            row["max_abs_err"] = float((whole - ref).abs().max())
            row["rel_err"] = _rel(whole, ref)
        if depth == 1:
            row["hier_exchange_ms"] = _ms(lambda: _hier_exchange(
                xs, plan["hier"], *groups, payload), device,
                config["iters"])
            row["flat_exchange_ms"] = _ms(lambda: _flat_exchange(
                xs, plan["send_idx"], flat_mesh.group("model"), payload),
                device, config["iters"])
            row["hier_khop_ms"] = _ms(lambda: halo_khop(
                spec, xs, hier_mesh, k=k, axis=both), device,
                config["iters"])
            row["flat_khop_ms"] = _ms(lambda: halo_khop(
                spec, xs, flat_mesh, k=k, axis="model"), device,
                config["iters"])
        out["case_s"].append(round(time.perf_counter() - t0, 2))
        if depth == 1 and payload == "float32":
            t0 = time.perf_counter()
            dist.barrier()
            if rank == 0:       # alone on the card while the others wait
                x2 = xs.movedim(-2, 0)
                out["k1"] = _k1_row(spec, plan, x2.reshape(x2.shape[0], -1),
                                    device, config["iters"])
            dist.barrier()
            out["k1_s"] = round(time.perf_counter() - t0, 2)
        out["cases"].append(row)
    return out


def multi_device_worker(rank, world, path, config):
    """Phase 23's 4-rank world (gloo ranks sharing the card as ``(host,
    chip)``): (1), (2) the two-level K-hop and its exchange
    (:func:`_hier_cases`); (3) ``obs/scaling.py::propagation_scaling`` on
    2 and 4 ranks; (4) the dry run (``exp/dryrun.py``). Returns the rank's
    rows, walls and peak memory (MiB)."""
    from sgp_tpu_torch.exp.dryrun import dryrun_rank
    from sgp_tpu_torch.obs.scaling import propagation_scaling
    device = torch.device(config["device"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    d = dict(np.load(path))
    out = {}
    t0 = time.perf_counter()
    out["halo"] = _hier_cases(rank, world, d, config, device)
    out["halo_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["scaling"] = [propagation_scaling(
        _graph(d), feat=config["scaling_feat"], k=config["k"], n_devices=n,
        mode="bsr", device=device, iters=config["iters"])
        for n in config["scaling_ranks"]]
    out["scaling_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_rank(rank, world, device)
    out["dryrun_s"] = time.perf_counter() - t0
    out["peak_mib"] = _peak_mib(device)
    return out
