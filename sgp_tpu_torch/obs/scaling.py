"""Multi-device scaling: the halo exchange's ledger, a projection of
node-sharded K-hop propagation over many cards, and the measured
propagation rate of one card against several ranks.

Counterpart of ``sgp_tpu/obs/scaling.py``, with the same formulas. The
projection prices the links by arguments whose defaults are an HGX H100
machine's, each with its source below; latencies no card has measured are
assumptions. The rows keep the JAX module's keys: ``dcn_bytes_per_hop``
is what a card sends across hosts, ``b_cross_host`` the cross-host
boundary.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from sgp_tpu_torch.graph.sparse import Graph, permute_nodes, rcm_order
from sgp_tpu_torch.ops.spmm import build_operator
from sgp_tpu_torch.parallel import collectives
from sgp_tpu_torch.parallel.halo import (build_halo_spec, halo_khop,
                                         shard_nodes)
from sgp_tpu_torch.parallel.mesh import make_mesh, rank_device
from sgp_tpu_torch.parallel.sharding import allgather_khop, shard_operator

# NVLink 4 between the 8 GPUs of an HGX H100 board: 18 links, 900 GB/s a
# GPU in both directions together (NVIDIA H100 data sheet), 450 GB/s each
# way
NVLINK_BYTES_PER_S = 450e9
# NDR InfiniBand between hosts: one 400 Gb/s ConnectX-7 port a GPU (NVIDIA
# DGX H100 user guide), 50 GB/s each way
IB_BYTES_PER_S = 50e9
# one collective's fixed cost: assumptions, not measured on a card
NVLINK_LATENCY_S = 10e-6
IB_LATENCY_S = 25e-6
# GPUs a host (HGX H100 8-GPU)
GPUS_PER_HOST = 8


def host_boundary_ledger(g: Graph, n_shards: int,
                         chips_per_host: int = GPUS_PER_HOST,
                         order="natural") -> Dict[str, int]:
    """Boundary sizes of the two-level halo exchange for ``n_shards``
    contiguous shards, ``chips_per_host`` a host: ``b_intra`` the most rows
    a shard needs from a peer on its own host, ``b_cross`` the most rows a
    (source shard, remote host) pair ships (the union over the host's
    shards: a row crosses once for each host that needs it), ``hosts``."""
    if isinstance(order, np.ndarray):
        g = permute_nodes(g, order)
    elif order == "rcm":
        g = permute_nodes(g, rcm_order(g))
    n, s = g.num_nodes, n_shards
    nl = -(-n // s)
    csr = g.to_scipy().tocsr()
    hosts = -(-s // chips_per_host)
    b_intra = 0
    need_by_pair: Dict[tuple, set] = {}
    for i in range(s):
        rows = csr[i * nl:min((i + 1) * nl, n)].tocsc()
        hi = i // chips_per_host
        for j in range(s):
            if j == i:
                continue
            block = rows[:, j * nl:min((j + 1) * nl, n)].tocoo()
            nz = np.unique(block.col[block.data != 0])
            if j // chips_per_host == hi:
                b_intra = max(b_intra, len(nz))
            else:
                need_by_pair.setdefault((j, hi), set()).update(nz.tolist())
    b_cross = max((len(v) for v in need_by_pair.values()), default=0)
    return {"b_intra": int(b_intra), "b_cross": int(b_cross),
            "hosts": hosts}


def project_scaling(g: Graph, feat: int, single_chip_edges_per_s: float,
                    n_chips_list=(1, 8, 32), k: int = 1,
                    itemsize: int = None, order="rcm",
                    payload_dtype: str = "bfloat16",
                    hierarchical: bool = True, depth: int = 1,
                    chips_per_host: int = GPUS_PER_HOST,
                    intra_bytes_per_s: float = NVLINK_BYTES_PER_S,
                    cross_bytes_per_s: float = IB_BYTES_PER_S,
                    intra_latency_s: float = NVLINK_LATENCY_S,
                    cross_latency_s: float = IB_LATENCY_S
                    ) -> Dict[str, dict]:
    """edges/s and efficiency of node-sharded K-hop propagation at each
    card count, from the halo plan's bytes and a measured single-card rate.

    A hop on a card computes ``(E/S) / rate`` and exchanges its send
    buffer: within a host over the intra-host link; across hosts, with
    ``hierarchical`` and whole hosts, the two-level plan (each boundary
    row across once for each needing host, padded to ``b_cross``, then
    spread over the intra-host link), else the flat ``all_to_all``'s ``S *
    b_max`` rows over the cross-host link. With overlap a hop costs
    max(compute, exchange), without their sum; efficiency is the ideal
    time over ``S`` times the hop's. ``depth=d`` exchanges once every d
    hops, the other d - 1 advancing the halo rows in the buffer
    (``ext_edges_max`` more edges a hop); bytes are amortized over d. Each
    row also carries the f32 flat ledger of the depth-1 boundary."""
    edges = g.num_edges * k
    t_single = edges / single_chip_edges_per_s
    out = {}
    for s in n_chips_list:
        if s == 1:
            out["1"] = {"edges_per_s": single_chip_edges_per_s,
                        "efficiency": 1.0, "comm_bytes_per_hop": 0}
            continue
        crosses_hosts = s > chips_per_host
        # the two-level plan needs whole hosts; others take the flat one
        use_hier = (crosses_hosts and hierarchical
                    and s % chips_per_host == 0)
        spec = build_halo_spec(
            g, s, order=order, payload_dtype=payload_dtype, depth=depth,
            mode="coo", chips_per_host=chips_per_host if use_hier else None)
        per_row = (feat * spec.payload_itemsize()
                   + (4 if payload_dtype == "int8" else 0)) \
            if itemsize is None else feat * itemsize
        flat_bytes = s * spec.b_max * per_row
        naive_bytes = s * spec.b_max_hop1 * feat * 4
        t_comp = (g.num_edges / s) / single_chip_edges_per_s
        t_ext = spec.ext_edges_max() / single_chip_edges_per_s
        if not crosses_hosts:
            comm_bytes = flat_bytes
            t_comm = comm_bytes / intra_bytes_per_s + intra_latency_s
        elif use_hier:
            _, _, _, c, hosts, b_intra, b_cross = spec.hier
            cross_bytes = (hosts - 1) * b_cross * per_row
            # the intra-host all_to_all and the spread of the cross rows
            intra_bytes = (c - 1) * b_intra * per_row \
                + (c - 1) * (hosts - 1) * b_cross * per_row
            comm_bytes = cross_bytes + intra_bytes
            t_comm = (cross_bytes / cross_bytes_per_s + cross_latency_s
                      + intra_bytes / intra_bytes_per_s + intra_latency_s)
        else:
            comm_bytes = flat_bytes
            t_comm = comm_bytes / cross_bytes_per_s + cross_latency_s
        d = max(1, depth)
        t_hop_overlap = (max(t_comp, t_comm)
                         + (d - 1) * (t_comp + t_ext)) / d
        t_hop_serial = (t_comp + t_comm + (d - 1) * (t_comp + t_ext)) / d
        row = {
            "edges_per_s": g.num_edges * k / (k * t_hop_overlap),
            "edges_per_s_no_overlap": g.num_edges * k / (k * t_hop_serial),
            "efficiency": (t_single / k) / (s * t_hop_overlap),
            "efficiency_no_overlap": (t_single / k) / (s * t_hop_serial),
            "comm_bytes_per_hop": int(comm_bytes / d),
            "comm_bytes_per_hop_naive_f32_flat": int(naive_bytes),
            "comm_bound": bool(t_comm > d * t_comp + (d - 1) * t_ext),
            "boundary_b_max": spec.b_max,
            "depth": d,
        }
        if use_hier:
            row["dcn_bytes_per_hop"] = int(cross_bytes / d)
            row["b_cross_host"] = int(b_cross)
        out[str(s)] = row
    return out


def _seconds(fn, device, iters: int) -> float:
    """Seconds a call of ``fn`` after one warm call."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters


def _slowest(seconds: float, group, device) -> float:
    """The largest of every rank's ``seconds``."""
    t = torch.tensor([seconds], dtype=torch.float64, device=device)
    return float(collectives.all_gather(t, group).max())


def propagation_scaling(g: Graph, feat: int = 128, k: int = 2,
                        n_devices: int = None, mode: str = "dense",
                        device=None, iters: int = 20) -> Dict[str, float]:
    """edges/s of k hops of propagation on one device and node-sharded over
    ``n_devices`` ranks (default: the process group's), with the
    exchange's ledger. Every rank of the group calls it; each returns the
    same dict. The ranks form a ``(world / n_devices, n_devices)`` mesh,
    each row of ``n_devices`` ranks propagating over its ``"model"``
    group. Routes: ``single`` (rank 0 alone, ``build_operator(g, mode)``:
    ``"dense"`` or ``"bsr"``, K1 on the card), ``halo`` (:func:`halo_khop`,
    K1 under each rank's block for ``"bsr"``) and ``allgather`` (the dense
    operator's row blocks, the whole activation all-gathered between hops:
    ``parallel/sharding.py::allgather_khop``); a route's time is its
    slowest rank's. ``halo_bytes_per_hop_per_device`` is the plan's
    ``bytes_per_hop``, ``allgather_bytes_per_hop_per_device`` its
    ``dense_gather_bytes``."""
    import torch.distributed as dist
    device = rank_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_devices = n_devices or world
    mesh = make_mesh(world // n_devices, n_devices)
    group = mesh.world_group()
    rank = dist.get_rank() if dist.is_initialized() else 0
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (g.num_nodes, feat)).astype(np.float32), device=device)
    dense = build_operator(g, "dense", precision="default", device=device)
    op = dense if mode == "dense" else build_operator(g, mode, device=device)

    def khop_single():
        cur = x
        for _ in range(k):
            cur = op @ cur
        return cur

    t_single = _seconds(khop_single, device, iters) if rank == 0 else 0.0
    t_single = _slowest(t_single, group, device)
    spec = build_halo_spec(g, mesh.size("model"),
                           mode="bsr" if mode == "bsr" else "auto")
    xs = shard_nodes(x, mesh, "model", spec=spec)
    if group is not None:
        dist.barrier()
    t_halo = _slowest(_seconds(lambda: halo_khop(
        spec, xs, mesh, k=k, axis="model"), device, iters), group, device)
    op_s = shard_operator(dense, mesh)
    if group is not None:
        dist.barrier()
    t_allgather = _slowest(_seconds(lambda: allgather_khop(
        op_s, x, mesh, k=k), device, iters), group, device)
    edges = g.num_edges * k
    return {
        "n_devices": mesh.size("model"),
        "mode": mode,
        "edges_per_s_single": edges / t_single,
        "edges_per_s_halo": edges / t_halo,
        "edges_per_s_allgather": edges / t_allgather,
        "halo_over_single": t_single / t_halo,
        "halo_bytes_per_hop_per_device": spec.bytes_per_hop(feat),
        "allgather_bytes_per_hop_per_device": spec.dense_gather_bytes(feat),
        "halo_comm_fraction": spec.bytes_per_hop(feat)
        / max(spec.dense_gather_bytes(feat), 1),
        "boundary_b_max": spec.b_max,
    }
