"""One sharded pass of every multi-device path on tiny shapes.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: on a ``(data
N/2, model 2)`` mesh of N ranks (``model`` 1 for odd N), it runs

1. the node-sharded halo K-hop over ``model``, and the deep halo (one
   exchange for the k hops) held to it at 1e-5;
2. a decoder step with data parallelism over ``data`` and tensor
   parallelism over ``model`` (``shard_params_tp``, ``shard_batch``);
3. the node-sharded IID step, unpacked and packed, each rank holding only
   its slab;
4. the sharded stratified step;
5. the sharded eval;
6. the data-parallel window step on an ``(N, 1)`` mesh;

and, for N >= 4 and even, the two-level halo K-hop on a ``(host 2, chip
N/2)`` mesh, bit for bit the flat exchange in f32. Each section asserts a
finite result; rank 0 prints one line ending in ``OK``.

Usage::

    python -m sgp_tpu_torch.exp.dryrun 4 --device cpu    # 4 gloo ranks
    python -m sgp_tpu_torch.exp.dryrun 4 --device cuda:0  # sharing a card
    torchrun --nproc-per-node 4 -m sgp_tpu_torch.exp.dryrun \\
        --backend nccl                                     # a card a rank
"""
from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.graph import Graph, coalesce, normalize_adj
from sgp_tpu_torch.models import SGPModel
from sgp_tpu_torch.ops.spmm import build_operator
from sgp_tpu_torch.parallel.halo import (build_halo_spec, gather_nodes,
                                         halo_khop, shard_nodes)
from sgp_tpu_torch.parallel.mesh import (make_hier_mesh, make_mesh,
                                         rank_device)
from sgp_tpu_torch.parallel.sharding import (
    make_dp_tp_step, make_sharded_iid_eval, make_sharded_iid_step,
    make_sharded_iid_stratified_step, make_sharded_window_step,
    rank_generator, shard_batch, shard_params_tp)
from sgp_tpu_torch.train.metrics import MaskedMetrics

N_NODES, FEAT, K, T_STEPS, HORIZON = 16, 8, 2, 12, 4


def _finite(name: str, value) -> float:
    value = float(value)
    assert math.isfinite(value), (name, value)
    return value


def _adam(model):
    return torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8)


def _model(input_size: int, order: int, hidden: int, mlp: int, seed: int,
           device):
    return SGPModel(input_size=input_size, order=order, n_nodes=N_NODES,
                    hidden_size=hidden, mlp_size=mlp, output_size=1,
                    n_layers=1, horizon=HORIZON, positional_encoding=True,
                    generator=torch.Generator().manual_seed(seed)
                    ).to(device)


def _halo(g, mesh, m: int, x_series, device):
    """(1): the encoding ``[T, N, (k+1)F]`` (whole) and the plan."""
    spec = build_halo_spec(g, m)
    xs = shard_nodes(x_series, mesh, "model", node_axis=1, spec=spec)
    enc = halo_khop(spec, xs, mesh, k=K, axis="model", concat=True)
    deep = build_halo_spec(g, m, depth=K)
    enc_deep = halo_khop(deep, shard_nodes(x_series, mesh, "model",
                                           node_axis=1, spec=deep),
                         mesh, k=K, axis="model", concat=True)
    torch.testing.assert_close(enc_deep, enc, rtol=0, atol=1e-5)
    return gather_nodes(enc, mesh, "model", node_axis=1, spec=spec), spec


def _hier(g, world: int, x_series, device) -> bool:
    """The two-level K-hop on ``(host 2, chip world/2)`` against the flat
    exchange over every rank, bit for bit in f32."""
    hier = make_hier_mesh(2, world // 2)
    flat = make_mesh(1, world)
    spec = build_halo_spec(g, world, chips_per_host=world // 2)
    outs = []
    for mesh, axis in ((hier, ("host", "chip")), (flat, "model")):
        xs = shard_nodes(x_series, mesh, axis, node_axis=1, spec=spec)
        outs.append(halo_khop(spec, xs, mesh, k=K, axis=axis, concat=True))
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1]), "two-level != flat exchange"
    return True


def dryrun_rank(rank: int, world: int, device=None) -> str:
    """The dry run on this rank of a process group of ``world`` ranks
    (:func:`~sgp_tpu_torch.parallel.launch.run_ranks`' signature); returns
    the summary line (every rank builds it; rank 0's is printed)."""
    device = rank_device(device)
    m = 2 if world % 2 == 0 else 1
    n_data = world // m
    mesh = make_mesh(n_data, m)
    rng = np.random.default_rng(0)
    g = normalize_adj(coalesce(Graph(
        rng.integers(0, N_NODES, 64), rng.integers(0, N_NODES, 64),
        rng.random(64).astype(np.float32), N_NODES)), "row")
    x_series = torch.as_tensor(rng.standard_normal(
        (T_STEPS, N_NODES, FEAT)).astype(np.float32), device=device)

    # (1) halo K-hop over 'model', deep halo held to it
    encoded, spec = _halo(g, mesh, m, x_series, device)
    width = encoded.shape[-1]

    # (2) DP over 'data' + TP over 'model'
    model = shard_params_tp(_model(width, K + 1, 32 * m, 16 * m, 0, device),
                            mesh)
    bs = max(2 * n_data, 4)
    batch = shard_batch({
        "x": encoded[:bs],
        "y": torch.as_tensor(rng.standard_normal(
            (bs, HORIZON, N_NODES, 1)).astype(np.float32), device=device),
        "mask": torch.ones(bs, HORIZON, N_NODES, 1, dtype=torch.bool,
                           device=device)}, mesh)
    loss = _finite("loss", make_dp_tp_step(model, _adam(model), mesh,
                                           grad_clip=5.0)(batch))

    # (3) node-sharded IID step over 'data', unpacked and packed
    target = torch.as_tensor(rng.standard_normal(
        (T_STEPS, N_NODES, 1)).astype(np.float32), device=device)
    maskf = torch.ones(T_STEPS, N_NODES, 1, dtype=torch.bool, device=device)
    valid = np.arange(T_STEPS - 5)
    h_off = 1 + np.arange(HORIZON)
    scaler = ScalerParams(torch.zeros(1, device=device),
                          torch.ones(1, device=device))

    def cut(a):
        return shard_nodes(a, mesh, "data", node_axis=1)

    enc_s, tgt_s, mask_s = cut(encoded), cut(target), cut(maskf)
    n_pad = -(-N_NODES // n_data) * n_data
    gen = rank_generator(2, mesh.index["data"], device)
    iid_model = _model(width, K + 1, 32 * m, 16 * m, 1, device)
    step = make_sharded_iid_step(
        iid_model, _adam(iid_model), enc_s, tgt_s, mask_s, valid, h_off,
        scaler, mesh, batch_size=8 * n_data, steps_per_call=2,
        n_nodes=N_NODES)
    assert step.data[0].shape[1] * n_data == n_pad, \
        "encoded must be node-sharded, not replicated"
    iid_loss = _finite("iid_loss", step(gen))
    step_pk = make_sharded_iid_step(
        iid_model, _adam(iid_model), enc_s.to(torch.bfloat16), tgt_s,
        mask_s, valid, h_off, scaler, mesh, batch_size=8 * n_data,
        steps_per_call=2, packed=True, n_nodes=N_NODES)
    big = step_pk.data[0]
    assert big.shape[-1] == width + 3 * HORIZON * 1, big.shape
    assert big.shape[1] * n_data == n_pad, "packed rows must stay sharded"
    pk_loss = _finite("packed_iid_loss", step_pk(gen))

    # (4) sharded stratified step on a dense support
    sm = _model(FEAT * 3, 3, 16, 8, 3, device)
    h = torch.as_tensor(rng.standard_normal(
        (T_STEPS, N_NODES, FEAT)).astype(np.float32), device=device)
    strat = make_sharded_iid_stratified_step(
        sm, _adam(sm), cut(h), tgt_s, mask_s, valid, h_off, scaler,
        [build_operator(g, "dense", device=device)], mesh,
        global_attr=True, times_per_batch=2, nodes_per_time=2 * n_data,
        steps_per_call=2, seed=4, n_nodes=N_NODES)
    st_loss = _finite("stratified_loss", strat(
        torch.Generator(device=device).manual_seed(4)))

    # (5) node-sharded eval
    ev = make_sharded_iid_eval(
        iid_model, enc_s, tgt_s, mask_s, valid, np.array([0]), h_off,
        scaler, MaskedMetrics.forecasting(), mesh, batch_size=4,
        n_nodes=N_NODES)()
    for k, v in ev.items():
        _finite(f"eval {k}", v)

    # (6) data-parallel window step over every rank
    dp_mesh = make_mesh(world, 1)
    wmodel = _model(FEAT, 1, 16, 8, 5, device)
    wstep = make_sharded_window_step(
        wmodel, _adam(wmodel), x_series, target, maskf, valid,
        np.arange(1), h_off, scaler, dp_mesh, batch_size=2 * world,
        steps_per_call=2)
    w_loss = _finite("dp_window_loss", wstep(rank_generator(6, rank,
                                                            device)))

    hier = world >= 4 and world % 2 == 0 and _hier(g, world, x_series,
                                                   device)
    shape = {"data": n_data, "model": m}
    return (f"dryrun_multichip({world}): mesh {shape} loss={loss:.4f} "
            f"iid_loss={iid_loss:.4f} packed_iid_loss={pk_loss:.4f} "
            f"stratified_loss={st_loss:.4f} "
            f"sharded_eval_mae={ev['mae']:.4f} "
            f"dp_window_loss={w_loss:.4f} halo_b_max={spec.b_max} "
            f"deep_halo_ok=True hier_halo_ok={hier} OK")


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n_ranks", type=int, nargs="?", default=None,
                        help="ranks to start (omit inside torchrun)")
    parser.add_argument("--device", default=None,
                        help="the ranks' device (default: the card)")
    parser.add_argument("--backend", default="gloo",
                        choices=("gloo", "nccl"))
    args = parser.parse_args(argv)
    if args.n_ranks is None and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist
        from sgp_tpu_torch.parallel.mesh import init_distributed
        device = rank_device(args.device) if args.device != "cpu" \
            else torch.device("cpu")
        world = init_distributed(args.backend, device=device)
        try:
            line = dryrun_rank(dist.get_rank(), world, args.device)
        finally:
            dist.destroy_process_group()
        rank = int(os.environ.get("RANK", 0))
    else:
        # by its module's name, which the spawned ranks import
        from sgp_tpu_torch.exp.dryrun import dryrun_rank as fn
        from sgp_tpu_torch.parallel.launch import run_ranks
        device = args.device or "cuda:0"
        line = run_ranks(fn, args.n_ranks or 1, args.backend, device,
                         device)[0]
        rank = 0
    if rank == 0:
        print(line, flush=True)
    return line


if __name__ == "__main__":
    main()
