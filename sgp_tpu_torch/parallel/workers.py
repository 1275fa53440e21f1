"""Rank functions for :func:`~sgp_tpu_torch.parallel.launch.run_ranks`.

Each takes ``(rank, world, path, config)``: the inputs as numpy arrays in
the ``.npz`` file ``path`` (the same on every rank), ``config`` a dict of
plain values whose ``device`` is the rank's card unless it names the CPU.
Each rank builds the mesh ``(world, 1)`` or ``(1, world)``,
cuts its slabs with ``shard_nodes``, runs the node-sharded function and
returns plain values; results that are node-sharded come back whole
(``gather_nodes``) from rank 0. The parity tests and ``chip_smoke.py``
share them: spawned processes import them from here.
"""
from __future__ import annotations

import numpy as np
import torch

from sgp_tpu_torch.graph.sparse import Graph
from sgp_tpu_torch.parallel.halo import (build_halo_spec, gather_nodes,
                                         halo_khop, shard_nodes)
from sgp_tpu_torch.parallel.mesh import make_mesh, rank_device


def _inputs(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _graph(d: dict) -> Graph:
    return Graph(d["src"], d["dst"], d["weight"], int(d["num_nodes"]))


def _device(config: dict) -> torch.device:
    """``config["device"]``: the rank's card unless it names the CPU."""
    return rank_device(config.get("device"))


def _axis_mesh(world: int, axis: str):
    return make_mesh(world, 1) if axis == "data" else make_mesh(1, world)


def halo_worker(rank, world, path, config):
    """``halo_khop`` for each of ``config["cases"]`` (the keyword arguments
    of ``build_halo_spec`` plus ``k``, ``concat`` and ``path``, another
    input file) on ``x``: rank 0 returns the whole result of each case, in
    natural order."""
    dev = _device(config)
    axis = config.get("axis", "model")
    mesh = _axis_mesh(world, axis)
    outs = []
    for case in config["cases"]:
        case = dict(case)
        d = _inputs(case.pop("path", path))
        k, concat = case.pop("k", 1), case.pop("concat", False)
        spec = build_halo_spec(_graph(d), world, **case)
        xs = shard_nodes(torch.as_tensor(d["x"], device=dev), mesh, axis,
                         spec=spec)
        y = halo_khop(spec, xs, mesh, k=k, axis=axis, concat=concat)
        outs.append(gather_nodes(y, mesh, axis, spec=spec).cpu().numpy())
    return outs if rank == 0 else None


def encode_worker(rank, world, path, config):
    """``encode_series_sharded`` of ``x_series`` over the graph with a
    ``Reservoir(**config["reservoir"])``; rank 0 returns the whole
    encoding ``[T, N, D]``."""
    from sgp_tpu_torch.encode import Reservoir
    from sgp_tpu_torch.parallel.encode import encode_series_sharded
    d = _inputs(path)
    dev = _device(config)
    mesh = _axis_mesh(world, "data")
    res = Reservoir(**config["reservoir"], device=dev)
    out = encode_series_sharded(res, torch.as_tensor(d["x_series"]),
                                _graph(d), mesh, axis="data",
                                **config.get("encode", {}))
    whole = gather_nodes(out, mesh, "data", node_axis=1,
                         num_nodes=int(d["num_nodes"]))
    return whole.cpu().numpy() if rank == 0 else None


def ridge_worker(rank, world, path, config):
    """``sharded_ridge_nodes`` on the node slabs of ``x``/``y`` for each
    of ``config["runs"]`` (``alpha``, ``fit_intercept``, ``mask``: use the
    file's mask): every rank returns its ``(W, b)`` of each."""
    from sgp_tpu_torch.parallel.encode import sharded_ridge_nodes
    d = _inputs(path)
    dev = _device(config)
    mesh = _axis_mesh(world, "data")

    def cut(a):
        return shard_nodes(torch.as_tensor(a, device=dev), mesh, "data",
                           node_axis=1)

    outs = []
    for run in config["runs"]:
        w, b = sharded_ridge_nodes(
            cut(d["x"]), cut(d["y"]), run["alpha"], mesh,
            mask=cut(d["mask"]) if run.get("mask") else None,
            fit_intercept=run.get("fit_intercept", True),
            n_nodes=d["x"].shape[1])
        outs.append((w.cpu().numpy(), b.cpu().numpy()))
    return outs


def _sgp_model(config: dict, dev):
    from sgp_tpu_torch.models import SGPModel
    model = SGPModel(**config["model"]).to(dev)
    state = torch.load(config["state"], map_location=dev)
    model.load_state_dict(state)
    return model


def _slabs(d: dict, mesh, dev, names):
    return [None if name not in d else shard_nodes(
        torch.as_tensor(d[name], device=dev), mesh, "data", node_axis=1)
        for name in names]


def _scaler(d: dict, dev):
    from sgp_tpu_torch.data.scalers import ScalerParams
    return ScalerParams(torch.as_tensor(d["bias"], device=dev),
                        torch.as_tensor(d["scale"], device=dev))


def step_worker(rank, world, path, config):
    """``make_sharded_iid_step`` from the weights in ``config["state"]``
    (Adam at ``config["lr"]``), stepped on the rank's draws ``t[rank,
    i]``/``n[rank, i]`` (local nodes) from the file, once for each of
    ``config["variants"]`` (overrides of ``packed``, ``dtype``: the
    encoding's type); returns, for each, every rank's losses and final
    weights (numpy, by name)."""
    from sgp_tpu_torch.parallel.sharding import make_sharded_iid_step
    d = _inputs(path)
    dev = _device(config)
    mesh = _axis_mesh(world, "data")
    enc, tgt, msk, u = _slabs(d, mesh, dev, ("encoded", "target", "mask",
                                             "u_node"))
    if "u" in d:
        u = torch.as_tensor(d["u"], device=dev)
    t = torch.as_tensor(d["t"], device=dev)
    n = torch.as_tensor(d["n"], device=dev)
    outs = []
    for variant in config.get("variants", [{}]):
        cfg = {**config, **variant}
        model = _sgp_model(cfg, dev)
        opt = torch.optim.Adam(model.parameters(), lr=cfg["lr"],
                               betas=(0.9, 0.999), eps=1e-8)
        step = make_sharded_iid_step(
            model, opt, enc.to(getattr(torch, cfg.get("dtype", "float32"))),
            tgt, msk, d["valid"], d["h_off"], _scaler(d, dev), mesh, u=u,
            batch_size=cfg["batch_size"], axis="data",
            packed=cfg.get("packed", False), grad_clip=cfg.get("grad_clip"),
            n_nodes=d["encoded"].shape[1])
        losses = [float(step.train_on(t[rank, i], n[rank, i]))
                  for i in range(t.shape[1])]
        outs.append((losses, {k: v.detach().cpu().numpy()
                              for k, v in model.state_dict().items()}))
    return outs


def eval_worker(rank, world, path, config):
    """``make_sharded_iid_eval`` with the weights in ``config["state"]``
    on the rank's slabs, once for each of ``config["variants"]``
    (``packed``: pack the slabs first, ``x_slice`` the encoding's width;
    ``unpack_targets``). Every rank returns its metrics of each."""
    from sgp_tpu_torch.parallel.sharding import make_sharded_iid_eval
    from sgp_tpu_torch.train import MaskedMetrics
    from sgp_tpu_torch.train.iid import pack_iid_data
    d = _inputs(path)
    dev = _device(config)
    mesh = _axis_mesh(world, "data")
    model = _sgp_model(config, dev)
    enc, tgt, msk = _slabs(d, mesh, dev, ("encoded", "target", "mask"))
    outs = []
    for variant in config.get("variants", [{}]):
        x, x_slice = enc, None
        unpack = variant.get("unpack_targets", False)
        if variant.get("packed"):
            x_slice = enc.shape[-1]
            x = pack_iid_data(enc.to(torch.bfloat16), tgt, msk, d["h_off"])
        ev = make_sharded_iid_eval(
            model, x, None if unpack else tgt, None if unpack else msk,
            d["items"], d["w_off"], d["h_off"], _scaler(d, dev),
            MaskedMetrics.forecasting(), mesh, axis="data",
            batch_size=config["batch_size"], x_slice=x_slice,
            unpack_targets=unpack, n_nodes=d["encoded"].shape[1])
        outs.append(ev())
    return outs


def mesh_worker(rank, world, path, config):
    """The ``(data, model)`` grid of ``config["shape"]``: each rank's
    coordinates and the sums of ``rank + 1`` over its data and its model
    axis (``all_reduce`` on each axis's group)."""
    from sgp_tpu_torch.parallel import collectives
    mesh = make_mesh(*config["shape"])
    sums = {}
    for axis in ("data", "model"):
        t = torch.tensor([float(rank + 1)])
        sums[axis] = float(collectives.all_reduce_(t, mesh.group(axis)))
    return dict(mesh.index), sums


def runner_worker(rank, world, argv, config=None):
    """``run_largescale_sgp`` from its command line ``argv`` on this rank
    of the group already joined; returns the results and the decoder's
    final weights (numpy, by name)."""
    from sgp_tpu_torch.exp import run_largescale_sgp as rls
    from sgp_tpu_torch.exp.common import Experiment
    kept = {}
    fit = rls._run_restartable_fit

    def keep_model(args, model, *rest):
        kept["model"] = model
        return fit(args, model, *rest)

    rls._run_restartable_fit = keep_model
    try:
        res = Experiment(rls.run_experiment,
                         rls.configure_parser_largescale()).run(argv)
    finally:
        rls._run_restartable_fit = fit
    return res, {k: v.detach().cpu().numpy()
                 for k, v in kept["model"].state_dict().items()}


def imported_modules(rank, world):
    """The top-level packages a rank process has imported."""
    import sys
    return sorted({name.split(".")[0] for name in sys.modules})
