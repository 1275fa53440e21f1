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
from sgp_tpu_torch.parallel.mesh import (make_hier_mesh, make_mesh,
                                         rank_device)


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


def hier_worker(rank, world, path, config):
    """``halo_khop`` on the ``(host, chip)`` grid of ``config["hosts"]``
    hosts (``world / hosts`` chips each) for each of ``config["cases"]``
    (``build_halo_spec``'s keywords, ``chips_per_host`` set from the grid,
    and ``k``, ``concat``, ``path``), then the same plan's flat exchange
    over every rank: rank 0 returns, for each case, both whole results in
    natural order."""
    dev = _device(config)
    hosts = config["hosts"]
    meshes = ((make_hier_mesh(hosts, world // hosts), ("host", "chip")),
              (make_mesh(1, world), "model"))
    outs = []
    for case in config["cases"]:
        case = dict(case)
        d = _inputs(case.pop("path", path))
        k, concat = case.pop("k", 1), case.pop("concat", False)
        spec = build_halo_spec(_graph(d), world,
                               chips_per_host=world // hosts, **case)
        x = torch.as_tensor(d["x"], device=dev)
        got = []
        for mesh, axis in meshes:
            y = halo_khop(spec, shard_nodes(x, mesh, axis, spec=spec), mesh,
                          k=k, axis=axis, concat=concat)
            got.append(gather_nodes(y, mesh, axis, spec=spec).cpu().numpy())
        outs.append(got)
    return outs if rank == 0 else None


def encode_worker(rank, world, path, config):
    """``encode_series_sharded`` of ``x_series`` over the graph with a
    ``Reservoir(**config["reservoir"])`` (on the ``(host, chip)`` grid of
    ``config["hosts"]`` hosts with ``chips_per_host`` when given); rank 0
    returns the whole encoding ``[T, N, D]``."""
    from sgp_tpu_torch.encode import Reservoir
    from sgp_tpu_torch.parallel.encode import encode_series_sharded
    d = _inputs(path)
    dev = _device(config)
    axis, mesh, kw = "data", _axis_mesh(world, "data"), {}
    if "hosts" in config:
        axis = ("host", "chip")
        mesh = make_hier_mesh(config["hosts"], world // config["hosts"])
        kw = {"chips_per_host": world // config["hosts"]}
    res = Reservoir(**config["reservoir"], device=dev)
    out = encode_series_sharded(res, torch.as_tensor(d["x_series"]),
                                _graph(d), mesh, axis=axis,
                                **config.get("encode", {}), **kw)
    whole = gather_nodes(out, mesh, axis, node_axis=1,
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
    ``unpack_targets``; ``supports``: ``_eval_supports``). Every rank
    returns its metrics of each."""
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
            unpack_targets=unpack, n_nodes=d["encoded"].shape[1],
            support_ops=_eval_supports(d, variant, dev))
        outs.append(ev())
    return outs


def _eval_supports(d: dict, variant: dict, dev):
    """An eval variant's ``support_ops``: ``build_support_operators`` of
    the file's graph at ``variant["supports"]``'s keywords (``global_attr``
    there adds the global mean last, as the stratified runner does);
    None without them."""
    if "supports" not in variant:
        return None
    from sgp_tpu_torch.data.sgp_loader import build_support_operators
    from sgp_tpu_torch.ops import GlobalMeanOperator
    kw = dict(variant["supports"])
    mean = kw.pop("global_attr", False)
    ops = build_support_operators(_graph(d), device=dev, **kw)
    return ops + ([GlobalMeanOperator(int(d["num_nodes"]))] if mean else [])


def stratified_worker(rank, world, path, config):
    """``make_sharded_iid_stratified_step`` from the weights in
    ``config["state"]`` (Adam at ``config["lr"]``) on the rank's slabs of
    ``h``, ``target``, ``mask`` (and ``u_node``, or the global ``u``) with
    the supports ``build_support_operators(graph, k=config["k"],
    operator_mode=config["mode"])``, stepped on the file's draws ``t[i]``
    (shared) and ``n[rank, i]`` (local rows); returns the losses, the
    final weights and the last step's clipped gradients (numpy, by
    name)."""
    from sgp_tpu_torch.data.sgp_loader import build_support_operators
    from sgp_tpu_torch.parallel.sharding import \
        make_sharded_iid_stratified_step
    d = _inputs(path)
    dev = _device(config)
    mesh = _axis_mesh(world, "data")
    h, tgt, msk, u = _slabs(d, mesh, dev, ("h", "target", "mask", "u_node"))
    if "u" in d:
        u = torch.as_tensor(d["u"], device=dev)
    ops = build_support_operators(_graph(d), k=config["k"],
                                  operator_mode=config["mode"], device=dev)
    model = _sgp_model(config, dev)
    opt = torch.optim.Adam(model.parameters(), lr=config["lr"],
                           betas=(0.9, 0.999), eps=1e-8)
    t = torch.as_tensor(d["t"], device=dev)
    n = torch.as_tensor(d["n"], device=dev)
    step = make_sharded_iid_stratified_step(
        model, opt, h, tgt, msk, d["valid"], d["h_off"], _scaler(d, dev),
        ops, mesh, global_attr=config["global_attr"], u=u,
        times_per_batch=t.shape[1], nodes_per_time=n.shape[-1] * world,
        grad_clip=config.get("grad_clip"), n_nodes=d["h"].shape[1])
    losses = [float(step.train_on(t[i], n[rank, i]))
              for i in range(t.shape[0])]
    return losses, _weights(model), {
        k: p.grad.cpu().numpy() for k, p in model.named_parameters()}


def window_worker(rank, world, path, config):
    """``make_sharded_window_step`` from the weights in ``config["state"]``
    (Adam at ``config["lr"]``, the clip at ``config["grad_clip"]``) on the
    whole series ``x``/``target``/``mask``/``u`` with the supports of
    ``config["supports"]`` (``build_support_operators``'s keywords; none
    without it), stepped on the rank's window starts ``items[rank, i]``;
    returns the losses and the final weights."""
    from sgp_tpu_torch.data.sgp_loader import build_support_operators
    from sgp_tpu_torch.parallel.sharding import make_sharded_window_step
    d = _inputs(path)
    dev = _device(config)
    mesh = _axis_mesh(world, "data")
    x, tgt, msk, u = (torch.as_tensor(d[k], device=dev)
                      for k in ("x", "target", "mask", "u"))
    ops = None if "supports" not in config else build_support_operators(
        _graph(d), device=dev, **config["supports"])
    model = _sgp_model(config, dev)
    opt = torch.optim.Adam(model.parameters(), lr=config["lr"],
                           betas=(0.9, 0.999), eps=1e-8)
    items = torch.as_tensor(d["items"], device=dev)
    step = make_sharded_window_step(
        model, opt, x, tgt, msk, d["starts"], d["w_off"], d["h_off"],
        _scaler(d, dev), mesh, u=u, support_ops=ops,
        batch_size=items.shape[-1] * world, grad_clip=config["grad_clip"])
    losses = [float(step.train_on(items[rank, i]))
              for i in range(items.shape[1])]
    return losses, _weights(model)


def _weights(model) -> dict:
    return {k: v.detach().cpu().numpy()
            for k, v in model.state_dict().items()}


def _carry_init(params_path):
    """A ``Predictor.init`` that carries the pickled flax tree in
    ``params_path`` into the model after drawing its own weights (None:
    ``Predictor.init`` itself)."""
    import pickle
    from sgp_tpu_torch.models import flax_to_torch
    from sgp_tpu_torch.train.predictor import Predictor
    init = Predictor.init
    if params_path is None:
        return init
    with open(params_path, "rb") as fp:
        params = pickle.load(fp)

    def carry(self, *args, **kwargs):
        out = init(self, *args, **kwargs)
        flax_to_torch(params, self.model)
        return out
    return carry


def _dp_case(case: dict, d: dict, dev):
    """``(model, to_call, static, train loader, eval loader, scaler)`` of a
    ``predictor_worker`` case: ``rnn`` (``RNNModel`` on windows of the
    file's ``series``; ``items`` train and evaluate) or ``gwnet``
    (``GraphWaveNetModel`` on the file's graph with its diffusion
    supports, weights from ``case["seed"]``)."""
    from sgp_tpu_torch.data import (SpatioTemporalDataset, StandardScaler,
                                    WindowedLoader, Windowing)
    from sgp_tpu_torch.models import (GraphWaveNetModel, RNNModel,
                                      diff_conv_support)
    graph = _graph(d) if case["model"] == "gwnet" else None
    ds = SpatioTemporalDataset(d["series"], graph=graph,
                               windowing=Windowing(**case["windowing"]))
    ds.fit_scaler(StandardScaler(axis=(0, 1)))
    train = WindowedLoader(ds, d["items"], batch_size=case["batch_size"],
                           shuffle=True, seed=case.get("loader_seed", 0))
    evaluate = WindowedLoader(ds, d["items"], batch_size=case["batch_size"])
    horizon = ds.windowing.horizon_steps
    if case["model"] == "rnn":
        return (RNNModel(ds.n_channels, output_size=ds.n_channels,
                         horizon=horizon, **case["kw"]), None, None, train,
                evaluate, ds.scaler_params(device=dev))
    model = GraphWaveNetModel(
        ds.n_channels, output_size=ds.n_channels, horizon=horizon,
        n_nodes=ds.n_nodes, **case["kw"],
        generator=torch.Generator().manual_seed(case["seed"]))

    def call(batch, training):
        return (batch["x"], batch["supports"]), {
            "training": training, "node_index": batch.get("node_index")}
    return (model, call, {"supports": diff_conv_support(graph, device=dev)},
            train, evaluate, ds.scaler_params(device=dev))


def predictor_worker(rank, world, path, config):
    """``Predictor(mesh=)`` over the ranks (``config["mesh"]`` False: no
    mesh, one process) for each of ``config["cases"]`` (``_dp_case``; the
    pickled flax tree ``init`` carried in; ``lr``, ``epochs``;
    ``local_stats`` leaves the batch norm's statistics rank-local
    (``sync_batch_stats=False``), to show they must not be; ``bad_batch`` a loader batch size the ranks do
    not divide): ``fit`` on the train loader, ``evaluate`` on the eval
    loader. Returns, for each, the metrics and the final weights, or the
    error ``fit`` raised."""
    from sgp_tpu_torch.train.predictor import Predictor
    d = _inputs(path)
    dev = _device(config)
    mesh = _axis_mesh(world, "data") if config.get("mesh", True) else None
    outs = []
    for case in config["cases"]:
        model, call, static, train, evaluate, scaler = _dp_case(case, d,
                                                                dev)
        if "bad_batch" in case:
            train.batch_size = case["bad_batch"]
        pred = Predictor(model, lr=case["lr"], seed=0, mesh=mesh,
                         sync_batch_stats=not case.get("local_stats"),
                         batch_to_call=call, static_batch=static,
                         device=dev)
        init = Predictor.init
        Predictor.init = _carry_init(case.get("init"))
        try:
            pred.fit(train, epochs=case["epochs"], scaler=scaler)
            outs.append((pred.evaluate(evaluate), _weights(pred.model)))
        except ValueError as e:
            outs.append(str(e))
        finally:
            Predictor.init = init
    return outs


def scaling_worker(rank, world, path, config):
    """``obs/scaling.py::propagation_scaling`` of the file's graph at
    ``config``'s ``feat``, ``k``, ``mode`` and ``iters``, over each of
    ``config["n_devices"]``; every rank returns its dicts."""
    from sgp_tpu_torch.obs.scaling import propagation_scaling
    g = _graph(_inputs(path))
    return [propagation_scaling(g, feat=config["feat"], k=config["k"],
                                n_devices=n, mode=config.get("mode",
                                                             "dense"),
                                device=_device(config),
                                iters=config.get("iters", 2))
            for n in config["n_devices"]]


def placement_worker(rank, world, path, config):
    """``parallel/sharding.py``'s placements on the ``(data, model)`` grid
    ``config["shape"]``: the all-gather K-hop of the file's graph on ``x``
    (``shard_operator``, ``sharded_spmm``; ``k`` hops over ``model``,
    whole from ``gather_nodes``), this rank's ``shard_batch`` slice of
    ``batch``, ``replicate`` of a tensor that differs by rank, and
    ``sharded_ridge`` of ``x_r``/``y_r`` cut over ``data``."""
    from sgp_tpu_torch.ops.spmm import build_operator
    from sgp_tpu_torch.parallel.sharding import (allgather_khop, replicate,
                                                 shard_batch,
                                                 shard_operator,
                                                 sharded_ridge)
    d = _inputs(path)
    dev = _device(config)
    mesh = make_mesh(*config["shape"])
    op_s = shard_operator(build_operator(_graph(d), "dense", device=dev),
                          mesh, "model")
    rows = allgather_khop(op_s, torch.as_tensor(d["x"], device=dev), mesh,
                          k=config["k"], axis="model")
    hops = gather_nodes(rows, mesh, "model",
                        num_nodes=int(d["num_nodes"])).cpu().numpy()
    part = shard_batch({"b": torch.as_tensor(d["batch"], device=dev)},
                       mesh, "data")["b"].cpu().numpy()
    rep = replicate({"t": [torch.full((3,), float(rank), device=dev)]},
                    mesh)["t"][0].cpu().numpy()
    rid = sharded_ridge(*shard_batch(
        {"x": torch.as_tensor(d["x_r"], device=dev),
         "y": torch.as_tensor(d["y_r"], device=dev)}, mesh, "data").values(),
        config["alpha"], mesh).cpu().numpy()
    return {"hops": hops, "batch": part, "replicate": rep, "ridge": rid,
            "op_rows": op_s.mat.shape[0]}


def tp_worker(rank, world, path, config):
    """One step of :func:`~sgp_tpu_torch.parallel.sharding.
    make_dp_tp_step` on the ``(world / m, m)`` grid (``m =
    config["model_axis"]``): ``SGPModel(**config["model"])`` with the
    pickled flax tree ``config["params"]`` carried in and its large
    linears split over ``model`` (``flax_to_tp``), Adam at ``config["lr"]``
    with the clip at ``config["clip"]``, on this rank's ``shard_batch``
    slice of the file's ``x``, ``y``, ``mask``. Returns the loss, the whole
    updated weights and the whole clipped gradients (``gather_params_tp``),
    this rank's own weights and the names of the split layers."""
    import pickle
    from sgp_tpu_torch.models import SGPModel
    from sgp_tpu_torch.parallel.sharding import (ColumnParallelLinear,
                                                 flax_to_tp,
                                                 gather_params_tp,
                                                 make_dp_tp_step,
                                                 shard_batch)
    d = _inputs(path)
    dev = _device(config)
    m = config["model_axis"]
    mesh = make_mesh(world // m, m)
    with open(config["params"], "rb") as fp:
        params = pickle.load(fp)
    model = flax_to_tp(params, SGPModel(**config["model"]).to(dev), mesh)
    opt = torch.optim.Adam(model.parameters(), lr=config["lr"],
                           betas=(0.9, 0.999), eps=1e-8)
    step = make_dp_tp_step(model, opt, mesh, grad_clip=config["clip"])
    batch = shard_batch({k: torch.as_tensor(d[k], device=dev)
                         for k in ("x", "y", "mask")}, mesh)
    loss = float(step(batch))
    whole, grads = ({k: v.cpu().numpy() for k, v in gather_params_tp(
        model, mesh, grads=g).items()} for g in (False, True))
    split = sorted(name for name, mod in model.named_modules()
                   if isinstance(mod, ColumnParallelLinear))
    return loss, whole, grads, _weights(model), split


def jobs_worker(rank, world, jobs):
    """Several of this module's rank functions in one world (one spawn):
    ``jobs`` a list of ``(function name, *arguments)``; returns their
    results in order."""
    return [globals()[name](rank, world, *args) for name, *args in jobs]


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
    of the group already joined, or the runner ``config["runner"]``
    (``"traffic_sgp"``, ``"traffic_baselines"``, ``"largescale_baselines"``;
    the pickled flax tree ``config["init"]`` carried into
    ``Predictor.init``; the run directories under ``config["logs_dir"]``);
    returns the results and the model's final weights (numpy, by name).
    ``config["skew_val_rank"]``: on that rank the fused validation MAE of
    ``run_traffic_sgp`` falls every epoch whatever the weights, and the
    runner's "early stop" log lines are returned third. ``config["env"]``:
    environment variables set in the rank first (``SGP_TPU_FAULT``)."""
    import importlib
    import logging
    import os
    from sgp_tpu_torch.exp import run_largescale_sgp as rls
    from sgp_tpu_torch.exp.common import Experiment
    from sgp_tpu_torch.train.predictor import Predictor
    from sgp_tpu_torch.utils.config import config as global_config
    config = config or {}
    os.environ.update(config.get("env", {}))
    if "logs_dir" in config:
        global_config["logs_dir"] = config["logs_dir"]
    name = config.get("runner", "largescale_sgp")
    mod = importlib.import_module(f"sgp_tpu_torch.exp.run_{name}")
    # the large-scale baselines take the traffic baselines' flags
    parser = rls.configure_parser_largescale() if name == "largescale_sgp" \
        else importlib.import_module({
            "traffic_sgp": "sgp_tpu_torch.exp.run_traffic_sgp"}.get(
                name, "sgp_tpu_torch.exp.run_traffic_baselines")
        ).configure_parser()
    kept = {}
    fit, init = rls._run_restartable_fit, Predictor.init
    carry = _carry_init(config.get("init"))

    def keep_model(args, model, *rest):
        kept["model"] = model
        return fit(args, model, *rest)

    def keep_predictor(self, *args, **kwargs):
        kept["model"] = self.model
        return carry(self, *args, **kwargs)

    rls._run_restartable_fit = keep_model
    Predictor.init = keep_predictor
    skew = "skew_val_rank" in config
    evals, stops = getattr(mod, "fused_eval_for", None), []
    if skew:
        if rank == config["skew_val_rank"]:
            mod.fused_eval_for = _falling_val(evals)
        log = logging.getLogger(mod.__name__)
        level = log.level
        log.setLevel(logging.INFO)
        handler = logging.Handler()
        handler.addFilter(lambda r: "early stop" in r.getMessage())
        handler.emit = lambda r: stops.append(r.getMessage())
        log.addHandler(handler)
    try:
        res = Experiment(mod.run_experiment, parser).run(argv)
    finally:
        rls._run_restartable_fit, Predictor.init = fit, init
        if skew:
            mod.fused_eval_for = evals
            log.removeHandler(handler)
            log.setLevel(level)
    if skew:
        return res, _weights(kept["model"]), stops
    return res, _weights(kept["model"])


def _falling_val(fused_eval_for):
    """``fused_eval_for`` whose first evaluation (the validation split's)
    reports an MAE that falls every call; later ones (the test split's)
    are left as they are."""
    calls = []

    def skewed(*args, **kwargs):
        evaluate = fused_eval_for(*args, **kwargs)
        calls.append(None)
        if len(calls) > 1:
            return evaluate
        epochs = iter(range(1 << 30))
        return lambda: {**evaluate(), "mae": -float(next(epochs))}
    return skewed


def imported_modules(rank, world):
    """The top-level packages a rank process has imported."""
    import sys
    return sorted({name.split(".")[0] for name in sys.modules})
