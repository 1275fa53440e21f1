"""SGP on large-scale datasets with fused IID (time, node) sampling.

Counterpart of the default branch of ``sgp_tpu/exp/run_largescale_sgp.py``:
k-nn connectivity, ``RobustScaler(10, 90)``, the whole-series encode, IID
decoder training on the card (``train/iid.py``) for ``epochs x
batches_epoch`` steps with the train loss monitored, restartable
checkpoints, and a fused evaluation of the best weights on the test split.

By default the encoder emits the packed IID training layout directly
(``streaming_encode`` with the target and mask lanes appended), so the
unpacked encoding never exists; ``--packed-gather false``, another
encoder or a non-bf16 ``--encode-dtype`` take the ``encode_dataset`` path.

``--iid-stratified true`` keeps only the reservoir's temporal embedding on
the device and propagates the sampled steps through the supports inside
each training step (``make_fused_iid_stratified_step``), for series too
long to expand. ``--search-lr``/``--search-seeds`` train every lr x seed
trial on shared batches (``train/multi_trial.py``), select on the fused
validation MAE and report the best trial's test metrics.
``--data-sharding nodes`` trains over every rank of the process group
(``--num-processes`` or ``torchrun``; one process a rank): each rank
encodes as above, keeps only its node slab of the rows (with
``--iid-stratified true``: of the temporal embedding), draws its share
of each batch from it and sums the gradients (``parallel/sharding.py``);
the test evaluation runs node-sharded too, and only rank 0 logs and
writes results.

Usage::

    python -m sgp_tpu_torch.exp.run_largescale_sgp \\
        --config largescale_100nn/sgp_pv.yaml --dataset-name synthetic \\
        --synthetic-nodes 5016 --synthetic-steps 640 --epochs 4
    # the stratified trainer: add --iid-stratified true
    # the trial search: add --search-lr 0.01,0.001 --search-seeds 0,1
    # on the CPU: add --device cpu
    # node-sharded over 2 cards: torchrun --nproc-per-node 2 -m
    #   sgp_tpu_torch.exp.run_largescale_sgp ... --data-sharding nodes
    #   (with --iid-stratified true too)
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from sgp_tpu_torch.data import (RobustScaler, SpatioTemporalDataset,
                                Windowing)
from sgp_tpu_torch.data.sgp_loader import build_support_operators
from sgp_tpu_torch.encode import (Reservoir, encode_dataset,
                                  encoder_input_array, get_encoder_class,
                                  rewire_exog_keys, streaming_encode)
from sgp_tpu_torch.encode.encode_dataset import torch_dtype
from sgp_tpu_torch.exp.common import (Experiment, dataset_kwargs,
                                      filter_kwargs, get_dataset,
                                      get_splitter, str2bool)
from sgp_tpu_torch.exp.run_traffic_sgp import configure_parser, derive_order
from sgp_tpu_torch.models import SGPModel
from sgp_tpu_torch.ops import GlobalMeanOperator
from sgp_tpu_torch.train import MaskedMetrics, Predictor
from sgp_tpu_torch.train.checkpoint import (AsyncCheckpointer,
                                            gather_rank_states,
                                            restore_run_state)
from sgp_tpu_torch.train.fused_window import make_fused_eval
from sgp_tpu_torch.train.iid import (fused_iid_inputs,
                                     make_fused_iid_multi_step,
                                     make_fused_iid_stratified_step,
                                     pack_iid_data)
from sgp_tpu_torch.train.multi_trial import (best_trial, eval_trials,
                                             init_trial_params, load_trial,
                                             make_fused_iid_multi_trial_step)
from sgp_tpu_torch.parallel import (local_mesh, make_sharded_iid_eval,
                                    make_sharded_iid_step,
                                    make_sharded_iid_stratified_step,
                                    process_rank, rank_device,
                                    rank_generator, shard_nodes)

logger = logging.getLogger(__name__)


def _searching(args) -> bool:
    return bool(getattr(args, "search_lr", None)
                or getattr(args, "search_seeds", None))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _state_copy(model) -> dict:
    """The weights as they are now: the optimizer updates the parameters
    in place, so a reference would follow them."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _dataset(args, device):
    """The dataset, its k-nn graph with the day encoding as exogenous
    input, the split and ``RobustScaler(10, 90)`` fitted on the train
    windows' start steps: ``(ds, split, exog)``."""
    dataset = get_dataset(args.dataset_name, **dataset_kwargs(args))
    exog = dataset.datetime_encoded("day")
    graph = dataset.get_connectivity(
        knn=args.adj_knn, threshold=None, include_self=False,
        device=device)
    logger.info(f"graph: {graph.num_nodes} nodes, {graph.num_edges} edges")
    ds = SpatioTemporalDataset(
        dataset.target, index=dataset.index, mask=dataset.mask,
        graph=graph, covariates={"u": exog},
        windowing=Windowing(window=args.window, horizon=args.horizon,
                            horizon_lag=args.horizon_lag))
    split = get_splitter(args.dataset_name, args.val_len,
                         args.test_len).split(ds)
    ds.fit_scaler(RobustScaler(axis=(0, 1), quantile_range=(10., 90.)),
                  step_index=ds.indices()[split.train])
    return ds, split, exog


def _decoder(args, ds, x_size: int, u_size: int, device,
             generator: torch.Generator = None):
    """The SGP decoder over ``x_size`` features, its weights drawn from
    ``generator`` (default: seeded with ``--seed``)."""
    if generator is None:
        generator = torch.Generator().manual_seed(args.seed)
    return SGPModel(
        input_size=x_size, order=derive_order(args), n_nodes=ds.n_nodes,
        hidden_size=args.hidden_size, mlp_size=args.mlp_size,
        output_size=ds.n_channels, n_layers=args.n_layers,
        horizon=ds.windowing.horizon_steps,
        positional_encoding=args.positional_encoding,
        emb_size=args.emb_size, exog_size=u_size, resnet=args.resnet,
        fully_connected=args.fully_connected, dropout=args.dropout,
        generator=generator).to(device)


def _exog_on(ds, device):
    u_arr = ds.exog_array()
    return None if u_arr is None else torch.as_tensor(
        np.ascontiguousarray(u_arr), dtype=torch.float32, device=device)


def run_experiment(args):
    if getattr(args, "iid_stratified", False):
        return run_experiment_stratified(args)
    if _searching(args):
        if getattr(args, "checkpoint_every", 0) or getattr(args, "resume",
                                                           False):
            raise ValueError(
                "--checkpoint-every/--resume are not supported with the "
                "vmapped --search-lr/--search-seeds path")
        if getattr(args, "data_sharding", "none") != "none":
            raise ValueError("--data-sharding is not supported with the "
                             "vmapped --search-lr/--search-seeds path")
    device = rank_device(getattr(args, "device", None))
    mesh = _nodes_mesh(args)
    sharded = mesh is not None
    ds, split, exog = _dataset(args, device)
    order = derive_order(args)
    est_gb = (ds.n_steps * ds.n_nodes * order * args.reservoir_size
              * 4 / 2 ** 30)
    logger.info(f"encoding memory estimate: {est_gb:.2f} GB (f32)")

    input_size = ds.n_channels + (exog.shape[-1]
                                  if args.preprocess_exogenous else 0)
    encoder_cls = get_encoder_class(args.encoder_name)
    encoder = encoder_cls(**filter_kwargs(encoder_cls.__init__, {
        **vars(args), "input_size": input_size, "seed": args.seed,
        "device": device}))

    # The streaming-packed path: the encoder writes the packed IID rows
    # ([enc | y_hi | y_lo | mask] bf16) directly, so the unpacked encoding
    # never exists and a step gathers one row a sample.
    streaming_packed = (
        getattr(args, "packed_gather", True)
        and args.encoder_name == "sgp"
        and (args.encode_dtype or "bfloat16") == "bfloat16")
    if streaming_packed:
        x_series = torch.as_tensor(
            encoder_input_array(ds, args.preprocess_exogenous),
            device=device)
        tgt = torch.as_tensor(ds.target, device=device)
        mask = torch.as_tensor(ds.mask, device=device)
        h_off = ds.windowing.horizon_offsets()
        lanes = pack_iid_data(
            torch.zeros(tgt.shape[:2] + (0,), dtype=torch.bfloat16,
                        device=device), tgt, mask, h_off)
        t_enc = time.time()
        packed = streaming_encode(
            encoder, x_series, ds.graph,
            time_chunk=args.encode_time_chunk or 64, extra_lanes=lanes,
            precision=getattr(args, "encode_precision", "highest"))
        _sync(device)
        logger.info(f"Streaming packed encode in "
                    f"{time.time() - t_enc:.1f}s -> {tuple(packed.shape)} "
                    f"{packed.dtype}")
        del x_series, lanes
        rewire_exog_keys(ds, args.preprocess_exogenous, args.keep_raw)
        u = _exog_on(ds, device)
        enc = None
        x_size = encoder.output_size
    else:
        store_dtype = args.encode_dtype or "bfloat16"
        encode_dataset(ds, encoder,
                       encode_exogenous=args.preprocess_exogenous,
                       keep_raw=args.keep_raw, store_dtype=store_dtype,
                       time_chunk=args.encode_time_chunk or 128,
                       device=device)
        enc, tgt, mask, _valid_all, h_off, u = fused_iid_inputs(
            ds, device=device)
        # the dtype the encode stored, as the JAX package keeps it on
        # the device (the host copy holds its values in f32)
        enc = enc.to(torch_dtype(store_dtype))
        x_size = enc.shape[-1]
        packed = getattr(args, "packed_gather", True)
    u_size = 0 if u is None else int(u.shape[-1])

    # train on the train slice only
    train_steps = ds.indices()[split.train]
    model = _decoder(args, ds, x_size, u_size, device)
    batches_epoch = args.batches_epoch if args.batches_epoch > 0 else 32
    scaler = ds.scaler_params(device=device)
    if _searching(args):
        return _run_multi_trial(
            args, ds, split, model, enc, tgt, mask, train_steps, h_off, u,
            packed, streaming_packed, x_size, u_size, scaler, device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    if sharded:
        step, test_eval_fn = _node_sharded(
            args, ds, split, model, optimizer, mesh, enc, tgt, mask, packed,
            h_off, u, scaler, x_size, batches_epoch)
        # this rank's slabs are all the step keeps: free the whole arrays
        enc = tgt = mask = packed = u = None
        generator = rank_generator(args.seed, mesh.index["data"], device)
    else:
        step = make_fused_iid_multi_step(
            model, optimizer, enc, tgt, mask, train_steps, h_off, scaler,
            u=u, batch_size=args.batch_size, scale_target=args.scale_target,
            steps_per_call=batches_epoch, packed=packed,
            gather_block=getattr(args, "gather_block", 1),
            grad_clip=args.grad_clip_val)
        # full-graph evaluation on the test split; the packed rows carry
        # the features first, so eval slices them out of the one packed
        # array
        test_eval_fn = make_fused_eval(
            model, packed if streaming_packed else enc, tgt, mask,
            ds.indices()[split.test], ds.windowing.window_offsets(), h_off,
            scaler, MaskedMetrics.forecasting(), u=u,
            batch_size=args.batch_inference or 16,
            x_slice=x_size if streaming_packed else None)
        generator = torch.Generator(device=device).manual_seed(args.seed)

    best_state, fit_state = _run_restartable_fit(
        args, model, optimizer, step, generator, batches_epoch, mesh)
    model.load_state_dict(best_state)
    results = {f"test_{k}": v for k, v in test_eval_fn().items()}
    results["train_time_s"] = fit_state["train_time_s"]
    if sharded:
        results["data_sharding"] = "nodes"
    logger.info(f"test: {results}")
    return results


def _nodes_mesh(args):
    """``--data-sharding nodes``: the mesh over the process group's ranks
    (None otherwise)."""
    if getattr(args, "data_sharding", "none") != "nodes":
        return None
    mesh = local_mesh(1)
    logger.info(f"data-sharding=nodes over {mesh.size('data')} ranks")
    return mesh


def _cut(a, mesh):
    """This rank's node slab of ``[T, N, ...]`` (None stays None)."""
    return None if a is None else shard_nodes(a, mesh, "data", node_axis=1)


def _node_sharded(args, ds, split, model, optimizer, mesh, enc, tgt, mask,
                  packed, h_off, u, scaler, x_size: int, batches_epoch: int):
    """The ``--data-sharding nodes`` step and test evaluation on this
    rank's node slabs: ``packed`` is the whole prebuilt packed array (the
    streaming encode's) or the ``--packed-gather`` flag. Returns ``(step,
    test_eval_fn)``; the slabs are copies, so the caller may free the
    whole arrays."""
    def cut(a):
        return _cut(a, mesh)

    prebuilt = isinstance(packed, torch.Tensor)
    step = make_sharded_iid_step(
        model, optimizer, cut(enc), cut(tgt), cut(mask),
        ds.indices()[split.train], h_off,
        scaler, mesh, u=cut(u) if u is not None and u.ndim == 3 else u,
        batch_size=args.batch_size, scale_target=args.scale_target,
        axis="data", steps_per_call=batches_epoch,
        packed=cut(packed) if prebuilt else packed,
        grad_clip=args.grad_clip_val, n_nodes=ds.n_nodes)
    w_off = ds.windowing.window_offsets()
    u_sh = step.data[-1] if u is not None else None
    kwargs = dict(u=u_sh, axis="data", batch_size=args.batch_inference or 16,
                  n_nodes=ds.n_nodes)
    items = ds.indices()[split.test]
    metrics = MaskedMetrics.forecasting()
    if step.packed and len(w_off) == 1:
        # features, shifted targets and masks all from the packed slab
        ev = make_sharded_iid_eval(
            model, step.data[0], None, None, items, w_off, h_off, scaler,
            metrics, mesh, x_slice=x_size, unpack_targets=True, **kwargs)
    elif step.packed:
        # a multi-step window cannot read the packed lanes: the explicit
        # target and mask slabs, the feature lanes sliced out
        ev = make_sharded_iid_eval(
            model, step.data[0], cut(tgt), cut(mask), items, w_off, h_off,
            scaler, metrics, mesh, x_slice=x_size, **kwargs)
    else:
        ev = make_sharded_iid_eval(
            model, step.data[0], step.data[1], step.data[2], items, w_off,
            h_off, scaler, metrics, mesh, **kwargs)
    return step, ev


def _train_config(args, batches_epoch):
    """Training hyperparameters recorded in checkpoints and asserted on
    resume: a resume under other settings is not the run it continues."""
    return {"lr": args.lr, "batch_size": args.batch_size,
            "batches_epoch": batches_epoch,
            "grad_clip_val": args.grad_clip_val, "seed": args.seed,
            "scale_target": bool(args.scale_target)}


def _run_restartable_fit(args, model, optimizer, step, generator,
                         batches_epoch, mesh=None):
    """The fit loop with restartable checkpoints: every
    ``--checkpoint-every`` epochs the current weights, optimizer state,
    generator state, torch's default generators' states (dropout's),
    best-so-far weights and progress go into one atomic file; ``--resume``
    continues the exact run (the same generator streams as an
    uninterrupted run; model and train configs asserted). Returns
    ``(best_state, {"train_time_s": ..., "best_loss": ...})``, the time
    including the epochs before a resume.

    Over the ranks of a node-sharded ``mesh`` the weights and the
    optimizer's state are replicated and rank 0 writes them, with every
    rank's generator states (the sampler's, the step's own where it has
    one, torch's defaults) gathered beside the world size; on resume each
    rank restores its own, and another world size raises."""
    ckpt_every = getattr(args, "checkpoint_every", 0)
    ckpt_path = getattr(args, "checkpoint_path", "") \
        or f"{args.logdir}/train_state.ckpt"
    tc = _train_config(args, batches_epoch)
    group = None if mesh is None else mesh.group("data")
    rank = 0 if mesh is None else mesh.index["data"]
    world = 1 if group is None else mesh.size("data")
    # the sampler's stream, and the step's own where it keeps one
    own = list(getattr(step, "generators", ()))
    generators = [generator] + own if own else generator
    start_epoch, best_loss, elapsed = 0, np.inf, 0.0
    best_state = _state_copy(model)
    if getattr(args, "resume", False) and os.path.exists(ckpt_path):
        start_epoch, best_loss, best_state, elapsed = restore_run_state(
            ckpt_path, model, optimizer, generators, train_config=tc,
            rank=rank, world_size=world)
        logger.info(f"resumed from {ckpt_path} at epoch {start_epoch} "
                    f"(best_loss={best_loss:.4f})")

    # fault injection for restart testing: SGP_TPU_FAULT="epoch:N,
    # marker:PATH" kills the process at the start of epoch N unless PATH
    # exists (created on the way out, so it fires once across restarts);
    # every rank looks before rank 0 writes it, so all of them die
    ckpt = AsyncCheckpointer()
    fault = os.environ.get("SGP_TPU_FAULT", "")
    fault_epoch, fault_marker = -1, ""
    if fault:
        parts = dict(p.split(":", 1) for p in fault.split(","))
        fault_epoch, fault_marker = int(parts["epoch"]), parts["marker"]

    t0 = time.time()
    for epoch in range(start_epoch, args.epochs):
        if epoch == fault_epoch:
            fire = not os.path.exists(fault_marker)
            ckpt.wait()
            if group is not None:
                dist.barrier(group)
            if fire:
                if rank == 0:
                    with open(fault_marker, "w") as fp:
                        fp.write(str(epoch))
                logger.info(f"FAULT INJECTION: dying at epoch {epoch}")
                os._exit(13)
        t_ep = time.time()
        loss = float(step(generator))   # sync: the epoch really finished
        dt_ep = time.time() - t_ep
        if loss < best_loss:
            best_loss, best_state = loss, _state_copy(model)
        if epoch % max(1, args.epochs // 20) == 0:
            bps = (batches_epoch * (epoch + 1 - start_epoch)
                   / max(time.time() - t0, 1e-9))
            logger.info(f"epoch {epoch}: train_mae={loss:.4f} "
                        f"({bps:.1f} batch/s) ({dt_ep:.2f}s)")
        if ckpt_every and (epoch + 1) % ckpt_every == 0:
            ranks = None if group is None else gather_rank_states(
                generators, model, group)
            if rank == 0:
                ckpt.save(ckpt_path, model, optimizer, generators, epoch,
                          best_loss, best_state,
                          elapsed_s=elapsed + time.time() - t0,
                          train_config=tc, ranks=ranks)
    ckpt.wait()   # the last checkpoint is durable before we report
    return best_state, {"train_time_s": elapsed + time.time() - t0,
                        "best_loss": best_loss}


def _run_multi_trial(args, ds, split, model, enc, tgt, mask, train_steps,
                     h_off, u, packed, streaming_packed, x_size, u_size,
                     scaler, device):
    """The search over lr x seed: every trial trains on shared sampled
    batches (``train/multi_trial.py``), each keeps a copy of its weights at
    its best epoch's train loss, the fused validation evaluation selects
    the winner and the fused test evaluation reports it. ``model`` holds
    the trials' architecture and ends with the best trial's weights."""
    lrs = [float(v) for v in (args.search_lr or str(args.lr)).split(",")]
    seeds = [int(v) for v in
             (args.search_seeds or str(args.seed)).split(",")]
    trials = [(lr, seed) for lr in lrs for seed in seeds]
    k_trials = len(trials)
    logger.info(f"search over {k_trials} trials (lr x seed): {trials}")
    stack = init_trial_params(
        lambda gen: _decoder(args, ds, x_size, u_size, device, gen),
        [s for _, s in trials])
    batches_epoch = args.batches_epoch if args.batches_epoch > 0 else 32
    step = make_fused_iid_multi_trial_step(
        model, enc, tgt, mask, train_steps, h_off, scaler,
        lrs=[lr for lr, _ in trials], u=u, batch_size=args.batch_size,
        grad_clip=args.grad_clip_val, scale_target=args.scale_target,
        steps_per_call=batches_epoch, packed=packed)
    opt_state = step.init_opt(stack)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    best_losses = torch.full((k_trials,), np.inf, device=device)
    best_stack = stack
    t0 = time.time()
    for epoch in range(args.epochs):
        stack, opt_state, losses = step(stack, opt_state, generator)
        better = losses < best_losses
        # new tensors: the step returns new ones, never updating in place
        best_stack = {k: torch.where(
            better.reshape((k_trials,) + (1,) * (v.ndim - 1)), v,
            best_stack[k]) for k, v in stack.items()}
        best_losses = torch.minimum(best_losses, losses)
        if epoch % max(1, args.epochs // 20) == 0:
            bps = (batches_epoch * k_trials * (epoch + 1)
                   / max(time.time() - t0, 1e-9))
            logger.info(f"epoch {epoch}: train_mae="
                        f"{losses.cpu().numpy().round(4).tolist()} "
                        f"({bps:.1f} trial-batch/s)")
    _sync(device)
    train_time = time.time() - t0

    metrics = MaskedMetrics.forecasting()
    w_off = ds.windowing.window_offsets()

    def fused(items):
        return make_fused_eval(
            model, packed if streaming_packed else enc, tgt, mask, items,
            w_off, h_off, scaler, metrics, u=u,
            batch_size=args.batch_inference or 16,
            x_slice=x_size if streaming_packed else None)

    val_items = ds.indices()[split.val]
    sel_eval = fused(val_items if len(val_items) else
                     ds.indices()[split.train])
    per_trial_val = eval_trials(sel_eval, model, best_stack)
    k_best = best_trial(per_trial_val, "mae")
    load_trial(model, best_stack, k_best)
    test_res = fused(ds.indices()[split.test])()
    results = {f"test_{k}": v for k, v in test_res.items()}
    results.update(
        best_lr=trials[k_best][0], best_seed=trials[k_best][1],
        val_mae_per_trial=per_trial_val["mae"].tolist(),
        trials=[{"lr": lr, "seed": s} for lr, s in trials],
        train_time_s=train_time)
    logger.info(f"best trial {k_best} {trials[k_best]}: {results}")
    return results


def run_experiment_stratified(args):
    """The path for series too long to expand: only the reservoir's
    temporal embedding stays on the device, and the spatial propagation
    happens inside each training step (``make_fused_iid_stratified_step``),
    so the (k+1)x expansion is never built. The supports come from
    ``build_support_operators`` with ``operator_mode`` read from the
    namespace (``auto`` when absent); the test evaluation propagates
    through the same supports and the global mean."""
    if _searching(args):
        raise ValueError("--search-lr/--search-seeds are not supported "
                         "with --iid-stratified (the trial search runs on "
                         "the precompute path)")
    device = rank_device(getattr(args, "device", None))
    mesh = _nodes_mesh(args)
    ds, split, exog = _dataset(args, device)
    input_size = ds.n_channels + (exog.shape[-1]
                                  if args.preprocess_exogenous else 0)
    res = Reservoir(input_size=input_size,
                    hidden_size=args.reservoir_size,
                    num_layers=args.reservoir_layers,
                    leaking_rate=args.leaking_rate,
                    spectral_radius=args.spectral_radius,
                    density=args.density, alpha_decay=args.alpha_decay,
                    input_scaling=args.input_scaling,
                    activation=args.reservoir_activation,
                    seed=args.seed, device=device)
    x_series = torch.as_tensor(
        encoder_input_array(ds, args.preprocess_exogenous), device=device)
    t0 = time.time()
    h_temporal = res(x_series, out_dtype=torch_dtype(
        args.encode_dtype or "bfloat16"))
    _sync(device)
    del x_series
    logger.info(f"reservoir encode {tuple(h_temporal.shape)} "
                f"{h_temporal.dtype} in {time.time() - t0:.1f}s (resident)")

    ops = build_support_operators(
        ds.graph, k=args.receptive_field, undirected=args.undirected,
        add_loops=args.add_self_loops, bidirectional=args.bidirectional,
        global_attr=False,
        operator_mode=getattr(args, "operator_mode", "auto"), device=device)
    d_total = int(h_temporal.shape[-1]) * (1 + len(ops)
                                           + (1 if args.global_attr else 0))
    # the decoder's exogenous input as encode_dataset rewires it: the day
    # encoding only when the reservoir did not take it, keep_raw adds the
    # scaled raw series
    rewire_exog_keys(ds, args.preprocess_exogenous, args.keep_raw)
    u = _exog_on(ds, device)
    u_size = 0 if u is None else int(u.shape[-1])
    model = _decoder(args, ds, d_total, u_size, device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr,
                                 betas=(0.9, 0.999), eps=1e-8)

    batches_epoch = args.batches_epoch if args.batches_epoch > 0 else 32
    times_per_batch = getattr(args, "times_per_batch", 32)
    nodes_per_time = max(args.batch_size // times_per_batch, 1)
    eval_ops = list(ops) + ([GlobalMeanOperator(ds.n_nodes)]
                            if args.global_attr else [])
    metrics = MaskedMetrics.forecasting()
    tgt = torch.as_tensor(np.ascontiguousarray(ds.target),
                          dtype=torch.float32, device=device)
    mask = torch.as_tensor(ds.mask, device=device)
    h_off = ds.windowing.horizon_offsets()
    scaler = ds.scaler_params(device=device)
    infer_bs = args.batch_inference or 16
    if mesh is not None:
        # the embedding, targets and masks as node slabs: a step
        # all-gathers only its sampled steps' rows, the evaluation each
        # batch's windows
        s = mesh.size("data")
        npt = max(-(-nodes_per_time // s) * s, s)
        if npt != nodes_per_time:
            logger.info(f"nodes_per_time {nodes_per_time} -> {npt} "
                        f"(rounded up to {s} ranks; effective batch "
                        f"{times_per_batch * npt})")
        h_temporal, tgt, mask = (_cut(a, mesh)
                                 for a in (h_temporal, tgt, mask))
        if u is not None and u.ndim == 3:
            u = _cut(u, mesh)
        step = make_sharded_iid_stratified_step(
            model, optimizer, h_temporal, tgt, mask,
            ds.indices()[split.train], h_off, scaler, ops, mesh,
            global_attr=args.global_attr, u=u,
            times_per_batch=times_per_batch, nodes_per_time=npt,
            scale_target=args.scale_target, steps_per_call=batches_epoch,
            grad_clip=args.grad_clip_val, seed=args.seed,
            n_nodes=ds.n_nodes)
        test_eval_fn = make_sharded_iid_eval(
            model, h_temporal, tgt, mask, ds.indices()[split.test],
            ds.windowing.window_offsets(), h_off, scaler, metrics, mesh,
            u=u, batch_size=infer_bs, support_ops=eval_ops,
            n_nodes=ds.n_nodes)
    else:
        step = make_fused_iid_stratified_step(
            model, optimizer, h_temporal, tgt, mask,
            ds.indices()[split.train], h_off, scaler, ops,
            global_attr=args.global_attr, u=u,
            times_per_batch=times_per_batch, nodes_per_time=nodes_per_time,
            scale_target=args.scale_target, steps_per_call=batches_epoch,
            grad_clip=args.grad_clip_val)
        # the full-graph test evaluation: the temporal embedding
        # propagated through the same supports and the global mean, as in
        # the step
        test_eval_fn = make_fused_eval(
            model, h_temporal, tgt, mask, ds.indices()[split.test],
            ds.windowing.window_offsets(), h_off, scaler, metrics, u=u,
            support_ops=eval_ops, batch_size=infer_bs)

    # every rank steps the same stream: the shared starts (the sharded
    # step draws a rank's own nodes from its rank generator)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    best_state, fit_state = _run_restartable_fit(
        args, model, optimizer, step, generator, batches_epoch, mesh)
    logger.info(f"train done in {fit_state['train_time_s']:.1f}s")
    model.load_state_dict(best_state)
    if process_rank() == 0:     # the ranks hold the same weights
        Predictor(model, metrics=metrics, device=device).save(
            f"{args.logdir}/best.pt")
    results = {f"test_{k}": v for k, v in test_eval_fn().items()}
    results["train_mae"] = fit_state["best_loss"]
    results["train_time_s"] = fit_state["train_time_s"]
    if mesh is not None:
        results["data_sharding"] = "nodes"
    logger.info(f"results: {results}")
    return results


def configure_parser_largescale():
    parser = configure_parser(data_sharding_choices=None)
    parser.add_argument("--iid-stratified", type=str2bool, default=False)
    parser.add_argument("--times-per-batch", type=int, default=32)
    parser.add_argument("--data-sharding", type=str, default="none",
                        choices=("none", "nodes"),
                        help="'nodes': train over the process group's "
                             "ranks, each holding a node slab of the rows")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="save weights, optimizer, generator and best "
                             "every N epochs (atomic; 0 disables)")
    parser.add_argument("--checkpoint-path", type=str, default="",
                        help="train-state path (default: "
                             "<logdir>/train_state.ckpt; pass an explicit "
                             "path to resume across runs)")
    parser.add_argument("--resume", type=str2bool, default=False,
                        help="continue from --checkpoint-path with the "
                             "exact generator stream of the uninterrupted "
                             "run")
    parser.add_argument("--search-lr", type=str, default="",
                        help="comma-separated lr list: train all lr x "
                             "seed trials on shared batches, select on the "
                             "fused validation MAE")
    parser.add_argument("--search-seeds", type=str, default="",
                        help="comma-separated init seeds for the trial "
                             "search")
    parser.add_argument("--encode-precision", type=str, default="highest",
                        choices=("highest", "default"),
                        help="precision of the streaming K-hop "
                             "propagation; 'default' stores BSR tiles in "
                             "bf16")
    parser.add_argument("--gather-block", type=int, default=1,
                        help="G>1: sample batch/G (time, node-block) "
                             "pairs and gather G consecutive packed rows "
                             "a draw; requires G | batch and G | n_nodes "
                             "and the packed layout")
    parser.add_argument("--packed-gather", type=str2bool, default=True,
                        help="pack features, targets and masks into one "
                             "bf16 row per (t, n): one gather a sample")
    return parser


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    Experiment(run_experiment, configure_parser_largescale()).run()
