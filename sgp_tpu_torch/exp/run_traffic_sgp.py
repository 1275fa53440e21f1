"""SGP, online-SGP and ESN experiments on the traffic datasets.

Counterpart of ``sgp_tpu/exp/run_traffic_sgp.py``: dataset, datetime
exogenous input, connectivity, ``StandardScaler`` fitted on the train
windows, the training-free encode kept on the device
(``encode_dataset(device_resident=True)``), then decoder training and the
test metrics (with the MAE at horizon steps 3, 6 and 12 when the horizon
is 12). Its flag surface (``configure_parser``, ``derive_order``) is also
the large-scale runner's.

Routes, as in the JAX runner:

- ``--model-name sgp`` (the configs' default) with ``--fused true``:
  windowed training on the device (``train/fused_window.py``),
  ``batches_epoch`` steps a call, validated after each epoch by the fused
  evaluation, the best epoch's weights (a copy) kept for the test;
- ``--fused false``, ``--model-name online_sgp`` (the K-hop embedding in
  the model's forward) or ``esn``: ``Predictor.fit`` on
  ``WindowedLoader``s;
- ``--iid-sampling true``: ``Predictor.fit`` on an ``IIDLoader``;
- ``--sgp-preprocessing true``: the supports of ``sgp_spatial_support``
  applied at load time (``data/sgp_loader.py``): ``SGPLoader`` /
  ``SGPIIDLoader``, or the fused step's ``support_ops``. The supports go
  through ``operator_mode`` (``auto``: dense at traffic sizes; ``"bsr"``
  set on the parsed namespace runs K1 under them).

``--data-sharding batch`` trains the fused SGP route over the process
group's ranks (``--num-processes`` or ``torchrun``; one process a rank):
``parallel/sharding.py::make_sharded_window_step``, each rank its share of
a batch from its own generator on the whole series; the evaluations run
whole on every rank, rank 0's validation metric decides the best epoch
and the early stop on every rank, and rank 0 writes the weights. Any other route
raises, as in the JAX runner.

Usage::

    python -m sgp_tpu_torch.exp.run_traffic_sgp --config traffic/sgp_la.yaml \\
        --dataset-name synthetic --synthetic-nodes 207 --epochs 5
    # on the CPU: add --device cpu
    # data-parallel over 2 cards: torchrun --nproc-per-node 2 -m
    #   sgp_tpu_torch.exp.run_traffic_sgp ... --data-sharding batch
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from sgp_tpu_torch.data import (IIDLoader, SpatioTemporalDataset,
                                StandardScaler, WindowedLoader, Windowing)
from sgp_tpu_torch.data.sgp_loader import (SGPIIDLoader, SGPLoader,
                                           apply_support,
                                           build_support_operators)
from sgp_tpu_torch.encode import (encode_dataset, get_encoder_class,
                                  prepare_propagation_graphs)
from sgp_tpu_torch.exp.common import (Experiment, add_common_args,
                                      dataset_kwargs, filter_kwargs,
                                      get_dataset, get_splitter, str2bool)
from sgp_tpu_torch.models import ESNModel, SGPModel, SGPOnlineModel
from sgp_tpu_torch.ops import build_operator
from sgp_tpu_torch.parallel import (local_mesh, make_sharded_window_step,
                                    process_rank, rank_device,
                                    rank_generator)
from sgp_tpu_torch.parallel.collectives import broadcast_
from sgp_tpu_torch.train import MaskedMetrics, Predictor
from sgp_tpu_torch.train.fused_window import (make_fused_eval,
                                              make_fused_window_step)

logger = logging.getLogger(__name__)


def configure_parser(data_sharding_choices=("none", "batch")
                     ) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--encoder-name", type=str, default="sgp")
    parser.add_argument("--model-name", type=str, default="sgp")
    # preprocessing
    parser.add_argument("--preprocess-exogenous", type=str2bool,
                        default=True)
    parser.add_argument("--keep-raw", type=str2bool, default=True)
    parser.add_argument("--iid-sampling", type=str2bool, default=False)
    parser.add_argument("--sgp-preprocessing", type=str2bool,
                        default=False)
    # reservoir and spatial flags (the encoder's surface)
    parser.add_argument("--reservoir-size", type=int, default=32)
    parser.add_argument("--reservoir-layers", type=int, default=1)
    parser.add_argument("--leaking-rate", type=float, default=0.9)
    parser.add_argument("--spectral-radius", type=float, default=0.9)
    parser.add_argument("--density", type=float, default=0.7)
    parser.add_argument("--input-scaling", type=float, default=1.0)
    parser.add_argument("--alpha-decay", type=str2bool, default=False)
    parser.add_argument("--reservoir-activation", type=str, default="tanh")
    parser.add_argument("--receptive-field", type=int, default=1)
    parser.add_argument("--bidirectional", type=str2bool, default=False)
    parser.add_argument("--undirected", type=str2bool, default=False)
    parser.add_argument("--add-self-loops", type=str2bool, default=False)
    parser.add_argument("--global-attr", type=str2bool, default=False)
    # decoder flags
    parser.add_argument("--hidden-size", type=int, default=32)
    parser.add_argument("--mlp-size", type=int, default=32)
    parser.add_argument("--emb-size", type=int, default=32)
    parser.add_argument("--n-layers", type=int, default=1)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--fully-connected", type=str2bool, default=False)
    parser.add_argument("--positional-encoding", type=str2bool,
                        default=True)
    parser.add_argument("--resnet", type=str2bool, default=False)
    parser.add_argument("--rec-layers", type=int, default=1)  # esn
    parser.add_argument("--fused", type=str2bool, default=True,
                        help="sampling, gather and train steps on the "
                             "device, batches_epoch steps a call")
    parser.add_argument("--encode-dtype", type=str, default=None,
                        help="storage dtype of the encoding, e.g. "
                             "bfloat16 (halves its memory)")
    parser.add_argument("--encode-time-chunk", type=int, default=None)
    if data_sharding_choices:
        parser.add_argument(
            "--data-sharding", type=str, default="none",
            choices=data_sharding_choices,
            help="'batch': the fused SGP route data-parallel over the "
                 "process group's ranks")
    return parser


def derive_order(args) -> int:
    """The decoder's number of feature blocks: the states, the hops of
    each direction, the global mean, for each reservoir layer."""
    order = 1
    order += (2 if args.bidirectional else 1) * args.receptive_field
    if args.global_attr:
        order += 1
    order *= args.reservoir_layers
    return order


def build_encoded_dataset(args, device):
    """Dataset, windows, the scaler fitted on the train windows and the
    encode, kept on ``device``: ``(ds, split)``."""
    dataset = get_dataset(args.dataset_name, **dataset_kwargs(args))
    exog = dataset.datetime_encoded("day")
    graph = dataset.get_connectivity(
        threshold=args.adj_threshold, knn=args.adj_knn, include_self=False,
        device=device)
    ds = SpatioTemporalDataset(
        dataset.target, index=dataset.index, mask=dataset.mask,
        graph=graph, covariates={"u": exog},
        windowing=Windowing(window=args.window, horizon=args.horizon,
                            stride=args.stride,
                            horizon_lag=args.horizon_lag))
    split = get_splitter(args.dataset_name, args.val_len,
                         args.test_len).split(ds)
    ds.fit_scaler(StandardScaler(axis=(0, 1)),
                  step_index=ds.indices()[split.train])

    input_size = ds.n_channels + (exog.shape[-1]
                                  if args.preprocess_exogenous else 0)
    encoder_cls = get_encoder_class(args.encoder_name)
    encoder = encoder_cls(**filter_kwargs(encoder_cls.__init__, {
        **vars(args), "input_size": input_size, "seed": args.seed,
        "device": device}))
    encode_dataset(ds, encoder, encode_exogenous=args.preprocess_exogenous,
                   keep_raw=args.keep_raw, device_resident=True,
                   store_dtype=args.encode_dtype,
                   time_chunk=args.encode_time_chunk, device=device)
    return ds, split


def _batch_sharded(args) -> bool:
    return getattr(args, "data_sharding", "none") == "batch"


def _state_copy(model) -> dict:
    """The weights as they are now: the optimizer updates the parameters
    in place, so a reference would follow them."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def build_model(args, ds, x_size: int, u_size: int, device):
    """``(model, to_call)`` for ``--model-name``: ``to_call`` is the
    Predictor's call from a batch (None: its default)."""
    if args.model_name == "online_sgp":
        graphs = prepare_propagation_graphs(
            ds.graph, undirected=args.undirected,
            add_loops=args.add_self_loops, bidirectional=args.bidirectional)
        operators = [build_operator(g, getattr(args, "operator_mode",
                                               "auto"), device=device)
                     for g in graphs]
        model = SGPOnlineModel(
            input_size=x_size, n_nodes=ds.n_nodes,
            output_size=ds.n_channels, horizon=ds.windowing.horizon_steps,
            receptive_field=args.receptive_field,
            reservoir_layers=args.reservoir_layers,
            bidirectional=args.bidirectional, hidden_size=args.hidden_size,
            mlp_size=args.mlp_size, n_layers=args.n_layers,
            positional_encoding=args.positional_encoding,
            emb_size=args.emb_size, exog_size=u_size, resnet=args.resnet,
            fully_connected=args.fully_connected, dropout=args.dropout)

        def to_call(batch, training):
            kwargs = {"u": batch.get("u"), "training": training}
            if "node_index" in batch:
                kwargs["node_index"] = batch["node_index"]
            return (batch["x"], operators), kwargs
        return model, to_call
    if args.model_name == "sgp":
        return SGPModel(
            input_size=x_size, order=derive_order(args), n_nodes=ds.n_nodes,
            hidden_size=args.hidden_size, mlp_size=args.mlp_size,
            output_size=ds.n_channels, n_layers=args.n_layers,
            horizon=ds.windowing.horizon_steps,
            positional_encoding=args.positional_encoding,
            emb_size=args.emb_size, exog_size=u_size, resnet=args.resnet,
            fully_connected=args.fully_connected,
            dropout=args.dropout), None
    if args.model_name == "esn":
        return ESNModel.build(
            input_size=x_size, hidden_size=args.hidden_size,
            output_size=ds.n_channels, exog_size=u_size,
            rec_layers=args.rec_layers, horizon=ds.windowing.horizon_steps,
            seed=args.seed), None
    raise ValueError(args.model_name)


def run_experiment(args):
    fused = (args.fused and args.model_name == "sgp"
             and not args.iid_sampling)
    if _batch_sharded(args) and not fused:
        # the data-parallel window step backs the fused SGP route only;
        # the loader-based models take --data-sharding batch on the
        # baseline runners (Predictor(mesh=))
        raise ValueError(
            "--data-sharding batch on run_traffic_sgp requires the fused "
            "SGP path (--fused true, --model-name sgp, --iid-sampling "
            "false); for loader-based baselines use run_traffic_baselines "
            "--data-sharding batch")
    device = rank_device(getattr(args, "device", None))
    ds, split = build_encoded_dataset(args, device)

    support_ops = None
    if args.sgp_preprocessing:
        support_ops = build_support_operators(
            ds.graph, k=args.receptive_field, undirected=args.undirected,
            add_loops=args.add_self_loops, bidirectional=args.bidirectional,
            global_attr=args.global_attr,
            operator_mode=getattr(args, "operator_mode", "auto"),
            device=device)

    sample = ds.gather_batch(np.array([0]))
    x_size = int(sample["x"].shape[-1])
    if support_ops is not None:
        x_size = x_size * (1 + len(support_ops))
    u_size = int(sample["u"].shape[-1]) if "u" in sample else 0
    model, to_call = build_model(args, ds, x_size, u_size, device)

    batches_epoch = args.batches_epoch if args.batches_epoch > 0 else None
    metrics = MaskedMetrics.forecasting(
        {"15": 2, "30": 5, "60": 11} if args.horizon == 12 else {})
    predictor = Predictor(
        model, loss="mae", lr=args.lr, weight_decay=args.l2_reg,
        grad_clip=args.grad_clip_val,
        lr_milestones=args.lr_milestones if args.use_lr_schedule else None,
        lr_gamma=args.lr_gamma,
        steps_per_epoch=batches_epoch or max(
            1, len(split.train) // args.batch_size),
        scale_target=args.scale_target, metrics=metrics,
        batch_to_call=to_call, seed=args.seed, device=device)
    scaler = ds.scaler_params(device=device)

    if fused:
        dev = device_arrays(ds, device)   # moved once: the train step and
        #                                   both evaluations share them
        _fit_fused(args, ds, split, predictor, support_ops, batches_epoch,
                   dev, scaler)
        if process_rank() == 0:     # the ranks hold the same weights
            predictor.save(f"{args.logdir}/best.pt")
        test_eval = fused_eval_for(ds, predictor, split.test, support_ops,
                                   args.batch_inference or args.batch_size,
                                   dev, scaler)
        results = {f"test_{k}": v for k, v in test_eval().items()}
    else:
        train_loader, val_loader, test_loader = _loaders(
            args, ds, split, support_ops, batches_epoch)
        predictor.fit(train_loader, val_loader, epochs=args.epochs,
                      patience=args.patience, scaler=scaler,
                      logdir=args.logdir)
        predictor.save(f"{args.logdir}/best.pt")
        results = predictor.evaluate(test_loader, prefix="test_")
    logger.info(f"test: {results}")
    return results


def _loaders(args, ds, split, support_ops, batches_epoch):
    """The train, validation and test loaders of the routes through
    ``Predictor.fit``."""
    infer_bs = args.batch_inference or args.batch_size
    iid = dict(batch_size=args.batch_size,
               num_batches=batches_epoch or 1000, seed=args.seed,
               step_index=ds.indices()[split.train])
    shuffled = dict(items=split.train, batch_size=args.batch_size,
                    shuffle=True, limit_batches=batches_epoch,
                    seed=args.seed)
    if support_ops is not None:
        train = SGPIIDLoader(ds, support_ops, **iid) if args.iid_sampling \
            else SGPLoader(ds, support_ops, **shuffled)
        return (train,
                SGPLoader(ds, support_ops, items=split.val,
                          batch_size=infer_bs),
                SGPLoader(ds, support_ops, items=split.test,
                          batch_size=infer_bs))
    train = IIDLoader(ds, **iid) if args.iid_sampling \
        else WindowedLoader(ds, **shuffled)
    return (train, WindowedLoader(ds, split.val, batch_size=infer_bs),
            WindowedLoader(ds, split.test, batch_size=infer_bs))


def device_arrays(ds, device) -> dict:
    """The whole series on ``device``, shared by the fused train step and
    both fused evaluations: the inputs (the encoding, where it already
    lives), targets, masks and the exogenous input."""
    def on(a, dtype=None):
        t = a if isinstance(a, torch.Tensor) \
            else torch.as_tensor(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype)
    u = ds.exog_array()
    return {"x": on(ds.input_array()), "y": on(ds.target, torch.float32),
            "m": on(ds.mask), "u": None if u is None
            else on(u, torch.float32)}


def fused_eval_for(ds, predictor, items, support_ops, batch_size, dev,
                   scaler):
    """The fused evaluation of the predictor's model over ``items``."""
    return make_fused_eval(
        predictor.model, dev["x"], dev["y"], dev["m"], ds.indices()[items],
        ds.windowing.window_offsets(), ds.windowing.horizon_offsets(),
        scaler, predictor.metrics, u=dev["u"], support_ops=support_ops,
        batch_size=batch_size)


def _fit_fused(args, ds, split, predictor, support_ops, batches_epoch, dev,
               scaler):
    """Windowed training on the device, ``batches_epoch`` steps a call
    and one call an epoch, with the fused validation after each; early
    stopping and the best epoch's weights as in ``Predictor.fit``."""
    first = ds.gather_batch(np.array([0, 1]))
    predictor.init(first, scaler)
    model = predictor.model
    fixed = (model, predictor.optimizer, dev["x"], dev["y"], dev["m"],
             ds.indices()[split.train], ds.windowing.window_offsets(),
             ds.windowing.horizon_offsets(), scaler)
    common = dict(u=dev["u"], support_ops=support_ops,
                  batch_size=args.batch_size, scale_target=args.scale_target,
                  steps_per_call=batches_epoch or 300,
                  grad_clip=predictor.grad_clip,
                  scheduler=predictor.scheduler)
    device = dev["x"].device
    if _batch_sharded(args):
        # each rank draws its share of every batch from its own generator
        mesh = local_mesh(1)
        n = mesh.size("data")
        if args.batch_size % n:
            raise ValueError(
                f"--data-sharding batch needs batch_size ({args.batch_size}"
                f") divisible by the rank count ({n})")
        logger.info(f"data-sharding=batch over {n} ranks")
        step = make_sharded_window_step(*fixed, mesh=mesh, **common)
        generator = rank_generator(args.seed, mesh.index["data"], device)
        group = mesh.group("data")
    else:
        step = make_fused_window_step(*fixed, **common)
        generator = torch.Generator(device=device).manual_seed(args.seed)
        group = None
    val_eval = fused_eval_for(
        ds, predictor, split.val, support_ops,
        args.batch_inference or args.batch_size, dev, scaler) \
        if len(split.val) else None
    best, best_state, bad = np.inf, _state_copy(model), 0
    for epoch in range(args.epochs):
        t0 = time.time()
        logs = {"train_loss": float(step(generator))}
        if val_eval is not None:
            logs.update({f"val_{k}": v for k, v in val_eval().items()})
            current = logs["val_mae"]
        else:
            current = logs["train_loss"]
        if group is not None:
            # every rank evaluated the whole validation split, and the card
            # may round the ranks' values apart: rank 0's decides, so the
            # ranks keep the same best weights and stop at the same epoch
            current = float(broadcast_(torch.tensor(
                current, dtype=torch.float64, device=device), group))
        if current < best:
            best, best_state, bad = current, _state_copy(model), 0
        else:
            bad += 1
        logger.info(f"epoch {epoch}: " + " ".join(
            f"{k}={v:.4f}" for k, v in logs.items())
            + f" ({time.time() - t0:.1f}s)")
        if args.patience is not None and bad > args.patience:
            logger.info(f"early stop at epoch {epoch}")
            break
    model.load_state_dict(best_state)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    Experiment(run_experiment, configure_parser()).run()
