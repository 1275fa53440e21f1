"""Trained baselines on the traffic datasets: windowed full-graph batches.

Counterpart of ``sgp_tpu/exp/run_traffic_baselines.py``: every flag of its
parser, ``StandardScaler`` fitted on the train windows, ``WindowedLoader``s
for train, validation and test, ``Predictor.fit`` monitoring the
validation MAE (with ``metrics.jsonl`` in the run's log directory), the
best weights written to ``best.pt`` and the test metrics, with the MAE at
horizon steps 3, 6 and 12 when the horizon is 12.

Ported models: ``gatedgn`` and ``gatedgn_conv`` with
``--gn-aggregation edges|ell|dense`` and ``--full-graph`` (the ELL table
runs kernel K4 on the card, the dense mask kernel K3), ``transformer``,
``rnn`` and ``fc_rnn`` (``--cell-type gru|lstm``), ``tcn``, ``dcrnn``
and ``gwnet`` on the diffusion supports of ``diff_conv_support``, and
``stcn`` and ``rnn2gcn`` on the row-normalized operator
``build_operator(normalize_adj(g, "row"))`` under their GraphConvs. Both
are built once on the run's device (``auto``: dense up to 512 MB, so on
the runners' graphs the hops are matrix products; a BSR operator would run
kernel K1). ``--data-sharding batch`` trains data-parallel over the
process group's ranks (``--num-processes`` or ``torchrun``; one process a
rank): ``Predictor(mesh=dp_mesh(args))`` splits every batch.

Usage::

    python -m sgp_tpu_torch.exp.run_traffic_baselines --model-name gatedgn \\
        --config largescale_100nn/gatedgn_pv.yaml --dataset-name synthetic \\
        --synthetic-nodes 5016 --synthetic-steps 640 --adj-knn 100 \\
        --gn-aggregation ell --epochs 2
    # on the CPU: add --device cpu
    # data-parallel over 2 cards: torchrun --nproc-per-node 2 -m
    #   sgp_tpu_torch.exp.run_traffic_baselines ... --data-sharding batch
"""
from __future__ import annotations

import argparse
import logging
import warnings

import numpy as np
import torch

from sgp_tpu_torch.data import (SpatioTemporalDataset, StandardScaler,
                                WindowedLoader, Windowing)
from sgp_tpu_torch.exp.common import (Experiment, add_common_args,
                                      dataset_kwargs, dp_mesh, get_dataset,
                                      get_splitter, str2bool)
from sgp_tpu_torch.graph import auto_band, normalize_adj, padded_incoming
from sgp_tpu_torch.models import (DCRNNModel, FCRNNModel, GraphWaveNetModel,
                                  RNNModel, TCNModel, diff_conv_support,
                                  get_model_class)
from sgp_tpu_torch.ops import build_operator, dense_adj_mask
from sgp_tpu_torch.parallel import rank_device
from sgp_tpu_torch.train import MaskedMetrics, Predictor

logger = logging.getLogger(__name__)

_PORTED = ("gatedgn", "gatedgn_conv", "transformer", "rnn", "fc_rnn",
           "dcrnn", "gwnet", "tcn", "stcn", "rnn2gcn")


def configure_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--model-name", type=str, default="rnn")
    parser.add_argument("--hidden-size", type=int, default=64)
    parser.add_argument("--ff-size", type=int, default=128)
    parser.add_argument("--n-layers", type=int, default=1)
    parser.add_argument("--rec-layers", type=int, default=1)
    parser.add_argument("--ff-layers", type=int, default=1)
    parser.add_argument("--kernel-size", type=int, default=2)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--rec-dropout", type=float, default=0.0)
    parser.add_argument("--ff-dropout", type=float, default=0.0)
    parser.add_argument("--cell-type", type=str, default="gru")
    parser.add_argument("--temporal-kernel-size", type=int, default=2)
    parser.add_argument("--spatial-kernel-size", type=int, default=2)
    parser.add_argument("--dilation", type=int, default=2)
    parser.add_argument("--dilation-mod", type=int, default=2)
    parser.add_argument("--norm", type=str, default="batch")
    parser.add_argument("--learned-adjacency", type=str2bool, default=True)
    parser.add_argument("--emb-size", type=int, default=10)
    parser.add_argument("--enc-layers", type=int, default=2)
    parser.add_argument("--gnn-layers", type=int, default=2)
    parser.add_argument("--full-graph", type=str2bool, default=False)
    parser.add_argument("--positional-encoding", type=str2bool,
                        default=True)
    parser.add_argument("--activation", type=str, default="silu")
    parser.add_argument("--compute-dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="'bfloat16': run the GatedGN message layers "
                             "in bf16 (f32 parameters and neighbour sums)")
    parser.add_argument("--gn-aggregation", type=str, default="edges",
                        choices=("edges", "ell", "dense"),
                        help="GatedGN message aggregation for full-graph "
                             "batches: 'edges' = gather and index_add_ "
                             "over the edge list; 'ell' = the padded "
                             "incoming layout (kernel K4); 'dense' = "
                             "all-pairs messages masked by the dense "
                             "adjacency (kernel K3). Subgraph batches "
                             "always use their edge list.")
    parser.add_argument("--max-edges", type=int, default=None)
    parser.add_argument("--cut-edges-uniformly", type=str2bool,
                        default=True)
    parser.add_argument("--num-subgraph-nodes", type=int, default=None)
    parser.add_argument("--subgraph-k", type=int, default=2)
    parser.add_argument("--data-sharding", type=str, default="none",
                        choices=("none", "batch"),
                        help="'batch': data-parallel training over the "
                             "process group's ranks, each batch split")
    return parser


def input_size(ds, u_size: int) -> int:
    """The channels a step of ``x`` carries, exogenous ones included."""
    return int(ds.gather_batch(np.array([0]))["x"].shape[-1]) + u_size


def gn_static(args, g, device):
    """The GatedGN graph state for full-graph batches by
    ``--gn-aggregation``: ``(static_batch, band)``. The ELL table, the
    dense mask (scattered on ``device``) with its band windows, or the edge
    list."""
    agg = args.gn_aggregation
    if agg == "ell":
        return {"gn_neigh": padded_incoming(g)}, None
    if agg == "dense":
        band = auto_band(g)
        if band is not None:
            logger.info(f"gn dense aggregation: band-limited sweep (max "
                        f"window {max(band[1])})")
        return {"gn_adj": dense_adj_mask(g, device=device)}, band
    return {"gn_src": g.src.astype(np.int64),
            "gn_dst": g.dst.astype(np.int64)}, None


def gn_kwargs(batch, band) -> dict:
    """The GatedGN model's graph keywords from a placed batch's static
    state (none: the model builds the all-pairs edge list)."""
    if "gn_adj" in batch:
        return {"adj": batch["gn_adj"], "adj_band": band}
    if "gn_neigh" in batch:
        return {"neigh": batch["gn_neigh"]}
    if "gn_src" in batch:
        return {"src": batch["gn_src"], "dst": batch["gn_dst"]}
    return {}


def diffusion_kwargs(name: str, batch, training: bool) -> dict:
    """DCRNN's and GraphWaveNet's keywords from a placed batch: ``u``, and
    ``node_index`` for GraphWaveNet's learned adjacency."""
    kwargs = {"u": batch.get("u"), "training": training}
    if name == "gwnet":
        kwargs["node_index"] = batch.get("node_index")
    return kwargs


def build_model_and_forward(args, ds, u_size, device=None):
    """``(model, to_call, static_batch)``: the model, its call from a batch
    (None: the Predictor's default) and the graph state merged into every
    batch (moved to the device once by the Predictor)."""
    name = args.model_name
    if name not in _PORTED:
        raise ValueError(f"Model {name} not available.")
    cls = get_model_class(name)
    horizon = ds.windowing.horizon_steps
    if name in ("transformer", "tcn"):
        model = cls(input_size=input_size(ds, u_size),
                    hidden_size=args.hidden_size, ff_size=args.ff_size,
                    output_size=ds.n_channels, horizon=horizon,
                    n_layers=args.n_layers, dropout=args.dropout)
        return model, None, None
    if name in ("rnn", "fc_rnn"):
        rnn = dict(output_size=ds.n_channels, horizon=horizon,
                   hidden_size=args.hidden_size, ff_size=args.ff_size,
                   rec_layers=args.rec_layers, ff_layers=args.ff_layers,
                   cell_type=args.cell_type, dropout=args.ff_dropout)
        model = RNNModel(input_size(ds, u_size), **rnn) if name == "rnn" \
            else FCRNNModel(ds.n_nodes * input_size(ds, u_size),
                            ds.n_nodes, **rnn)
        return model, None, None
    if name in ("dcrnn", "gwnet"):
        if name == "dcrnn":
            # the encoder conditions x on u: input_size counts x alone
            model = DCRNNModel(input_size(ds, 0), args.hidden_size,
                               args.ff_size, ds.n_channels, horizon,
                               n_layers=args.n_layers, exog_size=u_size,
                               kernel_size=args.kernel_size,
                               dropout=args.dropout)
        else:
            model = GraphWaveNetModel(
                input_size(ds, u_size), args.hidden_size, args.ff_size,
                ds.n_channels, horizon, n_layers=args.n_layers,
                temporal_kernel_size=args.temporal_kernel_size,
                spatial_kernel_size=args.spatial_kernel_size,
                learned_adjacency=args.learned_adjacency,
                n_nodes=ds.n_nodes, emb_size=args.emb_size,
                dilation=args.dilation, dilation_mod=args.dilation_mod,
                norm=args.norm, dropout=args.dropout)

        def diffusion_call(batch, training):
            return (batch["x"], batch["supports"]), diffusion_kwargs(
                name, batch, training)
        return model, diffusion_call, {
            "supports": diff_conv_support(ds.graph, device=device)}
    if name in ("stcn", "rnn2gcn"):
        if name == "stcn":
            model = cls(input_size(ds, u_size), args.hidden_size,
                        args.ff_size, ds.n_channels, horizon,
                        n_layers=args.n_layers, dropout=args.dropout)
        else:
            model = cls(input_size(ds, u_size), args.hidden_size,
                        ds.n_channels, horizon, rec_layers=args.rec_layers,
                        gcn_layers=args.n_layers, dropout=args.dropout)

        def graph_conv_call(batch, training):
            return (batch["x"], batch["op"]), {"u": batch.get("u"),
                                               "training": training}
        return model, graph_conv_call, {"op": build_operator(
            normalize_adj(ds.graph, "row"), device=device)}
    model = cls(input_size=input_size(ds, u_size),
                input_window_size=args.window,
                hidden_size=args.hidden_size, output_size=ds.n_channels,
                horizon=ds.windowing.horizon_steps, n_nodes=ds.n_nodes,
                enc_layers=args.enc_layers, gnn_layers=args.gnn_layers,
                positional_encoding=args.positional_encoding,
                activation=args.activation,
                compute_dtype=getattr(args, "compute_dtype", None))
    static, band = {}, None
    if args.full_graph:
        if args.gn_aggregation == "ell":
            warnings.warn("--full-graph honors only --gn-aggregation dense; "
                          "'ell' falls back to the generated all-pairs "
                          "edge list", stacklevel=2)
        if args.gn_aggregation == "dense":   # every pair, as one mask
            static["gn_adj"] = torch.ones((ds.n_nodes, ds.n_nodes),
                                          dtype=torch.uint8, device=device)
    else:
        static, band = gn_static(args, ds.graph, device)

    def to_call(batch, training):
        return (batch["x"],), {
            "u": batch.get("u"), "node_index": batch.get("node_index"),
            "training": training, **gn_kwargs(batch, band)}
    return model, to_call, static


def run_experiment(args):
    device = rank_device(getattr(args, "device", None))
    dataset = get_dataset(args.dataset_name, **dataset_kwargs(args))
    exog = dataset.datetime_encoded("day")
    graph = dataset.get_connectivity(
        threshold=args.adj_threshold, knn=args.adj_knn, include_self=False,
        device=device)
    ds = SpatioTemporalDataset(
        dataset.target, index=dataset.index, mask=dataset.mask,
        graph=graph, covariates={"u": exog},
        windowing=Windowing(window=args.window, horizon=args.horizon,
                            horizon_lag=args.horizon_lag))
    split = get_splitter(args.dataset_name, args.val_len,
                         args.test_len).split(ds)
    ds.fit_scaler(StandardScaler(axis=(0, 1)),
                  step_index=ds.indices()[split.train])

    sample = ds.gather_batch(np.array([0]))
    u_size = sample["u"].shape[-1] if "u" in sample else 0
    model, to_call, static = build_model_and_forward(args, ds, u_size,
                                                     device)

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
        batch_to_call=to_call, seed=args.seed, mesh=dp_mesh(args),
        static_batch=static, device=device)

    train_loader = WindowedLoader(ds, split.train,
                                  batch_size=args.batch_size, shuffle=True,
                                  limit_batches=batches_epoch,
                                  seed=args.seed)
    infer_bs = args.batch_inference or args.batch_size
    val_loader = WindowedLoader(ds, split.val, batch_size=infer_bs)
    test_loader = WindowedLoader(ds, split.test, batch_size=infer_bs)
    predictor.fit(train_loader, val_loader, epochs=args.epochs,
                  patience=args.patience,
                  scaler=ds.scaler_params(device=device),
                  logdir=args.logdir)
    predictor.save(f"{args.logdir}/best.pt")
    results = predictor.evaluate(test_loader, prefix="test_")
    logger.info(f"test: {results}")
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    Experiment(run_experiment, configure_parser()).run()
