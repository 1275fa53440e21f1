"""Baselines on the large-scale datasets: subgraph-sampled training with a
root-only loss, full-graph evaluation.

Counterpart of ``sgp_tpu/exp/run_largescale_baselines.py``: the k-nn graph
(``--adj-knn``; none keeps the whole similarity graph), ``RobustScaler``
on the 10-90 quantile range, training batches from ``SubgraphLoader``
(``--subgraph-k`` > 0: ``--num-subgraph-nodes`` roots, default N / 8 and
at least 256, their k-hop in-neighbourhood padded to 4x the roots' count
and ``--max-edges`` edges) or, for models without a graph, from
``SubsetLoader``; ``Predictor.fit`` with no validation loader (the train
loss is monitored), ``best.pt``, then the test metrics on full-graph
windows. It takes the traffic runner's flags
(``run_traffic_baselines.configure_parser``).

GatedGN trains on each batch's edge list (``index_add_``) and evaluates
through ``--gn-aggregation``: ``ell`` runs kernel K4's forward, ``dense``
kernel K3's, ``edges`` the edge list. DCRNN and GraphWaveNet train on COO
diffusion supports built on the device from each batch's edge arrays
(``diff_conv_support_from_arrays``) and evaluate on the full graph's
``diff_conv_support``. ``--subgraph-k 0`` with a graph model raises: a
node-subset batch with the full graph's edges indexes out of range (the
JAX runner silently computes on clamped indices). ``stcn`` and
``rnn2gcn`` raise with either loader: the JAX runner hands them the full
graph's operator beside subgraph batches, which fails on the node count
unless the padded subgraph holds every node, and then its relabelled
nodes need not be the graph's. ``--data-sharding batch`` trains
data-parallel over the process group's ranks (``Predictor(mesh=)``: each
rank a slice of every batch, the subgraph arrays whole).

Usage::

    python -m sgp_tpu_torch.exp.run_largescale_baselines \\
        --model-name gatedgn --config largescale_100nn/gatedgn_pv.yaml \\
        --dataset-name synthetic --synthetic-nodes 5016 \\
        --synthetic-steps 640 --gn-aggregation ell --epochs 2
    # on the CPU: add --device cpu
"""
from __future__ import annotations

import logging

import numpy as np

from sgp_tpu_torch.data import (RobustScaler, SpatioTemporalDataset,
                                SubgraphLoader, SubsetLoader, WindowedLoader,
                                Windowing)
from sgp_tpu_torch.exp.common import (Experiment, dataset_kwargs, dp_mesh,
                                      get_dataset, get_splitter)
from sgp_tpu_torch.exp.run_traffic_baselines import (
    build_model_and_forward, configure_parser, diffusion_kwargs, gn_kwargs,
    gn_static)
from sgp_tpu_torch.models import diff_conv_support_from_arrays
from sgp_tpu_torch.parallel import rank_device
from sgp_tpu_torch.train import MaskedMetrics, Predictor

logger = logging.getLogger(__name__)

# the models whose forward reads the graph; each needs subgraph batches
GRAPH_MODELS = ("gatedgn", "gatedgn_conv", "dcrnn", "gwnet")


# the models that propagate with the full graph's operator whatever the
# batch (the JAX runner's ``build_model_and_forward`` route)
FULL_GRAPH_MODELS = ("stcn", "rnn2gcn")


def check_loader(args):
    """A graph model on node-subset batches would pair the subset's nodes
    with the full graph's edges, and a model of ``FULL_GRAPH_MODELS`` pairs
    any sampled batch with them: refuse it before anything runs."""
    if args.model_name in FULL_GRAPH_MODELS:
        raise ValueError(
            f"--model-name {args.model_name} propagates with the full "
            f"graph's operator, which does not fit this runner's sampled "
            f"batches (subgraphs or node subsets); train it with "
            f"run_traffic_baselines")
    if args.subgraph_k <= 0 and args.model_name in GRAPH_MODELS:
        raise ValueError(
            f"--subgraph-k {args.subgraph_k} with --model-name "
            f"{args.model_name}: node-subset batches (SubsetLoader) carry "
            f"no edges and the full graph's do not fit them; use "
            f"--subgraph-k > 0")


def build_subgraph_forward(args, ds, u_size, device=None):
    """``(model, to_call, static_batch)``: for the graph models a call that
    takes a subgraph batch's own edges (``sub_src``/``sub_dst``, for DCRNN
    and GraphWaveNet with ``sub_weight`` as COO supports) and a full-graph
    batch's state from ``static_batch`` (GatedGN's ``--gn-aggregation``
    state, the diffusion supports); other models as the traffic runner
    builds them.

    The padding edges (``sub_weight == 0``) are left out of the call. The
    JAX runner passes them with ``edge_mask`` (or, to the supports, with
    weight 0) and adds their zeroed messages into node 0: the same sums,
    but on the card the gather's backward then accumulates every padding
    slot into node 0 one after another (on an NVIDIA H100, 376,696 of the
    501,600 slots of a batch at the 100-nn config's widths: 365 ms of a
    396 ms GatedGN step)."""
    name = args.model_name
    if name in ("dcrnn", "gwnet"):
        model, _, static = build_model_and_forward(args, ds, u_size, device)

        def diffusion_call(batch, training):
            if "sub_src" in batch:
                real = batch["sub_weight"] != 0
                supports = diff_conv_support_from_arrays(
                    batch["sub_src"][real], batch["sub_dst"][real],
                    batch["sub_weight"][real], batch["x"].shape[-2])
            else:
                supports = batch["supports"]
            return (batch["x"], supports), diffusion_kwargs(name, batch,
                                                            training)
        return model, diffusion_call, static
    if name not in ("gatedgn", "gatedgn_conv"):
        return build_model_and_forward(args, ds, u_size, device)
    model, _, _ = build_model_and_forward(args, ds, u_size, device)
    static, band = gn_static(args, ds.graph, device)

    def to_call(batch, training):
        common = {"u": batch.get("u"), "node_index": batch.get("node_index"),
                  "training": training}
        if "sub_src" in batch:
            real = batch["sub_weight"] != 0
            return (batch["x"],), {
                "src": batch["sub_src"][real], "dst": batch["sub_dst"][real],
                "edge_mask": None, **common}
        return (batch["x"],), {"edge_mask": None, **common,
                               **gn_kwargs(batch, band)}
    return model, to_call, static


def run_experiment(args):
    check_loader(args)
    device = rank_device(getattr(args, "device", None))
    dataset = get_dataset(args.dataset_name, **dataset_kwargs(args))
    exog = dataset.datetime_encoded("day")
    graph = dataset.get_connectivity(knn=args.adj_knn, threshold=None,
                                     include_self=False, device=device)
    logger.info(f"graph: {graph.num_nodes} nodes {graph.num_edges} edges")
    ds = SpatioTemporalDataset(
        dataset.target, index=dataset.index, mask=dataset.mask,
        graph=graph, covariates={"u": exog},
        windowing=Windowing(window=args.window, horizon=args.horizon,
                            horizon_lag=args.horizon_lag))
    split = get_splitter(args.dataset_name, args.val_len,
                         args.test_len).split(ds)
    ds.fit_scaler(RobustScaler(axis=(0, 1), quantile_range=(10., 90.)),
                  step_index=ds.indices()[split.train])

    sample = ds.gather_batch(np.array([0]))
    u_size = sample["u"].shape[-1] if "u" in sample else 0
    model, to_call, static = build_subgraph_forward(args, ds, u_size,
                                                    device)

    batches_epoch = args.batches_epoch if args.batches_epoch > 0 else 32
    num_sub = args.num_subgraph_nodes or max(ds.n_nodes // 8, 256)
    if args.subgraph_k > 0 and args.model_name not in ("rnn", "fc_rnn"):
        train_loader = SubgraphLoader(
            ds, split.train, batch_size=args.batch_size,
            num_roots=num_sub, k=args.subgraph_k,
            max_edges=args.max_edges,
            cut_edges_uniformly=args.cut_edges_uniformly,
            pad_nodes=min(4 * num_sub, ds.n_nodes),
            limit_batches=batches_epoch, seed=args.seed)
    else:
        train_loader = SubsetLoader(
            ds, split.train, batch_size=args.batch_size,
            num_nodes=num_sub, limit_batches=batches_epoch,
            seed=args.seed)

    predictor = Predictor(
        model, loss="mae", lr=args.lr, weight_decay=args.l2_reg,
        grad_clip=args.grad_clip_val,
        lr_milestones=args.lr_milestones if args.use_lr_schedule else None,
        lr_gamma=args.lr_gamma, steps_per_epoch=batches_epoch,
        scale_target=args.scale_target, metrics=MaskedMetrics.forecasting(),
        batch_to_call=to_call, seed=args.seed, mesh=dp_mesh(args),
        static_batch=static, device=device)

    infer_bs = args.batch_inference or args.batch_size
    test_loader = WindowedLoader(ds, split.test, batch_size=infer_bs)
    # no validation loader: the train loss picks the best epoch
    predictor.fit(train_loader, None, epochs=args.epochs,
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
