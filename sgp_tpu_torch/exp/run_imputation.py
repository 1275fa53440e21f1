"""Imputation experiment: GRIN, RNNI or BiRNNI on a corrupted series.

Counterpart of ``sgp_tpu/exp/run_imputation.py``, with every flag of its
parser and ``--device``: inject synthetic missingness
(``data/imputation.py::add_missing_values``, at ``--fault-seed``), train
the model on whitened batches (``train/imputer.py``), and score the
reconstruction of the hidden points in raw units (MAE, MSE and MRE at the
evaluation mask). GRIN runs on the diffusion supports of
``diff_conv_support`` built on the run's device (``auto``: dense up to 512
MB, so on the repository's graphs its hops are matrix products; BSR
supports would run kernel K1).

The JAX runner draws its weights, whitening masks and noise states with
``jax.random``; here they come from ``torch.Generator`` s seeded with
``--seed`` (the evaluation's noise states from one seeded with
``--fault-seed`` at every call, so validations compare weights only). The
batches are the same numpy draws in both.

Usage::

    python -m sgp_tpu_torch.exp.run_imputation --dataset-name synthetic \\
        --p-fault 0.0015 --p-noise 0.05 --epochs 20
    # on the CPU: add --device cpu
"""
from __future__ import annotations

import argparse
import copy
import logging
import time

import numpy as np
import torch

from sgp_tpu_torch.data import StandardScaler, Windowing
from sgp_tpu_torch.data.imputation import (ImputationDataset,
                                           add_missing_values)
from sgp_tpu_torch.exp.common import (Experiment, add_common_args,
                                      dataset_kwargs, get_dataset,
                                      get_splitter)
from sgp_tpu_torch.models.graph_layers import diff_conv_support
from sgp_tpu_torch.models.grin import GRINModel
from sgp_tpu_torch.models.rnni import BiRNNImputerModel, RNNImputerModel
from sgp_tpu_torch.train.imputer import (make_imputer_train_step,
                                         split_imputation_output)
from sgp_tpu_torch.train.predictor import lr_boundaries, make_optimizer
from sgp_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def configure_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--model-name", type=str, default="grin",
                        choices=("grin", "rnni", "birnni"))
    parser.add_argument("--hidden-size", type=int, default=64)
    parser.add_argument("--ff-size", type=int, default=64)
    parser.add_argument("--n-layers", type=int, default=1)
    parser.add_argument("--kernel-size", type=int, default=2)
    parser.add_argument("--decoder-order", type=int, default=1)
    parser.add_argument("--merge-mode", type=str, default="mlp")
    # the RNNI family
    parser.add_argument("--cell", type=str, default="gru",
                        choices=("gru", "lstm"))
    parser.add_argument("--concat-mask", type=lambda v: v.lower() != "false",
                        default=True)
    parser.add_argument("--detach-input", action="store_true")
    parser.add_argument("--process-nodes-independently",
                        action="store_true")
    parser.add_argument("--state-init", type=str, default="zero",
                        choices=("zero", "noise"))
    parser.add_argument("--dropout", type=float, default=0.0)
    # the whitened training
    parser.add_argument("--whiten-prob", type=float, default=0.05)
    parser.add_argument("--prediction-loss-weight", type=float,
                        default=1.0)
    parser.add_argument("--warm-up-steps", type=int, default=0)
    # the synthetic missingness
    parser.add_argument("--p-fault", type=float, default=0.0015)
    parser.add_argument("--p-noise", type=float, default=0.05)
    parser.add_argument("--min-seq", type=int, default=1)
    parser.add_argument("--max-seq", type=int, default=10)
    parser.add_argument("--fault-seed", type=int, default=56789)
    return parser


def build_model(args, ds, graph, device):
    """``(model, to_call)``: the model, its weights drawn from ``--seed``,
    on ``device``, and its call from a batch, ``to_call(batch, training,
    generator)`` (``generator``: the RNN imputers' noise states)."""
    gen = torch.Generator().manual_seed(args.seed)
    if args.model_name == "grin":
        supports = diff_conv_support(graph, device=device)
        model = GRINModel(input_size=ds.n_channels,
                          hidden_size=args.hidden_size,
                          ff_size=args.ff_size, n_layers=args.n_layers,
                          n_nodes=ds.n_nodes, kernel_size=args.kernel_size,
                          decoder_order=args.decoder_order,
                          merge_mode=args.merge_mode, generator=gen)

        def to_call(batch, training, generator=None):
            return (batch["x"], supports), {"mask": batch["mask"],
                                            "training": training}
    else:
        kw = dict(input_size=ds.n_channels, hidden_size=args.hidden_size,
                  cell=args.cell, concat_mask=args.concat_mask,
                  n_nodes=ds.n_nodes,
                  process_nodes_independently=(
                      args.process_nodes_independently),
                  detach_input=args.detach_input,
                  state_init=args.state_init, generator=gen)
        if args.model_name == "birnni":
            model = BiRNNImputerModel(dropout=args.dropout, **kw)
        else:
            model = RNNImputerModel(**kw)

        def to_call(batch, training, generator=None):
            return (batch["x"], batch["mask"]), {"training": training,
                                                 "generator": generator}
    return model.to(device), to_call


def run_experiment(args):
    device = resolve_device(getattr(args, "device", None))
    dataset = get_dataset(args.dataset_name, **dataset_kwargs(args))
    graph = dataset.get_connectivity(
        threshold=args.adj_threshold, knn=args.adj_knn, include_self=False,
        device=device)
    ds = ImputationDataset(
        dataset.target, index=dataset.index, mask=dataset.mask, graph=graph,
        windowing=Windowing(window=args.window, horizon=1))
    # the fault pattern is independent of the training seed, so runs with
    # other seeds score the same hidden points
    add_missing_values(ds, p_fault=args.p_fault, p_noise=args.p_noise,
                       min_seq=args.min_seq, max_seq=args.max_seq,
                       seed=args.fault_seed)
    ev = ds.covariates["eval_mask"].value.astype(bool)
    split = get_splitter(args.dataset_name, args.val_len,
                         args.test_len).split(ds)

    # the scaler is fitted on the training mask: the hidden points' values
    # must not reach its statistics
    steps = ds.indices()[split.train]
    scaler = StandardScaler(axis=(0, 1))
    scaler.fit(ds.target[steps], mask=ds.mask[steps] & ~ev[steps])
    sp = scaler.params(device=device)

    def on_device(a, dtype=torch.float32):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    def scaled_batch(items):
        """``ImputationDataset.gather_batch`` with x and y scaled, on the
        device."""
        b = ds.gather_batch(np.asarray(items))
        return {"x": sp.transform(on_device(b["x"])),
                "y": sp.transform(on_device(b["y"])),
                "mask": on_device(b["mask"], torch.bool),
                "eval_mask": on_device(b["eval_mask"], torch.bool)}

    model, to_call = build_model(args, ds, graph, device)
    batches_epoch = (args.batches_epoch if args.batches_epoch > 0
                     else max(1, len(split.train) // args.batch_size))
    boundaries = lr_boundaries(args.lr_milestones, batches_epoch) \
        if args.use_lr_schedule else []
    optimizer, scheduler = make_optimizer(list(model.parameters()), args.lr,
                                          args.l2_reg, boundaries,
                                          args.lr_gamma)
    train_gen = torch.Generator(device=device).manual_seed(args.seed)
    step = make_imputer_train_step(
        model, optimizer, lambda b, tr: to_call(b, tr, train_gen),
        whiten_prob=args.whiten_prob,
        prediction_loss_weight=args.prediction_loss_weight,
        warm_up=args.warm_up_steps, grad_clip=args.grad_clip_val,
        scheduler=scheduler, generator=train_gen)

    @torch.no_grad()
    def infer(x_scaled, train_mask):
        model.eval()
        gen = torch.Generator(device=device).manual_seed(args.fault_seed)
        x_in = torch.where(train_mask, x_scaled, 0.0)
        iargs, ikwargs = to_call({"x": x_in, "mask": train_mask}, False, gen)
        merged, _ = split_imputation_output(model(*iargs, **ikwargs))
        return sp.inverse_transform(merged)

    def evaluate(items):
        """Reconstruction error at the hidden (eval-mask) points, raw
        units."""
        abs_s = sq_s = ref_s = cnt = 0.0
        bs = args.batch_inference or args.batch_size
        for lo in range(0, len(items), bs):
            b = ds.gather_batch(np.asarray(items[lo:lo + bs]))
            x_raw, e = b["y"], b["eval_mask"]
            y_hat = infer(sp.transform(on_device(b["x"])),
                          on_device(b["mask"], torch.bool)).cpu().numpy()
            err = np.where(e, y_hat - x_raw, 0.0)
            abs_s += np.abs(err).sum()
            sq_s += (err ** 2).sum()
            ref_s += np.abs(np.where(e, x_raw, 0.0)).sum()
            cnt += e.sum()
        cnt = max(cnt, 1.0)
        return {"mae": abs_s / cnt, "mse": sq_s / cnt,
                "mre": abs_s / max(ref_s, 1e-8)}

    rng = np.random.default_rng(args.seed)
    best = {"val_mae": np.inf, "state": copy.deepcopy(model.state_dict())}
    bad_epochs = 0
    for epoch in range(args.epochs):
        t_epoch = time.time()
        losses = []
        for _ in range(batches_epoch):
            batch = scaled_batch(rng.choice(split.train, args.batch_size))
            losses.append(float(step(batch)))
        val = evaluate(split.val)
        logger.info(f"epoch {epoch}: loss={np.mean(losses):.4f} "
                    f"val_mae={val['mae']:.4f} "
                    f"({time.time() - t_epoch:.1f}s)")
        if val["mae"] < best["val_mae"]:
            best = {"val_mae": val["mae"],
                    "state": copy.deepcopy(model.state_dict())}
            bad_epochs = 0
        else:
            bad_epochs += 1
            if bad_epochs >= args.patience:
                logger.info(f"early stop at epoch {epoch}")
                break

    model.load_state_dict(best["state"])
    test = evaluate(split.test)
    results = {f"test_{k}": float(v) for k, v in test.items()}
    results["val_mae"] = float(best["val_mae"])
    logger.info(f"test: {results}")
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    Experiment(run_experiment, configure_parser()).run()
