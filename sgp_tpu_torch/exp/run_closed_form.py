"""DynGESN with closed-form ridge readouts.

Counterpart of ``sgp_tpu/exp/run_closed_form.py``: GESN-encode the whole
series, then one ridge solve per horizon lag on the flattened (step, node)
design matrix ``[scaled data, encoding]``, all lags sharing one Gram
(``train/ridge.py``), with masked metrics per lag and over all lags.

Routes, as in the JAX runner:

- the host route (default): the encoding comes to the host, the design
  matrix of the training windows goes to the device once, and the
  evaluation predicts each lag on the device;
- ``--device-resident true``: the encoding stays on the device in bf16
  (``encode_dataset(device_resident=True)``), the Gram and the per-lag
  moments accumulate by chunks of steps
  (``closed_form_readout_streaming``), and the evaluation runs in chunks
  of 256 steps with all lags in one ``einsum``.

The recurrence's operator follows ``operator_mode`` (``auto``: dense at
traffic sizes); ``operator_mode = "bsr"`` set on the parsed namespace
reaches :class:`~sgp_tpu_torch.encode.GESNEncoder` and runs each
layer-step's product over the nodes through the block-sparse kernel.

Usage::

    python -m sgp_tpu_torch.exp.run_closed_form \\
        --config traffic/gesn_la.yaml --dataset-name synthetic \\
        --synthetic-nodes 207
    # on the CPU: add --device cpu
"""
from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from sgp_tpu_torch.data import SpatioTemporalDataset, StandardScaler, Windowing
from sgp_tpu_torch.encode import GESNEncoder, encode_dataset
from sgp_tpu_torch.exp.common import (Experiment, add_common_args,
                                      dataset_kwargs, filter_kwargs,
                                      get_dataset, get_splitter, str2bool)
from sgp_tpu_torch.train.metrics import (masked_mape, masked_mse,
                                         numpy_masked_mae, numpy_metric)
from sgp_tpu_torch.train.ridge import (closed_form_readout,
                                       closed_form_readout_streaming,
                                       gather_feat_parts)
from sgp_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

EVAL_CHUNK = 256   # steps an evaluation chunk of the device-resident route


def configure_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--model-name", type=str, default="gesn")
    parser.add_argument("--encoder-name", type=str, default="gesn")
    parser.add_argument("--preprocess-exogenous", type=str2bool,
                        default=True)
    parser.add_argument("--reservoir-size", type=int, default=32)
    parser.add_argument("--reservoir-layers", type=int, default=1)
    parser.add_argument("--leaking-rate", type=float, default=0.9)
    parser.add_argument("--spectral-radius", type=float, default=0.9)
    parser.add_argument("--density", type=float, default=0.9)
    parser.add_argument("--input-scaling", type=float, default=1.0)
    parser.add_argument("--alpha-decay", type=str2bool, default=False)
    parser.add_argument("--reservoir-activation", type=str, default="tanh")
    parser.add_argument("--device-resident", type=str2bool, default=False,
                        help="keep the encoding on the device and solve "
                             "the ridge from Gram and moments accumulated "
                             "by chunks (for encodings too large to move "
                             "to the host)")
    return parser


def run_experiment(args):
    device = resolve_device(getattr(args, "device", None))
    dataset = get_dataset(args.dataset_name, **dataset_kwargs(args))
    exog = dataset.datetime_encoded("day")
    graph = dataset.get_connectivity(
        threshold=args.adj_threshold, knn=args.adj_knn, include_self=False,
        device=device)
    ds = SpatioTemporalDataset(
        dataset.target, index=dataset.index, mask=dataset.mask,
        graph=graph, covariates={"u": exog},
        windowing=Windowing(window=args.window, horizon=args.horizon))
    split = get_splitter(args.dataset_name, args.val_len,
                         args.test_len).split(ds)
    ds.fit_scaler(StandardScaler(axis=(0, 1)),
                  step_index=ds.indices()[split.train])

    input_size = ds.n_channels + (exog.shape[-1]
                                  if args.preprocess_exogenous else 0)
    encoder = GESNEncoder(**filter_kwargs(GESNEncoder.__init__, {
        **vars(args), "input_size": input_size, "seed": args.seed,
        "device": device}))
    encode_dataset(ds, encoder, encode_exogenous=args.preprocess_exogenous,
                   keep_raw=False, device_resident=args.device_resident,
                   store_dtype="bfloat16" if args.device_resident else None,
                   device=device)
    if args.device_resident:
        return _run_streaming(args, ds, split, device)

    # the design matrix [scaled data, encoding] over (step, node); the
    # dataset's windows already keep start + horizon < T
    horizon = args.horizon
    scaled = ds.target_scaled
    feats = np.concatenate([scaled, ds.covariates["encoded_x"].value], -1)
    d = feats.shape[-1]
    train_w = ds.indices()[split.train]
    solutions = closed_form_readout(
        feats[train_w].reshape(-1, d),
        [scaled[train_w + lag].reshape(-1, ds.n_channels)
         for lag in range(1, horizon + 1)], alpha=args.l2_reg,
        device=device)

    scaler = ds.scalers["target"]
    results = {}
    for name, items in (("val", split.val), ("test", split.test)):
        if not len(items):
            continue
        w_steps = ds.indices()[items]
        x_eval = torch.as_tensor(feats[w_steps].reshape(-1, d),
                                 device=device)
        y_hat_lags, y_lags, m_lags = [], [], []
        for lag, (w, b) in enumerate(solutions, start=1):
            pred = (x_eval @ w + b).cpu().numpy().reshape(
                len(w_steps), ds.n_nodes, ds.n_channels)
            pred = scaler.inverse_transform(pred)
            y_true = ds.target[w_steps + lag]
            m = ds.mask[w_steps + lag]
            y_hat_lags.append(pred)
            y_lags.append(y_true)
            m_lags.append(m)
            logger.info(f"{name}_mae_at_lag{lag}: "
                        f"{numpy_masked_mae(pred, y_true, m):.4f}")
        y_hat = np.stack(y_hat_lags, 1)
        y = np.stack(y_lags, 1)
        m = np.stack(m_lags, 1)
        results[f"{name}_mae"] = numpy_masked_mae(y_hat, y, m)
        results[f"{name}_mse"] = numpy_metric(masked_mse, y_hat, y, m)
        results[f"{name}_mape"] = numpy_metric(masked_mape, y_hat, y, m)
    logger.info(f"results: {results}")
    return results


def _run_streaming(args, ds, split, device):
    """The device-resident closed form: the encoding stays on the device,
    the Gram and moments and the evaluation's predictions run by chunks;
    the evaluation stacks all lag readouts into one einsum a chunk."""
    horizon = args.horizon
    scaled = torch.as_tensor(ds.target_scaled, dtype=torch.float32,
                             device=device)
    feat_parts = [scaled, ds.covariates["encoded_x"].value]
    solutions = closed_form_readout_streaming(
        feat_parts, scaled, ds.indices()[split.train], horizon,
        alpha=args.l2_reg)
    w_all = torch.stack([w for w, _ in solutions])        # [H, D, C]
    b_all = torch.stack([b for _, b in solutions])        # [H, C]

    scaler = ds.scalers["target"]
    results = {}
    for name, items in (("val", split.val), ("test", split.test)):
        if not len(items):
            continue
        w_steps = ds.indices()[items]
        sums = np.zeros(4)  # [abs_err, sq_err, ape, count]
        for s in range(0, len(w_steps), EVAL_CHUNK):
            steps = w_steps[s:s + EVAL_CHUNK]
            f = gather_feat_parts(feat_parts, steps)
            f2 = f.reshape(-1, f.shape[-1])
            preds = (torch.einsum("nd,hdc->hnc", f2, w_all)
                     + b_all[:, None, :]).cpu().numpy()
            preds = scaler.inverse_transform(preds.reshape(
                horizon, len(steps), ds.n_nodes, ds.n_channels))
            for lag in range(1, horizon + 1):
                y = ds.target[steps + lag]
                mval = ds.mask[steps + lag].astype(bool)
                err = preds[lag - 1] - y
                sums += (np.abs(err)[mval].sum(),
                         (err ** 2)[mval].sum(),
                         np.abs(err / np.where(y == 0, np.inf, y)
                                )[mval].sum(),
                         mval.sum())
        cnt = max(sums[3], 1)
        results[f"{name}_mae"] = float(sums[0] / cnt)
        results[f"{name}_mse"] = float(sums[1] / cnt)
        results[f"{name}_mape"] = float(sums[2] / cnt)
    logger.info(f"results: {results}")
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    Experiment(run_experiment, configure_parser()).run()
