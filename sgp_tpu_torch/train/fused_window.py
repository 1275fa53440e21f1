"""Fused full-graph evaluation over windows.

Counterpart of the evaluation half of ``sgp_tpu/train/fused_window.py``:
every eval window's features, horizon targets and masks are gathered from
arrays on the device, the model runs, and masked metrics accumulate on the
device over a loop of batches; the host reads them once at the end. Items
are padded to a multiple of the batch size and the padded slots drop out
of every mask. The fused windowed training step of the JAX module is not
ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.train.metrics import MaskedMetrics


def gather_steps(arr: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """``arr[steps]`` for a step-index matrix ``[B, W]``: ``[B, W, ...]``."""
    return arr[steps]


def make_offset_gather(offsets) -> Callable:
    """``g(arr, items) -> arr[items[:, None] + offsets]``, ``[B, W, ...]``
    for a fixed offset vector."""
    off = torch.as_tensor(np.asarray(offsets))

    def g(arr, items):
        return gather_steps(arr, items[:, None] + off.to(items.device))
    return g


def pad_eval_items(item_starts, batch_size: int, device=None):
    """Pad eval window starts to a multiple of ``batch_size``: ``(starts
    [n_batches, B], valid [n_batches, B])``, padded slots ``valid=False``
    (they repeat the first start)."""
    item_starts = np.asarray(item_starts)
    s = len(item_starts)
    n_batches = -(-s // batch_size)
    pad = n_batches * batch_size - s
    starts = np.concatenate(
        [item_starts, np.full(pad, item_starts[0] if s else 0,
                              item_starts.dtype)])
    valid = np.concatenate([np.ones(s, bool), np.zeros(pad, bool)])
    return (torch.as_tensor(starts, device=device).reshape(n_batches,
                                                           batch_size),
            torch.as_tensor(valid, device=device).reshape(n_batches,
                                                          batch_size))


def make_fused_eval(model, x_full, target, mask, item_starts,
                    window_offsets, horizon_offsets, scaler: ScalerParams,
                    metrics: MaskedMetrics, u=None, support_ops=None,
                    batch_size: int = 64,
                    x_slice: Optional[int] = None) -> Callable:
    """Build ``eval_fn() -> {metric: float}`` over every item of
    ``item_starts``, with the model's current weights, in eval mode and
    without autograd.

    Each batch gathers the windows ``x [B, W, N, C]`` (with ``x_slice``,
    only the first ``x_slice`` lanes: ``x_full`` is then the packed row
    layout of ``train/iid.py::pack_iid_data``, so that only it has to stay
    on the device), appends ``op @ x`` for each of ``support_ops``, runs
    ``model(x, u=u, training=False)``, inverse-scales and accumulates.
    Features reach the model as f32."""
    device = x_full.device
    starts, valid = pad_eval_items(item_starts, batch_size, device)
    gw = make_offset_gather(window_offsets)
    gh = make_offset_gather(horizon_offsets)

    @torch.no_grad()
    def eval_fn():
        model.eval()
        state = metrics.init()
        for items, ok in zip(starts, valid):
            x = gw(x_full, items)                       # [B, W, N, C]
            if x_slice is not None:
                x = x[..., :x_slice]
            x = x.float()
            if support_ops is not None:
                x = torch.cat([x] + [op @ x for op in support_ops], dim=-1)
            y = gh(target, items)
            m = gh(mask, items) & ok[:, None, None, None]
            kwargs = {} if u is None else {"u": gw(u, items)}
            y_hat = scaler.inverse_transform(
                model(x, training=False, **kwargs))
            state = metrics.update(state, y_hat, y, m)
        return metrics.compute(state)

    return eval_fn
