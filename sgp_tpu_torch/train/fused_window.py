"""Fused full-graph windowed training and evaluation.

Counterpart of ``sgp_tpu/train/fused_window.py``. Training: a step samples
window starts, gathers the windows ``x [B, W, N, C]`` and their horizon
targets and masks from arrays on the device, appends the support
propagations, and runs the forward, the masked loss, the backward and the
optimizer update, with nothing read back to the host; a call runs
``steps_per_call`` steps (the JAX package's ``lax.scan``, a Python loop
here) and returns their mean loss as a device tensor. Sampling draws from
an explicit ``torch.Generator`` on the data's device; its stream is not
JAX's, so the parity tests feed ``step.train_on`` the JAX package's draws.

Evaluation: masked metrics accumulate on the device over a loop of
batches; the host reads them once at the end. Items are padded to a
multiple of the batch size and the padded slots drop out of every mask.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.train.metrics import (_METRIC_FNS, MaskedMetrics,
                                         _masked_reduce)
from sgp_tpu_torch.train.predictor import apply_gradients


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


def make_fused_window_step(model, optimizer,
                           x_full: torch.Tensor,       # [T, N, Cin]
                           target: torch.Tensor,       # [T, N, C]
                           mask: torch.Tensor,         # [T, N, C] bool
                           item_starts,                # [S]
                           window_offsets,             # [W]
                           horizon_offsets,            # [H]
                           scaler: ScalerParams,
                           u: Optional[torch.Tensor] = None,  # [T, (N,) F]
                           support_ops=None,
                           batch_size: int = 64,
                           loss: str = "mae",
                           scale_target: bool = False,
                           steps_per_call: int = 1,
                           grad_clip: float = 5.0,
                           scheduler=None) -> Callable:
    """Build ``step(generator) -> mean loss`` over ``steps_per_call``
    steps, each on ``batch_size`` window starts drawn uniformly with
    replacement from ``item_starts``. A step appends ``op @ x`` for each
    of ``support_ops``, takes the masked loss (on the inverse-scaled
    output, or against the scaled target with ``scale_target``) and
    updates ``model``'s parameters in place through
    :func:`~sgp_tpu_torch.train.predictor.apply_gradients` (zero
    gradients for unreached parameters, the clip by global norm at
    ``grad_clip``, ``optimizer.step()``, ``scheduler.step()``): the JAX
    step's optax chain. ``step.train_on(items)`` takes one step on given
    window starts, ``step.sums_on(items)`` gives the masked loss's sum and
    count before the division; features reach the model as f32."""
    loss_pt = _METRIC_FNS[loss]
    device = x_full.device
    starts = torch.as_tensor(np.asarray(item_starts), device=device)
    gw = make_offset_gather(window_offsets)
    gh = make_offset_gather(horizon_offsets)

    def sums_on(items):
        """The masked loss's ``(sum, count)`` on window starts ``items``."""
        x = gw(x_full, items).float()                 # [B, W, N, Cin]
        if support_ops is not None:
            x = torch.cat([x] + [op @ x for op in support_ops], dim=-1)
        y, m = gh(target, items), gh(mask, items)
        kwargs = {} if u is None else {"u": gw(u, items)}
        model.train(True)
        y_hat = model(x, training=True, **kwargs)
        if scale_target:
            y_ref = scaler.transform(y)
        else:
            y_hat, y_ref = scaler.inverse_transform(y_hat), y
        return _masked_reduce(loss_pt, y_hat, y_ref, m)

    def loss_on(items):
        v, cnt = sums_on(items)
        return v / torch.clamp(cnt, min=1.0)

    def train_on(items):
        optimizer.zero_grad(set_to_none=True)
        loss_val = loss_on(torch.as_tensor(items, device=device))
        loss_val.backward()
        apply_gradients(model, optimizer, grad_clip, scheduler)
        return loss_val.detach()

    def sample(generator: torch.Generator):
        return starts[torch.randint(len(starts), (batch_size,),
                                    generator=generator, device=device)]

    def step(generator: torch.Generator):
        return torch.stack([train_on(sample(generator))
                            for _ in range(steps_per_call)]).mean()

    step.train_on = train_on
    step.sample = sample
    step.sums_on = sums_on
    return step


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
    on the device), appends ``op @ x`` for each of ``support_ops`` in x's
    dtype, as the JAX package does (a bf16 embedding gives bf16 hops), runs
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
            if support_ops is not None:
                # in x's dtype: a bf16 embedding gives bf16 hops
                x = torch.cat([x] + [op @ x for op in support_ops], dim=-1)
            x = x.float()
            y = gh(target, items)
            m = gh(mask, items) & ok[:, None, None, None]
            kwargs = {} if u is None else {"u": gw(u, items)}
            y_hat = scaler.inverse_transform(
                model(x, training=False, **kwargs))
            state = metrics.update(state, y_hat, y, m)
        return metrics.compute(state)

    return eval_fn
