"""Multi-trial fused IID training: K decoder trials on shared batches.

Counterpart of ``sgp_tpu/train/multi_trial.py``: K trials of one decoder
(the same shapes; their init seed and learning rate differ) train on the
same sampled batches. The sampling and the row gather run once a step;
the forward, the backward, the clip and Adam run over the stacked trials
through ``torch.func.vmap``. Sharing batches also pairs the trials'
comparisons. Axes that change parameter shapes are not searched here.

The trials' parameters are a dict of stacked tensors, the layout of
``torch.func.stack_module_state`` (each with a leading ``[K]`` axis).
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.train.iid import _build_iid_sample_and_loss

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # optax.scale_by_adam


def stack_trials(models: Sequence[torch.nn.Module]) -> Dict[str, torch.Tensor]:
    """The models' parameters stacked along a leading trial axis, as plain
    tensors (no autograd)."""
    params, _ = torch.func.stack_module_state(list(models))
    return {k: v.detach() for k, v in params.items()}


def init_trial_params(make_model: Callable, seeds: Sequence[int]
                      ) -> Dict[str, torch.Tensor]:
    """Stacked per-trial parameters: ``make_model(generator)`` builds each
    trial's model, its weights drawn from ``torch.Generator().manual_seed(
    seed)`` (flax's distributions, not its bits)."""
    return stack_trials([make_model(torch.Generator().manual_seed(int(s)))
                         for s in seeds])


def make_fused_iid_multi_trial_step(model, encoded, target, mask,
                                    valid_starts, horizon_offsets,
                                    scaler: ScalerParams, lrs,
                                    u=None, batch_size: int = 4096,
                                    grad_clip: float = 5.0,
                                    loss: str = "mae",
                                    scale_target: bool = False,
                                    steps_per_call: int = 1,
                                    packed=False, compute_dtype=None,
                                    gather_block: int = 1) -> Callable:
    """Build ``step(params, opt_state, generator) -> (params, opt_state,
    losses [K])``, training all K trials (``lrs [K]``) on the same sampled
    batches, ``steps_per_call`` steps a call; ``losses`` are each trial's
    mean over the call, a device tensor. ``model`` gives the trials'
    architecture (its own weights are not read). Each trial's update is
    the single-trial runner's chain: the clip by global norm at
    ``grad_clip`` (no epsilon), then Adam (optax's ``scale_by_adam``: b1
    0.9, b2 0.999, eps 1e-8 outside the root) scaled by ``-lr_k``, written
    as tensor ops on the stacked state. New tensors are returned; the
    inputs are not changed.

    ``step.init_opt(params)`` builds the stacked optimizer state and
    ``step.train_on(params, opt_state, t, n)`` takes one step on given
    draws. The sampling, the gather, ``packed``, ``compute_dtype`` and
    ``gather_block`` are :func:`~sgp_tpu_torch.train.iid.
    _build_iid_sample_and_loss`'s; the gathered rows are shared by all
    trials. Dropout draws the same mask for every trial (``randomness=
    "same"``: the JAX package passes each trial the same key)."""
    data, snl = _build_iid_sample_and_loss(
        model, encoded, target, mask, valid_starts, horizon_offsets,
        scaler, u=u, batch_size=batch_size, loss=loss,
        scale_target=scale_target, packed=packed,
        compute_dtype=compute_dtype, gather_block=gather_block)
    device = data[0].device
    lr = torch.as_tensor(np.asarray(lrs, np.float32), device=device)
    grad_and_loss = torch.func.vmap(
        torch.func.grad_and_value(lambda p, sampled: snl.loss_on(sampled, p)),
        in_dims=(0, None), randomness="same")

    def per_trial(v: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        """A ``[K]`` vector shaped to broadcast against ``ref``."""
        return v.reshape((-1,) + (1,) * (ref.ndim - 1))

    def train_on(params, opt_state, t, n):
        grads, losses = grad_and_loss(params, snl.gather(t, n))
        with torch.no_grad():
            sq = sum((g.float() ** 2).reshape(len(lr), -1).sum(1)
                     for g in grads.values())
            norm = torch.sqrt(sq)                          # [K]
            keep = norm < grad_clip
            count = opt_state["count"] + 1
            c1 = 1 - ADAM_B1 ** count.float()
            c2 = 1 - ADAM_B2 ** count.float()
            new_p, mu, nu = {}, {}, {}
            for k, g in grads.items():
                g = torch.where(per_trial(keep, g), g,
                                g / per_trial(norm, g) * grad_clip)
                mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * opt_state["mu"][k]
                nu[k] = (1 - ADAM_B2) * g * g + ADAM_B2 * opt_state["nu"][k]
                update = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
                new_p[k] = params[k] - per_trial(lr, g) * update
        return new_p, {"mu": mu, "nu": nu, "count": count}, losses.detach()

    def step(params, opt_state, generator: torch.Generator):
        losses = []
        for _ in range(max(steps_per_call, 1)):
            params, opt_state, loss_k = train_on(
                params, opt_state, *snl.sample(generator))
            losses.append(loss_k)
        return params, opt_state, torch.stack(losses).mean(0)

    def init_opt(params):
        return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()},
                "count": torch.zeros((), dtype=torch.int64, device=device)}

    step.init_opt = init_opt
    step.train_on = train_on
    step.sample_and_loss = snl
    step.data = data
    return step


def take_trial(params: Dict[str, torch.Tensor], k: int
               ) -> Dict[str, torch.Tensor]:
    """A copy of trial ``k``'s parameters from the stacked dict."""
    return {name: v[k].clone() for name, v in params.items()}


def load_trial(model: torch.nn.Module, params: Dict[str, torch.Tensor],
               k: int) -> torch.nn.Module:
    """Copy trial ``k``'s parameters into ``model`` in place."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name][k])
    return model


def eval_trials(eval_fn, model: torch.nn.Module,
                params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Each trial through one ``make_fused_eval`` callable built on
    ``model``: its weights are set to each trial's in turn and restored
    after. Per-trial metrics come from the suite's own ``compute``, as in
    single-trial evaluation. Returns ``{metric: np.ndarray [K]}``."""
    saved = copy.deepcopy(model.state_dict())
    per: List[dict] = []
    try:
        for k in range(next(iter(params.values())).shape[0]):
            load_trial(model, params, k)
            per.append(eval_fn())
    finally:
        model.load_state_dict(saved)
    return {name: np.asarray([p[name] for p in per]) for name in per[0]}


def best_trial(metrics_per_trial: dict, monitor: str = "mae",
               minimize: bool = True) -> int:
    vals = np.asarray(metrics_per_trial[monitor])
    return int(np.argmin(vals) if minimize else np.argmax(vals))
