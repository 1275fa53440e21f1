"""Imputation training engine.

Counterpart of ``sgp_tpu/train/imputer.py`` (``tsl``'s ``imputer.py``):
trains an imputation model (:class:`~sgp_tpu_torch.models.grin.GRINModel`,
the RNN imputers) on whitened batches. A random part of the observed
points is hidden at each step, and the loss is taken on those and on the
synthetic evaluation mask; window edges can be left out of the loss
(``warm_up``), and every auxiliary output the model returns adds its loss
with ``prediction_loss_weight``.

The JAX step draws its whitening mask with ``jax.random``, which torch
cannot reproduce: here it comes from an explicit ``torch.Generator``
(:func:`draw_keep`), and :func:`imputer_loss` takes the mask as an
argument, so a caller can hand it one.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from sgp_tpu_torch.train.metrics import _abs_err, _masked_reduce
from sgp_tpu_torch.train.predictor import apply_gradients


def split_imputation_output(out):
    """An imputation model's output as ``(merged, aux_predictions)``: a
    bare tensor (RNNI) has no auxiliary outputs; a tuple's first element
    is the merged imputation and every tensor in the rest is one (GRIN
    returns ``(merged, (imp_f, pred_f), (imp_b, pred_b))``, BiRNNI
    ``(merged, (fwd, bwd))``)."""
    if isinstance(out, (tuple, list)):
        return out[0], _leaves(out[1:])
    return out, []


def _leaves(v) -> list:
    if isinstance(v, (tuple, list)):
        return [leaf for part in v for leaf in _leaves(part)]
    return [] if v is None else [v]


def draw_keep(mask: torch.Tensor, whiten_prob: float,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The whitening draw: True where an observed point stays visible
    (a uniform draw above ``whiten_prob``), on the mask's device."""
    return torch.rand(mask.shape, generator=generator,
                      device=mask.device) > whiten_prob


def imputer_loss(model, batch: dict, batch_to_call: Callable,
                 keep: torch.Tensor, prediction_loss_weight: float = 1.0,
                 warm_up: int = 0) -> torch.Tensor:
    """The whitened loss of a batch (``x``, ``mask``, optionally ``y``
    and ``eval_mask``; see ``data/imputation.py``) with the visible points
    ``keep``: the model sees ``x`` at ``mask & keep``; the masked MAE of
    the merged imputation and, weighted, of every auxiliary output is
    taken at the whitened points and at the hidden ones
    (``~mask & eval_mask``), each over its count, steps before ``warm_up``
    left out."""
    x, mask = batch["x"], batch["mask"].bool()
    train_mask = mask & keep
    batch_in = dict(batch)
    batch_in["x"] = torch.where(train_mask, x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
    batch_in["mask"] = train_mask
    args, kwargs = batch_to_call(batch_in, True)
    merged, aux = split_imputation_output(model(*args, **kwargs))
    # ground truth: the raw window (x is zeroed at eval_mask points)
    y = batch.get("y", x)
    lm = mask & ~keep
    if batch.get("eval_mask") is not None:
        lm = lm | (~mask & batch["eval_mask"].bool())

    def trimmed(v):
        return v[:, warm_up:] if warm_up else v

    total = 0.0
    for pred, w in [(merged, 1.0)] + [(p, prediction_loss_weight)
                                      for p in aux]:
        v, n = _masked_reduce(_abs_err, trimmed(pred), trimmed(y),
                              trimmed(lm))
        total = total + w * v / torch.clamp(n, min=1.0)
    return total


def make_imputer_train_step(model, optimizer, batch_to_call: Callable,
                            whiten_prob: float = 0.05,
                            prediction_loss_weight: float = 1.0,
                            warm_up: int = 0, grad_clip: float = 5.0,
                            scheduler=None,
                            generator: Optional[torch.Generator] = None):
    """``step(batch, keep=None) -> loss``: one update on a placed batch.
    The whitening mask is ``keep`` when given, else :func:`draw_keep` from
    ``generator``; then :func:`imputer_loss`, its gradient, the clip by
    global norm, the optimizer's step and the schedule's, as ``Predictor``
    takes them (``train/predictor.py::apply_gradients``)."""

    def step(batch, keep=None):
        model.train()
        if keep is None:
            keep = draw_keep(batch["mask"], whiten_prob, generator)
        optimizer.zero_grad(set_to_none=True)
        loss = imputer_loss(model, batch, batch_to_call, keep,
                            prediction_loss_weight, warm_up)
        loss.backward()
        apply_gradients(model, optimizer, grad_clip, scheduler)
        return loss.detach()

    return step
