"""Masked forecasting metrics.

Counterpart of ``sgp_tpu/train/metrics.py``: each metric accumulates a
masked ``(sum, count)`` state across batches as two scalar tensors on the
batch's device, and ``compute`` divides once at the end. ``at=k``
restricts a metric to horizon step ``k``. The ``numpy_*`` twins take
arrays (the closed-form path's) and return floats.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


def _abs_err(y_hat, y):
    return (y_hat - y).abs()


def _sq_err(y_hat, y):
    return (y_hat - y) ** 2


def _ape(y_hat, y):
    return ((y_hat - y) / y).abs()


_METRIC_FNS: Dict[str, Callable] = {
    "mae": _abs_err, "mse": _sq_err, "mape": _ape,
}


def _masked_reduce(fn, y_hat, y, mask):
    """``(sum of fn over the valid entries, their count)`` as f32
    tensors."""
    val = fn(y_hat, y)
    if mask is None:
        return val.sum(), torch.tensor(float(val.numel()), device=val.device)
    mask = mask.bool()
    val = torch.where(mask, val, torch.zeros((), dtype=val.dtype,
                                             device=val.device))
    return val.sum(), mask.sum().float()


def _mean(fn, y_hat, y, mask):
    v, n = _masked_reduce(fn, y_hat, y, mask)
    return v / torch.clamp(n, min=1.0)


def masked_mae(y_hat, y, mask=None):
    return _mean(_abs_err, y_hat, y, mask)


def masked_mse(y_hat, y, mask=None):
    return _mean(_sq_err, y_hat, y, mask)


def masked_rmse(y_hat, y, mask=None):
    return torch.sqrt(masked_mse(y_hat, y, mask))


def masked_mape(y_hat, y, mask=None):
    return _mean(_ape, y_hat, y, mask)


def masked_mre(y_hat, y, mask=None):
    """sum |err| / sum |y|."""
    v, _ = _masked_reduce(_abs_err, y_hat, y, mask)
    tot, _ = _masked_reduce(lambda a, b: b.abs(), y_hat, y, mask)
    return v / torch.clamp(tot, min=1e-12)


# -- loss extras -------------------------------------------------------------

def pinball_loss(y_hat, y, q: float = 0.5):
    """Quantile (pinball) loss, elementwise."""
    err = y - y_hat
    return torch.maximum(q * err, (q - 1.0) * err)


def masked_pinball(y_hat, y, mask=None, q: float = 0.5):
    return _mean(lambda a, b: pinball_loss(a, b, q), y_hat, y, mask)


def multi_loss(losses, weights=None):
    """Weighted combination of loss callables: returns ``fn(y_hat, y,
    mask)``."""
    if weights is None:
        weights = [1.0] * len(losses)

    def fn(y_hat, y, mask=None):
        return sum(w * loss(y_hat, y, mask)
                   for w, loss in zip(weights, losses))
    return fn


def _take(x, index, dim: int):
    return torch.index_select(x, dim % x.dim(), torch.as_tensor(
        index, device=x.device).reshape(-1))


def metric_at_steps(metric_fn, steps):
    """Restrict a metric to specific horizon steps (axis 1)."""
    def fn(y_hat, y, mask=None):
        return metric_fn(_take(y_hat, steps, 1), _take(y, steps, 1),
                         None if mask is None else _take(mask, steps, 1))
    return fn


def metric_on_channels(metric_fn, channels):
    """Restrict a metric to a subset of channels (the last axis)."""
    def fn(y_hat, y, mask=None):
        return metric_fn(_take(y_hat, channels, -1),
                         _take(y, channels, -1),
                         None if mask is None else _take(mask, channels, -1))
    return fn


def numpy_metric(fn, y_hat, y, mask=None) -> float:
    """A one-shot metric ``fn`` of arrays, in f32 on the CPU (the JAX
    package's metrics take numpy arrays as f32)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))
    return float(fn(f32(y_hat), f32(y), None if mask is None
                    else torch.as_tensor(np.asarray(mask, bool))))


def numpy_masked_mae(y_hat, y, mask=None) -> float:
    return numpy_metric(masked_mae, y_hat, y, mask)


def numpy_masked_rmse(y_hat, y, mask=None) -> float:
    return numpy_metric(masked_rmse, y_hat, y, mask)


def numpy_masked_mre(y_hat, y, mask=None) -> float:
    return numpy_metric(masked_mre, y_hat, y, mask)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    kind: str                 # mae | mse | mape | mre
    at: Optional[int] = None  # horizon step restriction


class MaskedMetrics:
    """A named collection of accumulating masked metrics; the state is a
    dict ``name -> (value_sum, count)``."""

    def __init__(self, specs: Dict[str, MetricSpec]):
        self.specs = specs

    @property
    def names(self):
        return tuple(self.specs)

    @staticmethod
    def forecasting(horizon_at: Dict[str, int] = None) -> "MaskedMetrics":
        """mae, mse and mape, plus ``mae_at_<label>`` per horizon step."""
        specs = {"mae": MetricSpec("mae"), "mse": MetricSpec("mse"),
                 "mape": MetricSpec("mape")}
        for label, step in (horizon_at or {}).items():
            specs[f"mae_at_{label}"] = MetricSpec("mae", at=step)
        return MaskedMetrics(specs)

    def init(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        return {name: (torch.zeros(()), torch.zeros(()))
                for name in self.specs}

    def update(self, state, y_hat, y, mask=None):
        new = dict(state)
        for name, spec in self.specs.items():
            yh, yy, mm = y_hat, y, mask
            if spec.at is not None:
                yh = y_hat[:, spec.at:spec.at + 1]
                yy = y[:, spec.at:spec.at + 1]
                mm = None if mask is None else mask[:, spec.at:spec.at + 1]
            if spec.kind == "mre":
                v, _ = _masked_reduce(_abs_err, yh, yy, mm)
                n, _ = _masked_reduce(lambda a, b: b.abs(), yh, yy, mm)
            else:
                v, n = _masked_reduce(_METRIC_FNS[spec.kind], yh, yy, mm)
            pv, pn = state[name]
            new[name] = (pv.to(v.device) + v, pn.to(n.device) + n)
        return new

    def compute(self, state) -> Dict[str, float]:
        return {name: float(v) / max(float(n), 1e-12)
                for name, (v, n) in state.items()}
