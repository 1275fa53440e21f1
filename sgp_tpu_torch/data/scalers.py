"""Masked linear scalers.

Counterpart of ``sgp_tpu/data/scalers.py``: every scaler is the linear
transform ``f(x) = (x - bias) / scale``; fitting happens host-side in numpy
(the same code, so the same fitted values), and the fitted parameters go
to the device as a :class:`ScalerParams` of two tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch


def _zeros_to_one(scale: np.ndarray) -> np.ndarray:
    """Set near-zero scales to 1 (constant features), as sklearn's
    ``_handle_zeros_in_scale``."""
    scale = np.asarray(scale)
    eps = 10 * np.finfo(scale.dtype if scale.dtype.kind == "f"
                        else np.float32).eps
    out = scale.copy()
    out[np.isclose(scale, 0.0, atol=eps, rtol=eps)] = 1.0
    return out


class ScalerParams:
    """Linear transform parameters as two device tensors."""

    def __init__(self, bias: torch.Tensor, scale: torch.Tensor):
        self.bias = bias
        self.scale = scale

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.bias) / self.scale

    def inverse_transform(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale + self.bias

    def index_nodes(self, node_index: torch.Tensor,
                    node_axis: int = -2) -> "ScalerParams":
        """Node-resolved params cut to a node subset (a node shard);
        params shared by all nodes stay as they are."""
        def maybe_take(p):
            if p.ndim >= 2 and p.shape[node_axis] > 1:
                return p.index_select(node_axis % p.ndim, node_index)
            return p
        return ScalerParams(maybe_take(self.bias), maybe_take(self.scale))

    def index_nodes_iid(self, node_index: torch.Tensor) -> "ScalerParams":
        """Per-(time, node)-sample params for IID batches: node-resolved
        params ``[..., N, C]`` become ``[B, 1, C]`` to broadcast against
        ``y [B, H, C]``; params shared by all nodes stay as they are."""
        def maybe_take(p):
            if p.ndim >= 2 and p.shape[-2] > 1:
                flat = p.reshape(p.shape[-2], p.shape[-1])
                return flat[node_index][:, None, :]
            return p
        return ScalerParams(maybe_take(self.bias), maybe_take(self.scale))


class Scaler:
    """Base linear scaler; subclasses define :meth:`fit`."""

    def __init__(self, axis: Union[int, Tuple[int, ...]] = 0):
        self.axis = axis
        self.bias: np.ndarray = np.zeros(1, np.float32)
        self.scale: np.ndarray = np.ones(1, np.float32)

    def fit(self, x: np.ndarray, mask: Optional[np.ndarray] = None,
            keepdims: bool = True) -> "Scaler":
        raise NotImplementedError

    def transform(self, x):
        return (x - self.bias) / self.scale

    def inverse_transform(self, x):
        return x * self.scale + self.bias

    def fit_transform(self, x, mask=None):
        return self.fit(x, mask).transform(x)

    def params(self, dtype=torch.float32, device=None) -> ScalerParams:
        return ScalerParams(
            torch.as_tensor(np.asarray(self.bias), dtype=dtype, device=device),
            torch.as_tensor(np.asarray(self.scale), dtype=dtype,
                            device=device))


class StandardScaler(Scaler):
    """Mean / standard-deviation scaling, the traffic runners' scaler."""

    def fit(self, x, mask=None, keepdims=True):
        x = np.asarray(x)
        if mask is not None:
            xm = np.where(np.asarray(mask, bool), x, np.nan).astype(np.float32)
            self.bias = np.nanmean(xm, axis=self.axis, keepdims=keepdims
                                   ).astype(x.dtype)
            self.scale = np.nanstd(xm, axis=self.axis, keepdims=keepdims
                                   ).astype(x.dtype)
        else:
            self.bias = x.mean(axis=self.axis, keepdims=keepdims)
            self.scale = x.std(axis=self.axis, keepdims=keepdims)
        self.scale = _zeros_to_one(self.scale)
        return self


class MinMaxScaler(Scaler):
    """Rescale into ``out_range``."""

    def __init__(self, axis=0, out_range: Tuple[float, float] = (0.0, 1.0)):
        super().__init__(axis)
        self.out_range = out_range

    def fit(self, x, mask=None, keepdims=True):
        out_min, out_max = self.out_range
        if out_min >= out_max:
            raise ValueError(f"invalid out_range {self.out_range}")
        x = np.asarray(x)
        if mask is not None:
            xm = np.where(np.asarray(mask, bool), x, np.nan).astype(np.float32)
            x_min = np.nanmin(xm, axis=self.axis, keepdims=keepdims
                              ).astype(x.dtype)
            x_max = np.nanmax(xm, axis=self.axis, keepdims=keepdims
                              ).astype(x.dtype)
        else:
            x_min = x.min(axis=self.axis, keepdims=keepdims)
            x_max = x.max(axis=self.axis, keepdims=keepdims)
        scale = _zeros_to_one((x_max - x_min) / (out_max - out_min))
        self.bias = x_min - out_min * scale
        self.scale = scale
        return self


class RobustScaler(Scaler):
    """Median / quantile-range scaling; the large-scale experiments use
    ``RobustScaler(quantile_range=(10, 90))``."""

    def __init__(self, axis=0,
                 quantile_range: Tuple[float, float] = (25., 75.),
                 unit_variance: bool = False):
        super().__init__(axis)
        self.quantile_range = quantile_range
        self.unit_variance = unit_variance

    def fit(self, x, mask=None, keepdims=True):
        q_min, q_max = self.quantile_range
        if not 0 <= q_min <= q_max <= 100:
            raise ValueError(f"invalid quantile range {self.quantile_range}")
        x = np.asarray(x)
        dtype = x.dtype
        if mask is not None:
            xm = np.where(np.asarray(mask, bool), x, np.nan).astype(np.float32)
            self.bias = np.nanmedian(xm, axis=self.axis, keepdims=keepdims
                                     ).astype(dtype)
            min_q, max_q = np.nanpercentile(xm, self.quantile_range,
                                            axis=self.axis, keepdims=keepdims)
        else:
            self.bias = np.median(x, axis=self.axis, keepdims=keepdims)
            min_q, max_q = np.percentile(x, self.quantile_range,
                                         axis=self.axis, keepdims=keepdims)
        self.scale = _zeros_to_one((max_q - min_q).astype(dtype))
        if self.unit_variance:
            from scipy import stats
            adjust = (stats.norm.ppf(q_max / 100.0)
                      - stats.norm.ppf(q_min / 100.0))
            self.scale = self.scale / adjust
        return self
