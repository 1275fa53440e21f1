"""Temporal convolutions (``torch.nn``).

Counterparts of ``sgp_tpu/models/tcn.py`` (``tsl/nn/base/temporal_conv.py``
and ``tsl/nn/blocks/encoders/tcn.py``) and of ``TCNModel`` from
``sgp_tpu/models/stgn_extra.py``: dilated, optionally causal and optionally
gated-tanh convolutions over the time axis of ``[b s n c]`` tensors, each
one ``nn.Conv1d`` over the ``b * n`` series, and the stateless batch norm.

Under ``Predictor(mesh=)`` each rank holds a slice of the batch, and the
batch norm's statistics are those of the whole batch, as GSPMD computes
them in the JAX package: the trainer sets :class:`Norm`'s
``sum_over_ranks`` (as ``nn.SyncBatchNorm`` holds a process group), which
sums the count, the sums and the squared deviations over the ranks.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sgp_tpu_torch.models.blocks import (MLPDecoder, get_activation,
                                         lecun_normal_, maybe_cat_exog,
                                         reset_linear)


def reset_conv(conv: nn.Conv1d, generator=None):
    """flax ``nn.Conv`` init: lecun-normal kernel over fan-in ``in * k``,
    zero bias."""
    lecun_normal_(conv.weight, conv.in_channels * conv.kernel_size[0],
                  generator)
    nn.init.zeros_(conv.bias)


class TemporalConv(nn.Module):
    """A convolution over time of ``x [b s n c]``; ``causal_pad`` left-pads
    by ``(k - 1) * dilation`` zeros so that the length stays, otherwise the
    output is ``(k - 1) * dilation`` steps shorter. ``gated``: twice the
    channels, split into ``tanh(a) * sigmoid(g)``."""

    def __init__(self, input_channels: int, output_channels: int,
                 kernel_size: int, dilation: int = 1,
                 causal_pad: bool = True, gated: bool = False):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation if causal_pad else 0
        self.gated = gated
        self.conv = nn.Conv1d(input_channels,
                              output_channels * (2 if gated else 1),
                              kernel_size, dilation=dilation)

    def reset_parameters(self, generator=None):
        reset_conv(self.conv, generator)

    def forward(self, x):
        b, s, n, c = x.shape
        xt = x.permute(0, 2, 3, 1).reshape(b * n, c, s)
        out = self.conv(F.pad(xt, (self.pad, 0)) if self.pad else xt)
        if self.gated:
            a, g = out.chunk(2, dim=1)
            out = torch.tanh(a) * torch.sigmoid(g)
        return out.reshape(b, n, out.shape[1], -1).permute(0, 3, 1, 2)


class TemporalConvNet(nn.Module):
    """Stacked :class:`TemporalConv` layers with the activation (none when
    gated) and dropout after each; ``exponential_dilation``: layer ``i``
    dilates by ``dilation ** i``."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 kernel_size: int, dilation: int = 1, n_layers: int = 1,
                 gated: bool = False, causal_padding: bool = True,
                 exponential_dilation: bool = False,
                 activation: str = "relu", dropout: float = 0.0):
        super().__init__()
        self.activation = None if gated else activation
        self.layers = nn.ModuleList(
            TemporalConv(input_channels if i == 0 else hidden_channels,
                         hidden_channels, kernel_size,
                         dilation=dilation ** i if exponential_dilation
                         else dilation, causal_pad=causal_padding,
                         gated=gated)
            for i in range(n_layers))
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()

    def reset_parameters(self, generator=None):
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
            if self.activation is not None:
                x = get_activation(self.activation)(x)
            x = self.dropout(x)
        return x


def _split_moments(xf, axes, w, cnt, sum_over_ranks):
    """The mean and population variance over ``axes`` of the batch split
    over the ranks: this rank's (weighted) sums and ``cnt`` summed by
    ``sum_over_ranks``."""
    xw = xf if w is None else xf * w
    s = xw.sum(axes, keepdim=True)
    both = sum_over_ranks(
        torch.cat([s.reshape(-1), cnt.reshape(1).to(s.dtype)]))
    count = torch.clamp(both[-1], min=1.0)
    mean = both[:-1].reshape(s.shape) / count
    dev = (xf - mean).square()
    dev = dev if w is None else dev * w
    var = sum_over_ranks(dev.sum(axes, keepdim=True)) / count
    return mean, var


class Norm(nn.Module):
    """``none``, ``layer`` (flax's LayerNorm, in f32) or ``batch``: a batch
    norm without state, whose mean and population variance are taken over
    every axis but the channels in f32, at train and at eval alike (not
    ``torch.nn.BatchNorm``, which keeps running statistics), with eps 1e-5.
    ``time_mask [s]`` (bool) restricts the batch statistics to the valid
    time steps of ``x [b s n c]``. ``sum_over_ranks`` (None: the
    statistics are this process's batch) is a differentiable sum over the
    ranks that each hold a slice of the batch, set by the trainer while it
    runs such a slice: the statistics are then the whole batch's."""

    sum_over_ranks: Optional[Callable] = None

    def __init__(self, kind: str = "none", size: Optional[int] = None):
        super().__init__()
        if kind not in ("none", "layer", "batch"):
            raise ValueError(kind)
        self.kind = kind
        self.layer_norm = nn.LayerNorm(size, eps=1e-6) \
            if kind == "layer" else None
        self.scale = nn.Parameter(torch.ones(size)) \
            if kind == "batch" else None
        self.bias = nn.Parameter(torch.zeros(size)) \
            if kind == "batch" else None

    def reset_parameters(self, generator=None):
        """Unit scale, zero bias."""
        if self.layer_norm is not None:
            self.layer_norm.reset_parameters()
        if self.scale is not None:
            nn.init.ones_(self.scale)
            nn.init.zeros_(self.bias)

    def forward(self, x, time_mask=None):
        if self.kind == "none":
            return x
        if self.kind == "layer":
            return self.layer_norm(x.float()).to(x.dtype)
        xf = x.float()
        axes = tuple(range(x.ndim - 1))
        if self.sum_over_ranks is not None:
            w = None if time_mask is None else time_mask.to(
                torch.float32).reshape((1, -1) + (1,) * (x.ndim - 2))
            cnt = torch.tensor(float(x.numel() // x.shape[-1]),
                               device=x.device) if w is None else \
                w.sum() * (x.numel() // (x.shape[1] * x.shape[-1]))
            mean, var = _split_moments(xf, axes, w, cnt,
                                       self.sum_over_ranks)
        elif time_mask is None:
            mean = xf.mean(axes, keepdim=True)
            var = (xf - mean).square().mean(axes, keepdim=True)
        else:
            w = time_mask.to(torch.float32).reshape(
                (1, -1) + (1,) * (x.ndim - 2))
            cnt = torch.clamp(
                w.sum() * (x.numel() // (x.shape[1] * x.shape[-1])), min=1.0)
            mean = (xf * w).sum(axes, keepdim=True) / cnt
            var = ((xf - mean).square() * w).sum(axes, keepdim=True) / cnt
        out = (xf - mean) * torch.rsqrt(var + 1e-5) * self.scale.float() \
            + self.bias.float()
        return out.to(x.dtype)


class TCNModel(nn.Module):
    """Pure temporal-convolution forecaster (``models/tcn_model.py:15``):
    an input Linear, a :class:`TemporalConvNet` dilating by ``2 ** i``, and
    an :class:`MLPDecoder` on the last step. ``input_size`` is the channels
    of ``x`` and ``u`` together."""

    def __init__(self, input_size: int, hidden_size: int, ff_size: int,
                 output_size: int, horizon: int, kernel_size: int = 3,
                 n_layers: int = 3, gated: bool = False,
                 activation: str = "relu", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = nn.Linear(input_size, hidden_size)
        self.tcn = TemporalConvNet(hidden_size, hidden_size, kernel_size,
                                   dilation=2, n_layers=n_layers,
                                   gated=gated, exponential_dilation=True,
                                   activation=activation, dropout=dropout)
        self.decoder = MLPDecoder(hidden_size, ff_size, output_size,
                                  horizon=horizon, activation=activation,
                                  dropout=dropout)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        reset_linear(self.encoder, generator)
        self.tcn.reset_parameters(generator)
        self.decoder.reset_parameters(generator)

    def forward(self, x, u=None, training: bool = False, **kwargs):
        """``training`` and the runners' other keywords are taken and
        unused: dropout follows ``self.training``."""
        x = self.tcn(self.encoder(maybe_cat_exog(x, u)))
        return self.decoder(x[:, -1])
