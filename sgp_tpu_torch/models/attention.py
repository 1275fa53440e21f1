"""Attention primitives and transformer blocks (``torch.nn``).

Counterpart of ``sgp_tpu/models/attention.py``: sinusoidal positional
encoding, axis-selectable multi-head attention and its encoder, causal
linear attention, the temporal and spatiotemporal transformer layers, and
the forecasting ``TransformerModel``. Inputs keep the JAX layout ``[b s n
c]`` (or ``[b s c]``); attention runs over the steps (``axis="time"``) or
the nodes (``axis="nodes"``).

What differs in form, not in value: PyTorch needs each layer's input width
up front (``input_size``, the embedding width when left out); flax's
``DenseGeneral`` kernels ``[in, h, dh]`` and ``[h, dh, out]`` are
``nn.Linear`` layers over the flattened ``h * dh`` axis (``models/bridge.py``
reshapes them); dropout follows the module's ``train()`` mode, which
``Predictor`` sets from its ``training`` flag. The dense attention is a
matmul and a softmax, not ``scaled_dot_product_attention``, so that it
mirrors the JAX einsums and the ``-1e30`` causal fill. ``LayerNorm`` uses
flax's epsilon, 1e-6.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sgp_tpu_torch.models.blocks import (MLP, get_activation, layer_norm,
                                         reset_flax)


@functools.lru_cache(maxsize=None)
def _sinusoid_table(max_len: int, d: int) -> np.ndarray:
    """The JAX module's table, built the same way in numpy (float64 angles,
    rounded to float32 once), so the two are bit-equal."""
    pos = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    pe = np.zeros((max_len, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)[:, :d // 2]
    return pe


class PositionalEncoding(nn.Module):
    """Sinusoidal positional encoding over the steps axis of ``[b s ...
    c]`` (``layers/positional_encoding.py:7-42``)."""

    def __init__(self, max_len: int = 5000):
        super().__init__()
        self.max_len = max_len

    def forward(self, x):
        d, s = x.shape[-1], x.shape[1]
        pe = torch.from_numpy(_sinusoid_table(self.max_len, d)[:s]).to(
            x.device)
        return x + pe.view((1, s) + (1,) * (x.ndim - 3) + (d,))


def _move_axis_to_seq(x, axis: str):
    """``[b s n c]`` -> sequence-major layout for attention over ``"time"``
    (steps) or ``"nodes"``."""
    return x.transpose(1, 2) if axis == "time" else x


class MultiHeadAttention(nn.Module):
    """Scaled dot-product MHA over the ``axis`` dimension of ``[b s n c]``
    inputs (``attention.py:70-143``). Layers ``q``, ``k``, ``v`` (``input_size
    -> heads * head_dim``) and ``out`` (``heads * head_dim -> embed_dim``),
    each with a bias."""

    def __init__(self, embed_dim: int, num_heads: int = 1, axis: str = "time",
                 causal: bool = False, dropout: float = 0.0,
                 input_size: Optional[int] = None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.axis, self.causal, self.dropout = axis, causal, dropout
        inner = num_heads * (embed_dim // num_heads)
        input_size = input_size or embed_dim
        self.q = nn.Linear(input_size, inner)
        self.k = nn.Linear(input_size, inner)
        self.v = nn.Linear(input_size, inner)
        self.out = nn.Linear(inner, embed_dim)

    def forward(self, query, key=None, value=None):
        key = query if key is None else key
        value = key if value is None else value
        squeeze = query.ndim == 3
        if squeeze:  # [b s c] -> [b s 1 c]
            query, key, value = (a.unsqueeze(2) for a in (query, key, value))
        q = _move_axis_to_seq(query, self.axis)
        k = _move_axis_to_seq(key, self.axis)
        v = _move_axis_to_seq(value, self.axis)
        h, dh = self.num_heads, self.embed_dim // self.num_heads
        s = q.shape[2]                         # query positions

        def proj(x, lin):
            return lin(x).view(x.shape[:-1] + (h, dh))
        qh, kh, vh = proj(q, self.q), proj(k, self.k), proj(v, self.v)
        logits = torch.einsum("boshd,bothd->bohst", qh, kh) / np.sqrt(dh)
        if self.causal:
            causal_mask = torch.ones((s, kh.shape[2]), dtype=torch.bool,
                                     device=logits.device).tril()
            logits = torch.where(causal_mask, logits, -1e30)
        attn = torch.softmax(logits, dim=-1)
        attn = F.dropout(attn, self.dropout, self.training)
        out = torch.einsum("bohst,bothd->boshd", attn, vh)
        out = self.out(out.reshape(out.shape[:-2] + (h * dh,)))
        if self.axis == "time":
            out = out.transpose(1, 2)
        return out[:, :, 0, :] if squeeze else out


class AttentionEncoder(nn.Module):
    """Input projections ``q_in``, ``k_in``, ``v_in`` (with an optional
    activation) then :class:`MultiHeadAttention` (``attention.py:22-68``)."""

    def __init__(self, embed_dim: int, num_heads: int = 1, axis: str = "time",
                 activation: Optional[str] = None, causal: bool = False,
                 input_size: Optional[int] = None):
        super().__init__()
        input_size = input_size or embed_dim
        self.activation = activation
        self.q_in = nn.Linear(input_size, embed_dim)
        self.k_in = nn.Linear(input_size, embed_dim)
        self.v_in = nn.Linear(input_size, embed_dim)
        self.mha = MultiHeadAttention(embed_dim, num_heads, axis, causal)

    def forward(self, x):
        act = get_activation(self.activation) if self.activation \
            else (lambda t: t)
        return self.mha(act(self.q_in(x)), act(self.k_in(x)),
                        act(self.v_in(x)))


class CausalLinearAttention(nn.Module):
    """Linear attention with the causal cumulative-sum trick
    (``linear_attention.py:15-105``): ``phi(q)_t (sum_{<=t} phi(k)_s
    v_s^T)`` with ``phi = elu + 1``, over the steps of ``[b s c]`` or ``[b
    s n c]``."""

    def __init__(self, embed_dim: int, num_heads: int = 1,
                 input_size: Optional[int] = None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        inner = num_heads * (embed_dim // num_heads)
        input_size = input_size or embed_dim
        self.q = nn.Linear(input_size, inner)
        self.k = nn.Linear(input_size, inner)
        self.v = nn.Linear(input_size, inner)
        self.out = nn.Linear(inner, embed_dim)

    def forward(self, x):
        squeeze = x.ndim == 3
        if squeeze:
            x = x.unsqueeze(2)
        x = x.transpose(1, 2)  # [b n s c]
        h, dh = self.num_heads, self.embed_dim // self.num_heads
        q, k, v = (lin(x).view(x.shape[:-1] + (h, dh))
                   for lin in (self.q, self.k, self.v))
        phi_q, phi_k = F.elu(q) + 1, F.elu(k) + 1
        kv = torch.cumsum(torch.einsum("bnshd,bnshe->bnshde", phi_k, v),
                          dim=2)
        z = torch.cumsum(phi_k, dim=2)
        num = torch.einsum("bnshd,bnshde->bnshe", phi_q, kv)
        den = torch.einsum("bnshd,bnshd->bnsh", phi_q, z)[..., None]
        out = num / torch.clamp(den, min=1e-6)
        out = self.out(out.reshape(out.shape[:-2] + (h * dh,)))
        out = out.transpose(1, 2)
        return out[:, :, 0, :] if squeeze else out


class TransformerLayer(nn.Module):
    """Pre-norm transformer block attending over time or nodes
    (``transformer.py:11-98``): an input projection ``proj`` when
    ``input_size`` differs from ``hidden_size``, then ``norm1``,
    ``attention``, ``norm2`` and the feed-forward ``mlp``, each with a
    skip."""

    def __init__(self, hidden_size: int, ff_size: int, n_heads: int = 1,
                 axis: str = "time", causal: bool = True,
                 activation: str = "elu", dropout: float = 0.0,
                 input_size: Optional[int] = None):
        super().__init__()
        input_size = input_size or hidden_size
        self.proj = nn.Linear(input_size, hidden_size) \
            if input_size != hidden_size else None
        self.norm1 = layer_norm(hidden_size)
        self.attention = MultiHeadAttention(hidden_size, n_heads, axis,
                                            causal=causal, dropout=dropout)
        self.norm2 = layer_norm(hidden_size)
        self.mlp = MLP(hidden_size, ff_size, hidden_size,
                       activation=activation, dropout=dropout)

    def forward(self, x):
        if self.proj is not None:
            x = self.proj(x)
        x = x + self.attention(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class SpatioTemporalTransformerLayer(nn.Module):
    """Temporal attention (causal), then spatial attention, each a
    :class:`TransformerLayer` (``transformer.py:100-197``)."""

    def __init__(self, hidden_size: int, ff_size: int, n_heads: int = 1,
                 causal: bool = True, activation: str = "elu",
                 dropout: float = 0.0, input_size: Optional[int] = None):
        super().__init__()
        self.temporal = TransformerLayer(hidden_size, ff_size, n_heads,
                                         "time", causal, activation, dropout,
                                         input_size)
        self.spatial = TransformerLayer(hidden_size, ff_size, n_heads,
                                        "nodes", False, activation, dropout)

    def forward(self, x):
        return self.spatial(self.temporal(x))


class TransformerModel(nn.Module):
    """Forecasting transformer (``tsl/nn/models/transformer_model.py``):
    input and exogenous projection, positional encoding, stacked
    (spatio)temporal transformer layers, a last-step MLP readout to the
    horizon. ``x [b s n f]`` (+ ``u`` ``[b s f_u]`` or ``[b s n f_u]``) ->
    ``[b horizon n output_size]``; ``input_size`` is ``f + f_u``."""

    def __init__(self, input_size: int, hidden_size: int, ff_size: int,
                 output_size: int, horizon: int, n_layers: int = 1,
                 n_heads: int = 1, axis: str = "time",
                 activation: str = "elu", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.output_size, self.horizon = output_size, horizon
        self.encoder = nn.Linear(input_size, hidden_size)
        self.pe = PositionalEncoding()
        layer = (lambda: SpatioTemporalTransformerLayer(
            hidden_size, ff_size, n_heads, activation=activation,
            dropout=dropout)) if axis == "both" else (
            lambda: TransformerLayer(hidden_size, ff_size, n_heads, axis,
                                     activation=activation, dropout=dropout))
        self.layers = nn.ModuleList(layer() for _ in range(n_layers))
        self.readout = MLP(hidden_size, ff_size, output_size * horizon,
                           activation=activation)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """flax's initializers (its distributions, not its bits)."""
        reset_flax(self, generator)

    def forward(self, x, u=None, training: bool = False, **kwargs):
        """``training`` and the other keywords of the runners' call are
        taken and unused: dropout follows ``self.training``."""
        if u is not None:
            if u.ndim == 3:  # global exog -> broadcast over nodes
                u = u.unsqueeze(2).expand(x.shape[:3] + (u.shape[-1],))
            x = torch.cat([x, u], -1)
        x = self.pe(self.encoder(x))
        for layer in self.layers:
            x = layer(x)
        out = self.readout(x[:, -1])          # [b n horizon * output]
        b, n = out.shape[0], out.shape[1]
        return out.reshape(b, n, self.horizon, self.output_size
                           ).permute(0, 2, 1, 3)
