"""Gated Graph Network baselines (``torch.nn``).

Counterpart of ``sgp_tpu/models/gated_gn.py``: ``GatedGraphNetworkMLPModel``
(``lib/nn/models/gated_gn_model.py:83-159``) flattens the input window per
node, encodes it with a residual MLP, adds an optional node embedding, runs
a stack of :class:`GatedGraphNetwork` layers, a residual decoder layer and
a linear horizon readout. ``neigh`` selects the ELL aggregation, ``adj``
(and ``adj_band``) the dense all-pairs one; without an edge list or either
of them it builds the all-pairs edge list (:func:`full_graph_edges`).
``GatedGraphNetworkConvModel`` swaps the MLP encoder for a strided residual
CNN over the window (:class:`CNNResidual`) and, as the JAX model does,
takes only the edge list: ``neigh``, ``adj`` and ``adj_band`` are accepted
and not used, so without ``src`` it runs the all-pairs edge list.

``compute_dtype="bfloat16"`` runs the message layers and the decoder's
Dense in bf16 (float32 parameters cast at use, float32 neighbour sums);
the encoder, the embedding and the readout stay float32.

PyTorch needs the input width up front: ``input_size`` is the channels per
step the model sees, exogenous ones included.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sgp_tpu_torch.models.blocks import (StaticGraphEmbedding, get_activation,
                                         lecun_normal_, reset_linear)
from sgp_tpu_torch.models.graph_layers import GatedGraphNetwork, linear_as


def full_graph_edges(n: int):
    """All-pairs edge list, emitted dst-major: ``(src, dst)`` int32."""
    dst = np.repeat(np.arange(n, dtype=np.int32), n)
    src = np.tile(np.arange(n, dtype=np.int32), n)
    return src, dst


_COMPUTE_DTYPES = {None: None, "float32": None, "bf16": torch.bfloat16,
                   "bfloat16": torch.bfloat16}


def _full_graph(x):
    s, d = full_graph_edges(x.shape[-2])
    return (torch.as_tensor(s, dtype=torch.long, device=x.device),
            torch.as_tensor(d, dtype=torch.long, device=x.device))


def _cat_exog(x, u):
    """``x [b s n f]`` with ``u`` (``[b s f_u]``, broadcast over nodes, or
    ``[b s n f_u]``) appended on the channels."""
    if u is None:
        return x
    if u.ndim == 3:  # global exog -> broadcast over nodes
        u = u.unsqueeze(2).expand(x.shape[:3] + (u.shape[-1],))
    return torch.cat([x, u], -1)


class _GatedGNBase(nn.Module):

    def __init__(self, input_window_size: int, hidden_size: int,
                 output_size: int, horizon: int, n_nodes: int,
                 enc_layers: int = 2, gnn_layers: int = 2,
                 positional_encoding: bool = True, activation: str = "silu",
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype={compute_dtype!r} is not one of "
                             f"{sorted(map(str, _COMPUTE_DTYPES))}")
        self.dtype = _COMPUTE_DTYPES[compute_dtype]
        self.input_window_size = input_window_size
        self.hidden_size = hidden_size
        self.output_size = output_size
        self.horizon = horizon
        self.activation = activation
        self.emb = StaticGraphEmbedding(n_nodes, hidden_size) \
            if positional_encoding else None
        # every layer keeps its own all-pairs residuals: a 12 GB total
        # budget split across the stack, as in the JAX model
        self.gnn = nn.ModuleList(
            GatedGraphNetwork(hidden_size, hidden_size, activation,
                              resid_budget_gb=12.0 / max(gnn_layers, 1),
                              dtype=self.dtype)
            for _ in range(gnn_layers))
        self.dec = nn.Linear(hidden_size, hidden_size)
        self.readout = nn.Linear(hidden_size, horizon * output_size)

    def _reset_decoder(self, generator):
        if self.emb is not None:
            self.emb.reset_parameters(generator)
        for layer in self.gnn:
            layer.reset_parameters(generator)
        reset_linear(self.dec, generator)
        reset_linear(self.readout, generator)

    def _decode(self, x, node_index, src, dst, edge_mask=None, neigh=None,
                adj=None, adj_band=None):
        act = get_activation(self.activation)
        if self.emb is not None:
            x = x + self.emb(token_index=node_index)
        for layer in self.gnn:
            x = layer(x, src, dst, edge_mask=edge_mask, neigh=neigh, adj=adj,
                      adj_band=adj_band)
        x = act(linear_as(self.dec, x, self.dtype)) + x   # bf16+f32 -> f32
        out = self.readout(x.to(self.readout.weight.dtype))   # f32 readout
        b, n = out.shape[0], out.shape[1]
        return out.reshape(b, n, self.horizon, self.output_size
                           ).permute(0, 2, 1, 3)


class GatedGraphNetworkMLPModel(_GatedGNBase):
    """``x [b, s, n, f]`` (+ ``u`` ``[b, s, f_u]`` or ``[b, s, n, f_u]``)
    -> ``[b, horizon, n, output_size]``. ``input_size`` is ``f + f_u``."""

    def __init__(self, input_size: int, input_window_size: int,
                 hidden_size: int, output_size: int, horizon: int,
                 n_nodes: int, enc_layers: int = 2, gnn_layers: int = 2,
                 positional_encoding: bool = True, activation: str = "silu",
                 compute_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_window_size, hidden_size, output_size, horizon,
                         n_nodes, enc_layers, gnn_layers, positional_encoding,
                         activation, compute_dtype)
        self.enc_in = nn.Linear(input_window_size * input_size, hidden_size)
        # each block is outer(act(inner(h))) + h
        self.enc = nn.ModuleList(
            nn.ModuleDict({"inner": nn.Linear(hidden_size, hidden_size),
                           "outer": nn.Linear(hidden_size, hidden_size)})
            for _ in range(enc_layers))
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """flax's initializers, drawn in the JAX model's parameter order."""
        reset_linear(self.enc_in, generator)
        for blk in self.enc:
            reset_linear(blk["outer"], generator)
            reset_linear(blk["inner"], generator)
        self._reset_decoder(generator)

    def forward(self, x, src=None, dst=None, u=None, node_index=None,
                edge_mask=None, neigh=None, adj=None, adj_band=None,
                training: bool = False, **kwargs):
        act = get_activation(self.activation)
        x = _cat_exog(x, u)
        if neigh is None and adj is None and src is None:
            src, dst = _full_graph(x)
        xw = x[:, -self.input_window_size:]
        b, s, n, f = xw.shape
        h = self.enc_in(xw.permute(0, 2, 1, 3).reshape(b, n, s * f))
        for blk in self.enc:
            h = blk["outer"](act(blk["inner"](h))) + h
        return self._decode(h, node_index, src, dst, edge_mask, neigh, adj,
                            adj_band)


class Conv1dResidual(nn.Module):
    """``x + conv(silu(conv(x)))`` with kernel-1 convolutions, the hidden
    width ``channels // 2`` unless given. Channels first here (``[b, c,
    s]``); the flax module's channels-last math."""

    def __init__(self, channels: int, hidden_size: Optional[int] = None):
        super().__init__()
        hidden = hidden_size or channels // 2
        self.inner = nn.Conv1d(channels, hidden, 1)
        self.outer = nn.Conv1d(hidden, channels, 1)

    def reset_parameters(self, generator=None):
        for conv in (self.inner, self.outer):
            _reset_conv(conv, generator)

    def forward(self, x):
        return x + self.outer(F.silu(self.inner(x)))


def _reset_conv(conv: nn.Conv1d, generator=None):
    """flax ``nn.Conv`` init: lecun-normal kernel over fan-in ``in * k``,
    zero bias."""
    lecun_normal_(conv.weight, conv.in_channels * conv.kernel_size[0],
                  generator)
    nn.init.zeros_(conv.bias)


class CNNResidual(nn.Module):
    """Strided log-depth CNN window encoder: ``x [b, s, in_channels]`` ->
    ``[b, out_channels]``. ``ceil(log_k(window))`` layers (at least one),
    each left-padding the sequence with zeros to a multiple of the kernel,
    a convolution with stride = kernel (``VALID``) that doubles the width
    (from ``hidden_size``, at most ``max_hidden_size``) and a
    :class:`Conv1dResidual`; the flattened result goes through a Linear to
    ``out_channels`` when its width differs. Window 36, kernel 5: lengths
    36 -> 40 -> 8, 8 -> 10 -> 2, 2 -> 5 -> 1."""

    def __init__(self, out_channels: int, input_window_size: int,
                 in_channels: int, hidden_size: int = 64,
                 max_hidden_size: int = 256, kernel_size: int = 5):
        super().__init__()
        n_layers = math.ceil(math.log(input_window_size, kernel_size))
        self.kernel_size = kernel_size
        self.pads, self.convs, self.res = [], nn.ModuleList(), \
            nn.ModuleList()
        hidden, length, c_in = hidden_size, input_window_size, in_channels
        for i in range(max(n_layers, 1)):
            if i > 0:
                hidden = min(hidden * 2, max_hidden_size)
            pad = int((-length) % kernel_size)
            self.pads.append(pad)
            self.convs.append(nn.Conv1d(c_in, hidden, kernel_size,
                                        stride=kernel_size))
            self.res.append(Conv1dResidual(hidden))
            length = (length + pad) // kernel_size
            c_in = hidden
        flat = hidden * length
        self.out = nn.Linear(flat, out_channels) \
            if flat != out_channels else None

    def reset_parameters(self, generator=None):
        for conv, res in zip(self.convs, self.res):
            _reset_conv(conv, generator)
            res.reset_parameters(generator)
        if self.out is not None:
            reset_linear(self.out, generator)

    def forward(self, x):
        x = x.transpose(1, 2)                   # [b, c, s]
        for pad, conv, res in zip(self.pads, self.convs, self.res):
            x = res(conv(F.pad(x, (pad, 0))))
        # flatten as the channels-last [b, s, c] does: channel fastest
        x = x.transpose(1, 2).reshape(x.shape[0], -1)
        return x if self.out is None else self.out(x)


class GatedGraphNetworkConvModel(_GatedGNBase):
    """``x [b, s, n, f]`` (+ ``u``) -> ``[b, horizon, n, output_size]``: each
    node's window through :class:`CNNResidual` (width ``hidden_size``),
    then the GatedGN decoder on the edge list ``src``/``dst`` (the
    all-pairs list without one). ``input_size`` is ``f + f_u``;
    ``enc_layers`` is kept for the runners' signature and not used."""

    def __init__(self, input_size: int, input_window_size: int,
                 hidden_size: int, output_size: int, horizon: int,
                 n_nodes: int, enc_layers: int = 2, gnn_layers: int = 2,
                 positional_encoding: bool = True, activation: str = "silu",
                 compute_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_window_size, hidden_size, output_size, horizon,
                         n_nodes, enc_layers, gnn_layers, positional_encoding,
                         activation, compute_dtype)
        self.cnn = CNNResidual(hidden_size, input_window_size, input_size,
                               hidden_size=hidden_size)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        self.cnn.reset_parameters(generator)
        self._reset_decoder(generator)

    def forward(self, x, src=None, dst=None, u=None, node_index=None,
                edge_mask=None, training: bool = False, **kwargs):
        x = _cat_exog(x, u)
        if src is None:
            src, dst = _full_graph(x)
        xw = x[:, -self.input_window_size:]
        b, s, n, f = xw.shape
        h = self.cnn(xw.permute(0, 2, 1, 3).reshape(b * n, s, f))
        return self._decode(h.reshape(b, n, -1), node_index, src, dst,
                            edge_mask)
