"""Gated Graph Network baseline (``torch.nn``).

Counterpart of ``sgp_tpu/models/gated_gn.py``: ``GatedGraphNetworkMLPModel``
(``lib/nn/models/gated_gn_model.py:83-159``) flattens the input window per
node, encodes it with a residual MLP, adds an optional node embedding, runs
a stack of :class:`GatedGraphNetwork` layers, a residual decoder layer and
a linear horizon readout. ``neigh`` selects the ELL aggregation, ``adj``
(and ``adj_band``) the dense all-pairs one; without an edge list or either
of them it builds the all-pairs edge list (:func:`full_graph_edges`).

PyTorch needs the input width up front: ``input_size`` is the channels per
step the model sees, exogenous ones included. The convolutional variant
and ``compute_dtype="bfloat16"`` are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from sgp_tpu_torch.models.blocks import (StaticGraphEmbedding, get_activation,
                                         reset_linear)
from sgp_tpu_torch.models.graph_layers import GatedGraphNetwork


def full_graph_edges(n: int):
    """All-pairs edge list, emitted dst-major: ``(src, dst)`` int32."""
    dst = np.repeat(np.arange(n, dtype=np.int32), n)
    src = np.tile(np.arange(n, dtype=np.int32), n)
    return src, dst


class _GatedGNBase(nn.Module):

    def __init__(self, input_window_size: int, hidden_size: int,
                 output_size: int, horizon: int, n_nodes: int,
                 enc_layers: int = 2, gnn_layers: int = 2,
                 positional_encoding: bool = True, activation: str = "silu",
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if compute_dtype not in (None, "float32"):
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r}: the port runs GatedGN in "
                f"float32 only")
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
                              resid_budget_gb=12.0 / max(gnn_layers, 1))
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
        x = act(self.dec(x)) + x
        out = self.readout(x)
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
        if u is not None:
            if u.ndim == 3:  # global exog -> broadcast over nodes
                u = u.unsqueeze(2).expand(x.shape[:3] + (u.shape[-1],))
            x = torch.cat([x, u], -1)
        if neigh is None and adj is None and src is None:
            s, d = full_graph_edges(x.shape[-2])
            src = torch.as_tensor(s, dtype=torch.long, device=x.device)
            dst = torch.as_tensor(d, dtype=torch.long, device=x.device)
        xw = x[:, -self.input_window_size:]
        b, s, n, f = xw.shape
        h = self.enc_in(xw.permute(0, 2, 1, 3).reshape(b, n, s * f))
        for blk in self.enc:
            h = blk["outer"](act(blk["inner"](h))) + h
        return self._decode(h, node_index, src, dst, edge_mask, neigh, adj,
                            adj_band)
