"""SGP decoder model — the only trained part of the SGP pipeline.

Counterpart of ``sgp_tpu/models/sgp.py::SGPModel``: precomputed encoder
features go through a grouped projection (one weight block per hop/layer
block of the embedding), an optional learned node embedding, an
(optionally residual) MLP trunk and a linear multi-horizon readout. Input
may be full-graph ``[b (w) n f]`` or IID-sampled ``[b (w) f]`` per (time,
node) pair — the same parameters serve both. Dropout follows the module's
``train()``/``eval()`` state. ``SGPOnlineModel`` is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sgp_tpu_torch.models.blocks import (MLP, GroupedLinear, LinearReadout,
                                         ResidualMLP, StaticGraphEmbedding,
                                         reset_linear, get_activation,
                                         maybe_cat_exog)


class SGPModel(nn.Module):
    """Args mirror the JAX model's fields. ``input_size`` is the width of
    the encoder features, ``order`` the number of blocks in them, and
    ``exog_size`` the width of the exogenous input ``u`` the model will be
    called with (0 for none). Parameters are drawn from ``generator`` (the
    default generator when None)."""

    def __init__(self, input_size: int, order: int, n_nodes: int,
                 hidden_size: int, mlp_size: int, output_size: int,
                 n_layers: int, horizon: int,
                 positional_encoding: bool = True, emb_size: int = 32,
                 exog_size: int = 0, resnet: bool = False,
                 fully_connected: bool = False, dropout: float = 0.0,
                 activation: str = "silu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.horizon = horizon
        self.activation = activation
        if fully_connected:
            h_size = hidden_size
            self.encoder = nn.Linear(input_size, h_size)
        else:
            h_size = hidden_size - hidden_size % order
            self.encoder = GroupedLinear(input_size, h_size, order)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()
        if positional_encoding:
            self.emb = StaticGraphEmbedding(n_nodes, emb_size)
            self.emb_proj = nn.Linear(emb_size, h_size)
        else:
            self.emb = self.emb_proj = None
        trunk_in = h_size + exog_size
        if resnet:
            self.mlp = ResidualMLP(trunk_in, mlp_size, n_layers=n_layers,
                                   activation=activation, dropout=dropout,
                                   parametrized_skip=True)
        else:
            self.mlp = MLP(trunk_in, mlp_size, n_layers=n_layers,
                           activation=activation, dropout=dropout)
        self.readout = LinearReadout(mlp_size, output_size, horizon)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        if isinstance(self.encoder, nn.Linear):
            reset_linear(self.encoder, generator)
        else:
            self.encoder.reset_parameters(generator)
        if self.emb is not None:
            self.emb.reset_parameters(generator)
            reset_linear(self.emb_proj, generator)
        self.mlp.reset_parameters(generator)
        self.readout.reset_parameters(generator)

    def forward(self, x, u=None, node_index=None, iid: bool = False):
        # x: [b w n f] / [b n f] (full graph); IID mode (``iid=True``,
        # per-(time,node) samples): [b w f] / [b f] with node_index [b]
        squeeze_nodes = False
        if iid:
            if x.ndim == 3:
                x = x[:, -1]                  # IID [b w f] -> [b f]
            x = x[:, None, :]                 # treat pairs as 1 node
            squeeze_nodes = True
        elif x.ndim == 4:
            x = x[:, -1]                      # last window step -> [b n f]
        # u carries a window dim: [b w f] (global) or [b w n f]
        # (node-level); take the last window step
        if u is not None:
            if u.ndim in (3, 4):
                u = u[:, -1]
            if squeeze_nodes and u.ndim == 2:
                u = u[:, None, :]

        act = get_activation(self.activation)
        h = self.dropout(act(self.encoder(x)))

        if self.emb is not None:
            lin_emb = self.emb_proj(self.emb(token_index=node_index))
            if squeeze_nodes:                 # [b, e] -> [b, 1, e]
                lin_emb = lin_emb[:, None, :]
            h = h + lin_emb

        if u is not None:
            h = maybe_cat_exog(h, u)

        out = self.readout(self.mlp(h))       # [b h n c]
        if squeeze_nodes:
            out = out[:, :, 0, :]             # [b h c]
        return out
