"""GraphWaveNet baseline (``torch.nn``).

Counterpart of ``sgp_tpu/models/gwnet.py`` (``tsl``'s
``graph_wavenet_model.py`` with the ``node_index``-aware learned adjacency
of ``lib/nn/models/gwnet_model.py``): a residual stack of gated temporal
convolutions and diffusion convolutions, the skip sum into ``relu`` and an
:class:`MLPDecoder`, plus a dense learned adjacency ``softmax(relu(E_s
E_t^T))`` from two node embeddings, applied by order-K dense diffusion.

The time buffer keeps its length: each layer's temporal convolution is
causally left-padded, and a right-aligned validity mask, shrinking by
``d * (k - 1)`` a layer as the reference's VALID convolutions do, limits
the batch norm's statistics to the valid steps. The JAX model groups the
layers into blocks of ``dilation_mod`` (``nn.scan`` over them when there
are several) or, when ``dilation_mod`` does not divide ``n_layers``, one
layer a block; this model runs the same layers in a plain loop, and
``models/bridge.py`` reads either parameter layout (:meth:`flax_blocks`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sgp_tpu_torch.models.blocks import (MLPDecoder, StaticGraphEmbedding,
                                         reset_linear)
from sgp_tpu_torch.models.graph_layers import DiffConv
from sgp_tpu_torch.models.tcn import Norm, TemporalConvNet
from sgp_tpu_torch.ops.spmm import Operator


def node_matmul(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("ij,...jc->...ic", a, x)`` as one matrix product: the
    leading axes of ``x`` are folded into the columns."""
    lead, (n, c) = x.shape[:-2], x.shape[-2:]
    folded = x.reshape(-1, n, c).transpose(0, 1).reshape(n, -1)
    out = a @ folded
    return out.reshape(a.shape[0], -1, c).transpose(0, 1).reshape(
        lead + (a.shape[0], c))


class DenseSpatialConvOrderK(nn.Module):
    """Order-K diffusion over dense supports shared by the batch
    (``dense_spatial_conv.py``, ``include_self=False``): ``adj`` is one
    ``[n, n]`` support or ``[s, n, n]`` stacked ones (``n_supports``)."""

    def __init__(self, input_size: int, output_size: int, order: int = 2,
                 n_supports: int = 1):
        super().__init__()
        self.order = order
        self.linear = nn.Linear(order * n_supports * input_size, output_size)

    def reset_parameters(self, generator=None):
        reset_linear(self.linear, generator)

    @staticmethod
    def compute_support(adj):
        """The row-normalized forward and backward supports of a raw dense
        adjacency, stacked (``dense_spatial_conv.py:34-41``)."""
        eps = 1e-8
        fwd = adj / (adj.sum(1, keepdim=True) + eps)
        bwd = adj.T / (adj.T.sum(1, keepdim=True) + eps)
        return torch.stack([fwd, bwd])

    def forward(self, x, adj):
        supports = adj[None] if adj.ndim == 2 else adj
        out = []
        for a in supports:
            cur = x
            for _ in range(self.order):
                cur = node_matmul(a, cur)
                out.append(cur)
        return self.linear(torch.cat(out, -1))


class GWNetLayer(nn.Module):
    """One layer: a gated temporal convolution, its skip Linear into the
    ``ff_size`` sum, a :class:`DiffConv` (plus the learned adjacency's
    dense diffusion), dropout, the residual and the :class:`Norm`."""

    def __init__(self, hidden_size: int, ff_size: int,
                 temporal_kernel_size: int, spatial_kernel_size: int,
                 dilation: int, learned_adjacency: bool, norm: str,
                 dropout: float):
        super().__init__()
        self.tconv = TemporalConvNet(hidden_size, hidden_size,
                                     temporal_kernel_size, dilation=dilation,
                                     gated=True, causal_padding=True)
        self.skip = nn.Linear(hidden_size, ff_size)
        self.diff = DiffConv(hidden_size, hidden_size, spatial_kernel_size)
        self.dense = DenseSpatialConvOrderK(
            hidden_size, hidden_size, spatial_kernel_size) \
            if learned_adjacency else None
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()
        self.norm = Norm(norm, hidden_size)

    def reset_parameters(self, generator=None):
        self.tconv.reset_parameters(generator)
        reset_linear(self.skip, generator)
        self.diff.reset_parameters(generator)
        if self.dense is not None:
            self.dense.reset_parameters(generator)
        self.norm.reset_parameters(generator)

    def forward(self, x, out, time_mask, supports, adj_z):
        res = x
        x = self.tconv(x)
        out = self.skip(x) + out
        xs = self.diff(x, supports)
        if self.dense is not None:
            xs = xs + self.dense(x, adj_z)
        x = self.dropout(xs) + res
        return self.norm(x, time_mask=time_mask), out


class GraphWaveNetModel(nn.Module):
    """``x [b s n f]`` (``u`` appended: ``input_size`` counts both) and the
    two supports of :func:`diff_conv_support` -> ``[b horizon n
    output_size]``. ``node_index`` slices the
    node embeddings of the learned adjacency (subgraph batches).
    ``scan_layers`` names the JAX model's parameter layout for the bridge;
    the computation is the same either way."""

    def __init__(self, input_size: int, hidden_size: int, ff_size: int,
                 output_size: int, horizon: int, n_layers: int = 8,
                 temporal_kernel_size: int = 2,
                 spatial_kernel_size: int = 2,
                 learned_adjacency: bool = True,
                 n_nodes: Optional[int] = None, emb_size: int = 10,
                 dilation: int = 2, dilation_mod: int = 2,
                 norm: str = "batch", dropout: float = 0.0,
                 scan_layers: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dilation_mod, self.scan_layers = dilation_mod, scan_layers
        self.dilations = [dilation ** (i % dilation_mod)
                          for i in range(n_layers)]
        self.receptive_field = 1 + sum(
            d * (temporal_kernel_size - 1) for d in self.dilations)
        self.temporal_kernel_size, self.ff_size = temporal_kernel_size, \
            ff_size
        if learned_adjacency:
            self.emb_src = StaticGraphEmbedding(n_nodes, emb_size)
            self.emb_dst = StaticGraphEmbedding(n_nodes, emb_size)
        else:
            self.emb_src = self.emb_dst = None
        self.encoder = nn.Linear(input_size, hidden_size)
        self.layers = nn.ModuleList(
            GWNetLayer(hidden_size, ff_size, temporal_kernel_size,
                       spatial_kernel_size, d, learned_adjacency, norm,
                       dropout) for d in self.dilations)
        self.decoder = MLPDecoder(ff_size, 2 * ff_size, output_size,
                                  horizon=horizon, activation="relu")
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        if self.emb_src is not None:
            self.emb_src.reset_parameters(generator)
            self.emb_dst.reset_parameters(generator)
        reset_linear(self.encoder, generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        self.decoder.reset_parameters(generator)

    def flax_blocks(self):
        """``(stacked, blocks)``: the JAX model's grouping of the layers,
        ``blocks`` a list of lists of layer indices, ``stacked`` whether its
        parameters lie stacked along a leading block axis (``nn.scan``)."""
        n, mod = len(self.layers), self.dilation_mod
        if n % mod:
            return False, [[i] for i in range(n)]
        blocks = [list(range(b, b + mod)) for b in range(0, n, mod)]
        return self.scan_layers and len(blocks) > 1, blocks

    def time_masks(self, length: int, device) -> torch.Tensor:
        """``[n_layers, length]`` bool: each layer's valid, right-aligned
        steps."""
        valid, masks = length, []
        for d in self.dilations:
            valid -= d * (self.temporal_kernel_size - 1)
            masks.append(np.arange(length) >= length - valid)
        return torch.as_tensor(np.stack(masks), device=device)

    def forward(self, x, supports: Sequence[Operator], u=None,
                node_index=None, training: bool = False, **kwargs):
        """``training`` is taken and unused: dropout follows
        ``self.training``."""
        if u is not None:
            if u.ndim == 3:
                u = u.unsqueeze(2).expand(x.shape[:3] + (u.shape[-1],))
            x = torch.cat([x, u], -1)
        if self.receptive_field > x.shape[1]:
            x = F.pad(x, (0, 0, 0, 0, self.receptive_field - x.shape[1], 0))
        masks = self.time_masks(x.shape[1], x.device)
        adj_z = None
        if self.emb_src is not None:
            src = self.emb_src(node_index)
            dst = self.emb_dst(node_index)
            adj_z = torch.softmax(torch.relu(src @ dst.T), dim=1)
        x = self.encoder(x)
        out = x.new_zeros(x.shape[:3] + (self.ff_size,))
        for layer, mask in zip(self.layers, masks):
            x, out = layer(x, out, mask, supports, adj_z)
        return self.decoder(torch.relu(out))
