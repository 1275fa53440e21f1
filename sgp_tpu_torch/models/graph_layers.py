"""Trainable graph layers (``torch.nn``): the diffusion layers, the
edge-gated GatedGN layer and the two attention layers.

Counterparts in ``sgp_tpu/models/graph_layers.py``: :func:`diff_conv_support`
and :func:`diff_conv_support_from_arrays` (the row-normalized forward and
transposed diffusion operators, from a host graph or from a subgraph
batch's padded edge arrays), :class:`DiffConv` (``tsl``'s ``diff_conv.py``:
``[x, A x, .., A^k x, A' x, .., A'^k x]`` through one Linear; each hop is
``op @ x``, so a :class:`~sgp_tpu_torch.ops.spmm.BSROperator` support runs
kernel K1 on the card, forward and backward), :class:`ConditionalBlock`
(exogenous conditioning), :class:`GraphConv` (``D^-1 A X Theta``),
:class:`GATConv` (PyG graph attention over an edge list),
:class:`SpatioTemporalAttention` (temporal then spatial dense attention)
and ``GatedGraphNetwork``
(``tsl/nn/layers/graph_convs/gated_gn.py``, Satorras et al.), of whose
aggregation layouts three are ported:

- ELL, ``neigh=(src_idx [N, D], mask [N, D])`` from
  ``graph.padded_incoming``: the projections ``p_j`` are gathered into an
  ``[..., N, D, h/2]`` array and the gated messages summed over ``D``. With
  an activation of the kernel's table (``ops/activations.py``) this goes
  through ``ops/gn_ell.py::gn_ell_aggregate``, which runs kernel K4 on a
  CUDA tensor and its plain version on a CPU one. Another activation takes
  the plain ELL math, as the JAX layer takes its XLA path.
- the edge list, ``src``/``dst`` ``[E]``: gather, message MLP and gate per
  edge, then a sum into the destinations with ``index_add_``.
- dense all-pairs, ``adj [N, N]`` (``adj[dst, src] != 0`` marks an edge,
  from ``ops.dense_adj_mask``) and optionally ``adj_band`` (the window
  table of ``graph.band_windows``/``auto_band``): the gated messages of
  every masked pair, without a gather. With an activation of the kernel's
  table this goes through ``ops/gn_allpairs.py::gn_allpairs_aggregate``,
  which runs kernel K3 on a CUDA tensor (with or without the window table)
  and its plain version on a CPU one. Another activation takes the JAX
  layer's blocked plain math, checkpointing each block of dst rows when the
  saved ``[.., rows, W, h]`` residuals would exceed ``resid_budget_gb``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sgp_tpu_torch.graph.sparse import Graph, normalize_adj, transpose
from sgp_tpu_torch.models.attention import MultiHeadAttention
from sgp_tpu_torch.models.blocks import (get_activation, layer_norm,
                                         lecun_normal_, reset_linear)
from sgp_tpu_torch.ops.activations import ACTIVATIONS
from sgp_tpu_torch.ops.gn_allpairs import gn_allpairs_aggregate, row_blocks
from sgp_tpu_torch.ops.gn_ell import gn_ell_aggregate
from sgp_tpu_torch.ops.scatter import segment_softmax
from sgp_tpu_torch.ops.spmm import COOOperator, Operator, build_operator
from sgp_tpu_torch.utils.device import resolve_device


def linear_as(lin: nn.Linear, x, dtype: Optional[torch.dtype] = None):
    """``lin(x)`` computed in ``dtype``, the float32 parameters cast at use
    (flax's ``Dense(dtype=)``); ``lin(x)`` when ``dtype`` is None."""
    if dtype is None:
        return lin(x)
    return F.linear(x.to(dtype), lin.weight.to(dtype),
                    None if lin.bias is None else lin.bias.to(dtype))


def diff_conv_support(g: Graph, add_backward: bool = True,
                      operator_mode: str = "auto",
                      precision: str = "highest", device=None
                      ) -> List[Operator]:
    """The row-normalized forward operator (and, with ``add_backward``, the
    row-normalized transposed one) of ``g`` (``diff_conv.py:50-66``), built
    by ``build_operator`` with ``operator_mode`` and ``precision`` directly
    on ``device`` (default ``cuda:0``): a trainer moves the tensors of its
    batches, not operators."""
    device = resolve_device(device)
    ops = [build_operator(normalize_adj(g, "row"), operator_mode,
                          precision=precision, device=device)]
    if add_backward:
        ops.append(build_operator(normalize_adj(transpose(g), "row"),
                                  operator_mode, precision=precision,
                                  device=device))
    return ops


def diff_conv_support_from_arrays(src, dst, weight, num_nodes: int,
                                  add_backward: bool = True
                                  ) -> List[COOOperator]:
    """COO supports of a subgraph batch from its edge arrays (tensors on
    the device the supports run on), row-normalized on that device. An
    edge of weight 0 (a padding edge) adds nothing to the degrees or the
    sums, so a caller may leave such edges out first and get the same
    operators with fewer gathers."""
    src, dst = src.long(), dst.long()

    def normalized(s, d, w):
        deg = torch.zeros(num_nodes, dtype=w.dtype,
                          device=w.device).index_add_(0, d, w)
        inv = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1e-38),
                          torch.zeros_like(deg))
        return COOOperator(s, d, w * inv[d], num_nodes)

    ops = [normalized(src, dst, weight)]
    if add_backward:
        ops.append(normalized(dst, src, weight))
    return ops


class DiffConv(nn.Module):
    """Diffusion convolution: ``[x?, op^1 x, .., op^k x]`` per support,
    concatenated and through one Linear. ``input_size`` is x's channels and
    ``n_supports`` the number of operators the call passes (two from
    :func:`diff_conv_support`)."""

    def __init__(self, input_size: int, output_size: int, k: int,
                 root_weight: bool = True, n_supports: int = 2):
        super().__init__()
        self.k, self.root_weight = k, root_weight
        terms = n_supports * k + (1 if root_weight else 0)
        self.linear = nn.Linear(terms * input_size, output_size)

    def reset_parameters(self, generator=None):
        reset_linear(self.linear, generator)

    @staticmethod
    def hops(x, supports: Sequence[Operator], k: int) -> list:
        """``[op^1 x, .., op^k x]`` per support, in the concat order of
        ``forward``. Diffusion is linear and channel-separable (``op @ [a,
        b] = [op @ a, op @ b]``), so callers that apply several DiffConvs
        to overlapping inputs (the DCRNN gates) run the products once."""
        out = []
        for op in supports:
            cur = x
            for _ in range(k):
                cur = op @ cur
                out.append(cur)
        return out

    def forward(self, x, supports: Sequence[Operator], hops=None):
        """``hops``: this layer's :meth:`hops` of ``x``, computed by the
        caller (the same values; no product is run here then)."""
        out = [x] if self.root_weight else []
        out.extend(self.hops(x, supports, self.k) if hops is None else hops)
        return self.linear(torch.cat(out, -1))


class ConditionalBlock(nn.Module):
    """Exogenous conditioning (``tsl/nn/blocks/encoders/conditional.py``):
    ``act(lin(act(x_in(x))) + u_out(act(u_in(u))))``, dropout, and a skip
    Linear of x when ``skip_connection``."""

    def __init__(self, input_size: int, exog_size: int, output_size: int,
                 activation: str = "relu", dropout: float = 0.0,
                 skip_connection: bool = False):
        super().__init__()
        self.activation = activation
        self.x_in = nn.Linear(input_size, output_size)
        self.u_in = nn.Linear(exog_size, output_size)
        self.lin = nn.Linear(output_size, output_size)
        self.u_out = nn.Linear(output_size, output_size, bias=False)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()
        self.skip = nn.Linear(input_size, output_size) \
            if skip_connection else None

    def reset_parameters(self, generator=None):
        for lin in (self.x_in, self.u_in, self.lin, self.skip):
            if lin is not None:
                reset_linear(lin, generator)
        lecun_normal_(self.u_out.weight, self.u_out.in_features, generator)

    def forward(self, x, u):
        act = get_activation(self.activation)
        out = self.lin(act(self.x_in(x))) + self.u_out(act(self.u_in(u)))
        out = self.dropout(act(out))
        if self.skip is not None:
            out = self.skip(x) + out
        return out


class GraphConv(nn.Module):
    """``op @ (x Theta) (+ x Theta_root) + b`` on a row-normalized operator
    (``tsl/nn/base/graph_conv.py:11-75``)."""

    def __init__(self, input_size: int, output_size: int,
                 root_weight: bool = True, use_bias: bool = True):
        super().__init__()
        self.lin = nn.Linear(input_size, output_size, bias=False)
        self.root = nn.Linear(input_size, output_size, bias=False) \
            if root_weight else None
        self.bias = nn.Parameter(torch.zeros(output_size)) \
            if use_bias else None

    def reset_parameters(self, generator=None):
        for lin in (self.lin, self.root):
            if lin is not None:
                lecun_normal_(lin.weight, lin.in_features, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, op: Operator):
        out = op @ self.lin(x)
        if self.root is not None:
            out = out + self.root(x)
        if self.bias is not None:
            out = out + self.bias
        return out


class GATConv(nn.Module):
    """Graph attention convolution (``graph_convs/gat_conv.py:19-287``,
    PyG-style): per-edge logits ``leaky_relu(<x_src, a_src> + <x_dst,
    a_dst>)`` of a shared projection ``lin`` (``input_size -> heads *
    output_size``), softmax over each destination's incoming edges, heads
    concatenated (``concat``) or averaged. ``x [..., n, input_size]``;
    ``src``/``dst`` ``[E]``."""

    def __init__(self, input_size: int, output_size: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2):
        super().__init__()
        self.output_size, self.heads = output_size, heads
        self.concat, self.negative_slope = concat, negative_slope
        self.lin = nn.Linear(input_size, heads * output_size)
        self.a_src = nn.Parameter(torch.empty(heads, output_size))
        self.a_dst = nn.Parameter(torch.empty(heads, output_size))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """flax's initializers: ``a_src``/``a_dst`` lecun-normal over their
        ``(heads, output_size)`` shape, whose fan-in is ``heads``."""
        reset_linear(self.lin, generator)
        lecun_normal_(self.a_src, self.heads, generator)
        lecun_normal_(self.a_dst, self.heads, generator)

    def forward(self, x, src, dst):
        h, dh = self.heads, self.output_size
        n = x.shape[-2]
        src, dst = src.long(), dst.long()
        xp = self.lin(x).view(x.shape[:-1] + (h, dh))     # [..., n, h, dh]
        alpha_src = (xp * self.a_src).sum(-1)             # [..., n, h]
        alpha_dst = (xp * self.a_dst).sum(-1)
        logits = F.leaky_relu(alpha_src[..., src, :] + alpha_dst[..., dst, :],
                              self.negative_slope)       # [..., e, h]
        # the edge axis leads for the segment ops
        att = segment_softmax(logits.movedim(-2, 0), dst, n)
        msgs = xp[..., src, :, :].movedim(-3, 0)          # [e, ..., h, dh]
        out = torch.zeros((n,) + msgs.shape[1:], dtype=msgs.dtype,
                          device=msgs.device)
        out = out.index_add(0, dst, msgs * att[..., None]).movedim(0, -3)
        if self.concat:
            return out.reshape(out.shape[:-2] + (h * dh,))
        return out.mean(-2)


class SpatioTemporalAttention(nn.Module):
    """Temporal then spatial attention sandwich
    (``graph_convs/spatio_temporal_att.py:7-59``) on ``[b s n c]``: an input
    projection ``proj`` when ``input_size`` differs from ``hidden_size``,
    then ``x = norm1(x + temporal(x))`` and ``norm2(x + spatial(x))``."""

    def __init__(self, hidden_size: int, n_heads: int = 1,
                 dropout: float = 0.0, input_size: Optional[int] = None):
        super().__init__()
        input_size = input_size or hidden_size
        self.proj = nn.Linear(input_size, hidden_size) \
            if input_size != hidden_size else None
        self.temporal = MultiHeadAttention(hidden_size, n_heads, "time",
                                           dropout=dropout)
        self.norm1 = layer_norm(hidden_size)
        self.spatial = MultiHeadAttention(hidden_size, n_heads, "nodes",
                                          dropout=dropout)
        self.norm2 = layer_norm(hidden_size)

    def forward(self, x):
        if self.proj is not None:
            x = self.proj(x)
        x = self.norm1(x + self.temporal(x))
        return self.norm2(x + self.spatial(x))


class GatedGraphNetwork(nn.Module):
    """Edge-gated message passing: ``m_ij = sigmoid(g(f([x_i, x_j]))) *
    f([x_i, x_j])`` summed into each destination, then an update MLP with a
    skip. The first edge-MLP layer is linear in ``[x_i, x_j]``, so its two
    halves run as node-space projections ``p_i`` and ``p_j`` (width
    ``output_size // 2``) and only those are gathered into edge space.

    Layers, in the JAX layer's creation order: ``p_i``, ``p_j`` (no bias),
    ``msg``, ``gate``, ``update1`` (on ``[agg, x]``), ``update2`` and, when
    the input width differs from ``output_size``, ``skip``.

    ``resid_budget_gb``: the all-pairs plain math checkpoints its blocks
    when this layer's saved residuals would exceed it (the JAX layer's
    heuristic; the model splits a 12 GB total across its layers).

    ``dtype`` (``torch.bfloat16``) runs every Linear of the layer and the
    messages in that dtype, with the float32 parameters cast at use as
    flax's ``Dense(dtype=)`` does; the neighbour sum accumulates in float32
    and the output comes back in the input's dtype. The kernels get the
    bf16 projections: K4 with float32 weights that it rounds to bf16 and
    float32 biases, K3 with all four rounded to bf16 (as the JAX layer
    passes them)."""

    def __init__(self, input_size: int, output_size: int,
                 activation: str = "silu", resid_budget_gb: float = 6.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        h2 = output_size // 2
        self.output_size = output_size
        self.activation = activation
        self.resid_budget_gb = resid_budget_gb
        self.dtype = dtype
        self.p_i = nn.Linear(input_size, h2)
        self.p_j = nn.Linear(input_size, h2, bias=False)
        self.msg = nn.Linear(h2, output_size)
        self.gate = nn.Linear(output_size, 1)
        self.update1 = nn.Linear(output_size + input_size, output_size)
        self.update2 = nn.Linear(output_size, output_size)
        self.skip = None if input_size == output_size \
            else nn.Linear(input_size, output_size)

    def reset_parameters(self, generator=None):
        reset_linear(self.p_i, generator)
        lecun_normal_(self.p_j.weight, self.p_j.in_features, generator)
        for lin in (self.msg, self.gate, self.update1, self.update2,
                    self.skip):
            if lin is not None:
                reset_linear(lin, generator)

    def _lin(self, lin: nn.Linear, x):
        return linear_as(lin, x, self.dtype)

    def forward(self, x, src=None, dst=None, edge_mask=None, neigh=None,
                adj=None, adj_band=None):
        act = get_activation(self.activation)
        n = x.shape[-2]
        acc = x.dtype if self.dtype is None else torch.float32
        p_i, p_j = self._lin(self.p_i, x), self._lin(self.p_j, x)
        if adj is not None:
            agg = self._all_pairs(p_i, p_j, adj, adj_band).to(acc)
        elif neigh is not None:
            src_idx, nmask = neigh
            d = src_idx.shape[1]
            pj_n = p_j[..., src_idx.reshape(-1).long(), :]
            pj_n = pj_n.reshape(pj_n.shape[:-2] + (n, d, -1))
            if self.activation in ACTIVATIONS:
                h2 = p_i.shape[-1]
                lead = p_i.shape[:-2]
                agg = gn_ell_aggregate(
                    p_i.reshape(-1, n, h2), pj_n.reshape(-1, n, d, h2),
                    nmask, self.msg.weight.T, self.msg.bias,
                    self.gate.weight.T, self.gate.bias, self.activation
                ).reshape(lead + (n, self.output_size)).to(acc)
            else:
                m = self._message(act(p_i.unsqueeze(-2) + pj_n))
                agg = (m * nmask.unsqueeze(-1)).to(acc).sum(-2)  # over D
        else:
            src, dst = src.long(), dst.long()
            m = self._message(act(p_i[..., dst, :] + p_j[..., src, :]))
            if edge_mask is not None:     # zero padding edges
                m = m * edge_mask.unsqueeze(-1)
            m = m.to(acc)
            agg = torch.zeros(m.shape[:-2] + (n, m.shape[-1]),
                              dtype=acc, device=m.device)
            agg.index_add_(m.ndim - 2, dst, m)
        out = self._lin(self.update1, torch.cat([agg, x.to(agg.dtype)], -1))
        out = self._lin(self.update2, act(out))
        skip = x if self.skip is None else self._lin(self.skip, x)
        return (out + skip).to(x.dtype)

    def _all_pairs(self, p_i, p_j, adj, band):
        lead, (n, h2) = p_i.shape[:-2], p_i.shape[-2:]
        if self.activation in ACTIVATIONS:
            cd = p_i.dtype     # the JAX layer casts all four to it
            return gn_allpairs_aggregate(
                p_i.reshape(-1, n, h2), p_j.reshape(-1, n, h2), adj,
                self.msg.weight.T.to(cd), self.msg.bias.to(cd),
                self.gate.weight.T.to(cd), self.gate.bias.to(cd),
                self.activation, band
            ).reshape(lead + (n, self.output_size))
        act = get_activation(self.activation)
        # the masked sum's products and sums in f32 (the JAX layer's
        # preferred_element_type) when the messages are bf16
        acc = p_i.dtype if self.dtype is None else torch.float32
        mask = (adj != 0).to(acc)

        def block(pi_b, pj_b, mask_b):
            m = self._message(act(pi_b.unsqueeze(-2) + pj_b.unsqueeze(-3)))
            return torch.einsum("ij,...ijh->...ih", mask_b, m.to(acc))

        if band is None:
            w_mean = n
        elif isinstance(band[1], (tuple, list)):
            w_mean = sum(band[1]) / len(band[1])
        else:
            w_mean = band[1]
        resid_gb = (int(np.prod(lead)) or 1) * n * w_mean * \
            self.output_size * p_i.element_size() / 2 ** 30
        run = (lambda *a: checkpoint(block, *a, use_reentrant=False)) \
            if resid_gb > self.resid_budget_gb else block
        return torch.cat([run(p_i[..., r0:r1, :], p_j[..., c0:c1, :],
                              mask[r0:r1, c0:c1])
                          for r0, r1, c0, c1 in row_blocks(
                              n, self.output_size, p_i.element_size(), band)],
                         dim=-2)

    def _message(self, m):
        m = get_activation(self.activation)(self._lin(self.msg, m))
        return torch.sigmoid(self._lin(self.gate, m)) * m
