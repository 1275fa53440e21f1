"""The rest of the spatiotemporal model zoo (``torch.nn``).

Counterpart of ``sgp_tpu/models/stgn_extra.py``:

- the GraphConv-gated recurrent cells :class:`GraphConvGRUCell` and
  :class:`GraphConvLSTMCell`, their stack :class:`GraphConvRNN`, and
  :class:`DenseDCRNNCell` (order-K dense diffusion gates);
- :class:`ConditionalTCNBlock`, :class:`InputEncoder` and
  :class:`STCNBlock` (a temporal convolution, a :class:`GraphConv` and a
  LayerNorm around a skip);
- the decoders :class:`MultiHorizonMLPDecoder`, :class:`GCNDecoder` and
  :class:`AttPool`;
- the forecasters :class:`STCNModel` and :class:`RNNEncGCNDecModel`
  (``TCNModel`` lives in ``models/tcn.py``);
- :class:`LinkPredictor`, :class:`DifferentiableBinarySampler` and
  :class:`NRIDCRNN`;
- the ops :class:`Lambda`, :class:`Concatenate` and :class:`Select`.

Every :class:`GraphConv` propagates by ``op @ lin(x)``: on a
:class:`~sgp_tpu_torch.ops.spmm.BSROperator` that is kernel K1 on the card,
once forward and once (on the transposed structure) backward, with the
leading axes of ``x`` folded into its columns. The recurrent cells run one
product a gate, as the JAX cells do.

PyTorch needs each layer's input width up front, so the constructors take
``input_size`` (the channels of ``x``, with those of ``u`` where a model
appends them) and ``exog_size`` where a layer reads ``u`` apart. Dropout
follows ``self.training``; the ``training`` keywords are taken and unused.
``reset_parameters(generator)`` draws from flax's initializers;
``models/bridge.py`` loads flax weights instead.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from sgp_tpu_torch.models.blocks import (MLP, MLPDecoder, StaticGraphEmbedding,
                                         get_activation, layer_norm,
                                         lecun_normal_, maybe_cat_exog,
                                         reset_flax, reset_linear)
from sgp_tpu_torch.models.graph_layers import ConditionalBlock, GraphConv
from sgp_tpu_torch.models.gwnet import DenseSpatialConvOrderK
from sgp_tpu_torch.models.rnn import RNNStack
from sgp_tpu_torch.models.tcn import TCNModel, TemporalConv, TemporalConvNet
from sgp_tpu_torch.ops.spmm import Operator

__all__ = ["GraphConvGRUCell", "GraphConvLSTMCell", "GraphConvRNN",
           "DenseDCRNNCell", "ConditionalTCNBlock", "InputEncoder",
           "STCNBlock", "MultiHorizonMLPDecoder", "GCNDecoder", "AttPool",
           "TCNModel", "STCNModel", "RNNEncGCNDecModel", "LinkPredictor",
           "DifferentiableBinarySampler", "NRIDCRNN", "Lambda",
           "Concatenate", "Select"]


def _reset_graph_convs(convs, generator=None):
    for conv in convs:
        conv.reset_parameters(generator)


# -- recurrent graph cells -------------------------------------------------

class GraphConvGRUCell(nn.Module):
    """A GRU whose gates are GraphConvs (``gcgru.py``): ``r`` and ``u`` of
    ``[x, h]``, the candidate of ``[x, r * h]``."""

    def __init__(self, input_size: int, hidden_size: int,
                 root_weight: bool = True):
        super().__init__()
        width = input_size + hidden_size
        self.r, self.u, self.c = (GraphConv(width, hidden_size, root_weight)
                                  for _ in range(3))

    def reset_parameters(self, generator=None):
        _reset_graph_convs((self.r, self.u, self.c), generator)

    def forward(self, x, h, op: Operator):
        xh = torch.cat([x, h], -1)
        r = torch.sigmoid(self.r(xh, op))
        u = torch.sigmoid(self.u(xh, op))
        c = torch.tanh(self.c(torch.cat([x, r * h], -1), op))
        return u * h + (1.0 - u) * c


class GraphConvLSTMCell(nn.Module):
    """An LSTM whose gates ``i``, ``f``, ``g``, ``o`` are GraphConvs of
    ``[x, h]`` (``gclstm.py``); returns ``(h', (h', c'))``."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        width = input_size + hidden_size
        self.i, self.f, self.g, self.o = (GraphConv(width, hidden_size)
                                          for _ in range(4))

    def reset_parameters(self, generator=None):
        _reset_graph_convs((self.i, self.f, self.g, self.o), generator)

    def forward(self, x, state, op: Operator):
        h, c = state
        xh = torch.cat([x, h], -1)
        i = torch.sigmoid(self.i(xh, op))
        f = torch.sigmoid(self.f(xh, op))
        g = torch.tanh(self.g(xh, op))
        o = torch.sigmoid(self.o(xh, op))
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GraphConvRNN(nn.Module):
    """``n_layers`` GraphConv-gated cells (``cell`` ``gru`` or ``lstm``)
    unrolled over ``x [b s n c]`` from zero states; returns the top
    layer's last hidden state ``[b n hidden]``."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int = 1,
                 cell: str = "gru"):
        super().__init__()
        if cell not in ("gru", "lstm"):
            raise ValueError(f"cell must be 'gru' or 'lstm', got {cell!r}")
        self.cell, self.hidden_size = cell, hidden_size
        make = GraphConvGRUCell if cell == "gru" else GraphConvLSTMCell
        self.cells = nn.ModuleList(
            make(input_size if i == 0 else hidden_size, hidden_size)
            for i in range(n_layers))

    def reset_parameters(self, generator=None):
        for cell in self.cells:
            cell.reset_parameters(generator)

    def forward(self, x, op: Operator):
        b, s, n, _ = x.shape

        def zeros():
            return x.new_zeros((b, n, self.hidden_size))
        state = [zeros() if self.cell == "gru" else (zeros(), zeros())
                 for _ in self.cells]
        for t in range(s):
            inp = x[:, t]
            for i, cell in enumerate(self.cells):
                if self.cell == "gru":
                    state[i] = inp = cell(inp, state[i], op)
                else:
                    inp, state[i] = cell(inp, state[i], op)
        return inp


class DenseDCRNNCell(nn.Module):
    """A GRU whose gates ``forget``, ``update`` and ``cand`` are order-``k``
    dense diffusions (:class:`DenseSpatialConvOrderK`) over ``adj``, one
    ``[n, n]`` support or ``n_supports`` stacked ones (``encoders/
    dense_dcrnn.py:7-80``; two from ``compute_support``)."""

    def __init__(self, input_size: int, hidden_size: int, k: int = 2,
                 n_supports: int = 2):
        super().__init__()
        width = input_size + hidden_size
        self.forget, self.update, self.cand = (
            DenseSpatialConvOrderK(width, hidden_size, k, n_supports)
            for _ in range(3))

    def reset_parameters(self, generator=None):
        for gate in (self.forget, self.update, self.cand):
            gate.reset_parameters(generator)

    def forward(self, x, h, adj: torch.Tensor):
        xh = torch.cat([x, h], -1)
        r = torch.sigmoid(self.forget(xh, adj))
        u = torch.sigmoid(self.update(xh, adj))
        c = torch.tanh(self.cand(torch.cat([x, r * h], -1), adj))
        return u * h + (1.0 - u) * c


# -- temporal/conditional blocks ------------------------------------------

class ConditionalTCNBlock(nn.Module):
    """A conditional block of temporal convolutions
    (``encoders/conditional.py:90-164``): ``act(x_lin(conv_x(x)) +
    u_lin(conv_u(u)))`` (the convolutions' activation unless ``gated``),
    dropout, and with ``skip_connection`` a Linear of x's last steps added.
    ``u`` is ``[b s n exog_size]``."""

    def __init__(self, input_size: int, exog_size: int, output_size: int,
                 kernel_size: int = 2, dilation: int = 1,
                 gated: bool = False, activation: str = "relu",
                 dropout: float = 0.0, skip_connection: bool = False):
        super().__init__()
        self.gated, self.activation = gated, activation
        self.conv_x = TemporalConv(input_size, output_size, kernel_size,
                                   dilation, gated=gated)
        self.conv_u = TemporalConv(exog_size, output_size, kernel_size,
                                   dilation, gated=gated)
        self.x_lin = nn.Linear(output_size, output_size)
        self.u_lin = nn.Linear(output_size, output_size, bias=False)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()
        self.skip = nn.Linear(input_size, output_size) \
            if skip_connection else None

    def reset_parameters(self, generator=None):
        self.conv_x.reset_parameters(generator)
        self.conv_u.reset_parameters(generator)
        reset_linear(self.x_lin, generator)
        lecun_normal_(self.u_lin.weight, self.u_lin.in_features, generator)
        if self.skip is not None:
            reset_linear(self.skip, generator)

    def forward(self, x, u, training: bool = False):
        act = get_activation(self.activation)
        xc, uc = self.conv_x(x), self.conv_u(u)
        if not self.gated:
            xc, uc = act(xc), act(uc)
        out = self.dropout(act(self.x_lin(xc) + self.u_lin(uc)))
        if self.skip is not None:
            out = out + self.skip(x[:, -out.shape[1]:])
        return out


class InputEncoder(nn.Module):
    """``enc_type`` ``conditional`` (with ``exog_size`` > 0): a
    :class:`ConditionalBlock` of x on u (a ``[b s c]`` u broadcast over the
    nodes); otherwise an :class:`MLP` layer over ``[x, u]``
    (``encoders/input_encoder.py:9-57``). The JAX layer picks the MLP when
    a conditional encoder is called without u; this one, whose widths are
    fixed at construction, raises then."""

    def __init__(self, input_size: int, output_size: int,
                 enc_type: str = "mlp", activation: str = "relu",
                 exog_size: int = 0):
        super().__init__()
        self.conditional = enc_type == "conditional" and exog_size > 0
        self.encoder = ConditionalBlock(input_size, exog_size, output_size,
                                        activation=activation) \
            if self.conditional else MLP(input_size + exog_size, output_size,
                                         activation=activation)

    def reset_parameters(self, generator=None):
        self.encoder.reset_parameters(generator)

    def forward(self, x, u=None, training: bool = False):
        if not self.conditional:
            return self.encoder(x, u)
        if u is None:
            raise ValueError("a conditional InputEncoder needs u")
        if u.ndim == 3:
            u = u[:, :, None, :].expand(x.shape[:3] + (u.shape[-1],))
        return self.encoder(x, u)


class STCNBlock(nn.Module):
    """A temporal convolution, a :class:`GraphConv` with the activation,
    dropout, the skip (x, or a Linear of x when its width differs from
    ``hidden_size``) and flax's LayerNorm (eps 1e-6)
    (``encoders/stcn.py:10-78``)."""

    def __init__(self, input_size: int, hidden_size: int,
                 temporal_kernel_size: int = 2, dilation: int = 1,
                 gated: bool = False, activation: str = "relu",
                 dropout: float = 0.0):
        super().__init__()
        self.activation = activation
        self.tcn = TemporalConvNet(input_size, hidden_size,
                                   temporal_kernel_size, dilation=dilation,
                                   gated=gated, activation=activation,
                                   dropout=dropout)
        self.conv = GraphConv(hidden_size, hidden_size)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()
        self.skip = nn.Linear(input_size, hidden_size) \
            if input_size != hidden_size else None
        self.norm = layer_norm(hidden_size)

    def reset_parameters(self, generator=None):
        self.tcn.reset_parameters(generator)
        self.conv.reset_parameters(generator)
        reset_flax(self.norm)
        if self.skip is not None:
            reset_linear(self.skip, generator)

    def forward(self, x, op: Operator, training: bool = False):
        act = get_activation(self.activation)
        h = self.dropout(act(self.conv(self.tcn(x), op)))
        skip = x if self.skip is None else self.skip(x)
        return self.norm(h + skip)


# -- decoders --------------------------------------------------------------

class MultiHorizonMLPDecoder(nn.Module):
    """One MLP shared by the horizon steps, applied to ``[h, step_emb[t]]``
    for each step t (``decoders/multi_step_mlp_decoder.py:8``): ``h [b n
    f]`` (or ``[b s n f]``, its last step) -> ``[b horizon n
    output_size]``."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 horizon: int, activation: str = "relu",
                 dropout: float = 0.0):
        super().__init__()
        self.horizon = horizon
        self.step_emb = nn.Parameter(torch.empty(horizon, hidden_size))
        self.mlp = MLP(input_size + hidden_size, hidden_size, output_size,
                       activation=activation, dropout=dropout)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.step_emb.normal_(0.0, 0.02, generator=generator)
        self.mlp.reset_parameters(generator)

    def forward(self, h, training: bool = False):
        if h.ndim == 4:
            h = h[:, -1]
        outs = [self.mlp(torch.cat([h, self.step_emb[t].expand(
            h.shape[:-1] + (self.step_emb.shape[1],))], -1))
            for t in range(self.horizon)]
        return torch.stack(outs, dim=1)


class GCNDecoder(nn.Module):
    """``n_layers`` GraphConvs with the activation, then an
    :class:`MLPDecoder` (``decoders/gcn_decoder.py:9``): ``h [b n
    input_size]`` (or ``[b s n f]``, its last step) -> ``[b horizon n
    output_size]``."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 horizon: int, n_layers: int = 1, activation: str = "relu",
                 dropout: float = 0.0):
        super().__init__()
        self.activation = activation
        self.convs = nn.ModuleList(
            GraphConv(input_size if i == 0 else hidden_size, hidden_size)
            for i in range(n_layers))
        self.readout = MLPDecoder(hidden_size if n_layers else input_size,
                                  hidden_size, output_size, horizon=horizon,
                                  activation=activation, dropout=dropout)

    def reset_parameters(self, generator=None):
        _reset_graph_convs(self.convs, generator)
        self.readout.reset_parameters(generator)

    def forward(self, h, op: Operator, training: bool = False):
        act = get_activation(self.activation)
        if h.ndim == 4:
            h = h[:, -1]
        for conv in self.convs:
            h = act(conv(h, op))
        return self.readout(h)


class AttPool(nn.Module):
    """Attention pooling over ``axis`` (``decoders/att_pool.py:5``): a
    Linear score a position, softmax over the axis, the weighted sum."""

    def __init__(self, input_size: int, axis: int = 1):
        super().__init__()
        self.axis = axis
        self.score = nn.Linear(input_size, 1)

    def reset_parameters(self, generator=None):
        reset_linear(self.score, generator)

    def forward(self, x):
        att = torch.softmax(self.score(x), dim=self.axis)
        return (x * att).sum(self.axis)


# -- models ----------------------------------------------------------------

class STCNModel(nn.Module):
    """Stacked :class:`STCNBlock` s (block i dilating by ``2 ** i``) and an
    :class:`MLPDecoder` on the last step (``models/stgn/
    stcn_model.py:13``): ``x [b s n c]`` (``u`` appended: ``input_size``
    counts both) and a row-normalized operator -> ``[b horizon n
    output_size]``."""

    def __init__(self, input_size: int, hidden_size: int, ff_size: int,
                 output_size: int, horizon: int, n_layers: int = 2,
                 temporal_kernel_size: int = 2, activation: str = "relu",
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            STCNBlock(input_size if i == 0 else hidden_size, hidden_size,
                      temporal_kernel_size, dilation=2 ** i,
                      activation=activation, dropout=dropout)
            for i in range(n_layers))
        self.decoder = MLPDecoder(hidden_size, ff_size, output_size,
                                  horizon=horizon, activation=activation)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        for block in self.blocks:
            block.reset_parameters(generator)
        self.decoder.reset_parameters(generator)

    def forward(self, x, op: Operator, u=None, training: bool = False,
                **kwargs):
        x = maybe_cat_exog(x, u)
        for block in self.blocks:
            x = block(x, op)
        return self.decoder(x[:, -1])


class RNNEncGCNDecModel(nn.Module):
    """A GRU encoder per node (:class:`RNNStack`) over the window, then a
    :class:`GCNDecoder` (``models/stgn/rnn2gcn_model.py:11``): ``x [b s n
    c]`` is folded into ``[b * n, s, c]`` for the GRU, its last states
    ``[b n hidden]`` go through the GraphConvs."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 horizon: int, rec_layers: int = 1, gcn_layers: int = 1,
                 activation: str = "relu", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rnn = RNNStack(input_size, hidden_size, rec_layers)
        self.decoder = GCNDecoder(hidden_size, hidden_size, output_size,
                                  horizon, n_layers=gcn_layers,
                                  activation=activation, dropout=dropout)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        self.rnn.reset_parameters(generator)
        self.decoder.reset_parameters(generator)

    def forward(self, x, op: Operator, u=None, training: bool = False,
                **kwargs):
        x = maybe_cat_exog(x, u)
        b, s, n, f = x.shape
        h = self.rnn(x.permute(0, 2, 1, 3).reshape(b * n, s, f))
        return self.decoder(h.reshape(b, n, -1), op)


class LinkPredictor(nn.Module):
    """Pairwise scores ``S = MLP_s(E) MLP_t(E)^T`` of node embeddings
    (``tsl/nn/layers/link_predictor.py:7-60``); each branch is a Linear to
    ``ff_size``, the activation, dropout and a Linear to ``hidden_size``."""

    def __init__(self, input_size: int, ff_size: int, hidden_size: int,
                 activation: str = "relu", dropout: float = 0.0):
        super().__init__()
        self.activation = activation
        self.src = nn.ModuleList([nn.Linear(input_size, ff_size),
                                  nn.Linear(ff_size, hidden_size)])
        self.dst = nn.ModuleList([nn.Linear(input_size, ff_size),
                                  nn.Linear(ff_size, hidden_size)])
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()

    def reset_parameters(self, generator=None):
        reset_flax(self, generator)

    def _branch(self, lins, x):
        return lins[1](self.dropout(get_activation(self.activation)(
            lins[0](x))))

    def forward(self, x, training: bool = False):
        z_s, z_t = self._branch(self.src, x), self._branch(self.dst, x)
        return torch.einsum("...ik,...jk->...ij", z_s, z_t)


class DifferentiableBinarySampler(nn.Module):
    """The Gumbel relaxation of a Bernoulli draw
    (``blocks/encoders/nri_dcrnn.py:12-29``): ``sigmoid((logit(p) +
    logit(U)) / tau)``. ``U`` is ``noise`` when given (the tests pass the
    JAX draw in, since its stream cannot be repeated here), else uniform
    draws from ``generator`` on the scores' device."""

    def forward(self, scores, tau: float,
                generator: Optional[torch.Generator] = None, noise=None):
        eps = 1e-8
        unif = noise if noise is not None else torch.rand(
            scores.shape, generator=generator, dtype=scores.dtype,
            device=scores.device)
        logit = (torch.log(scores + eps) - torch.log(1 - scores + eps)
                 + torch.log(unif + eps) - torch.log(1 - unif + eps))
        return torch.sigmoid(logit / tau)


class NRIDCRNN(nn.Module):
    """Neural relational inference DCRNN (``nri_dcrnn.py:33-69``): a dense
    adjacency scored by a :class:`LinkPredictor` over static node
    embeddings, sampled by :class:`DifferentiableBinarySampler` when a
    ``generator`` or ``noise`` is given (else the mean adjacency, the JAX
    model's call without an rng), row-normalized forward and backward
    (``DenseSpatialConvOrderK.compute_support``), driving
    :class:`DenseDCRNNCell` s over ``x [b s n c]``; returns the top layer's
    last state ``[b n hidden]``."""

    def __init__(self, input_size: int, hidden_size: int, emb_size: int,
                 n_nodes: int, n_layers: int = 1, k: int = 2,
                 tau: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.tau, self.hidden_size = tau, hidden_size
        self.emb = StaticGraphEmbedding(n_nodes, emb_size)
        self.link = LinkPredictor(emb_size, hidden_size, hidden_size)
        self.sampler = DifferentiableBinarySampler()
        self.cells = nn.ModuleList(
            DenseDCRNNCell(input_size if i == 0 else hidden_size,
                           hidden_size, k, n_supports=2)
            for i in range(n_layers))
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        self.emb.reset_parameters(generator)
        self.link.reset_parameters(generator)
        for cell in self.cells:
            cell.reset_parameters(generator)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                noise=None, training: bool = False):
        scores = torch.sigmoid(self.link(self.emb()))
        if generator is not None or noise is not None:
            scores = self.sampler(scores, self.tau, generator, noise)
        adj = DenseSpatialConvOrderK.compute_support(scores)
        b, s, n, _ = x.shape
        h = [x.new_zeros((b, n, self.hidden_size)) for _ in self.cells]
        for t in range(s):
            inp = x[:, t]
            for i, cell in enumerate(self.cells):
                h[i] = inp = cell(inp, h[i], adj)
        return h[-1]


# -- nn ops (``tsl/nn/ops/ops.py:9-39``) ----------------------------------

class Lambda(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class Concatenate(nn.Module):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, tensors: Sequence[torch.Tensor]):
        return torch.cat(list(tensors), dim=self.axis)


class Select(nn.Module):
    def __init__(self, axis: int, index: int):
        super().__init__()
        self.axis, self.index = axis, index

    def forward(self, x):
        return torch.select(x, self.axis, self.index)
