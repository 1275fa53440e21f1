"""GRIN imputation family (``torch.nn``).

Counterpart of ``sgp_tpu/models/grin.py`` (``tsl``'s ``grin_cell.py`` and
``grin_model.py``): a DCRNN-cell recurrence whose input at each step is the
series with its missing values filled in two stages, first a readout of
the hidden state, then a spatial decoder that aggregates the neighbours'
information over the diffusion supports. The bidirectional model runs one
:class:`GRIL` forward in time and another on the time-reversed series and
merges them with an MLP.

Every diffusion hop is ``op @ x`` on a support of
``models/graph_layers.py::diff_conv_support``: on BSR supports each is one
launch of kernel K1 on the card. A step of one direction runs 10 hops on
the two supports at ``kernel_size`` 2 and ``decoder_order`` 1: 2 for the
decoder and 8 for the cell (:class:`~sgp_tpu_torch.models.dcrnn.DCRNNCell`
shares the gates' hops).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from sgp_tpu_torch.models.blocks import MLP, StaticGraphEmbedding
from sgp_tpu_torch.models.blocks import layer_norm as flax_layer_norm
from sgp_tpu_torch.models.blocks import reset_linear
from sgp_tpu_torch.models.dcrnn import DCRNNCell
from sgp_tpu_torch.models.graph_layers import DiffConv
from sgp_tpu_torch.ops.spmm import Operator


class SpatialDecoder(nn.Module):
    """``[x, mask, h(, u)]`` -> Linear -> a diffusion convolution without
    root weight -> ``[., h]`` -> Linear -> PReLU with one learned slope
    (initialized to 0.25) -> ``repr = [z, h]`` -> the imputation. Returns
    ``(imputation, repr)``."""

    def __init__(self, input_size: int, hidden_size: int, order: int = 1,
                 exog_size: int = 0, n_supports: int = 2):
        super().__init__()
        self.lin_in = nn.Linear(2 * input_size + hidden_size + exog_size,
                                hidden_size)
        self.conv = DiffConv(hidden_size, hidden_size, order,
                             root_weight=False, n_supports=n_supports)
        self.prelu_slope = nn.Parameter(torch.tensor(0.25))
        self.lin_out = nn.Linear(2 * hidden_size, hidden_size)
        self.readout = nn.Linear(2 * hidden_size, input_size)

    def reset_parameters(self, generator=None):
        for lin in (self.lin_in, self.lin_out, self.readout):
            reset_linear(lin, generator)
        self.conv.reset_parameters(generator)
        with torch.no_grad():
            self.prelu_slope.fill_(0.25)

    def forward(self, x, mask, h, supports: Sequence[Operator], u=None):
        x_in = [x, mask, h] + ([u] if u is not None else [])
        out = self.conv(self.lin_in(torch.cat(x_in, -1)), supports)
        z = self.lin_out(torch.cat([out, h], -1))
        z = torch.where(z >= 0, z, self.prelu_slope * z)
        repr_s = torch.cat([z, h], -1)
        return self.readout(repr_s), repr_s


class GRIL(nn.Module):
    """One direction: at each step the first-stage readout of the top
    hidden state fills the missing points, the spatial decoder fills them
    again, and the filled ``[x, mask(, u)]`` updates the DCRNN cells.
    ``x``, ``mask`` ``[b s n c]``; returns ``(imputations, predictions,
    representations)`` stacked over time. The initial states are a learned
    node embedding a layer when ``n_nodes`` is given, else zeros."""

    def __init__(self, input_size: int, hidden_size: int,
                 exog_size: int = 0, n_layers: int = 1,
                 n_nodes: Optional[int] = None, kernel_size: int = 2,
                 decoder_order: int = 1, layer_norm: bool = False,
                 n_supports: int = 2):
        super().__init__()
        self.hidden_size = hidden_size
        rnn_in = 2 * input_size + exog_size
        self.cells = nn.ModuleList(
            DCRNNCell(rnn_in if i == 0 else hidden_size, hidden_size,
                      kernel_size) for i in range(n_layers))
        self.norms = nn.ModuleList(
            flax_layer_norm(hidden_size) if layer_norm else nn.Identity()
            for _ in range(n_layers))
        self.first_stage = nn.Linear(hidden_size, input_size)
        self.decoder = SpatialDecoder(input_size, hidden_size,
                                      decoder_order, exog_size, n_supports)
        self.h0 = None if n_nodes is None else nn.ModuleList(
            StaticGraphEmbedding(n_nodes, hidden_size)
            for _ in range(n_layers))

    def reset_parameters(self, generator=None):
        for cell in self.cells:
            cell.reset_parameters(generator)
        for norm in self.norms:
            if isinstance(norm, nn.LayerNorm):
                norm.reset_parameters()
        reset_linear(self.first_stage, generator)
        self.decoder.reset_parameters(generator)
        for emb in self.h0 or ():
            emb.reset_parameters(generator)

    def forward(self, x, supports: Sequence[Operator], mask=None, u=None):
        b, s, n, _ = x.shape
        mask = torch.ones_like(x) if mask is None else mask.to(x.dtype)
        if self.h0 is not None:
            h = [emb()[None].expand(b, n, self.hidden_size)
                 for emb in self.h0]
        else:
            h = [x.new_zeros((b, n, self.hidden_size)) for _ in self.cells]
        imputations, predictions, reprs = [], [], []
        for t in range(s):
            x_s, m_s = x[:, t], mask[:, t]
            u_s = u[:, t] if u is not None else None
            observed = m_s.bool()
            h_top = h[-1]
            xs_hat_1 = self.first_stage(h_top)
            x_s = torch.where(observed, x_s, xs_hat_1)
            xs_hat_2, repr_s = self.decoder(x_s, m_s, h_top, supports, u=u_s)
            x_s = torch.where(observed, x_s, xs_hat_2)
            rnn_in = torch.cat([x_s, m_s] + ([u_s] if u_s is not None
                                             else []), -1)
            for i, (cell, norm) in enumerate(zip(self.cells, self.norms)):
                h[i] = norm(cell(rnn_in, h[i], supports))
                rnn_in = h[i]
            imputations.append(xs_hat_2)
            predictions.append(xs_hat_1)
            reprs.append(repr_s)
        return (torch.stack(imputations, 1), torch.stack(predictions, 1),
                torch.stack(reprs, 1))


class GRINModel(nn.Module):
    """Bidirectional GRIL: ``fwd`` on the series, ``bwd`` on the series
    reversed in time, merged by an MLP of ``[repr_f, repr_b, mask]``
    (``merge_mode="mlp"``, which needs the mask) or by their mean. Returns
    ``(merged, (imp_f, pred_f), (imp_b, pred_b))``, the stage outputs
    feeding the trainer's auxiliary losses. ``training`` is taken and
    unused: dropout follows ``self.training``."""

    def __init__(self, input_size: int, hidden_size: int,
                 exog_size: int = 0, n_layers: int = 1,
                 n_nodes: Optional[int] = None, kernel_size: int = 2,
                 decoder_order: int = 1, ff_size: int = 64,
                 merge_mode: str = "mlp", n_supports: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(input_size=input_size, hidden_size=hidden_size,
                  exog_size=exog_size, n_layers=n_layers, n_nodes=n_nodes,
                  kernel_size=kernel_size, decoder_order=decoder_order,
                  n_supports=n_supports)
        self.fwd, self.bwd = GRIL(**kw), GRIL(**kw)
        self.merge_mode = merge_mode
        self.merge = MLP(4 * hidden_size + input_size, ff_size, input_size) \
            if merge_mode == "mlp" else None
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        self.fwd.reset_parameters(generator)
        self.bwd.reset_parameters(generator)
        if self.merge is not None:
            self.merge.reset_parameters(generator)

    def forward(self, x, supports: Sequence[Operator], mask=None, u=None,
                training: bool = False, **kwargs):
        if self.merge is not None and mask is None:
            raise ValueError("merge_mode='mlp' merges with the mask: pass "
                             "mask")

        def rev(a):
            return None if a is None else a.flip(1)

        imp_f, pred_f, repr_f = self.fwd(x, supports, mask=mask, u=u)
        imp_b, pred_b, repr_b = (rev(a) for a in self.bwd(
            rev(x), supports, mask=rev(mask), u=rev(u)))
        if self.merge is not None:
            merged = self.merge(torch.cat([repr_f, repr_b, mask.to(x.dtype)],
                                          -1))
        else:
            merged = 0.5 * (imp_f + imp_b)
        return merged, (imp_f, pred_f), (imp_b, pred_b)
