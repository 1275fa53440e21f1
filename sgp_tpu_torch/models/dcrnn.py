"""DCRNN baseline (``torch.nn``).

Counterpart of ``sgp_tpu/models/dcrnn.py`` (``tsl``'s ``dcrnn_model.py``,
``blocks/encoders/dcrnn.py`` and ``gcrnn.py``): a GRU whose gates are
diffusion convolutions, unrolled over the window, on the supports of
``models/graph_layers.py::diff_conv_support`` (or, for subgraph batches,
``diff_conv_support_from_arrays``) passed at call time.

A cell runs its diffusion products once for the three gates: r and u
read the same hops of ``[x, h]``, and the candidate's hops of ``[x, r*h]``
reuse their x channels, so a cell call takes ``2 * k`` products per
support (8 with two supports at k 2, not 12). On BSR supports each product
is one launch of kernel K1 on the card, and one more in the backward.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from sgp_tpu_torch.models.blocks import MLPDecoder, reset_linear
from sgp_tpu_torch.models.graph_layers import ConditionalBlock, DiffConv
from sgp_tpu_torch.ops.spmm import Operator


class DCRNNCell(nn.Module):
    """``h' = u * h + (1 - u) * c`` with ``r``, ``u`` and ``c`` from
    diffusion convolutions of ``[x, h]`` and ``[x, r * h]``."""

    def __init__(self, input_size: int, hidden_size: int, k: int = 2,
                 root_weight: bool = True):
        super().__init__()
        self.k = k
        width = input_size + hidden_size
        self.r, self.u, self.c = (DiffConv(width, hidden_size, k, root_weight)
                                  for _ in range(3))

    def reset_parameters(self, generator=None):
        for conv in (self.r, self.u, self.c):
            conv.reset_parameters(generator)

    def forward(self, x, h, supports: Sequence[Operator]):
        f_in = x.shape[-1]
        xh = torch.cat([x, h], -1)
        hops_xh = DiffConv.hops(xh, supports, self.k)
        r = torch.sigmoid(self.r(xh, supports, hops=hops_xh))
        u = torch.sigmoid(self.u(xh, supports, hops=hops_xh))
        w = r * h
        hops_xc = [torch.cat([hx[..., :f_in], hw], -1) for hx, hw in
                   zip(hops_xh, DiffConv.hops(w, supports, self.k))]
        c = torch.tanh(self.c(torch.cat([x, w], -1), supports, hops=hops_xc))
        return u * h + (1.0 - u) * c


class DCRNN(nn.Module):
    """``n_layers`` stacked :class:`DCRNNCell` s over ``x [b s n c]``, the
    time loop unrolled; returns the top layer's last state ``[b n h]``."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int = 1,
                 k: int = 2, root_weight: bool = True):
        super().__init__()
        self.hidden_size = hidden_size
        self.cells = nn.ModuleList(
            DCRNNCell(input_size if i == 0 else hidden_size, hidden_size, k,
                      root_weight) for i in range(n_layers))

    def reset_parameters(self, generator=None):
        for cell in self.cells:
            cell.reset_parameters(generator)

    def forward(self, x, supports: Sequence[Operator]):
        b, s, n, _ = x.shape
        h = [x.new_zeros((b, n, self.hidden_size)) for _ in self.cells]
        for t in range(s):
            inp = x[:, t]
            for i, cell in enumerate(self.cells):
                h[i] = cell(inp, h[i], supports)
                inp = h[i]
        return h[-1]


class DCRNNModel(nn.Module):
    """An input encoder (a :class:`ConditionalBlock` on ``u`` when
    ``exog_size`` > 0, else a Linear), :class:`DCRNN` and an
    :class:`MLPDecoder`: ``x [b s n input_size]`` -> ``[b horizon n
    output_size]``, on the two supports of :func:`diff_conv_support`."""

    def __init__(self, input_size: int, hidden_size: int, ff_size: int,
                 output_size: int, horizon: int, n_layers: int = 1,
                 exog_size: int = 0, kernel_size: int = 2,
                 activation: str = "relu", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.exog_size = exog_size
        self.encoder = ConditionalBlock(input_size, exog_size, hidden_size,
                                        activation=activation) \
            if exog_size else nn.Linear(input_size, hidden_size)
        self.dcrnn = DCRNN(hidden_size, hidden_size, n_layers, kernel_size)
        self.decoder = MLPDecoder(hidden_size, ff_size, output_size,
                                  horizon=horizon, activation=activation,
                                  dropout=dropout)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        if isinstance(self.encoder, nn.Linear):
            reset_linear(self.encoder, generator)
        else:
            self.encoder.reset_parameters(generator)
        self.dcrnn.reset_parameters(generator)
        self.decoder.reset_parameters(generator)

    def forward(self, x, supports: Sequence[Operator], u=None,
                training: bool = False, **kwargs):
        """``training`` is taken and unused: dropout follows
        ``self.training``."""
        if u is not None and self.exog_size:
            if u.ndim == 3:
                u = u[:, :, None, :]
            u = u.expand(x.shape[:3] + (u.shape[-1],))
            x = self.encoder(x, u)
        else:
            x = self.encoder(x)
        return self.decoder(self.dcrnn(x, supports))
