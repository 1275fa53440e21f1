"""GRU and LSTM baselines (``torch.nn``).

Counterpart of ``sgp_tpu/models/rnn.py`` (``tsl/nn/models/rnn_model.py``):
:class:`RNNModel` runs a recurrent encoder per node over the window and an
:class:`MLPDecoder` on its last state; :class:`FCRNNModel` runs one sequence
over all nodes' channels flattened.

The recurrence is ``torch.nn.GRU`` / ``torch.nn.LSTM`` (cuDNN on the card)
in place of flax's ``nn.RNN`` scan over ``GRUCell`` /
``OptimizedLSTMCell``. Both packages use the gate orders (r, z, n) and
(i, f, g, o), but flax's cells have fewer biases: ``GRUCell`` none on the
hidden side's r and z gates, ``OptimizedLSTMCell`` none on the input side.
The torch biases those cells lack are held at 0: the forward reads them
through a mask, so their gradient is 0 and Adam leaves them at 0.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.func import functional_call

from sgp_tpu_torch.models.blocks import (MLPDecoder, lecun_normal_,
                                         maybe_cat_exog)


class RNNStack(nn.Module):
    """``n_layers`` GRU or LSTM layers over ``x [b, s, f]`` -> the last
    step's state ``[b, hidden]``, from zero initial states. The sequences
    go through the recurrence ``CHUNK`` at a time: they are independent,
    and cuDNN's LSTM backward over one batch of 321,024 (64 windows of
    5,016 series) asks for a 40 GiB workspace (on an NVIDIA H100)."""

    CHUNK = 65536

    def __init__(self, input_size: int, hidden_size: int, n_layers: int = 1,
                 cell: str = "gru"):
        super().__init__()
        if cell not in ("gru", "lstm"):
            raise ValueError(f"cell must be 'gru' or 'lstm', got {cell!r}")
        self.cell, self.hidden_size = cell, hidden_size
        rnn = nn.GRU if cell == "gru" else nn.LSTM
        self.rnn = rnn(input_size, hidden_size, num_layers=n_layers,
                       batch_first=True)
        # 1 where flax's cell has the bias, 0 where it has none
        h = hidden_size
        keep_ih = torch.ones(3 * h) if cell == "gru" else torch.zeros(4 * h)
        keep_hh = torch.cat([torch.zeros(2 * h), torch.ones(h)]) \
            if cell == "gru" else torch.ones(4 * h)
        self.register_buffer("keep_ih", keep_ih, persistent=False)
        self.register_buffer("keep_hh", keep_hh, persistent=False)

    def reset_parameters(self, generator=None):
        """flax's initializers: lecun-normal input kernels, orthogonal
        recurrent kernels (each gate's ``[h, h]`` block), zero biases."""
        h = self.hidden_size
        for name, p in self.rnn.named_parameters():
            with torch.no_grad():
                if name.startswith("weight_ih"):
                    for gate in p.view(-1, h, p.shape[1]):
                        lecun_normal_(gate, p.shape[1], generator)
                elif name.startswith("weight_hh"):
                    for gate in p.view(-1, h, h):
                        gate.copy_(_orthogonal(h, generator).T)
                else:
                    p.zero_()

    def forward(self, x):
        masked = {}
        for name, p in self.rnn.named_parameters():
            if name.startswith("bias_"):
                masked[name] = p * (self.keep_ih if name.startswith(
                    "bias_ih") else self.keep_hh)
        return torch.cat([functional_call(self.rnn, masked, (part,))[0][:, -1]
                          for part in x.split(self.CHUNK)])


def _orthogonal(n: int, generator=None) -> torch.Tensor:
    """An ``[n, n]`` orthogonal matrix from the QR of a standard normal one
    (jax's ``orthogonal`` initializer)."""
    a = torch.randn(n, n, generator=generator)
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))


class RNNModel(nn.Module):
    """Per-node recurrent encoder + :class:`MLPDecoder`: ``x [b s n f]``
    (with ``u`` appended: ``input_size`` counts both) ->
    ``[b horizon n output_size]``."""

    def __init__(self, input_size: int, output_size: int, horizon: int,
                 hidden_size: int = 64, ff_size: int = 64,
                 rec_layers: int = 1, ff_layers: int = 1,
                 cell_type: str = "gru", activation: str = "relu",
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rnn = RNNStack(input_size, hidden_size, rec_layers, cell_type)
        self.decoder = MLPDecoder(hidden_size, ff_size, output_size,
                                  horizon=horizon, n_layers=ff_layers,
                                  activation=activation, dropout=dropout)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        self.rnn.reset_parameters(generator)
        self.decoder.reset_parameters(generator)

    def forward(self, x, u=None, training: bool = False, **kwargs):
        """``training`` and the runners' other keywords are taken and
        unused: dropout follows ``self.training``."""
        x = maybe_cat_exog(x, u)
        b, s, n, f = x.shape
        h = self.rnn(x.permute(0, 2, 1, 3).reshape(b * n, s, f))
        return self.decoder(h.reshape(b, n, -1))


class FCRNNModel(nn.Module):
    """FC-GRU/LSTM: one sequence over the flattened (node, channel) axis,
    ``input_size`` = ``n_nodes`` times the channels of ``x`` and ``u``."""

    def __init__(self, input_size: int, n_nodes: int, output_size: int,
                 horizon: int, hidden_size: int = 64, ff_size: int = 64,
                 rec_layers: int = 1, ff_layers: int = 1,
                 cell_type: str = "gru", activation: str = "relu",
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_nodes, self.output_size, self.horizon = \
            n_nodes, output_size, horizon
        self.rnn = RNNStack(input_size, hidden_size, rec_layers, cell_type)
        self.decoder = MLPDecoder(hidden_size, ff_size,
                                  output_size * n_nodes, horizon=horizon,
                                  n_layers=ff_layers, activation=activation,
                                  dropout=dropout)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        self.rnn.reset_parameters(generator)
        self.decoder.reset_parameters(generator)

    def forward(self, x, u=None, training: bool = False, **kwargs):
        x = maybe_cat_exog(x, u)
        b, s, n, f = x.shape
        h = self.rnn(x.reshape(b, s, n * f))[:, None, :]   # one "node"
        out = self.decoder(h)                              # [b h 1 (n c)]
        return out.reshape(b, self.horizon, self.n_nodes, self.output_size)
