"""Autoregressive RNN imputers (``torch.nn``).

Counterpart of ``sgp_tpu/models/rnni.py`` (``tsl``'s ``rnni_models.py``):
a GRU or LSTM one-step-ahead predictor whose own previous prediction is
fed back wherever the input is missing, and the bidirectional variant that
reads out the forward and the time-reversed pass's hidden states together.

The JAX model's ``nn.scan`` over time is a Python loop over the window
here. The cells are flax's ``GRUCell`` and ``OptimizedLSTMCell`` written
out: the gate orders (r, z, n) and (i, f, g, o) and the bias placement of
``models/rnn.py::RNNStack``, with parameters only where flax has them (the
GRU's biases on the input side and on n's hidden side, the LSTM's on the
hidden side). ``state_init="noise"`` draws the initial state from a
``torch.Generator`` the caller passes, or takes it as ``state0``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sgp_tpu_torch.models.blocks import lecun_normal_, reset_linear
from sgp_tpu_torch.models.rnn import _orthogonal


def _broadcast_exog(u, x):
    """``u`` with a node axis matching ``x [b s n c]``."""
    if u is not None and u.ndim == 3:  # [b s e] -> [b s n e]
        u = u[:, :, None, :].expand(x.shape[:3] + (u.shape[-1],))
    return u


class FlaxRNNCell(nn.Module):
    """flax's ``GRUCell`` (``cell="gru"``; carry ``h``) or
    ``OptimizedLSTMCell`` (``"lstm"``; carry ``(c, h)``) on ``[B, F]``
    inputs; the gates stacked along the rows of ``weight_ih`` /
    ``weight_hh`` as in ``torch.nn.GRUCell`` / ``LSTMCell``."""

    def __init__(self, input_size: int, hidden_size: int, cell: str = "gru"):
        super().__init__()
        if cell not in ("gru", "lstm"):
            raise NotImplementedError(f'"{cell}" cell not implemented.')
        self.cell, self.hidden_size = cell, hidden_size
        gates = 3 if cell == "gru" else 4
        self.weight_ih = nn.Parameter(torch.empty(gates * hidden_size,
                                                  input_size))
        self.weight_hh = nn.Parameter(torch.empty(gates * hidden_size,
                                                  hidden_size))
        if cell == "gru":   # ir, iz, in; and hn
            self.bias_ih = nn.Parameter(torch.zeros(3 * hidden_size))
            self.bias_hn = nn.Parameter(torch.zeros(hidden_size))
        else:               # hi, hf, hg, ho
            self.bias_hh = nn.Parameter(torch.zeros(4 * hidden_size))

    def reset_parameters(self, generator=None):
        """flax's initializers: lecun-normal input kernels, orthogonal
        recurrent kernels (each gate's ``[h, h]`` block), zero biases."""
        h = self.hidden_size
        with torch.no_grad():
            for gate in self.weight_ih.view(-1, h, self.weight_ih.shape[1]):
                lecun_normal_(gate, self.weight_ih.shape[1], generator)
            for gate in self.weight_hh.view(-1, h, h):
                gate.copy_(_orthogonal(h, generator).T)
            for name, p in self.named_parameters():
                if name.startswith("bias"):
                    p.zero_()

    def zero_carry(self, batch: int, like: torch.Tensor):
        h = like.new_zeros((batch, self.hidden_size))
        return h if self.cell == "gru" else (torch.zeros_like(h), h)

    def noise_carry(self, batch: int, like: torch.Tensor, generator=None):
        def one():
            return torch.randn((batch, self.hidden_size), generator=generator,
                               dtype=like.dtype, device=like.device)
        return one() if self.cell == "gru" else (one(), one())

    @staticmethod
    def visible(carry):
        """The state ``h`` a readout sees (the LSTM carry is ``(c, h)``)."""
        return carry[1] if isinstance(carry, tuple) else carry

    def forward(self, x, carry):
        if self.cell == "gru":
            h = carry
            ir, iz, in_ = F.linear(x, self.weight_ih,
                                   self.bias_ih).chunk(3, -1)
            hr, hz, hn = F.linear(h, self.weight_hh).chunk(3, -1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            n = torch.tanh(in_ + r * (hn + self.bias_hn))
            return (1.0 - z) * n + z * h
        c, h = carry
        i, f, g, o = (F.linear(x, self.weight_ih)
                      + F.linear(h, self.weight_hh, self.bias_hh)).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


class RNNImputerModel(nn.Module):
    """One-step-ahead recurrent imputer. ``process_nodes_independently``
    folds the nodes into the batch (one cell a node, shared weights);
    otherwise every node's channels form one sequence (``n_nodes``
    needed). ``preds[t]`` predicts step ``t`` from the observations up to
    ``t - 1``; ``preds[0]`` is the readout of the initial state.
    ``exog_size`` counts the channels of ``u`` a node."""

    def __init__(self, input_size: int, hidden_size: int,
                 exog_size: int = 0, cell: str = "gru",
                 concat_mask: bool = True, n_nodes: Optional[int] = None,
                 process_nodes_independently: bool = False,
                 detach_input: bool = False, state_init: str = "zero",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not process_nodes_independently and n_nodes is None:
            raise ValueError("n_nodes is required unless "
                             "process_nodes_independently=True")
        if state_init not in ("zero", "noise"):
            raise ValueError(f"state_init must be 'zero' or 'noise', got "
                             f"{state_init!r}")
        self.indep = process_nodes_independently
        self.concat_mask, self.detach_input = concat_mask, detach_input
        self.state_init = state_init
        per = 1 if process_nodes_independently else n_nodes
        self.flat_size = input_size * per
        width = self.flat_size * (2 if concat_mask else 1) + exog_size * per
        self.rnn_cell = FlaxRNNCell(width, hidden_size, cell)
        self.readout = nn.Linear(hidden_size, self.flat_size)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        self.rnn_cell.reset_parameters(generator)
        reset_linear(self.readout, generator)

    def forward(self, x, mask, u=None, training: bool = False,
                return_hidden: bool = False, generator=None, state0=None):
        """``x``, ``mask`` ``[b s n c]``; ``u`` ``[b s e]`` or ``[b s n
        e]``. ``state0`` is the initial carry (``h``, or ``(c, h)`` for
        the LSTM); without it ``state_init`` gives zeros or a standard
        normal draw from ``generator``. Returns ``x_hat`` (and the hidden
        states ``[b s (n) h]`` with ``return_hidden``)."""
        b, s, n, c = x.shape
        u = _broadcast_exog(u, x)

        def flat(v):   # [b s n f] -> time-major [s, b*n, f] or [s, b, n*f]
            v = v.permute(1, 0, 2, 3)
            return v.reshape(s, b * n, -1) if self.indep \
                else v.reshape(s, b, -1)
        xf, mf = flat(x), flat(mask.to(x.dtype))
        uf = flat(u) if u is not None and u.shape[-1] else None
        if state0 is not None:
            carry = state0
        elif self.state_init == "noise":
            carry = self.rnn_cell.noise_carry(xf.shape[1], x, generator)
        else:
            carry = self.rnn_cell.zero_carry(xf.shape[1], x)
        h = self.rnn_cell.visible(carry)
        x_hat = self.readout(h)
        preds, hs = [x_hat], [h]
        # step t reads x[t] and predicts x[t + 1]: the last step is not read
        for t in range(s - 1):
            fill = x_hat.detach() if self.detach_input else x_hat
            parts = [torch.where(mf[t].bool(), xf[t], fill)]
            if uf is not None:
                parts.append(uf[t])
            if self.concat_mask:
                parts.append(mf[t])
            carry = self.rnn_cell(torch.cat(parts, -1), carry)
            h = self.rnn_cell.visible(carry)
            x_hat = self.readout(h)
            preds.append(x_hat)
            hs.append(h)
        x_hat = torch.stack(preds).reshape(s, b, n, c).permute(1, 0, 2, 3)
        if not return_hidden:
            return x_hat
        hs = torch.stack(hs)                                  # [s B h]
        if self.indep:
            return x_hat, hs.reshape(s, b, n, -1).permute(1, 0, 2, 3)
        return x_hat, hs.permute(1, 0, 2)                     # [b s h]


class BiRNNImputerModel(nn.Module):
    """Forward and time-reversed one-step imputers (``fwd_rnn``,
    ``bwd_rnn``), hidden states concatenated, dropout, and one Linear
    readout. Returns ``(x_hat, (x_hat_fwd, x_hat_bwd))``. Dropout follows
    ``self.training``; ``state0`` is ``(fwd carry, bwd carry)``."""

    def __init__(self, input_size: int, hidden_size: int,
                 exog_size: int = 0, cell: str = "gru",
                 concat_mask: bool = True, n_nodes: Optional[int] = None,
                 process_nodes_independently: bool = False,
                 detach_input: bool = False, state_init: str = "zero",
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(input_size=input_size, hidden_size=hidden_size,
                  exog_size=exog_size, cell=cell, concat_mask=concat_mask,
                  n_nodes=n_nodes,
                  process_nodes_independently=process_nodes_independently,
                  detach_input=detach_input, state_init=state_init)
        self.fwd_rnn = RNNImputerModel(**kw)
        self.bwd_rnn = RNNImputerModel(**kw)
        self.indep = process_nodes_independently
        self.dropout = nn.Dropout(dropout)
        self.readout = nn.Linear(2 * hidden_size, input_size * (
            1 if process_nodes_independently else n_nodes))
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        self.fwd_rnn.reset_parameters(generator)
        self.bwd_rnn.reset_parameters(generator)
        reset_linear(self.readout, generator)

    def forward(self, x, mask, u=None, training: bool = False,
                generator=None, state0=None):
        u = _broadcast_exog(u, x)

        def rev(v):
            return None if v is None else v.flip(1)
        s_f, s_b = (None, None) if state0 is None else state0
        x_hat_fwd, h_fwd = self.fwd_rnn(x, mask, u=u, return_hidden=True,
                                        generator=generator, state0=s_f)
        x_hat_bwd, h_bwd = self.bwd_rnn(rev(x), rev(mask), u=rev(u),
                                        return_hidden=True,
                                        generator=generator, state0=s_b)
        x_hat_bwd, h_bwd = rev(x_hat_bwd), rev(h_bwd)
        x_hat = self.readout(self.dropout(torch.cat([h_fwd, h_bwd], -1)))
        if not self.indep:
            x_hat = x_hat.reshape(x.shape)
        return x_hat, (x_hat_fwd, x_hat_bwd)
