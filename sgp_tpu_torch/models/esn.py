"""Echo-state network baseline: a frozen reservoir and a trained linear
readout.

Counterpart of ``sgp_tpu/models/esn.py::ESNModel``: the window ``x [b, s,
n, f]`` (with the exogenous input appended) runs through the reservoir
over its ``s`` steps for every (batch, node) series at once, and the last
state of every layer feeds a :class:`LinearReadout`. The reservoir's
weights are buffers, not parameters: they move with the module and take no
gradient. Only the readout trains.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from sgp_tpu_torch.encode.reservoir import (Reservoir, ReservoirLayerParams,
                                            reservoir_scan)
from sgp_tpu_torch.models.blocks import LinearReadout, maybe_cat_exog


class ESNModel(nn.Module):
    def __init__(self, reservoir_layers: Sequence[ReservoirLayerParams],
                 reservoir_activation: str, output_size: int, horizon: int):
        super().__init__()
        self.reservoir_activation = reservoir_activation
        self.alphas = [float(p.alpha) for p in reservoir_layers]
        self.has_bias = [p.b_ih is not None for p in reservoir_layers]
        for i, p in enumerate(reservoir_layers):
            self.register_buffer(f"w_ih_{i}", p.w_ih.detach().clone())
            self.register_buffer(f"w_hh_{i}", p.w_hh.detach().clone())
            if p.b_ih is not None:
                self.register_buffer(f"b_ih_{i}", p.b_ih.detach().clone())
        state = sum(p.w_hh.shape[0] for p in reservoir_layers)
        self.readout = LinearReadout(state, output_size, horizon)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.readout.reset_parameters(generator)

    def layers(self):
        """The reservoir as :class:`ReservoirLayerParams`, on the module's
        device."""
        return [ReservoirLayerParams(
            getattr(self, f"w_ih_{i}"), getattr(self, f"w_hh_{i}"),
            getattr(self, f"b_ih_{i}") if bias else None, alpha)
            for i, (alpha, bias) in enumerate(zip(self.alphas,
                                                  self.has_bias))]

    def forward(self, x, u=None, training: bool = False, **kwargs):
        # x: [b s n f]; ``training`` is the JAX model's keyword, unused
        x = maybe_cat_exog(x, u)
        b, s, n, f = x.shape
        xt = x.transpose(0, 1).reshape(s, b * n, f)       # [s, (b n), f]
        h = reservoir_scan(self.layers(), self.reservoir_activation, xt,
                           return_last_state=True)        # [(b n), L*H]
        return self.readout(h.reshape(b, n, -1))

    @staticmethod
    def build(input_size, hidden_size, output_size, exog_size, rec_layers,
              horizon, activation="tanh", spectral_radius=0.9,
              leaking_rate=0.9, density=0.7, seed=0) -> "ESNModel":
        """The reservoir drawn from ``seed`` as the JAX package draws it
        (numpy's generator: the same weights bit for bit), on the CPU; the
        trainer moves the model to its device."""
        res = Reservoir(input_size=input_size + exog_size,
                        hidden_size=hidden_size, num_layers=rec_layers,
                        leaking_rate=leaking_rate,
                        spectral_radius=spectral_radius, density=density,
                        activation=activation, seed=seed, device="cpu")
        return ESNModel(res.layers, activation, output_size, horizon)
