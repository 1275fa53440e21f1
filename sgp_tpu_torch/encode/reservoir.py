"""Randomized echo-state reservoir over time.

Counterpart of ``sgp_tpu/encode/reservoir.py``. The per-step update

    h' = (1 - alpha) * h + alpha * act(W_ih x + b_ih + W_hh h)

runs for every layer in turn (layer i feeds layer i+1's input); the scan
over time is a Python loop, and the per-step states of all layers are
concatenated channel-wise, ``[T, N, L*H]``.

Initialization draws from numpy's ``default_rng(seed)`` exactly as the JAX
package does, so the same seed gives bit-identical weights in both.
The layer-pipelined ``mode="wavefront"`` scan of the JAX package is not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from sgp_tpu_torch.ops.linalg import spectral_radius_exact


def self_normalizing_activation(x: torch.Tensor, r: float = 1.0):
    """``r * x / ||x||_2`` along the channel axis."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return r * x / norm.clamp_min(1e-12)


_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
    "self_norm": self_normalizing_activation,
}


@dataclasses.dataclass(frozen=True)
class ReservoirLayerParams:
    w_ih: torch.Tensor            # [H, F_in]
    w_hh: torch.Tensor            # [H, H]
    b_ih: Optional[torch.Tensor]  # [H] or None
    alpha: float


def _init_layer(rng: np.random.Generator, input_size: int, hidden_size: int,
                spectral_radius: float, leaking_rate: float,
                density: float, in_scaling: float, bias: bool,
                bias_scale: float, device=None) -> ReservoirLayerParams:
    w_ih = rng.uniform(-1, 1, (hidden_size, input_size)) * in_scaling
    b_ih = rng.uniform(-1, 1, hidden_size) * bias_scale if bias else None
    w_hh = rng.uniform(-1, 1, (hidden_size, hidden_size))
    if density < 1:
        n_units = hidden_size * hidden_size
        mask = np.ones(n_units)
        drop = rng.permutation(n_units)[:int(n_units * (1 - density))]
        mask[drop] = 0.0
        w_hh = w_hh * mask.reshape(hidden_size, hidden_size)
    w_hh = w_hh * (spectral_radius / spectral_radius_exact(w_hh))

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return ReservoirLayerParams(dev(w_ih), dev(w_hh),
                                None if b_ih is None else dev(b_ih),
                                float(leaking_rate))


class Reservoir:
    """Stacked frozen echo-state layers with optional alpha decay
    (alpha decremented by 0.1 per layer, clipped to [0.1, 1])."""

    def __init__(self, input_size: int, hidden_size: int,
                 input_scaling: float = 1.0, num_layers: int = 1,
                 leaking_rate: float = 0.9, spectral_radius: float = 0.9,
                 density: float = 0.9, activation: str = "tanh",
                 bias: bool = True, alpha_decay: bool = False,
                 seed: int = 0, device=None):
        assert activation in _ACTIVATIONS, activation
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.activation = activation
        rng = np.random.default_rng(seed)
        layers: List[ReservoirLayerParams] = []
        alpha = leaking_rate
        for i in range(num_layers):
            layers.append(_init_layer(
                rng, input_size if i == 0 else hidden_size, hidden_size,
                spectral_radius, alpha, density, input_scaling,
                bias, 1.0, device))
            if alpha_decay:
                alpha = float(np.clip(alpha - 0.1, 0.1, 1.0))
        self.layers = layers

    @property
    def output_size(self) -> int:
        return self.num_layers * self.hidden_size

    def __call__(self, x: torch.Tensor, h0=None,
                 return_last_state: bool = False,
                 out_dtype=None, with_state: bool = False):
        """Run the scan. ``x [T, N, F]`` (or any flat batch axes) ->
        ``[T, N, L*H]``; ``return_last_state`` gives only the final step
        ``[N, L*H]``. ``out_dtype`` casts each step's output as it is
        written. ``with_state`` returns ``(out, last_h)``, the per-layer
        state list to feed back as ``h0``."""
        return reservoir_scan(self.layers, self.activation, x, h0,
                              return_last_state, out_dtype=out_dtype,
                              with_state=with_state)

    def step(self, h: Sequence[torch.Tensor], x_t: torch.Tensor):
        """Single-step update (streaming / incremental encoding)."""
        return _reservoir_step(self.layers, _ACTIVATIONS[self.activation],
                               list(h), x_t)


def _reservoir_step(layers, act, h, x_t):
    new_h = []
    inp = x_t
    for i, p in enumerate(layers):
        pre = inp @ p.w_ih.T + h[i] @ p.w_hh.T
        if p.b_ih is not None:
            pre = pre + p.b_ih
        hi = (1.0 - p.alpha) * h[i] + p.alpha * act(pre)
        new_h.append(hi)
        inp = hi
    return new_h


def reservoir_scan(layers, activation: str, x: torch.Tensor, h0=None,
                   return_last_state: bool = False, out_dtype=None,
                   with_state: bool = False):
    """The sequential scan of ``sgp_tpu.encode.reservoir.reservoir_scan``:
    all batch axes are flattened, ``h0`` defaults to zeros of x's dtype,
    and the output is written step by step into one preallocated
    ``[T, B, L*H]`` tensor."""
    act = _ACTIVATIONS[activation]
    batch_shape = x.shape[1:-1]
    x2 = x.reshape(x.shape[0], -1, x.shape[-1])  # [T, B, F]
    if h0 is None:
        h0 = [torch.zeros((x2.shape[1], p.w_hh.shape[0]), dtype=x.dtype,
                          device=x.device) for p in layers]
    h = list(h0)
    out = torch.empty((x2.shape[0], x2.shape[1],
                       sum(p.w_hh.shape[0] for p in layers)),
                      dtype=out_dtype or x.dtype, device=x.device)
    for t in range(x2.shape[0]):
        h = _reservoir_step(layers, act, h, x2[t])
        out[t] = torch.cat(h, dim=-1)
    if return_last_state:
        return torch.cat(h, -1).reshape(batch_shape + (-1,))
    out = out.reshape((x.shape[0],) + batch_shape + (out.shape[-1],))
    if with_state:
        return out, h
    return out
