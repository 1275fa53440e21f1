"""Graph echo-state network (the DynGESN encoder).

Counterpart of ``sgp_tpu/encode/graph_reservoir.py``. The recurrent term
is propagated over the graph,

    h' = (1 - alpha) * h + alpha * act(W_ih x + b + A @ (h W_hh^T))

with A the row-normalized adjacency (self-loops added by
:class:`~sgp_tpu_torch.encode.encoders.GESNEncoder`). Each layer-step is a
GEMM and one ``op @ x`` through the port's operator: under a
:class:`~sgp_tpu_torch.ops.spmm.BSROperator` that is one launch of the
block-sparse kernel at F = H (a leading stream axis folds into the
columns). Stacked layers' states are concatenated channel-wise,
``[T, N, L*H]``.

Initialization draws from numpy's ``default_rng(seed)`` exactly as the JAX
package does (:func:`~sgp_tpu_torch.encode.reservoir._init_layer`), so the
same seed gives bit-identical weights in both.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from sgp_tpu_torch.encode.reservoir import (_ACTIVATIONS,
                                            ReservoirLayerParams,
                                            _init_layer)
from sgp_tpu_torch.utils.device import resolve_device


class GraphESN:
    """Stacked frozen GESN layers, initialized as
    :class:`~sgp_tpu_torch.encode.reservoir.Reservoir`. The weights live on
    ``device`` (default ``cuda:0``; ``"cpu"`` for the CPU)."""

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
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        layers: List[ReservoirLayerParams] = []
        alpha = leaking_rate
        for i in range(num_layers):
            layers.append(_init_layer(
                rng, input_size if i == 0 else hidden_size, hidden_size,
                spectral_radius, alpha, density, input_scaling, bias, 1.0,
                device))
            if alpha_decay:
                alpha = float(np.clip(alpha - 0.1, 0.1, 1.0))
        self.layers = layers

    @classmethod
    def from_arrays(cls, weights: Sequence[dict], activation: str = "tanh",
                    device=None) -> "GraphESN":
        """Layers from arrays: dicts with ``w_ih [H, F]``, ``w_hh [H, H]``,
        an optional ``b_ih [H]`` and ``alpha``."""
        device = resolve_device(device)

        def dev(a):
            return torch.as_tensor(np.array(a, np.float32), device=device)

        obj = cls.__new__(cls)
        obj.activation = activation
        obj.layers = [ReservoirLayerParams(
            dev(w["w_ih"]), dev(w["w_hh"]),
            None if w.get("b_ih") is None else dev(w["b_ih"]),
            float(w.get("alpha", 0.9))) for w in weights]
        obj.num_layers = len(obj.layers)
        obj.hidden_size = obj.layers[0].w_hh.shape[0]
        obj.input_size = obj.layers[0].w_ih.shape[1]
        return obj

    @property
    def output_size(self) -> int:
        return self.num_layers * self.hidden_size

    def __call__(self, x: torch.Tensor, op, return_last_state: bool = False,
                 out_dtype=None, h0=None, with_state: bool = False):
        """``x [T, ..., N, F]`` and a normalized operator ->
        ``[T, ..., N, L*H]``. Each step is cast to ``out_dtype`` as it is
        written into one preallocated output (the f32 state history is
        never built). ``h0``/``with_state`` carry the per-layer states
        across calls (streaming, online serving); ``return_last_state``
        gives only the last step's ``[..., N, L*H]``."""
        return gesn_scan(self.layers, self.activation, op, x,
                         return_last_state, out_dtype=out_dtype, h0=h0,
                         with_state=with_state)

    def step(self, h: Sequence[torch.Tensor], op, x_t: torch.Tensor):
        """One step for every layer: ``x_t [..., N, F]`` and the per-layer
        state list -> the new state list."""
        return _gesn_step(self.layers, _ACTIVATIONS[self.activation], op,
                          list(h), x_t)


def _gesn_cell(p, act, op, h, x_t):
    rec = op @ (h @ p.w_hh.T)           # A (h W_hh^T): the product over nodes
    pre = x_t @ p.w_ih.T + rec
    if p.b_ih is not None:
        pre = pre + p.b_ih
    return (1.0 - p.alpha) * h + p.alpha * act(pre)


def _gesn_step(layers, act, op, h, x_t):
    new_h = []
    inp = x_t
    for i, p in enumerate(layers):
        hi = _gesn_cell(p, act, op, h[i], inp)
        new_h.append(hi)
        inp = hi
    return new_h


def gesn_scan(layers, activation: str, op, x: torch.Tensor,
              return_last_state: bool = False, out_dtype=None, h0=None,
              with_state: bool = False):
    """The scan of ``sgp_tpu.encode.graph_reservoir.gesn_scan``: ``h0``
    defaults to zeros of x's dtype, and each step is written into one
    preallocated ``[T, ..., N, L*H]`` tensor."""
    act = _ACTIVATIONS[activation]
    if h0 is None:
        h0 = [torch.zeros(x.shape[1:-1] + (p.w_hh.shape[0],),
                          dtype=x.dtype, device=x.device) for p in layers]
    h = list(h0)
    if return_last_state:
        for t in range(x.shape[0]):
            h = _gesn_step(layers, act, op, h, x[t])
        return torch.cat(h, -1)
    width = sum(p.w_hh.shape[0] for p in layers)
    out = torch.empty(x.shape[:-1] + (width,), dtype=out_dtype or x.dtype,
                      device=x.device)
    for t in range(x.shape[0]):
        h = _gesn_step(layers, act, op, h, x[t])
        out[t] = torch.cat(h, -1)
    if with_state:
        return out, h
    return out
