"""Randomized echo-state reservoir over time.

Counterpart of ``sgp_tpu/encode/reservoir.py``. The per-step update

    h' = (1 - alpha) * h + alpha * act(W_ih x + b_ih + W_hh h)

runs for every layer in turn (layer i feeds layer i+1's input); the scan
over time is a Python loop, and the per-step states of all layers are
concatenated channel-wise, ``[T, N, L*H]``.

Initialization draws from numpy's ``default_rng(seed)`` exactly as the JAX
package does, so the same seed gives bit-identical weights in both.
``reservoir_scan(mode="wavefront")`` is the JAX package's layer-pipelined
scan: layer ``i`` computes time ``t`` at iteration ``t + i``, so the L
layer updates of one iteration are one pair of batched products; ``auto``
picks the sequential scan, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from sgp_tpu_torch.ops.linalg import spectral_radius_exact
from sgp_tpu_torch.utils.device import resolve_device


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
    (alpha decremented by 0.1 per layer, clipped to [0.1, 1]). The weights
    live on ``device`` (default ``cuda:0``; ``"cpu"`` for the CPU)."""

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
                   with_state: bool = False, mode: str = "auto"):
    """The scan of ``sgp_tpu.encode.reservoir.reservoir_scan``: all batch
    axes are flattened, ``h0`` defaults to zeros of x's dtype, and the
    output is written into one preallocated ``[T, B, L*H]`` tensor.
    ``mode``: ``"sequential"`` (the layers one after another at each
    step), ``"wavefront"`` (:func:`_wavefront_scan`: the same recurrence,
    the L layer updates of an iteration batched), or ``"auto"``
    (sequential, as the JAX package picks)."""
    act = _ACTIVATIONS[activation]
    batch_shape = x.shape[1:-1]
    x2 = x.reshape(x.shape[0], -1, x.shape[-1])  # [T, B, F]
    if h0 is None:
        h0 = [torch.zeros((x2.shape[1], p.w_hh.shape[0]), dtype=x.dtype,
                          device=x.device) for p in layers]
    if mode == "auto":
        mode = "sequential"
    if mode == "wavefront":
        out, h = _wavefront_scan(layers, act, x2, list(h0), out_dtype)
    elif mode == "sequential":
        h = list(h0)
        out = torch.empty((x2.shape[0], x2.shape[1],
                           sum(p.w_hh.shape[0] for p in layers)),
                          dtype=out_dtype or x.dtype, device=x.device)
        for t in range(x2.shape[0]):
            h = _reservoir_step(layers, act, h, x2[t])
            out[t] = torch.cat(h, dim=-1)
    else:
        raise ValueError(f"unknown scan mode {mode!r}")
    if return_last_state:
        return torch.cat(h, -1).reshape(batch_shape + (-1,))
    out = out.reshape((x.shape[0],) + batch_shape + (out.shape[-1],))
    if with_state:
        return out, h
    return out


def _wavefront_scan(layers, act, x2: torch.Tensor, h0, out_dtype,
                    time_chunk: int = 256):
    """The layer-pipelined scan of ``x2 [T, B, F]``.

    At iteration ``s`` of a time chunk starting at ``t0``, layer ``i``
    computes its state for time ``t_i = t0 + s - i`` from its own state
    and layer ``i-1``'s (which holds ``h_{i-1}(t_i)``, updated the
    iteration before): one ``[L, B, P] x [L, P, H]`` and one ``[L, B, H] x
    [L, H, H]`` batched product (P = max(F, H), inputs zero-padded to P).
    Only the layers with ``t0 <= t_i < t0 + TC`` and ``t_i < T`` keep
    their update, so after the chunk's ``L - 1`` flush iterations every
    layer holds its state at the chunk's last step (the carry is aligned
    at every chunk boundary), and the next chunk refills the pipeline
    from it. Iteration ``s`` emits every layer's state; layer ``i``'s
    state at chunk time ``r`` sits at iteration ``r + i``, so L slices
    realign the chunk into the output. The chunk length TC divides T where
    a divisor lies near ``time_chunk`` (:func:`_pick_time_chunk`), which
    bounds the emission buffer to ``O(TC * L * B * H)``."""
    t_total, b, f = x2.shape
    l_n = len(layers)
    h = layers[0].w_hh.shape[0]
    p_dim = max(f, h)
    dev = x2.device
    w_in = torch.zeros((l_n, p_dim, h), dtype=x2.dtype, device=dev)
    for i, p in enumerate(layers):
        w_in[i, :p.w_ih.shape[1]] = p.w_ih.T
    w_hh = torch.stack([p.w_hh.T for p in layers])           # [L, H, H]
    bias = torch.stack([p.b_ih if p.b_ih is not None
                        else torch.zeros(h, device=dev)
                        for p in layers])[:, None, :]        # [L, 1, H]
    alpha = torch.tensor([p.alpha for p in layers], dtype=torch.float32,
                         device=dev)[:, None, None]
    tc = _pick_time_chunk(t_total, time_chunk)
    out_dtype = out_dtype or x2.dtype
    out = torch.empty((t_total, b, l_n * h), dtype=out_dtype, device=dev)
    emitted = torch.empty((tc + l_n - 1, l_n, b, h), dtype=out_dtype,
                          device=dev)
    inp = torch.zeros((l_n, b, p_dim), dtype=x2.dtype, device=dev)
    hcur = torch.stack(h0)                                   # [L, B, H]
    for t0 in range(0, t_total, tc):
        n_valid = min(tc, t_total - t0)
        for s in range(n_valid + l_n - 1):
            # layers i with t0 <= t0 + s - i < min(t0 + tc, T)
            lo, hi = max(0, s - n_valid + 1), min(l_n, s + 1)
            if s < n_valid:
                inp[0, :, :f] = x2[t0 + s]
            else:                  # flush: layer 0 is idle from here on
                inp[0, :, :f] = 0
            inp[1:, :, :h] = hcur[:-1]
            pre = torch.baddbmm(torch.baddbmm(bias, inp, w_in), hcur, w_hh)
            upd = (1.0 - alpha) * hcur + alpha * act(pre)
            hcur[lo:hi] = upd[lo:hi]
            emitted[s] = hcur
        for i in range(l_n):
            out[t0:t0 + n_valid, :, i * h:(i + 1) * h] = \
                emitted[i:i + n_valid, i]
    return out, [hcur[i] for i in range(l_n)]


def _pick_time_chunk(t_total: int, target: int) -> int:
    """A divisor of ``t_total`` near ``target``: searched over [target,
    target/4], then (target, 4*target]; ``target`` (a ragged last chunk)
    when none lies there, ``t_total`` when it is at most ``target``."""
    if t_total <= target:
        return t_total
    for d in range(target, max(target // 4, 1) - 1, -1):
        if t_total % d == 0:
            return d
    for d in range(target + 1, min(4 * target, t_total) + 1):
        if t_total % d == 0:
            return d
    return target
