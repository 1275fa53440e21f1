"""Shared trainable NN blocks (``torch.nn``).

Counterparts of ``sgp_tpu/models/blocks.py``. PyTorch needs each layer's
input width up front, so every block takes ``input_size``. The public
layouts stay the JAX package's: :class:`GroupedLinear` keeps its
``[groups, in/groups, out/groups]`` weight and :class:`LinearReadout`
returns ``[b, h, n, c]``. Each block's ``reset_parameters(generator)``
draws from the distributions flax initializes with: lecun-normal kernels
(a normal truncated at two standard deviations), zero biases, and
U(±1/√emb) for the node embedding. ``models/bridge.py`` loads flax
weights instead.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

_ACT = {
    "relu": torch.relu, "silu": F.silu, "elu": F.elu, "tanh": torch.tanh,
    "leaky_relu": F.leaky_relu, "sigmoid": torch.sigmoid,
    # flax's nn.gelu is the tanh approximation by default
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "softplus": F.softplus, "identity": lambda x: x, "linear": lambda x: x,
}

# std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def get_activation(name: str) -> Callable:
    return _ACT[name]


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    """flax's ``lecun_normal``: N(0, 1/fan_in) truncated at ±2 std, by
    inverse-CDF sampling."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
        t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)
    return t


def reset_linear(lin: nn.Linear, generator=None):
    """flax ``nn.Dense`` init: lecun-normal kernel, zero bias."""
    lecun_normal_(lin.weight, lin.in_features, generator)
    nn.init.zeros_(lin.bias)


def reset_flax(module: nn.Module, generator=None):
    """flax's initializers for every ``nn.Linear`` (lecun-normal kernel,
    zero bias) and ``nn.LayerNorm`` (unit scale, zero bias) in ``module``."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            reset_linear(m, generator)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def layer_norm(size: int) -> nn.LayerNorm:
    """flax's ``nn.LayerNorm``: epsilon 1e-6 (torch's default is 1e-5)."""
    return nn.LayerNorm(size, eps=1e-6)


def maybe_cat_exog(x, u):
    """Concat exogenous onto x along channels, broadcasting missing axes."""
    if u is None:
        return x
    if u.ndim < x.ndim:  # u [..., F] global vs x [..., N, C]
        u = u.unsqueeze(-2).expand(x.shape[:-1] + (u.shape[-1],))
    return torch.cat([x, u], dim=-1)


class Dense(nn.Module):
    """Linear -> activation -> dropout."""

    def __init__(self, input_size: int, output_size: int,
                 activation: str = "relu", dropout: float = 0.0):
        super().__init__()
        self.linear = nn.Linear(input_size, output_size)
        self.activation = activation
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()

    def reset_parameters(self, generator=None):
        reset_linear(self.linear, generator)

    def forward(self, x):
        return self.dropout(_ACT[self.activation](self.linear(x)))


class GroupedLinear(nn.Module):
    """Feature-grouped projection: input channels split into ``groups``
    equal blocks, each with its own weight (a 1x1 grouped convolution),
    as one batched matmul."""

    def __init__(self, input_size: int, output_size: int, groups: int):
        super().__init__()
        assert input_size % groups == 0 and output_size % groups == 0, \
            f"channels in {input_size} / out {output_size} not divisible " \
            f"by {groups} groups"
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(
            groups, input_size // groups, output_size // groups))
        self.bias = nn.Parameter(torch.empty(output_size))

    def reset_parameters(self, generator=None):
        g, i, _ = self.weight.shape
        lecun_normal_(self.weight, g * i, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        g, i, o = self.weight.shape
        xg = x.reshape(x.shape[:-1] + (g, i))
        out = torch.einsum("...gi,gio->...go", xg, self.weight)
        return out.reshape(x.shape[:-1] + (g * o,)) + self.bias


class MLP(nn.Module):
    """Stacked Dense layers + optional readout."""

    def __init__(self, input_size: int, hidden_size: int,
                 output_size: Optional[int] = None, n_layers: int = 1,
                 activation: str = "relu", dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            Dense(input_size if i == 0 else hidden_size, hidden_size,
                  activation, dropout) for i in range(n_layers))
        self.readout = None if output_size is None else \
            nn.Linear(hidden_size, output_size)

    def reset_parameters(self, generator=None):
        for layer in self.layers:
            layer.reset_parameters(generator)
        if self.readout is not None:
            reset_linear(self.readout, generator)

    def forward(self, x, u=None):
        x = maybe_cat_exog(x, u)
        for layer in self.layers:
            x = layer(x)
        if self.readout is not None:
            x = self.readout(x)
        return x


class ResidualMLP(nn.Module):
    """MLP with (optionally parametrized) skip connections. Layer ``i``
    holds ``dense`` (Dense block), ``linear`` and ``skip`` (a Linear, or
    None for the identity skip)."""

    def __init__(self, input_size: int, hidden_size: int,
                 output_size: Optional[int] = None, n_layers: int = 1,
                 activation: str = "relu", dropout: float = 0.0,
                 parametrized_skip: bool = False):
        super().__init__()
        self.layers = nn.ModuleList()
        for i in range(n_layers):
            in_size = input_size if i == 0 else hidden_size
            layer = nn.Module()
            layer.dense = Dense(in_size, hidden_size, activation, dropout)
            layer.linear = nn.Linear(hidden_size, hidden_size)
            layer.skip = nn.Linear(in_size, hidden_size) \
                if (i == 0 and in_size != hidden_size) or parametrized_skip \
                else None
            self.layers.append(layer)
        self.readout = None if output_size is None else \
            nn.Linear(hidden_size, output_size)

    def reset_parameters(self, generator=None):
        for layer in self.layers:
            layer.dense.reset_parameters(generator)
            reset_linear(layer.linear, generator)
            if layer.skip is not None:
                reset_linear(layer.skip, generator)
        if self.readout is not None:
            reset_linear(self.readout, generator)

    def forward(self, x, u=None):
        x = maybe_cat_exog(x, u)
        for layer in self.layers:
            h = layer.linear(layer.dense(x))
            x = h + (x if layer.skip is None else layer.skip(x))
        if self.readout is not None:
            x = self.readout(x)
        return x


class LinearReadout(nn.Module):
    """Last-step linear multi-horizon readout: ``[b (s) n f]`` ->
    ``[b h n c]``."""

    def __init__(self, input_size: int, output_size: int, horizon: int = 1):
        super().__init__()
        self.output_size = output_size
        self.horizon = horizon
        self.linear = nn.Linear(input_size, output_size * horizon)

    def reset_parameters(self, generator=None):
        reset_linear(self.linear, generator)

    def forward(self, h):
        if h.ndim == 4:
            h = h[:, -1]
        out = self.linear(h)
        # [b n (h c)] -> [b h n c]
        b, n = out.shape[0], out.shape[1]
        return out.reshape(b, n, self.horizon, self.output_size
                           ).permute(0, 2, 1, 3)


class MLPDecoder(nn.Module):
    """The last ``receptive_field`` steps flattened per node -> MLP ->
    horizon (``blocks/decoders/mlp_decoder.py:9-55``): ``[b (s) n f]`` ->
    ``[b h n c]``; ``input_size`` is ``f``."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 horizon: int = 1, receptive_field: int = 1,
                 n_layers: int = 1, activation: str = "relu",
                 dropout: float = 0.0):
        super().__init__()
        self.output_size, self.horizon = output_size, horizon
        self.receptive_field = receptive_field
        self.mlp = MLP(receptive_field * input_size, hidden_size,
                       output_size * horizon, n_layers=n_layers,
                       activation=activation, dropout=dropout)

    def reset_parameters(self, generator=None):
        self.mlp.reset_parameters(generator)

    def forward(self, h):
        if h.ndim == 4:   # [b s n f] -> [b n (r f)]
            h = h[:, -self.receptive_field:].permute(0, 2, 1, 3)
            h = h.reshape(h.shape[0], h.shape[1], -1)
        out = self.mlp(h)
        b, n = out.shape[0], out.shape[1]
        return out.reshape(b, n, self.horizon, self.output_size
                           ).permute(0, 2, 1, 3)


class StaticGraphEmbedding(nn.Module):
    """Learned per-node embedding table with optional ``token_index``
    gather; initialized U(-1/sqrt(emb), +1/sqrt(emb))."""

    def __init__(self, n_tokens: int, emb_size: int):
        super().__init__()
        self.emb = nn.Parameter(torch.empty(n_tokens, emb_size))

    def reset_parameters(self, generator=None):
        bound = 1.0 / (self.emb.shape[1] ** 0.5)
        with torch.no_grad():
            self.emb.uniform_(-bound, bound, generator=generator)

    def forward(self, token_index=None):
        if token_index is not None:
            return self.emb[token_index]
        return self.emb
