"""Load a flax parameter tree into the port's :class:`SGPModel` or
:class:`GatedGraphNetworkMLPModel`.

The tree comes as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, params)``), with or without its top-level
``"params"`` key. Module names follow flax's creation order: for SGP
``GroupedLinear_0``, ``StaticGraphEmbedding_0``, ``Dense_0``,
``ResidualMLP_0/…`` or ``MLP_0/…``, ``LinearReadout_0/Dense_0``; for
GatedGN see :func:`_gated_gn_targets`. ``Dense``
kernels are transposed from flax's ``[in, out]`` to ``nn.Linear``'s
``[out, in]``. Any key missing from the tree or left over in it raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from sgp_tpu_torch.models.blocks import MLP
from sgp_tpu_torch.models.gated_gn import GatedGraphNetworkMLPModel
from sgp_tpu_torch.models.graph_layers import GatedGraphNetwork
from sgp_tpu_torch.models.sgp import SGPModel

Path = Tuple[str, ...]


def _linear(out: dict, prefix: Path, lin: nn.Linear):
    out[prefix + ("kernel",)] = (lin.weight, True)
    out[prefix + ("bias",)] = (lin.bias, False)


def _trunk(out: dict, scope: Path, trunk: nn.Module):
    """An ``MLP`` or ``ResidualMLP``: flax numbers every Dense-named
    submodule of the trunk with one shared counter, in creation order."""
    k = 0
    for layer in trunk.layers:
        dense = layer if isinstance(trunk, MLP) else layer.dense
        _linear(out, scope + (f"Dense_{k}", "Dense_0"), dense.linear)
        k += 1
        if not isinstance(trunk, MLP):
            _linear(out, scope + (f"Dense_{k}",), layer.linear)
            k += 1
            if layer.skip is not None:
                _linear(out, scope + (f"Dense_{k}",), layer.skip)
                k += 1
    if trunk.readout is not None:
        _linear(out, scope + (f"Dense_{k}",), trunk.readout)


def _targets(model: SGPModel) -> Dict[Path, Tuple[torch.Tensor, bool]]:
    """flax path -> (torch parameter, transpose?) for every parameter."""
    out: Dict[Path, Tuple[torch.Tensor, bool]] = {}
    n_dense = 0
    if isinstance(model.encoder, nn.Linear):
        _linear(out, (f"Dense_{n_dense}",), model.encoder)
        n_dense += 1
    else:
        out[("GroupedLinear_0", "kernel")] = (model.encoder.weight, False)
        out[("GroupedLinear_0", "bias")] = (model.encoder.bias, False)
    if model.emb is not None:
        out[("StaticGraphEmbedding_0", "emb")] = (model.emb.emb, False)
        _linear(out, (f"Dense_{n_dense}",), model.emb_proj)
    trunk = model.mlp
    _trunk(out, ("MLP_0",) if isinstance(trunk, MLP) else ("ResidualMLP_0",),
           trunk)
    _linear(out, ("LinearReadout_0", "Dense_0"), model.readout.linear)
    return out


def _gn_layer(out: dict, scope: Path, layer: GatedGraphNetwork):
    """One ``GatedGraphNetwork``: ``Dense_0`` p_i, ``Dense_1`` p_j (no
    bias), ``Dense_2`` message, ``Dense_3`` gate, ``Dense_4`` and
    ``Dense_5`` the update, ``Dense_6`` the skip when there is one."""
    _linear(out, scope + ("Dense_0",), layer.p_i)
    out[scope + ("Dense_1", "kernel")] = (layer.p_j.weight, True)
    for k, lin in enumerate((layer.msg, layer.gate, layer.update1,
                             layer.update2, layer.skip), start=2):
        if lin is not None:
            _linear(out, scope + (f"Dense_{k}",), lin)


def _gated_gn_targets(model: GatedGraphNetworkMLPModel
                      ) -> Dict[Path, Tuple[torch.Tensor, bool]]:
    """The MLP encoder's input Dense is ``Dense_0``; in each residual block
    ``Dense(h)(act(Dense(h)(h)))`` the outer Dense is constructed first and
    takes the lower number though it is applied second. Then the embedding,
    the ``GatedGraphNetwork_i`` layers, the decoder Dense and the readout
    Dense."""
    out: Dict[Path, Tuple[torch.Tensor, bool]] = {}
    _linear(out, ("Dense_0",), model.enc_in)
    k = 1
    for blk in model.enc:
        _linear(out, (f"Dense_{k}",), blk["outer"])
        _linear(out, (f"Dense_{k + 1}",), blk["inner"])
        k += 2
    if model.emb is not None:
        out[("StaticGraphEmbedding_0", "emb")] = (model.emb.emb, False)
    for i, layer in enumerate(model.gnn):
        _gn_layer(out, (f"GatedGraphNetwork_{i}",), layer)
    _linear(out, (f"Dense_{k}",), model.dec)
    _linear(out, (f"Dense_{k + 1}",), model.readout)
    return out


def _flatten(tree: dict, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            flat.update(_flatten(value, prefix + (key,)))
        else:
            flat[prefix + (key,)] = np.asarray(value)
    return flat


def flax_to_torch(params_np: dict, model: nn.Module) -> nn.Module:
    """Copy the flax tree ``params_np`` into ``model`` (an ``SGPModel`` or a
    ``GatedGraphNetworkMLPModel``) in place; returns the model."""
    if isinstance(model, GatedGraphNetworkMLPModel):
        _load(params_np, _gated_gn_targets(model))
    elif isinstance(model, SGPModel):
        _load(params_np, _targets(model))
    else:
        raise TypeError(f"no flax mapping for {type(model).__name__}")
    return model


def _load(params_np: dict, targets: Dict[Path, Tuple[torch.Tensor, bool]]):
    """Copy ``params_np`` into the ``targets`` parameters, raising on any
    key missing or left over and on any shape that does not fit."""
    if set(params_np) == {"params"}:
        params_np = params_np["params"]
    flat = _flatten(params_np)
    missing = sorted("/".join(p) for p in targets.keys() - flat.keys())
    extra = sorted("/".join(p) for p in flat.keys() - targets.keys())
    if missing or extra:
        raise KeyError(f"flax tree does not match the model: missing "
                       f"{missing}, left over {extra}")
    with torch.no_grad():
        for path, (param, transpose) in targets.items():
            value = torch.from_numpy(np.array(
                flat[path].T if transpose else flat[path], np.float32))
            if value.shape != param.shape:
                raise ValueError(f"{'/'.join(path)}: flax shape "
                                 f"{tuple(flat[path].shape)} does not fit "
                                 f"{tuple(param.shape)}")
            param.copy_(value)
