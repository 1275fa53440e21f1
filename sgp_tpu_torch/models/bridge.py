"""Load a flax ``SGPModel`` parameter tree into the port's :class:`SGPModel`.

The tree comes as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, params)``), with or without its top-level
``"params"`` key. Module names follow flax's creation order
(``GroupedLinear_0``, ``StaticGraphEmbedding_0``, ``Dense_0``,
``ResidualMLP_0/…`` or ``MLP_0/…``, ``LinearReadout_0/Dense_0``); ``Dense``
kernels are transposed from flax's ``[in, out]`` to ``nn.Linear``'s
``[out, in]``. Any key missing from the tree or left over in it raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from sgp_tpu_torch.models.blocks import MLP
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


def _flatten(tree: dict, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            flat.update(_flatten(value, prefix + (key,)))
        else:
            flat[prefix + (key,)] = np.asarray(value)
    return flat


def flax_to_torch(params_np: dict, model: SGPModel) -> SGPModel:
    """Copy the flax tree ``params_np`` into ``model`` in place; returns
    the model."""
    _load(params_np, _targets(model))
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
