"""The windowed spatiotemporal dataset over host arrays.

A numpy copy of the part of ``sgp_tpu/data/spatiotemporal.py`` that the
training slices reach, held bit-exact against it by the parity tests: the
whole series lives as contiguous host arrays and a batch is one vectorized
gather over window and horizon steps. A covariate may instead be a torch
tensor (the encoded features that ``encode_dataset(device_resident=True)``
keeps on the device): every gather that touches it then runs where it
lives, with no copy to the host, and hands the model f32 features.

Layout: target ``[T, N, C]`` float32, mask ``[T, N, C]`` bool, covariates
with pattern ``'t n c'`` (node-level) or ``'t c'`` (global), an optional
:class:`~sgp_tpu_torch.graph.Graph` and a datetime index.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sgp_tpu_torch.data.scalers import Scaler, ScalerParams
from sgp_tpu_torch.data.windowing import Windowing
from sgp_tpu_torch.graph.sparse import Graph


def _cat(parts):
    """Channel-wise concatenation, on the device of the first tensor part
    when there is one."""
    if len(parts) == 1:
        return parts[0]
    device = next((a.device for a in parts if isinstance(a, torch.Tensor)),
                  None)
    if device is None:
        return np.concatenate(parts, axis=-1)
    return torch.cat([torch.as_tensor(np.ascontiguousarray(a), device=device)
                      if isinstance(a, np.ndarray) else a for a in parts],
                     dim=-1)


def _take(arr, *index):
    """``arr[index]`` for numpy index arrays; a tensor is indexed where it
    lives, and floating features come out f32 (flax promotes bf16 inputs
    against f32 weights; torch does not)."""
    if not isinstance(arr, torch.Tensor):
        return arr[index]
    out = arr[tuple(torch.as_tensor(i, device=arr.device)
                    if isinstance(i, np.ndarray) else i for i in index)]
    return out.float() if out.is_floating_point() else out


@dataclasses.dataclass
class Covariate:
    value: np.ndarray   # or a torch tensor kept where it lives
    pattern: str  # 't n c', 't c', 'n c'


class Batch(dict):
    """A plain dict of arrays with attribute access (x, y, mask, u, ...)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


class SpatioTemporalDataset:
    """Windowed spatiotemporal dataset over host arrays.

    Args:
        target: ``[T, N, C]`` (or ``[T, N]``, expanded) observations.
        index: optional ``[T]`` ``np.datetime64`` timestamps.
        mask: optional ``[T, N, C]`` validity mask.
        graph: optional connectivity.
        covariates: name -> array, the pattern inferred from ndim (3 ->
            ``'t n c'``, 2 -> ``'t c'``) or given as ``(array, pattern)``.
            Names starting with ``u`` are the exogenous input.
        windowing: window and horizon (see :class:`Windowing`).
    """

    def __init__(self, target: np.ndarray,
                 index: Optional[np.ndarray] = None,
                 mask: Optional[np.ndarray] = None,
                 graph: Optional[Graph] = None,
                 covariates: Optional[Dict] = None,
                 windowing: Optional[Windowing] = None,
                 precision: np.dtype = np.float32):
        target = np.asarray(target, precision)
        if target.ndim == 2:
            target = target[..., None]
        assert target.ndim == 3, "target must be [T, N, C]"
        self.target = target
        self.index = None if index is None else np.asarray(index)
        if mask is None:
            mask = np.ones_like(target, bool)
        else:
            mask = np.asarray(mask, bool)
            if mask.ndim == 2:
                mask = mask[..., None]
            mask = np.broadcast_to(mask, target.shape).copy()
        self.mask = mask
        self.graph = graph
        self.windowing = windowing or Windowing()
        self.covariates: Dict[str, Covariate] = {}
        for name, val in (covariates or {}).items():
            if isinstance(val, tuple):
                self.add_covariate(name, val[0], val[1])
            else:
                self.add_covariate(name, val)
        self.scalers: Dict[str, Scaler] = {}
        self._target_scaled: Optional[np.ndarray] = None
        # which keys form the model input x and the exogenous input u
        self.input_keys: List[str] = ["target"]
        self.exog_keys: List[str] = [
            k for k in (covariates or {}) if k.startswith("u")]

    # -- shape properties --------------------------------------------------
    @property
    def n_steps(self) -> int:
        return self.target.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.target.shape[1]

    @property
    def n_channels(self) -> int:
        return self.target.shape[2]

    @property
    def horizon(self) -> int:
        return self.windowing.horizon

    def __len__(self) -> int:
        return len(self.indices())

    def indices(self) -> np.ndarray:
        return self.windowing.indices(self.n_steps)

    # -- covariates --------------------------------------------------------
    def add_covariate(self, name: str, value: np.ndarray,
                      pattern: Optional[str] = None):
        """A numpy array (stored as f32) or a torch tensor (kept as it
        is, on its device)."""
        if not isinstance(value, torch.Tensor):
            value = np.asarray(value)
        if pattern is None:
            if value.ndim == 3:
                pattern = "t n c"
            elif value.ndim == 2:
                pattern = "t c"
            else:
                raise ValueError(
                    f"cannot infer pattern for {name} with ndim {value.ndim}")
        if pattern in ("t n c", "t c"):
            assert value.shape[0] == self.n_steps, \
                f"{name}: time dim {value.shape[0]} != {self.n_steps}"
        if pattern == "t n c":
            assert value.shape[1] == self.n_nodes
        if not isinstance(value, torch.Tensor):
            value = value.astype(np.float32, copy=False)
        self.covariates[name] = Covariate(value, pattern)

    # -- scaling -----------------------------------------------------------
    def fit_scaler(self, scaler: Scaler,
                   step_index: Optional[np.ndarray] = None):
        """Fit the target scaler on (a slice of) the series, mask-aware,
        then cache the scaled series."""
        x = self.target if step_index is None else self.target[step_index]
        m = self.mask if step_index is None else self.mask[step_index]
        scaler.fit(x, mask=m if not m.all() else None)
        self.scalers["target"] = scaler
        self._target_scaled = scaler.transform(self.target).astype(
            self.target.dtype)
        return self

    @property
    def target_scaled(self) -> np.ndarray:
        if self._target_scaled is None:
            return self.target
        return self._target_scaled

    def scaler_params(self, device=None) -> ScalerParams:
        if "target" in self.scalers:
            return self.scalers["target"].params(device=device)
        return Scaler().params(device=device)

    # -- input assembly ----------------------------------------------------
    def set_input_keys(self, keys: Sequence[str]):
        for k in keys:
            assert k in ("target", "target_scaled") or k in self.covariates, k
        self.input_keys = list(keys)

    def _key_array(self, key: str) -> Tuple[np.ndarray, str]:
        if key in ("target", "target_scaled"):
            return self.target_scaled, "t n c"
        cov = self.covariates[key]
        return cov.value, cov.pattern

    def _over_nodes(self, arr):
        shape = (arr.shape[0], self.n_nodes, arr.shape[-1])
        if isinstance(arr, torch.Tensor):
            return arr[:, None, :].expand(shape)
        return np.broadcast_to(arr[:, None, :], shape)

    def input_array(self):
        """The input keys concatenated channel-wise to ``[T, N, Cin]``,
        global (``'t c'``) covariates broadcast over nodes; a tensor when
        any key is one."""
        parts = []
        for k in self.input_keys:
            arr, pattern = self._key_array(k)
            parts.append(self._over_nodes(arr) if pattern == "t c" else arr)
        return _cat(parts)

    def exog_array(self) -> Optional[np.ndarray]:
        """Exogenous ``u``: ``[T, F]`` if every part is global, else
        node-level ``[T, N, F]``."""
        parts = [self._key_array(k) for k in self.exog_keys
                 if k in self.covariates
                 or k in ("target", "target_scaled")]
        if not parts:
            return None
        if any(p == "t n c" for _, p in parts):
            vals = [arr if p == "t n c" else self._over_nodes(arr)
                    for arr, p in parts]
        else:
            vals = [arr for arr, _ in parts]
        return _cat(vals)

    # -- batch gather ------------------------------------------------------
    def gather_batch(self, item_idx: np.ndarray,
                     node_index: Optional[np.ndarray] = None) -> Batch:
        """The batch of window-start items ``item_idx [B]``: ``x [B, W, N,
        Cin]``, ``y`` and ``mask [B, H, N, C]``, and ``u`` / ``u_horizon``
        when there is an exogenous input; one gather per array."""
        w = self.windowing
        starts = self.indices()[np.asarray(item_idx)]
        w_steps = starts[:, None] + w.window_offsets()[None, :]   # [B, W]
        h_steps = starts[:, None] + w.horizon_offsets()[None, :]  # [B, H]
        batch = Batch(x=_take(self.input_array(), w_steps),
                      y=self.target[h_steps], mask=self.mask[h_steps])
        u = self.exog_array()
        if u is not None:
            batch["u"] = _take(u, w_steps)    # [B, W, F] or [B, W, N, F]
            batch["u_horizon"] = _take(u, h_steps)
        if node_index is not None:
            node_index = np.asarray(node_index)
            for k in ("x", "y", "mask", "u", "u_horizon"):
                if k in batch and batch[k].ndim == 4:
                    batch[k] = _take(batch[k], Ellipsis, node_index,
                                     slice(None))
            batch["node_index"] = node_index
        return batch

    def gather_iid_batch(self, step_idx: np.ndarray,
                         node_idx: np.ndarray) -> Batch:
        """The batch of (time, node) pairs: window inputs ``x [B, W, Cin]``
        at the sampled step and node, horizon targets and masks ``[B, H,
        C]``, ``node_index``, and ``u`` at the node (node-level) or the
        step (global)."""
        w = self.windowing
        starts = np.asarray(step_idx)
        node_idx = np.asarray(node_idx)
        w_steps = starts[:, None] + w.window_offsets()[None, :]   # [B, W]
        h_steps = starts[:, None] + w.horizon_offsets()[None, :]
        batch = Batch(x=_take(self.input_array(), w_steps, node_idx[:, None]),
                      y=self.target[h_steps, node_idx[:, None]],
                      mask=self.mask[h_steps, node_idx[:, None]],
                      node_index=node_idx)
        u = self.exog_array()
        if u is not None:
            at = (node_idx[:, None],) if u.ndim == 3 else ()
            batch["u"] = _take(u, w_steps, *at)
            batch["u_horizon"] = _take(u, h_steps, *at)
        return batch
