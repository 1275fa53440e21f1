"""Online low-latency serving for SGP forecasters.

Counterpart of ``sgp_tpu/serve.py::OnlineForecaster``: a stateful
forecaster that carries the echo-state reservoir across time, so serving a
new observation is one reservoir update, K hops of propagation and one
decoder forward. The online feature assembly is the offline
``SGPEncoder``'s, so a decoder trained offline serves online unchanged.

:class:`OnlineGESNForecaster` serves DynGESN the same way: one graph
echo-state update and the stacked per-lag ridge readouts a step.

:func:`export_forecaster` writes either forecaster's step as one
``torch.export`` artifact and :func:`load_forecaster` serves it
(:class:`ExportedForecaster`) without the encoder or model code.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.encode.encoders import (GESNEncoder, SGPEncoder,
                                           build_streaming_ops)
from sgp_tpu_torch.graph.sparse import Graph
from sgp_tpu_torch.utils.device import resolve_device


class OnlineForecaster:
    """Stateful forecaster, one update per observation.

    Args:
        encoder: the (training-free) :class:`SGPEncoder` used offline.
        graph: the sensor graph (operators built once, on ``device``).
        model: the trained decoder (e.g. :class:`SGPModel`), applied in
            full-graph mode on the assembled ``[1, N, D]`` features and
            in ``eval()`` mode.
        scaler: the dataset scaler — raw observations are transformed on
            the device and forecasts inverse-transformed, so callers
            feed/receive raw values.
        precision: ``"highest"``, or ``"default"`` for bf16 BSR tiles;
            use the value the offline encode ran with.
        store_dtype: dtype the offline encoding was stored in (e.g.
            ``"bfloat16"``) — online features are rounded through it and
            cast back to f32 before the decoder, so a decoder trained on
            bf16 features sees the same rounding online. ``None`` keeps
            f32.
        n_streams: serve ``S`` independent streams in the same step:
            states stack on a leading stream axis and ``step`` takes and
            returns ``[S, N, C]`` / ``[S, H, N, C]``.
        device: where the state, operators and computation live
            (default ``cuda:0``; ``"cpu"`` for the CPU); the encoder's
            reservoir, the model and the scaler must be there.
    """

    def __init__(self, encoder: SGPEncoder, graph: Graph, model,
                 scaler: ScalerParams, precision: str = "highest",
                 store_dtype=None, n_streams: Optional[int] = None,
                 device=None):
        self.model = model.eval()
        self.scaler = scaler
        self.device = resolve_device(device)
        self.store_dtype = None if store_dtype is None else \
            getattr(torch, str(store_dtype).replace("torch.", ""))
        self._res = encoder.reservoir
        self._ops = build_streaming_ops(encoder, graph, precision=precision,
                                        device=self.device)
        self._k = encoder.spatial.receptive_field
        self._global_attr = encoder.spatial.global_attr
        self.n_streams = n_streams
        lead = () if n_streams is None else (n_streams,)
        self.state = [torch.zeros(lead + (graph.num_nodes, p.w_hh.shape[0]),
                                  dtype=torch.float32, device=self.device)
                      for p in self._res.layers]

    @torch.no_grad()
    def step(self, x_raw, u_t: Optional[torch.Tensor] = None):
        """Ingest one raw observation ``[N, C]`` (``[S, N, C]`` with
        ``n_streams``) plus optional global exogenous ``[F]`` (``[S, F]``);
        returns the forecast ``[H, N, C]`` (``[S, H, N, C]``) in raw
        units."""
        self.state, y = self._advance(self.state, x_raw, u_t)
        return y

    def _advance(self, state, x_raw, u_t=None):
        """``(state, x_raw[, u_t]) -> (state', forecast)``: the step as a
        function of the state (what :func:`export_forecaster` traces)."""
        x_raw = torch.as_tensor(x_raw, dtype=torch.float32,
                                device=self.device)
        # scaler params carry [1, 1, C]-style broadcast dims; keep the
        # single observation's [N, C] rank
        x_t = self.scaler.transform(x_raw).reshape(x_raw.shape)
        state = self._res.step(state, x_t)
        hc = torch.cat(state, -1)                   # [(S,) N, L*H]
        parts = [hc]
        for op in self._ops:   # same assembly/order as the offline encoder
            cur = hc
            for _ in range(self._k):
                cur = op @ cur
                parts.append(cur)
        if self._global_attr:
            parts.append(hc.mean(-2, keepdim=True).expand_as(hc))
        feat = torch.cat(parts, -1)                 # [(S,) N, D]
        if self.store_dtype is not None:  # the offline stored rounding
            feat = feat.to(self.store_dtype).to(torch.float32)
        # single stream: [N, D] -> batch of 1; multi-stream: [S, N, D] is
        # the full-graph batch layout [b n f]
        single = feat.ndim == 2
        x_in = feat[None] if single else feat
        u = None
        if u_t is not None:
            u_t = torch.as_tensor(u_t, dtype=torch.float32,
                                  device=self.device)
            u = u_t[None, None] if single else u_t[:, None]  # [S, 1, F]
        y = self.scaler.inverse_transform(self.model(x_in, u=u))
        return state, (y[0] if single else y)       # [(S,) H, N, C]

    def reset(self):
        """Zero the reservoir state (new stream / washout restart)."""
        self.state = [torch.zeros_like(h) for h in self.state]

    @torch.no_grad()
    def warm_up(self, x_history):
        """Replay a raw history ``[T, N, C]`` (``[T, S, N, C]`` with
        ``n_streams``) through the scan to condition the reservoir state
        before live serving (exogenous inputs only affect the decoder)."""
        x_history = torch.as_tensor(x_history, dtype=torch.float32,
                                    device=self.device)
        x = self.scaler.transform(x_history).reshape(x_history.shape)
        # the scan flattens all batch axes: states go through as
        # [S*N, H] and come back reshaped
        h0 = [h.reshape(-1, h.shape[-1]) for h in self.state]
        _, h = self._res(x, h0=h0, with_state=True)
        self.state = [hn.reshape(hs.shape)
                      for hn, hs in zip(h, self.state)]


class OnlineGESNForecaster:
    """Online DynGESN serving: the graph echo-state update and the per-lag
    closed-form ridge readouts, one update per observation.

    Args:
        encoder: the :class:`GESNEncoder` used offline (its layers and
            ``operator_mode``; ``"bsr"`` runs each layer-step's product
            over the nodes through the block-sparse kernel).
        graph: the sensor graph; its operator built once by
            :meth:`GESNEncoder.operator`, where the encoder's layers live.
        readouts: one ``(W [D, C], b [C])`` a horizon lag, as
            ``train.ridge.closed_form_readout`` returns them (tensors or
            numpy arrays); stacked into ``[L, D, C]`` and ``[L, C]``.
        scaler: the dataset scaler; observations and forecasts are raw.
        n_streams: serve ``S`` independent streams in one update: the
            states stack on a leading stream axis (one product at
            F = S * H under BSR) and ``step`` takes and returns
            ``[S, N, C]`` / ``[S, L, N, C]``.
        device: where the state and readouts live (default ``cuda:0``;
            ``"cpu"`` for the CPU); the encoder's layers and the scaler
            must be there.
    """

    def __init__(self, encoder: GESNEncoder, graph: Graph, readouts,
                 scaler: ScalerParams, n_streams: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        self.scaler = scaler
        self._gesn = encoder.gesn
        self._op = encoder.operator(graph)

        def dev(a):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.array(a, np.float32))
            return a.to(device=self.device, dtype=torch.float32)
        self._w = torch.stack([dev(w) for w, _ in readouts])   # [L, D, C]
        self._b = torch.stack([dev(b) for _, b in readouts])   # [L, C]
        self.n_streams = n_streams
        lead = () if n_streams is None else (n_streams,)
        self.state = [torch.zeros(lead + (graph.num_nodes, p.w_hh.shape[0]),
                                  dtype=torch.float32, device=self.device)
                      for p in self._gesn.layers]

    @torch.no_grad()
    def step(self, x_raw):
        """One raw observation ``[N, C]`` (``[S, N, C]`` with
        ``n_streams``) -> the forecasts of every lag ``[L, N, C]``
        (``[S, L, N, C]``) in raw units."""
        self.state, y = self._advance(self.state, x_raw)
        return y

    def _advance(self, state, x_raw, u_t=None):
        """``(state, x_raw) -> (state', forecasts)`` (``u_t`` is taken and
        unused: the closed form has no exogenous input)."""
        x_raw = torch.as_tensor(x_raw, dtype=torch.float32,
                                device=self.device)
        x_t = self.scaler.transform(x_raw).reshape(x_raw.shape)
        state = self._gesn.step(state, self._op, x_t)
        hc = torch.cat(state, -1)                      # [(S,) N, D]
        # b [L, C] -> [L, 1, C] broadcasts over the nodes
        y = torch.einsum("...nd,ldc->...lnc", hc, self._w) + self._b[:, None]
        return state, self.scaler.inverse_transform(y)

    def reset(self):
        """Zero the GESN state (a new stream)."""
        self.state = [torch.zeros_like(h) for h in self.state]

    @torch.no_grad()
    def warm_up(self, x_history):
        """Condition the state on a raw history ``[T, N, C]`` (``[T, S, N,
        C]`` with ``n_streams``) through the scan."""
        x_history = torch.as_tensor(x_history, dtype=torch.float32,
                                    device=self.device)
        x = self.scaler.transform(x_history).reshape(x_history.shape)
        _, self.state = self._gesn(x, self._op, h0=self.state,
                                   with_state=True)


# -- export -----------------------------------------------------------------

_META = "sgp_forecaster.json"   # the artifact's metadata, an extra file


def _holds_tensor(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return True
    if isinstance(obj, nn.Module):
        return False
    if isinstance(obj, (list, tuple)):
        return any(_holds_tensor(o) for o in obj)
    return hasattr(obj, "__dict__") and any(
        _holds_tensor(v) for v in vars(obj).values())


def _hold(module: nn.Module, name: str, obj):
    """Register every tensor reachable from ``obj`` (through attributes,
    dataclass fields and list items; not through modules) as a buffer of
    ``module``. Returns a function that rebuilds ``obj`` from the buffers:
    shallow copies of each object on the way, so a traced call reads the
    module's buffers and the forecaster is left as it is."""
    if isinstance(obj, torch.Tensor):
        module.register_buffer(name, obj)
        return lambda: getattr(module, name)
    if not _holds_tensor(obj):
        return lambda: obj
    if isinstance(obj, (list, tuple)):
        parts = [_hold(module, f"{name}_{i}", o) for i, o in enumerate(obj)]
        return lambda: type(obj)(p() for p in parts)
    fields = {k: _hold(module, f"{name}_{k}", v)
              for k, v in vars(obj).items() if _holds_tensor(v)}

    def rebuild():
        new = copy.copy(obj)
        for k, part in fields.items():   # frozen dataclasses too
            object.__setattr__(new, k, part())
        return new
    return rebuild


class _StepModule(nn.Module):
    """A forecaster's ``_advance`` as a module for ``torch.export``: the
    decoder is a submodule (its parameters), and the reservoir or GESN
    layers, the operators, the readouts and the scaler are buffers."""

    def __init__(self, fc, parts):
        super().__init__()
        self._fc = fc
        if isinstance(fc, OnlineForecaster):
            self.model = fc.model
        self._parts = {p: _hold(self, p.strip("_"), getattr(fc, p))
                       for p in parts}

    def forward(self, state, x_raw, u_t=None):
        fc = copy.copy(self._fc)
        for part, rebuild in self._parts.items():
            setattr(fc, part, rebuild())
        return fc._advance(list(state), x_raw, u_t)


def export_forecaster(fc, path: str, example_u=None) -> int:
    """Write the forecaster's step as one deployable artifact.

    ``torch.export.export`` traces the step ``(state, x_raw) -> (state',
    forecast)``, or ``(state, x_raw, u_t) -> ...`` when ``example_u`` is
    given, with the reservoir state managed by the caller or
    :class:`ExportedForecaster`. The decoder parameters, the propagation
    operators, the reservoir or GESN layers, the readouts and the scaler
    are embedded (the parameters and buffers of a small wrapper module),
    so serving needs no model or encoder code, only :func:`load_forecaster`.
    Works for multi-stream (``n_streams``) forecasters (the input keeps the
    ``[S, N, C]`` layout) and for :class:`OnlineGESNForecaster`. The
    program and its shapes go into one file written by
    ``torch.export.save`` (the shapes in an extra file), through a
    ``.tmp`` file and ``os.replace``. Returns the artifact's size in bytes.

    Args:
        example_u: an exogenous input of the shape live ``step`` calls
            will pass (``[F]``, or ``[S, F]`` with ``n_streams``),
            required when the decoder was built with exogenous features
            (only its shape is used).

    Two differences from the JAX package's StableHLO artifact: loading
    needs ``sgp_tpu_torch.ops`` imported, because importing it registers
    the custom op ``sgp::bsr_spmm`` that a BSR operator's hops call; and
    the artifact is tied to the device it was exported on (the card's
    artifact serves on the card, through the kernel).
    """
    if isinstance(fc, OnlineGESNForecaster):
        if example_u is not None:
            raise ValueError("the DynGESN serving path takes no "
                             "exogenous input")
        parts = ("_gesn", "_op", "_w", "_b", "scaler")
        f_in = fc._gesn.layers[0].w_ih.shape[1]
        u_shape = None
    else:
        parts = ("_res", "_ops", "scaler")
        f_in = fc._res.layers[0].w_ih.shape[1]
        if getattr(fc.model, "exog_size", 0) and example_u is None:
            raise ValueError(
                "the decoder was built with exog_size="
                f"{fc.model.exog_size} — pass example_u (shape of the "
                "live u_t) so the artifact's signature includes it")
        u_shape = None if example_u is None else \
            tuple(np.shape(example_u))
    # state is [N, H] a layer (or [S, N, H] multi-stream); the raw
    # observation has the same leading axes with C = f_in channels
    x_shape = tuple(fc.state[0].shape[:-1]) + (f_in,)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=fc.device)
    args = ([zeros(h.shape) for h in fc.state], zeros(x_shape)) + (
        () if u_shape is None else (zeros(u_shape),))
    with torch.no_grad():
        program = torch.export.export(_StepModule(fc, parts).eval(), args)
    meta = {"state_shapes": [list(h.shape) for h in fc.state],
            "input_shape": list(x_shape),
            "u_shape": None if u_shape is None else list(u_shape),
            "device": str(fc.device)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        torch.export.save(program, fp, extra_files={_META: json.dumps(meta)})
    os.replace(tmp, path)
    return os.path.getsize(path)


class ExportedForecaster:
    """Runtime wrapper around an :func:`export_forecaster` artifact: the
    same ``step``/``reset`` surface as :class:`OnlineForecaster`, no model
    or encoder code needed."""

    def __init__(self, program, state_shapes, input_shape, u_shape=None,
                 device="cpu"):
        self._step = program.module()
        self._state_shapes = [tuple(s) for s in state_shapes]
        self.input_shape = tuple(input_shape)
        self.u_shape = None if u_shape is None else tuple(u_shape)
        self.device = torch.device(device)
        self.reset()

    @torch.no_grad()
    def step(self, x_raw, u_t=None):
        if (u_t is None) != (self.u_shape is None):
            raise ValueError(
                "artifact exported "
                + ("WITH" if self.u_shape is not None else "WITHOUT")
                + f" exogenous input (u_shape={self.u_shape}); step() "
                + "must match")
        args = (self.state, torch.as_tensor(
            x_raw, dtype=torch.float32, device=self.device))
        if u_t is not None:
            args += (torch.as_tensor(u_t, dtype=torch.float32,
                                     device=self.device),)
        self.state, y = self._step(*args)
        return y

    def reset(self):
        self.state = [torch.zeros(s, dtype=torch.float32, device=self.device)
                      for s in self._state_shapes]


def load_forecaster(path: str) -> ExportedForecaster:
    """Load an artifact written by :func:`export_forecaster` (on the
    device it was exported on). Importing this module imports
    ``sgp_tpu_torch.ops``, which registers ``sgp::bsr_spmm``."""
    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    return ExportedForecaster(program, meta["state_shapes"],
                              meta["input_shape"], meta["u_shape"],
                              meta["device"])
