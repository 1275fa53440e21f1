"""Online low-latency serving for SGP forecasters.

Counterpart of ``sgp_tpu/serve.py::OnlineForecaster``: a stateful
forecaster that carries the echo-state reservoir across time, so serving a
new observation is one reservoir update, K hops of propagation and one
decoder forward. The online feature assembly is the offline
``SGPEncoder``'s, so a decoder trained offline serves online unchanged.

``export_forecaster``, ``load_forecaster`` and ``OnlineGESNForecaster`` are
not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.encode.encoders import SGPEncoder, build_streaming_ops
from sgp_tpu_torch.graph.sparse import Graph


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
        device: where the state, operators and computation live; the
            encoder's reservoir, the model and the scaler must be there.
    """

    def __init__(self, encoder: SGPEncoder, graph: Graph, model,
                 scaler: ScalerParams, precision: str = "highest",
                 store_dtype=None, n_streams: Optional[int] = None,
                 device=None):
        self.model = model.eval()
        self.scaler = scaler
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
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
        x_raw = torch.as_tensor(x_raw, dtype=torch.float32,
                                device=self.device)
        # scaler params carry [1, 1, C]-style broadcast dims; keep the
        # single observation's [N, C] rank
        x_t = self.scaler.transform(x_raw).reshape(x_raw.shape)
        self.state = self._res.step(self.state, x_t)
        hc = torch.cat(self.state, -1)              # [(S,) N, L*H]
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
        return y[0] if single else y                # [(S,) H, N, C]

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
