"""Training-free encoder pipelines.

Counterpart of the SGP encoders of ``sgp_tpu/encode/encoders.py``, with the
same interface: ``encoder(x [T, N, F], graph) -> [T, N, D]``.

- :class:`SGPEncoder` — reservoir over time, then K-hop propagation over
  space, optional global-mean channel.
- :class:`SGPTemporalEncoder` — reservoir only (ablation ``time``).
- :class:`SGPSpatialEncoder` — propagation only (ablation ``space``).
- :func:`streaming_encode` — the whole-series SGP encode that feeds
  training, streamed over time chunks into one preallocated output.
- :class:`GESNEncoder` — DynGESN, the graph echo-state scan over the
  self-looped, row-normalized graph.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from sgp_tpu_torch.encode.graph_reservoir import GraphESN
from sgp_tpu_torch.encode.reservoir import Reservoir, reservoir_scan
from sgp_tpu_torch.encode.spatial import (prepare_propagation_graphs,
                                          sgp_spatial_embedding)
from sgp_tpu_torch.graph.sparse import Graph, add_self_loops, normalize_adj
from sgp_tpu_torch.ops.spmm import build_operator


class SGPSpatialEncoder:
    def __init__(self, receptive_field: int = 1, bidirectional: bool = False,
                 undirected: bool = False, global_attr: bool = False,
                 add_self_loops: bool = False,
                 operator_mode: str = "auto"):
        self.receptive_field = receptive_field
        self.bidirectional = bidirectional
        self.undirected = undirected
        self.global_attr = global_attr
        self.add_self_loops = add_self_loops
        self.operator_mode = operator_mode

    def output_size(self, input_size: int) -> int:
        order = 1 + (2 if self.bidirectional else 1) * self.receptive_field
        order += 1 if self.global_attr else 0
        return order * input_size

    def __call__(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        out: List[torch.Tensor] = sgp_spatial_embedding(
            x, graph, k=self.receptive_field,
            undirected=self.undirected,
            add_loops=self.add_self_loops,
            bidirectional=self.bidirectional,
            operator_mode=self.operator_mode)
        if self.global_attr:
            out.append(x.mean(-2, keepdim=True).expand_as(x))
        return torch.cat(out, dim=-1)


class SGPTemporalEncoder:
    """The reservoir alone; ``device`` as for :class:`SGPEncoder`."""

    def __init__(self, input_size: int, reservoir_size: int = 32,
                 reservoir_layers: int = 1, leaking_rate: float = 0.9,
                 spectral_radius: float = 0.9, density: float = 0.7,
                 input_scaling: float = 1.0, alpha_decay: bool = False,
                 reservoir_activation: str = "tanh", seed: int = 0,
                 device=None):
        self.reservoir = Reservoir(
            input_size=input_size, hidden_size=reservoir_size,
            input_scaling=input_scaling, num_layers=reservoir_layers,
            leaking_rate=leaking_rate, spectral_radius=spectral_radius,
            density=density, activation=reservoir_activation,
            alpha_decay=alpha_decay, seed=seed, device=device)

    @property
    def output_size(self) -> int:
        return self.reservoir.output_size

    def __call__(self, x: torch.Tensor,
                 graph: Optional[Graph] = None) -> torch.Tensor:
        return self.reservoir(x)


class SGPEncoder:
    """Reservoir -> K-hop spatial propagation (the full SGP encoder).
    ``device`` is where the reservoir weights live (default ``cuda:0``;
    ``"cpu"`` for the CPU)."""

    def __init__(self, input_size: int, reservoir_size: int = 32,
                 reservoir_layers: int = 1, leaking_rate: float = 0.9,
                 spectral_radius: float = 0.9, density: float = 0.7,
                 input_scaling: float = 1.0, receptive_field: int = 1,
                 bidirectional: bool = False, alpha_decay: bool = False,
                 global_attr: bool = False, add_self_loops: bool = False,
                 undirected: bool = False,
                 reservoir_activation: str = "tanh", seed: int = 0,
                 operator_mode: str = "auto", device=None):
        self.reservoir = Reservoir(
            input_size=input_size, hidden_size=reservoir_size,
            input_scaling=input_scaling, num_layers=reservoir_layers,
            leaking_rate=leaking_rate, spectral_radius=spectral_radius,
            density=density, activation=reservoir_activation,
            alpha_decay=alpha_decay, seed=seed, device=device)
        self.spatial = SGPSpatialEncoder(
            receptive_field=receptive_field, bidirectional=bidirectional,
            undirected=undirected, global_attr=global_attr,
            add_self_loops=add_self_loops, operator_mode=operator_mode)

    @property
    def output_size(self) -> int:
        return self.spatial.output_size(self.reservoir.output_size)

    def __call__(self, x: torch.Tensor, graph: Graph,
                 time_chunk: Optional[int] = None,
                 out_dtype=None) -> torch.Tensor:
        """Encode ``x [T, N, F]``. ``time_chunk`` runs the spatial stage
        in chunks of steps so only one chunk's full-width (k+1)x expansion
        is live at a time; each chunk is cast to ``out_dtype`` before
        concatenation."""
        h = self.reservoir(x)  # [T, N, L*H]
        dtype = out_dtype or h.dtype
        if time_chunk is None:
            return self.spatial(h, graph).to(dtype)
        return torch.cat([self.spatial(h[s:s + time_chunk], graph).to(dtype)
                          for s in range(0, h.shape[0], time_chunk)], dim=0)


def build_streaming_ops(encoder: SGPEncoder, graph: Graph,
                        precision: str = "highest", device=None) -> tuple:
    """Host-side operator prep, built (and uploaded) once for repeat
    callers such as the online forecaster: the encoder's forward (and, if
    bidirectional, backward) propagation operators."""
    sp = encoder.spatial
    graphs = prepare_propagation_graphs(
        graph, undirected=sp.undirected, add_loops=sp.add_self_loops,
        bidirectional=sp.bidirectional)
    return tuple(build_operator(g, sp.operator_mode, precision=precision,
                                device=device)
                 for g in graphs)


def streaming_encode(encoder: SGPEncoder, x: torch.Tensor, graph: Graph,
                     time_chunk: int = 64, out_dtype=torch.bfloat16,
                     extra_lanes: Optional[torch.Tensor] = None,
                     precision: str = "highest",
                     ops: Optional[tuple] = None) -> torch.Tensor:
    """The whole-series SGP encode, ``[T, N, D + E]`` in ``out_dtype``.

    Equivalent to ``encoder(x, graph)`` cast to ``out_dtype``, but streamed
    over chunks of ``time_chunk`` steps with the reservoir state carried
    from one chunk to the next, and each chunk's parts (the states, the k
    hops of each operator, the global mean) written straight into one
    preallocated output: peak memory is the output plus one chunk's
    expansion. ``extra_lanes [T, N, E]`` fill the last E lanes of each row
    (e.g. the packed target and mask lanes of
    :func:`sgp_tpu_torch.train.iid.pack_iid_data`, so the encode emits the
    packed training layout). A shorter tail chunk gives the rows the JAX
    package's padded one does: the scan is causal. ``ops`` are prebuilt
    operators from :func:`build_streaming_ops`, checked against the graph's
    node count and ``precision``."""
    sp = encoder.spatial
    if ops is None:
        ops = build_streaming_ops(encoder, graph, precision=precision,
                                  device=x.device)
    else:
        for op in ops:   # catch prebuilds that disagree with the call
            if op.num_nodes != graph.num_nodes:
                raise ValueError(
                    f"prebuilt operator is for {op.num_nodes} nodes, "
                    f"graph has {graph.num_nodes}")
            op_prec = getattr(op, "precision", None)
            if op_prec is not None and op_prec != precision:
                raise ValueError(
                    f"prebuilt operator precision {op_prec!r} != "
                    f"requested {precision!r}; rebuild with "
                    f"build_streaming_ops(..., precision={precision!r})")
    layers = encoder.reservoir.layers
    activation = encoder.reservoir.activation
    t, n = x.shape[0], x.shape[1]
    width = encoder.output_size
    n_extra = 0 if extra_lanes is None else extra_lanes.shape[-1]
    out = torch.empty((t, n, width + n_extra), dtype=out_dtype,
                      device=x.device)
    h = None
    for s in range(0, t, time_chunk):
        e = min(s + time_chunk, t)
        hc, h = reservoir_scan(layers, activation, x[s:e], h,
                               with_state=True)
        parts = [hc]
        for op in ops:          # fwd (+ bwd if bidirectional), each
            cur = hc            # propagating the ORIGINAL states
            for _ in range(sp.receptive_field):
                cur = op @ cur
                parts.append(cur)
        if sp.global_attr:
            parts.append(hc.mean(-2, keepdim=True).expand_as(hc))
        col = 0
        for part in parts:      # the slice's copy casts to out_dtype
            out[s:e, :, col:col + part.shape[-1]] = part
            col += part.shape[-1]
        if n_extra:
            out[s:e, :, width:] = extra_lanes[s:e]
    return out


class GESNEncoder:
    """DynGESN: self-loops, row normalization, the operator of
    ``operator_mode`` (``"bsr"`` runs the recurrence's products through the
    block-sparse kernel on the card), then the :class:`GraphESN` scan.
    ``device`` is where the weights and the operator live (default
    ``cuda:0``; ``"cpu"`` for the CPU)."""

    def __init__(self, input_size: int, reservoir_size: int = 32,
                 reservoir_layers: int = 1, leaking_rate: float = 0.9,
                 spectral_radius: float = 0.9, density: float = 0.9,
                 input_scaling: float = 1.0, alpha_decay: bool = False,
                 reservoir_activation: str = "tanh", seed: int = 0,
                 operator_mode: str = "auto", device=None):
        self.gesn = GraphESN(
            input_size=input_size, hidden_size=reservoir_size,
            input_scaling=input_scaling, num_layers=reservoir_layers,
            leaking_rate=leaking_rate, spectral_radius=spectral_radius,
            density=density, activation=reservoir_activation,
            alpha_decay=alpha_decay, seed=seed, device=device)
        self.operator_mode = operator_mode

    @property
    def output_size(self) -> int:
        return self.gesn.output_size

    @property
    def device(self) -> torch.device:
        return self.gesn.layers[0].w_ih.device

    def operator(self, graph: Graph):
        """The recurrence's operator: ``graph`` with self-loops,
        row-normalized, built on the encoder's device."""
        g = normalize_adj(add_self_loops(graph), "row")
        return build_operator(g, self.operator_mode, device=self.device)

    def __call__(self, x: torch.Tensor, graph: Graph,
                 out_dtype=None) -> torch.Tensor:
        return self.gesn(x, self.operator(graph), out_dtype=out_dtype)


def get_encoder_class(name: str):
    """Encoder registry, as the JAX package's."""
    return {"sgp": SGPEncoder, "time": SGPTemporalEncoder,
            "space": SGPSpatialEncoder, "gesn": GESNEncoder}[name]
