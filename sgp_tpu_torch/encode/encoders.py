"""Training-free encoder pipelines.

Counterpart of the SGP encoders of ``sgp_tpu/encode/encoders.py``, with the
same interface: ``encoder(x [T, N, F], graph) -> [T, N, D]``.

- :class:`SGPEncoder` — reservoir over time, then K-hop propagation over
  space, optional global-mean channel.
- :class:`SGPSpatialEncoder` — propagation only.

``streaming_encode`` (the chunked whole-series encode that feeds training)
is not ported yet.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from sgp_tpu_torch.encode.reservoir import Reservoir
from sgp_tpu_torch.encode.spatial import (prepare_propagation_graphs,
                                          sgp_spatial_embedding)
from sgp_tpu_torch.graph.sparse import Graph
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


class SGPEncoder:
    """Reservoir -> K-hop spatial propagation (the full SGP encoder).
    ``device`` is where the reservoir weights live."""

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
