"""Loader-side SGP propagation (the ``sgp_preprocessing=True`` path).

Counterpart of ``sgp_tpu/data/sgp_loader.py``: instead of precomputing the
K-hop embedding over the whole series, the operator list ``[A, A^2, ...,
(A'^k), (1/N)]`` is materialized once (``sgp_spatial_support``) and applied
to each batch's inputs as it is loaded, on the operators' device. Built
with ``operator_mode="bsr"`` the supports run kernel K1 on the card; the
``auto`` route at traffic sizes is the dense operator, one matmul each.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from sgp_tpu_torch.data.loader import IIDLoader, WindowedLoader
from sgp_tpu_torch.data.spatiotemporal import Batch, SpatioTemporalDataset
from sgp_tpu_torch.encode.spatial import sgp_spatial_support
from sgp_tpu_torch.graph.sparse import Graph
from sgp_tpu_torch.ops.spmm import (BSROperator, COOOperator, DenseOperator,
                                    Operator, build_operator)
from sgp_tpu_torch.utils.device import resolve_device


def build_support_operators(g: Graph, k: int = 2,
                            undirected: bool = False,
                            add_loops: bool = False,
                            bidirectional: bool = False,
                            global_attr: bool = False,
                            operator_mode: str = "auto",
                            true_powers: bool = True,
                            device=None) -> List[Operator]:
    """The supports of :func:`sgp_spatial_support` as operators on
    ``device`` (default ``cuda:0``; ``"cpu"`` for the CPU)."""
    device = resolve_device(device)
    graphs = sgp_spatial_support(
        g, k=k, undirected=undirected, add_loops=add_loops,
        bidirectional=bidirectional, global_attr=global_attr,
        true_powers=true_powers)
    return [build_operator(sg, operator_mode, device=device)
            for sg in graphs]


def operator_device(operators: List[Operator]) -> torch.device:
    """Where the operators' tensors live."""
    for op in operators:
        if isinstance(op, DenseOperator):
            return op.mat.device
        if isinstance(op, BSROperator):
            return op.blocks.device
        if isinstance(op, COOOperator):
            return op.src.device
    raise ValueError("no operator holds a tensor")


def apply_support(x: torch.Tensor, operators: List[Operator],
                  node_index=None) -> torch.Tensor:
    """``cat([x] + [A_i @ x])`` along channels. With ``node_index`` the
    rows are sliced to the sampled nodes after each full-width product."""
    if node_index is not None:
        node_index = torch.as_tensor(node_index, device=x.device)
    parts = [x if node_index is None else x.index_select(-2, node_index)]
    for op in operators:
        prop = op @ x
        if node_index is not None:
            prop = prop.index_select(-2, node_index)
        parts.append(prop)
    return torch.cat(parts, dim=-1)


class SGPLoader(WindowedLoader):
    """Windowed loader that propagates each batch's inputs ``x [B, W, N,
    C]`` through the supports as it yields it (on their device)."""

    def __init__(self, dataset: SpatioTemporalDataset,
                 operators: List[Operator], **kwargs):
        super().__init__(dataset, **kwargs)
        self.operators = operators
        self.device = operator_device(operators)

    def __iter__(self) -> Iterator[Batch]:
        for batch in super().__iter__():
            x = torch.as_tensor(batch["x"], device=self.device)
            batch["x"] = apply_support(x, self.operators)
            yield batch


class SGPIIDLoader(IIDLoader):
    """IID (time, node) loader with propagation at load time: the window
    inputs of the sampled pairs are ``[x[nodes], (A_i @ x)[nodes]]``,
    ``[B, W, C']``, each product over the whole graph at the sampled
    steps."""

    def __init__(self, dataset: SpatioTemporalDataset,
                 operators: List[Operator], **kwargs):
        super().__init__(dataset, **kwargs)
        self.operators = operators
        self.device = operator_device(operators)

    def __iter__(self) -> Iterator[Batch]:
        x_full = self.dataset.input_array()
        x_full = torch.as_tensor(
            x_full if isinstance(x_full, torch.Tensor)
            else np.ascontiguousarray(x_full), device=self.device)
        offsets = self.dataset.windowing.window_offsets()
        for _ in range(self.num_batches):
            t, n = self.draw()
            batch = self.dataset.gather_iid_batch(t, n)
            steps = torch.as_tensor(t[:, None] + offsets, device=self.device)
            xw = x_full[steps].float()                      # [B, W, N, C]
            rows = torch.arange(len(n), device=self.device)
            nodes = torch.as_tensor(n, device=self.device)
            parts = [xw[rows, :, nodes]]                    # [B, W, C]
            for op in self.operators:
                parts.append((op @ xw)[rows, :, nodes])
            batch["x"] = torch.cat(parts, dim=-1)
            yield batch
