"""K-hop graph-shift-operator spatial embedding.

Counterpart of ``sgp_tpu/encode/spatial.py``: ``res = [x, Ax, A^2 x, ...,
A^k x]`` with a row- (or GCN-) normalized propagation operator, optionally
repeated on the transposed operator (bidirectional). Host-side graph
preparation is split from device-side propagation so the prepared
operators can be reused across calls. :func:`sgp_spatial_support`
materializes the powers themselves, for loader-side propagation
(``data/sgp_loader.py``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from sgp_tpu_torch.graph.sparse import (Graph, add_self_loops, edge_dropout,
                                        normalize_adj, remove_self_loops,
                                        spgemm, to_undirected, transpose)
from sgp_tpu_torch.ops.spmm import Operator, build_operator


def _prepare_adj(g: Graph, gcn_norm: bool, set_diag: bool,
                 remove_diag: bool) -> Graph:
    """Diagonal handling then row (D^-1 A) or sym (D^-1/2 A D^-1/2)
    normalization."""
    if set_diag:
        g = add_self_loops(g)
    elif remove_diag:
        g = remove_self_loops(g)
    return normalize_adj(g, "sym" if gcn_norm else "row")


def prepare_propagation_graphs(g: Graph,
                               undirected: bool = False,
                               add_loops: bool = False,
                               remove_loops: bool = False,
                               bidirectional: bool = False,
                               dropout_rate: float = 0.0,
                               rng: Optional[np.random.Generator] = None
                               ) -> List[Graph]:
    """Host-side graph prep for :func:`sgp_spatial_embedding`: the
    normalized forward operator and, if bidirectional, the normalized
    transposed operator (dropout -> to_undirected -> normalize; the
    backward pass re-prepares from the dropped-out, untransformed edges,
    transposed)."""
    if dropout_rate > 0:
        g = edge_dropout(g, dropout_rate, rng or np.random.default_rng())
    graphs = []
    if undirected:
        assert not bidirectional
        gu = to_undirected(g)
        graphs.append(_prepare_adj(gu, gcn_norm=True, set_diag=add_loops,
                                   remove_diag=remove_loops))
    else:
        graphs.append(_prepare_adj(g, gcn_norm=False, set_diag=add_loops,
                                   remove_diag=remove_loops))
    if bidirectional:
        graphs.append(_prepare_adj(transpose(g), gcn_norm=False,
                                   set_diag=add_loops,
                                   remove_diag=remove_loops))
    return graphs


def propagate_khop(op: Operator, x: torch.Tensor, k: int,
                   include_input: bool = True) -> List[torch.Tensor]:
    """``res = [x]; for _ in range(k): x = A @ x; res.append(x)``."""
    res = [x] if include_input else []
    for _ in range(k):
        x = op @ x
        res.append(x)
    return res


def sgp_spatial_embedding(x: torch.Tensor,
                          graph: Graph,
                          k: int = 2,
                          undirected: bool = False,
                          add_loops: bool = False,
                          remove_loops: bool = False,
                          bidirectional: bool = False,
                          one_hot_encoding: bool = False,
                          dropout_rate: float = 0.0,
                          rng: Optional[np.random.Generator] = None,
                          operator_mode: str = "auto",
                          precision: str = "highest") -> List[torch.Tensor]:
    """Full spatial embedding on ``x [..., N, F]``; returns the list
    ``[x, Ax, ..., A^k x (, A'x, ..., A'^k x)]``."""
    graphs = prepare_propagation_graphs(
        graph, undirected=undirected, add_loops=add_loops,
        remove_loops=remove_loops, bidirectional=bidirectional,
        dropout_rate=dropout_rate, rng=rng)
    if one_hot_encoding:
        n = graph.num_nodes
        ids = torch.eye(n, dtype=x.dtype, device=x.device)
        ids = ids.expand(x.shape[:-1] + (n,))
        x = torch.cat([x, ids], dim=-1)
    fwd_op = build_operator(graphs[0], operator_mode, precision=precision,
                            device=x.device)
    res = propagate_khop(fwd_op, x, k, include_input=True)
    if bidirectional:
        bwd_op = build_operator(graphs[1], operator_mode,
                                precision=precision, device=x.device)
        res += propagate_khop(bwd_op, res[0], k, include_input=False)
    return res


def sgp_spatial_support(g: Graph, k: int = 2,
                        undirected: bool = False,
                        add_loops: bool = False,
                        remove_loops: bool = False,
                        bidirectional: bool = False,
                        global_attr: bool = False,
                        true_powers: bool = True) -> List[Graph]:
    """The operator list ``[A, A^2, ..., A^k]`` (then the same on the
    transposed graph when ``bidirectional``, then the dense ``1/N`` graph
    when ``global_attr``), as host graphs.

    ``true_powers=False`` keeps the reference's quirk of appending ``A @ A``
    k-1 times instead of the successive powers. The backward support is the
    real transpose, as in :func:`sgp_spatial_embedding`."""
    if undirected:
        g = to_undirected(g)
    if add_loops:
        g = add_self_loops(g)
    elif remove_loops:
        g = remove_self_loops(g)
    adj0 = normalize_adj(g, "sym" if undirected else "row")
    support = [adj0]
    power = adj0
    for _ in range(k - 1):
        if true_powers:
            power = spgemm(power, adj0)
            support.append(power)
        else:
            support.append(spgemm(adj0, adj0))
    if bidirectional:
        support += sgp_spatial_support(transpose(g), k=k,
                                       true_powers=true_powers)
    if global_attr:
        n = g.num_nodes
        support.append(Graph.from_dense(np.full((n, n), 1.0 / n,
                                                np.float32)))
    return support
