"""Node-sharded whole-series encoding and closed-form readout.

Counterpart of ``sgp_tpu/parallel/encode.py``. The series ``[T, N, F]``
is cut along its nodes over a mesh axis: each rank runs the reservoir on
its own node block (the scan is node-local), zeroes the padding rows, and
propagates the K hops with the boundary-halo exchange
(:mod:`sgp_tpu_torch.parallel.halo`). The encoding never exists whole on
one rank. The ridge readout shards the same way: each rank's masked Gram,
moments and sums are ``all_reduce``d and every rank solves the same
system.
"""
from __future__ import annotations

import torch

from sgp_tpu_torch.encode.spatial import prepare_propagation_graphs
from sgp_tpu_torch.graph.sparse import Graph
from sgp_tpu_torch.parallel import collectives
from sgp_tpu_torch.parallel.halo import build_halo_spec, halo_khop, shard_nodes
from sgp_tpu_torch.parallel.mesh import Axis, Mesh
from sgp_tpu_torch.train.ridge import solve_ridge_normal


def encode_series_sharded(reservoir, x_series, graph: Graph, mesh: Mesh,
                          k: int = 2, axis: Axis = "data",
                          undirected: bool = False,
                          add_loops: bool = False,
                          bidirectional: bool = False,
                          global_attr: bool = False,
                          out_dtype=None,
                          halo_payload: str = "float32",
                          chips_per_host: int = None,
                          halo_depth: int = 1) -> torch.Tensor:
    """SGP-encode ``x_series [T, N, F]`` (the whole series, on this rank's
    device) with every stage node-sharded over ``axis``. Returns this
    rank's slab ``[T, Nl, D]`` of the embedding, its padding rows (past N)
    zero, in the layout ``[h, Ah, ..., A^k h (, A'h, ..., A'^k h)(,
    mean(h))]``; :func:`~sgp_tpu_torch.parallel.halo.gather_nodes` with
    ``num_nodes=N`` assembles the whole. ``halo_payload``/``halo_depth``
    as in :func:`~sgp_tpu_torch.parallel.halo.build_halo_spec`;
    ``chips_per_host`` with ``axis=("host", "chip")`` runs the two-level
    exchange. Every rank of the axis calls it together."""
    n_shards = mesh.size(axis)
    n_true = graph.num_nodes
    graphs = prepare_propagation_graphs(
        graph, undirected=undirected, add_loops=add_loops,
        bidirectional=bidirectional)
    specs = [build_halo_spec(g, n_shards, payload_dtype=halo_payload,
                             chips_per_host=chips_per_host,
                             depth=halo_depth) for g in graphs]
    x = torch.as_tensor(x_series, device=reservoir.layers[0].w_ih.device)
    h = reservoir(shard_nodes(x, mesh, axis, node_axis=1, spec=specs[0]),
                  out_dtype=out_dtype)                # [T, Nl, LH]
    nl = h.shape[1]
    rows = mesh.index[axis] * nl + torch.arange(nl, device=h.device)
    # the reservoir's bias makes the padding rows non-zero: zero them, or
    # they pollute the global mean
    h = torch.where((rows < n_true)[None, :, None], h, h.new_zeros(()))
    parts = [halo_khop(specs[0], h, mesh, k=k, axis=axis, concat=True)]
    if bidirectional:
        parts.append(halo_khop(specs[1], h, mesh, k=k, axis=axis,
                               concat=True)[..., h.shape[-1]:])
    if global_attr:
        total = collectives.all_reduce_(
            h.float().sum(-2, keepdim=True), mesh.group(axis))
        parts.append((total / n_true).to(h.dtype).expand(h.shape))
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return out if out_dtype is None else out.to(out_dtype)


def sharded_ridge_nodes(x, y, alpha: float, mesh: Mesh, mask=None,
                        axis: str = "data", fit_intercept: bool = True,
                        n_nodes: int = None):
    """Closed-form ridge over every (t, node) row of this rank's slabs
    ``x [T, Nl, D]`` / ``y [T, Nl, C]`` and those of the other ranks of
    ``axis``: the masked Gram, moments and sums of each rank summed by
    ``all_reduce``, then the same solve on every rank. ``mask [T, Nl, *]``
    marks the rows that count (any True along the last dim; default all);
    ``n_nodes`` (the true N) drops the padding rows past it. Returns ``(W
    [D, C], b [C])`` as ``sgp_tpu``'s ``sharded_ridge_nodes`` does on the
    whole arrays."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    (t, nl), d, c = x.shape[:2], x.shape[-1], y.shape[-1]
    keep = torch.ones(t, nl, dtype=torch.bool, device=x.device)
    if mask is not None:
        keep = torch.as_tensor(mask, device=x.device).any(-1)
    if n_nodes is not None:
        rows = mesh.index[axis] * nl + torch.arange(nl, device=x.device)
        keep = keep & (rows < n_nodes)[None, :]
    w = keep.reshape(-1, 1).float()
    xf = x.reshape(-1, d) * w
    yf = y.reshape(-1, c) * w
    # one all_reduce for the count, the sums, the Gram and the moments
    flat = torch.cat([w.sum().reshape(1), xf.sum(0), yf.sum(0),
                      (xf.T @ xf).reshape(-1), (xf.T @ yf).reshape(-1)])
    flat = collectives.all_reduce_(flat, mesh.group(axis))
    cnt = flat[0].clamp_min(1.0)
    sx, sy = flat[1:1 + d], flat[1 + d:1 + d + c]
    g = flat[1 + d + c:1 + d + c + d * d].reshape(d, d)
    mom = flat[1 + d + c + d * d:].reshape(d, c)
    if fit_intercept:
        x_mean, y_mean = sx / cnt, sy / cnt
        g = g - cnt * torch.outer(x_mean, x_mean)
        mom = mom - cnt * torch.outer(x_mean, y_mean)
    w_sol = solve_ridge_normal(g, mom, alpha)
    if not fit_intercept:
        return w_sol, y.new_zeros(c)
    return w_sol, y_mean - x_mean @ w_sol

