"""Host-side sparse graph representation and graph algorithms.

A numpy copy of the part of ``sgp_tpu/graph/sparse.py`` that the serving
path reaches, held bit-exact against it by the parity tests. Graphs are
prepared once on the host; device compute consumes a dense operator or the
packed block-sparse tiles of :meth:`Graph.to_bsr` (``sgp_tpu_torch.ops``).

Conventions
-----------
Edges are stored COO as ``(src, dst, weight)``. The propagation operator is
the (normalized) adjacency ``A[dst, src] = w`` so that ``x' = A @ x``
aggregates *source* features into each *target* node.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class Graph:
    """An immutable weighted directed graph on ``num_nodes`` nodes.

    Attributes:
        src: ``[E]`` int32 source node of each edge.
        dst: ``[E]`` int32 target node of each edge.
        weight: ``[E]`` float32 edge weight.
        num_nodes: number of nodes ``N``.
    """
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    num_nodes: int

    def __post_init__(self):
        object.__setattr__(self, "src", np.asarray(self.src, np.int32))
        object.__setattr__(self, "dst", np.asarray(self.dst, np.int32))
        w = (np.ones(len(self.src), np.float32) if self.weight is None
             else np.asarray(self.weight, np.float32))
        object.__setattr__(self, "weight", w)
        if len(self.src) != len(self.dst) or len(self.src) != len(w):
            raise ValueError("src/dst/weight length mismatch")

    @classmethod
    def from_dense(cls, adj: np.ndarray) -> "Graph":
        """Build from a dense ``A[dst, src]`` matrix (zeros = no edge)."""
        dst, src = np.nonzero(adj)
        return cls(src, dst, adj[dst, src].astype(np.float32), adj.shape[0])

    @property
    def num_edges(self) -> int:
        return int(len(self.src))

    def to_scipy(self) -> sp.csr_matrix:
        """CSR matrix of the operator ``A[dst, src] = w``."""
        return sp.csr_matrix(
            (self.weight, (self.dst, self.src)),
            shape=(self.num_nodes, self.num_nodes))

    def to_dense(self, dtype=np.float32) -> np.ndarray:
        """Dense operator ``A[dst, src]``."""
        return np.asarray(self.to_scipy().todense(), dtype=dtype)

    def to_bsr(self, block: int = 128):
        """Pack into block-sparse-row format for the BSR SpMM kernel.

        Returns ``(blocks, block_cols, row_ptr)`` where ``blocks`` is
        ``[nnzb, block, block]`` dense sub-tiles of the (zero-padded)
        operator, ``block_cols[nnzb]`` the block-column index of each tile
        and ``row_ptr[N/block + 1]`` CSR-style offsets over block rows.
        """
        n_pad = ((self.num_nodes + block - 1) // block) * block
        mat = self.to_scipy()
        mat.resize((n_pad, n_pad))
        bsr = mat.tobsr(blocksize=(block, block))
        bsr.sort_indices()
        return (np.asarray(bsr.data, np.float32),
                np.asarray(bsr.indices, np.int32),
                np.asarray(bsr.indptr, np.int32))

    def with_weight(self, weight: np.ndarray) -> "Graph":
        return Graph(self.src, self.dst, weight, self.num_nodes)


# ---------------------------------------------------------------------------
# graph algorithms (all host-side, operate on / return Graph)
# ---------------------------------------------------------------------------

def coalesce(g: Graph, reduce: str = "sum") -> Graph:
    """Sort edges by (dst, src) and merge duplicates.

    Only the numpy branch of ``sgp_tpu.graph.coalesce``: the JAX package
    hands large edge lists to its native library (``sgp_tpu.native``),
    which the port does not load. Both branches give the same result."""
    key = g.dst.astype(np.int64) * g.num_nodes + g.src
    order = np.argsort(key, kind="stable")
    key, src, dst, w = key[order], g.src[order], g.dst[order], g.weight[order]
    uniq, first = np.unique(key, return_index=True)
    if len(uniq) == len(key):
        return Graph(src, dst, w, g.num_nodes)
    seg = np.searchsorted(uniq, key)
    if reduce == "sum":
        wm = np.zeros(len(uniq), np.float32)
        np.add.at(wm, seg, w)
    elif reduce == "max":
        wm = np.full(len(uniq), -np.inf, np.float32)
        np.maximum.at(wm, seg, w)
    else:
        raise ValueError(reduce)
    return Graph(src[first], dst[first], wm, g.num_nodes)


def transpose(g: Graph) -> Graph:
    """Reverse all edges (operator transpose)."""
    return Graph(g.dst, g.src, g.weight, g.num_nodes)


def to_undirected(g: Graph, reduce: str = "sum") -> Graph:
    """Symmetrize: ``A + A^T`` with duplicate merge."""
    return coalesce(Graph(
        np.concatenate([g.src, g.dst]),
        np.concatenate([g.dst, g.src]),
        np.concatenate([g.weight, g.weight]),
        g.num_nodes), reduce=reduce)


def add_self_loops(g: Graph, fill_value: float = 1.0) -> Graph:
    """Set the diagonal to ``fill_value`` (torch_sparse ``set_diag``)."""
    loop = np.arange(g.num_nodes, dtype=np.int32)
    keep = g.src != g.dst
    return coalesce(Graph(
        np.concatenate([g.src[keep], loop]),
        np.concatenate([g.dst[keep], loop]),
        np.concatenate([g.weight[keep],
                        np.full(g.num_nodes, fill_value, np.float32)]),
        g.num_nodes))


def remove_self_loops(g: Graph) -> Graph:
    keep = g.src != g.dst
    return Graph(g.src[keep], g.dst[keep], g.weight[keep], g.num_nodes)


def weighted_degree(g: Graph, direction: str = "in") -> np.ndarray:
    """Weighted degree. ``in`` sums over incoming edges (by dst) — the
    row-sum of the operator."""
    index = g.dst if direction == "in" else g.src
    deg = np.zeros(g.num_nodes, np.float32)
    np.add.at(deg, index, g.weight)
    return deg


def normalize_adj(g: Graph, norm: str = "row",
                  add_loops: bool = False,
                  remove_loops: bool = False) -> Graph:
    """Normalize the propagation operator.

    ``row``: ``D_in^-1 A``; ``sym``: ``D^-1/2 A D^-1/2``; ``none``:
    pass-through. Zero-degree rows get 0 (inf→0).
    """
    if add_loops:
        g = add_self_loops(g)
    elif remove_loops:
        g = remove_self_loops(g)
    if norm == "none":
        return g
    deg = weighted_degree(g, "in")
    if norm == "row":
        inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-38), 0.0)
        return g.with_weight(g.weight * inv[g.dst])
    if norm == "sym":
        inv_sqrt = np.where(deg > 0, deg.astype(np.float64) ** -0.5, 0.0)
        return g.with_weight(
            (g.weight * inv_sqrt[g.dst] * inv_sqrt[g.src]).astype(np.float32))
    raise ValueError(f"unknown norm {norm!r}")


def edge_dropout(g: Graph, p: float, rng: np.random.Generator) -> Graph:
    """Drop each edge independently with prob ``p`` (no rescaling)."""
    if p <= 0:
        return g
    keep = rng.random(g.num_edges) >= p
    return Graph(g.src[keep], g.dst[keep], g.weight[keep], g.num_nodes)
