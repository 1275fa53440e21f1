"""Host-side sparse graph representation and graph algorithms.

A numpy copy of the part of ``sgp_tpu/graph/sparse.py`` that the serving,
GatedGN training, subgraph-sampling and support-materialization paths reach, held bit-exact against
it by the parity tests; large edge lists go to the host C++ core
(``sgp_tpu_torch/native``) where the JAX functions take theirs. Graphs are prepared once on the host; device compute consumes a
dense operator, the packed block-sparse tiles of :meth:`Graph.to_bsr`, the
ELL table of :func:`padded_incoming` or a dense mask with the band windows
of :func:`band_windows` / :func:`auto_band` (``sgp_tpu_torch.ops``).

Conventions
-----------
Edges are stored COO as ``(src, dst, weight)``. The propagation operator is
the (normalized) adjacency ``A[dst, src] = w`` so that ``x' = A @ x``
aggregates *source* features into each *target* node.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from sgp_tpu_torch import native

# edges from which coalesce takes the host core, as the JAX function does
NATIVE_MIN_EDGES = 100_000


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

    @classmethod
    def from_scipy(cls, mat: sp.spmatrix) -> "Graph":
        coo = mat.tocoo()
        return cls(coo.col, coo.row, coo.data.astype(np.float32),
                   mat.shape[0])

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

    At ``reduce="sum"`` and :data:`NATIVE_MIN_EDGES` edges or more the host
    core does it (:func:`sgp_tpu_torch.native.coalesce_edges`), as in
    ``sgp_tpu.graph.coalesce``; below that, or at ``"max"``, numpy. The two
    routes give the same edges, but their ``std::sort`` and numpy's stable
    ``argsort`` order duplicates differently, so an edge that occurs three
    times or more may sum its weights to other last bits."""
    if reduce == "sum" and g.num_edges >= NATIVE_MIN_EDGES:
        src, dst, w = native.coalesce_edges(g.src, g.dst, g.weight,
                                            g.num_nodes)
        return Graph(src, dst, w, g.num_nodes)
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


def spgemm(a: Graph, b: Graph) -> Graph:
    """The operator product ``a @ b`` (support materialization), by
    scipy on the host."""
    return Graph.from_scipy(a.to_scipy() @ b.to_scipy())


def edge_dropout(g: Graph, p: float, rng: np.random.Generator) -> Graph:
    """Drop each edge independently with prob ``p`` (no rescaling)."""
    if p <= 0:
        return g
    keep = rng.random(g.num_edges) >= p
    return Graph(g.src[keep], g.dst[keep], g.weight[keep], g.num_nodes)


def rcm_order(g: Graph) -> np.ndarray:
    """Reverse-Cuthill-McKee node order of ``A + A^T``: it gathers the
    edges near the diagonal, so each block of dst rows of the dense
    all-pairs mask touches a narrow band of columns (:func:`band_windows`).
    Returns ``perm`` (new position -> old id)."""
    mat = g.to_scipy() + g.to_scipy().T
    return np.asarray(
        sp.csgraph.reverse_cuthill_mckee(mat.tocsr(), symmetric_mode=True),
        np.int64)


def permute_nodes(g: Graph, perm: np.ndarray) -> Graph:
    """Relabel nodes so new node ``i`` is old node ``perm[i]``."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return Graph(inv[g.src], inv[g.dst], g.weight, g.num_nodes)


def adjacency_rows(g: Graph, flow: str = "target_to_source"
                   ) -> sp.csr_matrix:
    """The CSR that :func:`k_hop_subgraph` expands through: with
    ``flow="target_to_source"`` row ``t`` holds the sources of ``t``'s
    incoming edges, with ``"source_to_target"`` the targets of its outgoing
    ones. Build it once per graph and pass it to every call."""
    if flow not in ("target_to_source", "source_to_target"):
        raise ValueError(f"unknown flow {flow!r}")
    rows, cols = (g.dst, g.src) if flow == "target_to_source" \
        else (g.src, g.dst)
    return sp.csr_matrix((np.ones(g.num_edges, np.int8), (rows, cols)),
                         shape=(g.num_nodes, g.num_nodes))


def k_hop_subgraph(g: Graph, roots: np.ndarray, k: int,
                   flow: str = "target_to_source",
                   rows: Optional[sp.csr_matrix] = None):
    """K-hop neighbourhood of ``roots`` and the subgraph it induces.

    With ``flow="target_to_source"`` the frontier expands from targets to
    their sources (the nodes whose features flow into the roots). ``rows``
    is :func:`adjacency_rows` of ``g`` for ``flow``, built here when not
    given. The host core's BFS walks ``rows`` (:func:`sgp_tpu_torch.native.
    khop_mask`) at every flow and size: the JAX function walks its own at
    ``"target_to_source"`` from 100,000 edges and numpy below, and the
    reached set, and so the result, is the same on every route.

    Returns ``(nodes, sub, root_positions)``: the sorted node set, the
    induced subgraph relabelled to positions in ``nodes`` (edges in ``g``'s
    order) and the position of each root in ``nodes``.
    """
    n = g.num_nodes
    roots = np.asarray(roots, np.int64)
    if rows is None:
        rows = adjacency_rows(g, flow)
    elif rows.shape != (n, n):
        raise ValueError(f"rows is {rows.shape}, the graph has {n} nodes")
    mask = native.khop_mask(rows.indptr, rows.indices, n, roots, k)
    nodes = np.flatnonzero(mask)
    relabel = np.full(n, -1, np.int64)
    relabel[nodes] = np.arange(len(nodes))
    e_keep = mask[g.src] & mask[g.dst]
    sub = Graph(relabel[g.src[e_keep]], relabel[g.dst[e_keep]],
                g.weight[e_keep], len(nodes))
    return nodes, sub, relabel[roots]


def _block_bounds(dst: np.ndarray, src: np.ndarray, n: int, block: int):
    """Per block of ``block`` dst rows, the first and last src column of
    its edges (``(0, 0)`` for a block without edges)."""
    n_blk = -(-n // block)
    lo = np.full(n_blk, n, np.int64)
    hi = np.full(n_blk, -1, np.int64)
    blk = np.asarray(dst, np.int64) // block
    np.minimum.at(lo, blk, src)
    np.maximum.at(hi, blk, src)
    empty = hi < 0
    lo[empty], hi[empty] = 0, 0
    return [(int(a), int(b)) for a, b in zip(lo, hi)]


def _windows(bounds, n: int, block: int, width_mult: int, uniform: bool):
    width = max([1] + [hi - lo + 1 for lo, hi in bounds])
    width = min(n, -(-width // width_mult) * width_mult)
    if uniform:
        return block, width, tuple(min(max(lo, 0), n - width)
                                   for lo, _ in bounds)
    widths = tuple(min(n, -(-max(hi - lo + 1, 1) // width_mult) * width_mult)
                   for lo, hi in bounds)
    los = tuple(min(max(lo, 0), n - w) for (lo, _), w in zip(bounds, widths))
    return block, widths, los


def band_windows(dense_adj: np.ndarray, block: int, width_mult: int = 128,
                 uniform: bool = True):
    """Per-row-block column windows of an ``A[dst, src]`` matrix (nonzero =
    edge): for each block of ``block`` dst rows, the smallest column
    interval that covers its edges, padded to a multiple of
    ``width_mult`` and clamped into ``[0, N]``.

    Returns ``(block, width, los)``: ``width`` one int, or with
    ``uniform=False`` a tuple of one width per block; ``los`` a tuple of
    each block's first column. The dense all-pairs GatedGN aggregation
    (``adj_band=``) then computes only the pairs inside the windows."""
    dst, src = np.nonzero(np.asarray(dense_adj) != 0)
    n = np.asarray(dense_adj).shape[0]
    return _windows(_block_bounds(dst, src, n, block), n, block, width_mult,
                    uniform)


def auto_band(g: Graph, block: int = 256, width_mult: int = 128,
              max_nodes: int = 20000, max_frac: float = 0.6):
    """Variable-width band windows of ``g`` in its own node order, or
    ``None`` (a full sweep) when the windowed pairs would reach
    ``max_frac`` of ``N^2`` or ``N`` exceeds ``max_nodes``. Stored zero
    weights are not edges. Built from the edge list in O(E); the JAX
    package's densifies, which its ``max_nodes`` guard bounds and this
    keeps, so both return the same."""
    n = g.num_nodes
    if n > max_nodes:
        return None
    keep = g.weight != 0
    band = _windows(_block_bounds(g.dst[keep], g.src[keep], n, block), n,
                    block, width_mult, uniform=False)
    blk, widths, _ = band
    if sum(widths) * blk >= max_frac * n * n:
        return None
    return band


def padded_incoming(g: Graph, pad_to: Optional[int] = None):
    """ELL layout of the incoming edges: per destination node, the source
    indices (sorted) padded to a fixed width ``D``, the in-degree maximum
    unless ``pad_to`` is given. A k-nn graph has in-degree k everywhere
    and no padding.

    Returns ``(src_idx [N, D] int32, mask [N, D] bool)``; padded slots
    point at node 0 with ``mask=False``.
    """
    order = np.lexsort((g.src, g.dst))
    dst_s, src_s = g.dst[order], g.src[order]
    counts = np.bincount(dst_s, minlength=g.num_nodes)
    d = int(pad_to or (counts.max() if counts.size else 0))
    if counts.size and counts.max() > d:
        raise ValueError(f"pad_to={d} < max in-degree {counts.max()}")
    src_idx = np.zeros((g.num_nodes, d), np.int32)
    mask = np.zeros((g.num_nodes, d), bool)
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(dst_s)) - starts[dst_s]
    src_idx[dst_s, slot] = src_s
    mask[dst_s, slot] = True
    return src_idx, mask


def dummy_graph(kind: str, num_nodes: int, edge_prob: float = 0.1,
                directed: bool = True, seed: int = 0):
    """Synthetic connectivity: ``'identity'`` (A = I), ``'full'`` (all
    pairs incl. self), ``'random'`` (Erdős–Rényi with edge probability
    ``edge_prob``; undirected = symmetrized upper triangle), or ``'none'``
    (returns None). Host-side :class:`Graph` with unit weights."""
    if kind == "none":
        return None
    if kind == "identity":
        idx = np.arange(num_nodes, dtype=np.int64)
        return Graph(idx, idx, np.ones(num_nodes, np.float32), num_nodes)
    if kind == "full":
        idx = np.arange(num_nodes, dtype=np.int64)
        src = np.repeat(idx, num_nodes)
        dst = np.tile(idx, num_nodes)
        return Graph(src, dst, np.ones(len(src), np.float32), num_nodes)
    if kind == "random":
        rng = np.random.default_rng(seed)
        keep = rng.random((num_nodes, num_nodes)) < edge_prob
        np.fill_diagonal(keep, False)
        if not directed:
            keep = np.triu(keep) | np.triu(keep).T
        src, dst = np.nonzero(keep)
        return Graph(src.astype(np.int64), dst.astype(np.int64),
                     np.ones(len(src), np.float32), num_nodes)
    raise ValueError(f"unknown dummy connectivity {kind!r}")


def band_graph(num_nodes: int, halfwidth: int = 4) -> Graph:
    """Banded line graph: node ``i`` connects to ``i±1..halfwidth`` (both
    directions, unit weights), the road-network shape of the traffic
    datasets (low degree, 1-D locality)."""
    srcs, dsts = [], []
    for d in range(1, halfwidth + 1):
        idx = np.arange(num_nodes - d)
        srcs += [idx, idx + d]
        dsts += [idx + d, idx]
    src = np.concatenate(srcs).astype(np.int64)
    dst = np.concatenate(dsts).astype(np.int64)
    return Graph(src, dst, np.ones(len(src), np.float32), num_nodes)


def morton_order(pos: np.ndarray, bits: int = 16) -> np.ndarray:
    """Z-order (Morton) node permutation from 2-D positions: nodes sorted
    by interleaved coordinate bits, so contiguous index blocks are compact
    spatial tiles. Returns ``perm`` (new position -> old id), the
    convention of :func:`rcm_order`."""
    p = np.asarray(pos, np.float64)
    if p.ndim != 2 or p.shape[1] != 2:
        raise ValueError("morton_order expects [N, 2] positions")
    lo, hi = p.min(0), p.max(0)
    q = ((p - lo) / np.maximum(hi - lo, 1e-12)
         * (2 ** bits - 1)).astype(np.uint64)
    code = np.zeros(len(p), np.uint64)
    for b in range(bits):
        code |= ((q[:, 0] >> np.uint64(b)) & np.uint64(1)) \
            << np.uint64(2 * b)
        code |= ((q[:, 1] >> np.uint64(b)) & np.uint64(1)) \
            << np.uint64(2 * b + 1)
    return np.argsort(code, kind="stable").astype(np.int64)
