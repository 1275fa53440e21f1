"""Subgraph and node-subset batches for training graph baselines on large
graphs.

Counterpart of ``sgp_tpu/data/subgraph.py``, numpy on the host, drawing
from one ``np.random.Generator`` in the same order as the JAX loaders, so
that a seed gives their batches bit for bit:

- :func:`cap_edges` keeps at most ``max_edges`` edges, uniformly or with
  probability proportional to 1 / in-degree.
- :class:`SubsetLoader` slices every node tensor to a random node subset;
  the batch carries no edges.
- :class:`SubgraphLoader` samples roots, expands their k-hop
  in-neighbourhood (:func:`graph.k_hop_subgraph` through the by-target CSR
  it builds once), slices the node tensors to the subgraph and attaches
  its edges and the roots' positions (``target_nodes``: the trainer's loss
  reads the roots only).

Shapes are static, as in the JAX loader: nodes padded to ``pad_nodes``
with node 0, edges padded to ``max_edges`` with ``src = dst = 0`` and
weight 0 (a model masks them by ``sub_weight != 0``).
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from sgp_tpu_torch.data.spatiotemporal import Batch, SpatioTemporalDataset
from sgp_tpu_torch.graph.sparse import (Graph, adjacency_rows,
                                        k_hop_subgraph, weighted_degree)


def cap_edges(g: Graph, max_edges: int, rng: np.random.Generator,
              uniform: bool = True) -> Graph:
    """At most ``max_edges`` of ``g``'s edges, drawn without replacement
    uniformly or with p ∝ 1 / in-degree of the edge's target."""
    if g.num_edges <= max_edges:
        return g
    if uniform:
        keep = rng.choice(g.num_edges, max_edges, replace=False)
    else:
        deg = weighted_degree(g.with_weight(
            np.ones(g.num_edges, np.float32)), "in")
        p = 1.0 / np.maximum(deg[g.dst], 1.0)
        p = p / p.sum()
        keep = rng.choice(g.num_edges, max_edges, replace=False, p=p)
    return Graph(g.src[keep], g.dst[keep], g.weight[keep], g.num_nodes)


def _n_batches(items, batch_size: int, limit_batches: Optional[int]) -> int:
    n = -(-len(items) // batch_size)
    return min(n, limit_batches) if limit_batches else n


class SubsetLoader:
    """Batches of window items on a random node subset of ``num_nodes``
    nodes (a new subset a batch); no edges."""

    def __init__(self, dataset: SpatioTemporalDataset,
                 items: Optional[np.ndarray] = None,
                 batch_size: int = 4, num_nodes: int = 1024,
                 shuffle: bool = True, seed: int = 0,
                 limit_batches: Optional[int] = None):
        self.dataset = dataset
        self.items = (np.arange(len(dataset)) if items is None
                      else np.asarray(items))
        self.batch_size = batch_size
        self.num_nodes = min(num_nodes, dataset.n_nodes)
        self.shuffle = shuffle
        self.limit_batches = limit_batches
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return _n_batches(self.items, self.batch_size, self.limit_batches)

    def __iter__(self) -> Iterator[Batch]:
        order = self._rng.permutation(self.items) if self.shuffle \
            else self.items
        for b in range(len(self)):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            if not len(sel):
                return
            nodes = self._rng.permutation(
                self.dataset.n_nodes)[:self.num_nodes]
            batch = self.dataset.gather_batch(sel, node_index=nodes)
            batch["target_nodes"] = np.arange(len(nodes))
            yield batch


class SubgraphLoader:
    """K-hop subgraph batches: ``num_roots`` roots a batch, their ``k``-hop
    in-neighbourhood capped at ``pad_nodes`` nodes (all roots and a random
    share of the rest) and ``max_edges`` edges, then padded to those sizes.
    A batch holds the node tensors sliced to the subgraph, ``node_index``,
    ``target_nodes`` (the roots' positions) and the padded edge arrays
    ``sub_src``, ``sub_dst`` (int32) and ``sub_weight`` (float32)."""

    def __init__(self, dataset: SpatioTemporalDataset,
                 items: Optional[np.ndarray] = None,
                 batch_size: int = 4, num_roots: int = 512, k: int = 2,
                 max_edges: Optional[int] = None,
                 cut_edges_uniformly: bool = True,
                 pad_nodes: Optional[int] = None,
                 shuffle: bool = True, seed: int = 0,
                 limit_batches: Optional[int] = None):
        if dataset.graph is None:
            raise ValueError("SubgraphLoader needs a dataset with a graph")
        self.dataset = dataset
        self.items = (np.arange(len(dataset)) if items is None
                      else np.asarray(items))
        self.batch_size = batch_size
        self.num_roots = min(num_roots, dataset.n_nodes)
        self.k = k
        self.max_edges = max_edges or dataset.graph.num_edges
        self.cut_edges_uniformly = cut_edges_uniformly
        self.pad_nodes = min(pad_nodes or dataset.n_nodes,
                             dataset.n_nodes)
        self.shuffle = shuffle
        self.limit_batches = limit_batches
        self._rng = np.random.default_rng(seed)
        # the by-target CSR, built once (the JAX loader's numpy path
        # rebuilds it every batch)
        self._rows = adjacency_rows(dataset.graph, "target_to_source")

    def __len__(self) -> int:
        return _n_batches(self.items, self.batch_size, self.limit_batches)

    def _sample_subgraph(self):
        g = self.dataset.graph
        roots = self._rng.permutation(
            self.dataset.n_nodes)[:self.num_roots]
        nodes, sub, root_pos = k_hop_subgraph(
            g, roots, self.k, flow="target_to_source", rows=self._rows)
        if len(nodes) > self.pad_nodes:
            # keep all roots and a random subset of the expansion
            is_root = np.zeros(len(nodes), bool)
            is_root[root_pos] = True
            others = np.nonzero(~is_root)[0]
            keep_local = np.concatenate([
                root_pos,
                self._rng.permutation(others)[
                    :self.pad_nodes - len(root_pos)]])
            keep_local.sort()
            nodes = nodes[keep_local]
            relabel = np.full(sub.num_nodes, -1, np.int64)
            relabel[keep_local] = np.arange(len(keep_local))
            e_keep = (relabel[sub.src] >= 0) & (relabel[sub.dst] >= 0)
            sub = Graph(relabel[sub.src[e_keep]],
                        relabel[sub.dst[e_keep]],
                        sub.weight[e_keep], len(nodes))
            # keep_local is sorted and holds every root position
            root_pos = np.searchsorted(keep_local, np.sort(root_pos))
        if sub.num_edges > self.max_edges:
            sub = cap_edges(sub, self.max_edges, self._rng,
                            self.cut_edges_uniformly)
        return nodes, sub, root_pos

    def _pad(self, nodes, sub):
        """The node list and edge arrays padded to their static sizes."""
        nodes_p = np.zeros(self.pad_nodes, np.int64)
        nodes_p[:len(nodes)] = nodes
        src = np.zeros(self.max_edges, np.int32)
        dst = np.zeros(self.max_edges, np.int32)
        w = np.zeros(self.max_edges, np.float32)
        src[:sub.num_edges] = sub.src
        dst[:sub.num_edges] = sub.dst
        w[:sub.num_edges] = sub.weight
        return nodes_p, src, dst, w

    def __iter__(self) -> Iterator[Batch]:
        order = self._rng.permutation(self.items) if self.shuffle \
            else self.items
        for b in range(len(self)):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            if not len(sel):
                return
            nodes, sub, root_pos = self._sample_subgraph()
            nodes_p, src, dst, w = self._pad(nodes, sub)
            batch = self.dataset.gather_batch(sel, node_index=nodes_p)
            batch["target_nodes"] = root_pos
            batch["sub_src"] = src
            batch["sub_dst"] = dst
            batch["sub_weight"] = w
            yield batch
