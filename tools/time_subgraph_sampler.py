"""Time the parts of ``SubgraphLoader._sample_subgraph`` on the host.

The large-scale baseline runner at ``configs/largescale/gatedgn_pv.yaml``
(``exp/run_largescale_baselines.py``: no k-nn and no threshold, so every
pair of the 5,016 nodes is an edge, 25,155,240 edges) samples 627 roots a
batch, their 2-hop in-neighbourhood, cut to 2,508 nodes and capped at
2,500,000 edges. This script builds that graph and loader and times, over
``--samples`` batches, a copy of ``_sample_subgraph`` split into its
parts: the roots' draw, the BFS over the by-target CSR, the edge mask
(``mask[src] & mask[dst]``), the first relabel (the induced subgraph), the
cut to ``pad_nodes`` (its edge mask and second relabel) and the edge cap
(``cap_edges``: a draw without replacement). Each sample's result is held
to the loader's own ``_sample_subgraph`` from the same generator state.

    python tools/time_subgraph_sampler.py [--samples 3] [--nodes 5016]

Host numpy only; the numbers are the machine's it runs on.
"""
from __future__ import annotations

import argparse
import copy
import json
import platform
import time

import numpy as np

from sgp_tpu_torch.data import SpatioTemporalDataset, Windowing
from sgp_tpu_torch.data.datasets import SyntheticDiffusion
from sgp_tpu_torch.data.subgraph import SubgraphLoader, cap_edges
from sgp_tpu_torch.graph.sparse import Graph


def sample_in_parts(loader: SubgraphLoader, times: dict):
    """``loader._sample_subgraph()`` with each part timed into ``times``."""
    def tick(name, t0):
        t1 = time.perf_counter()
        times[name] = times.get(name, 0.0) + (t1 - t0) * 1e3
        return t1

    g, rng = loader.dataset.graph, loader._rng
    t = time.perf_counter()
    roots = rng.permutation(loader.dataset.n_nodes)[:loader.num_roots]
    t = tick("roots", t)
    n = g.num_nodes
    mask = np.zeros(n, bool)
    mask[roots] = True
    frontier = roots.astype(np.int64)
    for _ in range(loader.k):
        reach = np.zeros(n, bool)
        reach[loader._rows[frontier].indices] = True
        reach &= ~mask
        frontier = np.flatnonzero(reach)
        if len(frontier) == 0:
            break
        mask |= reach
    nodes = np.flatnonzero(mask)
    t = tick("bfs", t)
    e_keep = mask[g.src] & mask[g.dst]
    t = tick("edge_mask", t)
    relabel = np.full(n, -1, np.int64)
    relabel[nodes] = np.arange(len(nodes))
    sub = Graph(relabel[g.src[e_keep]], relabel[g.dst[e_keep]],
                g.weight[e_keep], len(nodes))
    root_pos = relabel[roots]
    t = tick("relabel_induced", t)
    if len(nodes) > loader.pad_nodes:
        is_root = np.zeros(len(nodes), bool)
        is_root[root_pos] = True
        others = np.nonzero(~is_root)[0]
        keep_local = np.concatenate([root_pos, rng.permutation(others)[
            :loader.pad_nodes - len(root_pos)]])
        keep_local.sort()
        nodes = nodes[keep_local]
        relabel = np.full(sub.num_nodes, -1, np.int64)
        relabel[keep_local] = np.arange(len(keep_local))
        e_keep = (relabel[sub.src] >= 0) & (relabel[sub.dst] >= 0)
        t = tick("cut_edge_mask", t)
        sub = Graph(relabel[sub.src[e_keep]], relabel[sub.dst[e_keep]],
                    sub.weight[e_keep], len(nodes))
        root_pos = np.searchsorted(keep_local, np.sort(root_pos))
        t = tick("cut_relabel", t)
    if sub.num_edges > loader.max_edges:
        sub = cap_edges(sub, loader.max_edges, rng,
                        loader.cut_edges_uniformly)
        t = tick("cap_edges", t)
    return nodes, sub, root_pos


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=5016)
    ap.add_argument("--steps", type=int, default=640)
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--num-roots", type=int, default=None,
                    help="default: the runner's max(nodes // 8, 256)")
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--max-edges", type=int, default=2_500_000)
    args = ap.parse_args()
    t0 = time.perf_counter()
    raw = SyntheticDiffusion(num_nodes=args.nodes, num_steps=args.steps,
                             seed=0)
    graph = raw.get_connectivity(knn=None, threshold=None,
                                 include_self=False)
    ds = SpatioTemporalDataset(raw.target, mask=raw.mask, graph=graph,
                               windowing=Windowing(window=36, horizon=22,
                                                   horizon_lag=7))
    roots = args.num_roots or max(args.nodes // 8, 256)
    loader = SubgraphLoader(ds, batch_size=1, num_roots=roots, k=args.k,
                            max_edges=args.max_edges,
                            pad_nodes=min(4 * roots, args.nodes), seed=0)
    setup_s = time.perf_counter() - t0
    parts, whole = {}, []
    for _ in range(args.samples):
        twin = copy.deepcopy(loader._rng)
        got = sample_in_parts(loader, parts)
        mirror = copy.copy(loader)
        mirror._rng = twin
        t1 = time.perf_counter()
        want = mirror._sample_subgraph()
        whole.append((time.perf_counter() - t1) * 1e3)
        for a, b in ((got[0], want[0]), (got[1].src, want[1].src),
                     (got[1].dst, want[1].dst), (got[2], want[2])):
            np.testing.assert_array_equal(a, b)
    row = {"host": platform.processor() or platform.machine(),
           "nodes": args.nodes, "edges": graph.num_edges, "roots": roots,
           "k": args.k, "pad_nodes": loader.pad_nodes,
           "max_edges": args.max_edges, "samples": args.samples,
           "setup_s": setup_s,
           "ms_per_sample": {k: v / args.samples for k, v in parts.items()},
           "parts_ms": sum(parts.values()) / args.samples,
           "sample_subgraph_ms": whole}
    print(json.dumps(row))


if __name__ == "__main__":
    main()
