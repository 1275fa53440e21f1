"""The port's subgraph sampling against the JAX package's, bit for bit:
``k_hop_subgraph`` (on a graph below 100k edges, where the JAX function
takes its numpy path, and on one above, where it calls its native C++
mask), ``cap_edges``, and the ``SubsetLoader`` / ``SubgraphLoader``
batches of one seed, every key, over two passes. numpy on both sides, so
every array must be equal, dtypes included.
"""
import numpy as np
import pytest

from sgp_tpu import native
from sgp_tpu.data import SpatioTemporalDataset as JDataset
from sgp_tpu.data import Windowing as JWindowing
from sgp_tpu.data.subgraph import SubgraphLoader as JSubgraphLoader
from sgp_tpu.data.subgraph import SubsetLoader as JSubsetLoader
from sgp_tpu.data.subgraph import cap_edges as j_cap_edges
from sgp_tpu.graph.sparse import Graph as JGraph
from sgp_tpu.graph.sparse import k_hop_subgraph as j_k_hop_subgraph

from sgp_tpu_torch.data import (SpatioTemporalDataset, SubgraphLoader,
                                SubsetLoader, Windowing, cap_edges)
from sgp_tpu_torch.graph import (Graph, adjacency_rows, coalesce,
                                 k_hop_subgraph)


def _graphs(rng, n, e):
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    return JGraph(src, dst, w, n), Graph(src, dst, w, n)


def _same_graph(a, b):
    assert a.num_nodes == b.num_nodes
    for f in ("src", "dst", "weight"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _same(a, b, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    assert np.array_equal(a, b), name


@pytest.mark.parametrize("n,e", [(300, 3000), (2000, 150_000)],
                         ids=["numpy-path", "native-path"])
@pytest.mark.parametrize("flow", ["target_to_source", "source_to_target"])
def test_k_hop_subgraph_bit_identical(n, e, flow):
    rng = np.random.default_rng(n)
    jg, g = _graphs(rng, n, e)
    rows = adjacency_rows(g, flow)
    if e >= 100_000 and flow == "target_to_source":
        assert native.AVAILABLE      # the JAX side takes its C++ mask
    for k in (0, 1, 2, 3):
        roots = rng.permutation(n)[:max(n // 100, 3)]
        want = j_k_hop_subgraph(jg, roots, k, flow=flow)
        for got in (k_hop_subgraph(g, roots, k, flow=flow),
                    k_hop_subgraph(g, roots, k, flow=flow, rows=rows)):
            _same(got[0], want[0], "nodes")
            _same(got[2], want[2], "root positions")
            _same_graph(got[1], want[1])
        assert (k > 0) == (len(want[0]) > len(roots))


def test_k_hop_subgraph_rejects_a_foreign_csr():
    rng = np.random.default_rng(1)
    _, g = _graphs(rng, 20, 60)
    _, other = _graphs(rng, 21, 60)
    with pytest.raises(ValueError):
        k_hop_subgraph(g, [0], 1, rows=adjacency_rows(other))
    with pytest.raises(ValueError):
        adjacency_rows(g, "sideways")


@pytest.mark.parametrize("uniform", [True, False])
def test_cap_edges_bit_identical(uniform):
    rng = np.random.default_rng(2)
    jg, g = _graphs(rng, 40, 900)
    for max_edges in (100, 900, 2000):
        want = j_cap_edges(jg, max_edges, np.random.default_rng(7), uniform)
        got = cap_edges(g, max_edges, np.random.default_rng(7), uniform)
        _same_graph(got, want)
        assert got.num_edges == min(max_edges, 900)


def _datasets(n=30, t=60, e=260, seed=3):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    target = rng.standard_normal((t, n, 1)).astype(np.float32)
    mask = rng.random((t, n, 1)) > 0.1
    u = rng.standard_normal((t, 2)).astype(np.float32)
    g = coalesce(Graph(src, dst, w, n))
    out = []
    for dset, graph, win in (
            (JDataset, JGraph(g.src, g.dst, g.weight, n), JWindowing),
            (SpatioTemporalDataset, g, Windowing)):
        out.append(dset(target, mask=mask, graph=graph,
                        covariates={"u": u},
                        windowing=win(window=4, horizon=3)))
    return out


def _same_batches(jl, tl, keys):
    assert len(jl) == len(tl)
    for _ in range(2):               # two passes, two permutations
        n = 0
        for jb, tb in zip(jl, tl):
            assert set(jb) == set(tb) == keys
            for k in jb:
                _same(jb[k], tb[k], k)
            n += 1
        assert n == len(jl)


def test_subset_loader_bit_identical():
    jds, tds = _datasets()
    kw = dict(batch_size=5, num_nodes=12, limit_batches=4, seed=11)
    _same_batches(JSubsetLoader(jds, **kw), SubsetLoader(tds, **kw),
                  {"x", "y", "mask", "u", "u_horizon", "node_index",
                   "target_nodes"})


@pytest.mark.parametrize("kw", [
    dict(num_roots=4, k=2, max_edges=40, pad_nodes=14),   # both caps
    dict(num_roots=4, k=1, max_edges=None, pad_nodes=None),
    dict(num_roots=3, k=2, max_edges=60, pad_nodes=30,
         cut_edges_uniformly=False),
    dict(num_roots=5, k=1, max_edges=300, pad_nodes=20, shuffle=False)],
    ids=["capped", "uncapped", "by-in-degree", "unshuffled"])
def test_subgraph_loader_bit_identical(kw):
    jds, tds = _datasets()
    kw = dict(batch_size=4, limit_batches=5, seed=5, **kw)
    jl, tl = JSubgraphLoader(jds, **kw), SubgraphLoader(tds, **kw)
    assert (jl.pad_nodes, jl.max_edges) == (tl.pad_nodes, tl.max_edges)
    _same_batches(jl, tl, {"x", "y", "mask", "u", "u_horizon", "node_index",
                           "target_nodes", "sub_src", "sub_dst",
                           "sub_weight"})


def test_subgraph_batch_is_the_induced_subgraph():
    """Each batch's real edges are edges of the graph between its nodes,
    the padding has weight 0 at node 0, and the roots' rows carry the
    roots' data."""
    _, tds = _datasets(seed=4)
    g = tds.graph
    edges = set(zip(g.src.tolist(), g.dst.tolist()))
    loader = SubgraphLoader(tds, batch_size=2, num_roots=4, k=1,
                            max_edges=80, pad_nodes=12, limit_batches=3,
                            shuffle=False)
    for i, b in enumerate(loader):
        real = b["sub_weight"] != 0
        nodes = b["node_index"]
        assert all((int(nodes[s]), int(nodes[d])) in edges for s, d in
                   zip(b["sub_src"][real], b["sub_dst"][real]))
        assert not b["sub_src"][~real].any() and not b["sub_dst"][~real].any()
        full = tds.gather_batch(np.arange(2 * i, 2 * i + 2))
        np.testing.assert_array_equal(
            b["x"][:, :, b["target_nodes"]],
            full["x"][:, :, nodes[b["target_nodes"]]])
