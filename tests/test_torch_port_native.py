"""The port's host graph core (``sgp_tpu_torch/native``) is the JAX
package's (``sgp_tpu/native``) bit for bit, and the port's ``coalesce`` and
``k_hop_subgraph`` give the JAX functions' results on both sides of the
100,000-edge threshold where the JAX functions hand the work to that core
(the port's ``coalesce`` there too, its ``k_hop_subgraph`` at every
size)."""
import numpy as np
import pytest

import sgp_tpu.graph as jg
from sgp_tpu import native as jnative

import sgp_tpu_torch.graph as tg
from sgp_tpu_torch import native
from sgp_tpu_torch.graph.sparse import NATIVE_MIN_EDGES


@pytest.fixture(autouse=True, scope="module")
def _jax_core_built():
    # the reference route: without its library the JAX functions take
    # numpy, and the comparisons below would hold the wrong route
    assert jnative.AVAILABLE, "sgp_tpu.native did not build"


def _edges(seed, n, e):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e), rng.integers(0, n, e),
            rng.random(e).astype(np.float32))


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 42])
def test_coalesce_edges_matches_jax_core(seed):
    n, e = 400, 150_000   # ~940 draws an edge slot: triplicates abound
    src, dst, w = _edges(seed, n, e)
    key = dst * n + src
    assert np.bincount(key).max() >= 3
    _same(native.coalesce_edges(src, dst, w, n),
          jnative.coalesce_edges(src, dst, w, n))


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_khop_mask_matches_jax_core(seed, k):
    n, e = 3000, 6000
    src, dst, w = _edges(seed, n, e)
    rows = tg.adjacency_rows(tg.Graph(src, dst, w, n))
    roots = np.random.default_rng(seed + 1).permutation(n)[:20]
    got = native.khop_mask(rows.indptr, rows.indices, n, roots, k)
    np.testing.assert_array_equal(
        got, jnative.khop_mask(src, dst, n, roots, k))


@pytest.mark.parametrize("seed", [0, 42])
def test_csr_spmm_matches_jax_core(seed):
    n, e, f = 500, 8000, 33
    src, dst, w = _edges(seed, n, e)
    mat = tg.coalesce(tg.Graph(src, dst, w, n)).to_scipy()
    x = np.random.default_rng(seed + 1).standard_normal(
        (n, f)).astype(np.float32)
    got = native.csr_spmm(mat.indptr, mat.indices, mat.data, x)
    np.testing.assert_array_equal(
        got, jnative.csr_spmm(mat.indptr, mat.indices, mat.data, x))


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("m", [1, 500, 20_000])
def test_sample_edges_uniform_matches_jax_core(seed, m):
    got = native.sample_edges_uniform(10_000, m, seed)
    np.testing.assert_array_equal(
        got, jnative.sample_edges_uniform(10_000, m, seed))
    assert len(np.unique(got)) == len(got) == min(m, 10_000)


def test_coalesce_pins_the_native_route():
    """The repaired fault: at 200,000 edges on 300 nodes the JAX function
    sums duplicates in ``std::sort``'s order, numpy's stable argsort in
    another (7,895 weights differed in their last bits)."""
    src, dst, w = _edges(0, 300, 200_000)
    ref = jg.coalesce(jg.Graph(src, dst, w, 300))
    got = tg.coalesce(tg.Graph(src, dst, w, 300))
    _same((got.src, got.dst, got.weight), (ref.src, ref.dst, ref.weight))


@pytest.mark.parametrize("e", [NATIVE_MIN_EDGES - 1, NATIVE_MIN_EDGES,
                               160_000])
@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_coalesce_matches_jax_at_the_threshold(e, reduce):
    src, dst, w = _edges(7, 350, e)
    ref = jg.coalesce(jg.Graph(src, dst, w, 350), reduce)
    got = tg.coalesce(tg.Graph(src, dst, w, 350), reduce)
    _same((got.src, got.dst, got.weight), (ref.src, ref.dst, ref.weight))


@pytest.mark.parametrize("e", [NATIVE_MIN_EDGES - 1, NATIVE_MIN_EDGES])
@pytest.mark.parametrize("flow", ["target_to_source", "source_to_target"])
def test_k_hop_subgraph_matches_jax_at_the_threshold(e, flow):
    n = 40_000   # sparse enough that two hops reach a part of the graph
    src, dst, w = _edges(3, n, e)
    roots = np.random.default_rng(4).permutation(n)[:64]
    ref = jg.k_hop_subgraph(jg.Graph(src, dst, w, n), roots, 2, flow)
    g = tg.Graph(src, dst, w, n)
    for rows in (None, tg.adjacency_rows(g, flow)):
        nodes, sub, pos = tg.k_hop_subgraph(g, roots, 2, flow, rows=rows)
        assert 0 < len(nodes) < n
        _same((nodes, sub.src, sub.dst, sub.weight, pos),
              (ref[0], ref[1].src, ref[1].dst, ref[1].weight, ref[2]))
        assert sub.num_nodes == ref[1].num_nodes


def test_khop_mask_checks_its_inputs():
    rows = tg.adjacency_rows(tg.Graph([0, 1], [1, 2], None, 3))
    with pytest.raises(ValueError, match="roots"):
        native.khop_mask(rows.indptr, rows.indices, 3, [3], 1)
    with pytest.raises(ValueError, match="indptr"):
        native.khop_mask(rows.indptr[:-1], rows.indices, 3, [0], 1)


def test_failed_build_raises(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    out = tmp_path / "broken.so"
    with pytest.raises(RuntimeError, match="g\\+\\+ broken.cpp failed") \
            as err:
        native.compile_library(bad, out)
    assert "error" in str(err.value)
    assert not out.exists()


def test_library_is_keyed_on_the_source(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a, b = tmp_path / "a" / "g.cpp", tmp_path / "b" / "g.cpp"
    a.write_text("int x;\n")
    b.write_text("int y;\n")
    assert native.lib_path(a) != native.lib_path(b)
    assert native.lib_path(a) == native.lib_path(a)
    assert native.lib_path().parent == native.BUILD_DIR
