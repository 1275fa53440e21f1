"""The port's block-sparse attention (``sgp_tpu_torch/ops/sddmm.py``), its
edge-list twin (``ops/functional.py``) and the segment ops
(``ops/scatter.py``) against the JAX package's, on the CPU.

Inputs come from a numpy seed and go to both sides. The graphs have N not a
multiple of 128, zero-weight edges and a block row with no stored block.
On the CPU the port runs K2's plain version; the JAX side runs
``variant="xla"`` and, through the Pallas interpreter, ``variant="pallas"``.

Tolerances: f32 1e-5 of each output's largest value (the same f32 products
summed in another order); bf16 inputs 2e-2 (both sides multiply bf16 values
exactly in f32, so only the summation order differs; the bound leaves room
for one bf16 ulp of an input); block against edge-list attention 1e-4
absolute, the JAX test's own (``tests/test_sddmm.py``); gradients 1e-5 of
each gradient's largest value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.graph.sparse import Graph as JGraph
from sgp_tpu.ops import functional as jfunc
from sgp_tpu.ops import scatter as jscatter
from sgp_tpu.ops import sddmm as jsddmm

from sgp_tpu_torch.graph import Graph, coalesce
from sgp_tpu_torch.ops import functional as tfunc
from sgp_tpu_torch.ops import scatter as tscatter
from sgp_tpu_torch.ops import sddmm as tsddmm

torch.set_num_threads(1)


def _graph(seed=0, n=300, e=2500, empty_block_row=True):
    """A coalesced random graph with some zero weights; with
    ``empty_block_row`` no edge ends in nodes 128..255 (block row 1)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    if empty_block_row:
        dst = np.where((dst >= 128) & (dst < 256), dst % 128, dst)
    w = rng.standard_normal(e).astype(np.float32)
    w[::7] = 0.0
    return coalesce(Graph(src, dst, w, n))


def _jgraph(g):
    return JGraph(g.src, g.dst, g.weight, g.num_nodes)


def _structs(g):
    return (jsddmm.bsr_attention_structure(_jgraph(g)),
            tsddmm.bsr_attention_structure(g, device="cpu"))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n,empty", [(300, True), (130, False)])
def test_structure_is_bit_equal(n, empty):
    g = _graph(n=n, e=8 * n, empty_block_row=empty)
    js, ts = _structs(g)
    assert (ts.n_block_rows, ts.num_nodes) == (js.n_block_rows, js.num_nodes)
    assert np.array_equal(ts.block_rows.numpy(), np.asarray(js.block_rows))
    assert np.array_equal(ts.block_cols.numpy(), np.asarray(js.block_cols))
    assert np.array_equal(ts.mask_blocks.numpy(), np.asarray(js.mask_blocks))
    assert ts.block_rows.dtype == ts.block_cols.dtype == ts.row_ptr.dtype \
        == torch.int32
    assert np.array_equal(np.diff(ts.row_ptr.numpy()),
                          np.bincount(ts.block_rows.numpy(),
                                      minlength=ts.n_block_rows))
    # zero-weight edges stay attendable
    zero = g.weight == 0
    assert zero.any()
    rows, cols = g.dst[zero], g.src[zero]
    br, bc = ts.block_rows.numpy(), ts.block_cols.numpy()
    for r, c in zip(rows, cols):
        blk = np.flatnonzero((br == r // 128) & (bc == c // 128))
        assert len(blk) == 1 and ts.mask_blocks[blk[0], r % 128, c % 128]


@pytest.mark.parametrize("variant", ["xla", "pallas"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_bsr_sddmm_matches_jax(variant, dtype, tol):
    g = _graph()
    js, ts = _structs(g)
    rng = np.random.default_rng(1)
    d = 40                                   # not a multiple of 128
    q, k = _normal(rng, (g.num_nodes, d)), _normal(rng, (g.num_nodes, d))
    want = np.asarray(jsddmm.bsr_sddmm(jnp.asarray(q, dtype),
                                       jnp.asarray(k, dtype), js,
                                       variant=variant))
    tdt = getattr(torch, dtype)
    got = tsddmm.bsr_sddmm(torch.as_tensor(q).to(tdt),
                           torch.as_tensor(k).to(tdt), ts)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= tol
    # rows and columns past N are exactly 0
    pad, last = g.num_nodes % 128, ts.n_block_rows - 1
    assert not got[ts.block_rows == last, pad:].any()
    assert not got[ts.block_cols == last][:, :, pad:].any()


def test_bsr_sddmm_strided_head_view():
    """``q[:, h]`` of ``[N, H, D]`` (a row stride of H*D) gives the same
    scores as its contiguous copy."""
    g = _graph(seed=2)
    _, ts = _structs(g)
    rng = np.random.default_rng(2)
    q = torch.as_tensor(_normal(rng, (g.num_nodes, 3, 16)))
    k = torch.as_tensor(_normal(rng, (g.num_nodes, 3, 16)))
    got = tsddmm.bsr_sddmm(q[:, 1], k[:, 1], ts)
    want = tsddmm.bsr_sddmm(q[:, 1].contiguous(), k[:, 1].contiguous(), ts)
    assert torch.equal(got, want)


def test_bsr_masked_softmax_matches_jax():
    g = _graph(seed=3)
    js, ts = _structs(g)
    rng = np.random.default_rng(3)
    logits = _normal(rng, (ts.block_rows.numel(), 128, 128))
    want = np.asarray(jsddmm.bsr_masked_softmax(jnp.asarray(logits), js))
    got = tsddmm.bsr_masked_softmax(torch.as_tensor(logits), ts)
    assert _rel(got.numpy(), want) <= 1e-5
    assert not got[~ts.mask_blocks].any()


@pytest.mark.parametrize("h,d,scale", [(2, 8, None), (3, 16, 0.3),
                                       (1, 40, None)])
def test_bsr_multi_head_attention_matches_jax(h, d, scale):
    g = _graph(seed=4, n=200, e=1500)
    js, ts = _structs(g)
    rng = np.random.default_rng(4)
    q, k, v = (_normal(rng, (g.num_nodes, h, d)) for _ in range(3))
    want = np.asarray(jsddmm.bsr_multi_head_attention(
        *map(jnp.asarray, (q, k, v)), js, scale=scale))
    edge = np.asarray(jfunc.sparse_multi_head_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(g.src), jnp.asarray(g.dst),
        g.num_nodes, scale=scale))
    got = tsddmm.bsr_multi_head_attention(
        *map(torch.as_tensor, (q, k, v)), ts, scale=scale).numpy()
    t_edge = tfunc.sparse_multi_head_attention(
        *map(torch.as_tensor, (q, k, v)), torch.as_tensor(g.src),
        torch.as_tensor(g.dst), g.num_nodes, scale=scale).numpy()
    assert got.shape == (g.num_nodes, h, d)
    assert _rel(got, want) <= 1e-5
    np.testing.assert_allclose(got, edge, atol=1e-4)
    np.testing.assert_allclose(t_edge, edge, atol=1e-5)
    np.testing.assert_allclose(got, t_edge, atol=1e-4)


def test_empty_structure_gives_zeros():
    g = Graph(np.zeros(0, np.int32), np.zeros(0, np.int32), None, 150)
    js, ts = _structs(g)
    assert ts.block_rows.numel() == 0
    q = np.ones((150, 1, 8), np.float32)
    want = np.asarray(jsddmm.bsr_multi_head_attention(
        *(jnp.asarray(q),) * 3, js))
    got = tsddmm.bsr_multi_head_attention(*(torch.as_tensor(q),) * 3, ts)
    assert got.shape == want.shape and not got.any() and not want.any()


def test_bsr_sddmm_backward_matches_jax_grad():
    """dQ and dK of ``<dS, SDDMM(q, k)>`` against ``jax.grad`` through
    ``bsr_sddmm_xla``."""
    g = _graph(seed=5)
    js, ts = _structs(g)
    rng = np.random.default_rng(5)
    q, k = _normal(rng, (g.num_nodes, 40)), _normal(rng, (g.num_nodes, 40))
    ds = _normal(rng, (ts.block_rows.numel(), 128, 128))

    def f(qq, kk):
        return (jsddmm.bsr_sddmm_xla(qq, kk, js.block_rows, js.block_cols,
                                     js.n_block_rows) * ds).sum()
    jq, jk = jax.grad(f, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    tq, tk = (torch.tensor(a, requires_grad=True) for a in (q, k))
    (tsddmm.bsr_sddmm(tq, tk, ts) * torch.as_tensor(ds)).sum().backward()
    assert _rel(tq.grad.numpy(), jq) <= 1e-5
    assert _rel(tk.grad.numpy(), jk) <= 1e-5


def test_bsr_multi_head_attention_backward_matches_jax_grad():
    """Gradients of the whole op (SDDMM, masked softmax, block SpMM) in q,
    k and v against ``jax.grad`` of the JAX op."""
    g = _graph(seed=6, n=200, e=1500)
    js, ts = _structs(g)
    rng = np.random.default_rng(6)
    q, k, v, w = (_normal(rng, (g.num_nodes, 2, 8)) for _ in range(4))

    def f(qq, kk, vv):
        return (jsddmm.bsr_multi_head_attention(qq, kk, vv, js) * w).sum()
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (tsddmm.bsr_multi_head_attention(tq, tk, tv, ts)
     * torch.as_tensor(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)])
def test_bsr_sddmm_backward_is_two_block_spmms(monkeypatch, needs):
    """The SDDMM's backward runs the block SpMM's route (K1 on the card,
    its plain version here) once for each gradient asked for: ``dQ`` over
    the structure, ``dK`` over its transpose; no ``index_add_`` of its
    own."""
    from sgp_tpu_torch.ops import bsr_kernel
    g = _graph(seed=7)
    ts = tsddmm.bsr_attention_structure(g, device="cpu")
    rng = np.random.default_rng(7)
    q, k = (torch.tensor(_normal(rng, (g.num_nodes, 24)),
                         requires_grad=r) for r in needs)
    ds = torch.as_tensor(_normal(rng, (ts.block_rows.numel(), 128, 128)))
    calls = []

    def counted(blocks, block_cols, row_ptr, block_rows, x):
        calls.append(torch.equal(row_ptr, ts.row_ptr))
        return bsr_kernel._spmm(blocks, block_cols, row_ptr, block_rows, x)
    monkeypatch.setattr(tsddmm, "_spmm", counted)
    grads = torch.autograd.grad((tsddmm.bsr_sddmm(q, k, ts) * ds).sum(),
                                [t for t in (q, k) if t.requires_grad])
    assert len(calls) == sum(needs) == len(grads)
    # dQ walks the structure's row_ptr, dK the transpose's
    assert calls == [True] * needs[0] + [False] * needs[1]


@pytest.mark.parametrize("shape,view,dtype,copied", [
    ((700, 3, 5), 1, torch.float32, True),      # rows 60 bytes apart
    ((700, 1), None, torch.float32, True),      # D = 1: 4 bytes
    ((700, 4, 16), 2, torch.float32, False),    # 256-byte rows, 128 in
    ((700, 40), None, torch.bfloat16, False),   # 80-byte rows
    ((700, 3), None, torch.bfloat16, True),     # 6-byte rows
])
def test_aligned_rows_pads_only_unaligned_rows(shape, view, dtype, copied):
    """K2's copies read rows from 16-byte boundaries: the wrapper keeps an
    aligned [N, D] as it is and pads the others' rows with zero columns to
    16 bytes, the same values at the same width."""
    x = torch.as_tensor(_normal(np.random.default_rng(8), shape)).to(dtype)
    x = x[:, view] if view is not None else x
    got = tsddmm._aligned_rows(x)
    assert got.shape == x.shape and torch.equal(got, x)
    assert (got.data_ptr() != x.data_ptr()) == copied
    assert got.data_ptr() % 16 == 0
    assert got.stride(0) * got.element_size() % 16 == 0
    assert got.stride(1) == 1


@pytest.mark.parametrize("name", ["segment_sum", "segment_mean",
                                  "segment_softmax"])
@pytest.mark.parametrize("shape", [(60,), (60, 3)])
def test_segment_ops_match_jax(name, shape):
    rng = np.random.default_rng(7)
    data = _normal(rng, shape)
    ids = rng.integers(0, 12, shape[0])
    ids[ids == 5] = 4                        # segment 5 stays empty
    want = np.asarray(getattr(jscatter, name)(jnp.asarray(data),
                                              jnp.asarray(ids), 12))
    got = getattr(tscatter, name)(torch.as_tensor(data), torch.as_tensor(ids),
                                  12).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-6


def test_functional_ops_match_jax():
    rng = np.random.default_rng(8)
    a, b = _normal(rng, (3, 1, 5, 2)), _normal(rng, (4, 1, 3))
    want = np.asarray(jfunc.expand_then_cat([jnp.asarray(a), jnp.asarray(b)]))
    got = tfunc.expand_then_cat([torch.as_tensor(a), torch.as_tensor(b)])
    assert np.array_equal(got.numpy(), want)
    x = _normal(rng, (2, 6, 8))
    for axis in (-1, 1):
        np.testing.assert_allclose(
            tfunc.gated_tanh(torch.as_tensor(x), axis).numpy(),
            np.asarray(jfunc.gated_tanh(jnp.asarray(x), axis)), rtol=1e-6,
            atol=1e-7)
        assert np.array_equal(
            tfunc.reverse_tensor(torch.as_tensor(x), axis).numpy(),
            np.asarray(jfunc.reverse_tensor(jnp.asarray(x), axis)))
    scores, idx = _normal(rng, (50, 2)), rng.integers(0, 9, 50)
    np.testing.assert_allclose(
        tfunc.sparse_softmax(torch.as_tensor(scores), torch.as_tensor(idx),
                             9).numpy(),
        np.asarray(jfunc.sparse_softmax(jnp.asarray(scores),
                                        jnp.asarray(idx), 9)),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("scale", [None, 0.0, 0.5])
def test_sparse_multi_head_attention_matches_jax(scale):
    """The edge-list op, with its ``scale or d ** -0.5`` (0 falls back)."""
    g = _graph(seed=9, n=90, e=700, empty_block_row=False)
    rng = np.random.default_rng(9)
    q, k, v = (_normal(rng, (g.num_nodes, 2, 8)) for _ in range(3))
    want = np.asarray(jfunc.sparse_multi_head_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(g.src), jnp.asarray(g.dst),
        g.num_nodes, scale=scale))
    got = tfunc.sparse_multi_head_attention(
        *map(torch.as_tensor, (q, k, v)), torch.as_tensor(g.src),
        torch.as_tensor(g.dst), g.num_nodes, scale=scale).numpy()
    assert _rel(got, want) <= 1e-5
