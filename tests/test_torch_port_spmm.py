"""Propagation operators of the PyTorch port against the JAX package.

The BSR plain version (what a CPU tensor runs) is held against JAX's
``bsr_spmm_prepared`` with the Pallas kernel in interpret mode, and
against ``bsr_spmm_xla``. Tolerances: f32 tiles 1e-5 (order of
summation); bf16 tiles against the Pallas kernel 1e-2 relative (both
round the output to bf16, so a different f32 sum order can flip one bf16
ulp, 2^-8); bf16 tiles against ``bsr_spmm_xla``, which does not round its
output, the same bf16-level 1e-2. Gradients against ``jax.grad`` through
the JAX operator (``bsr_spmm_xla``) at the same tolerances: f32 the same
sums in another order; bf16 the forward's output rounding and JAX's bf16
intermediates, each within a bf16 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgp_tpu.graph as jg
from sgp_tpu.ops import build_operator as j_build_operator
from sgp_tpu.ops.bsr_kernel import (bsr_spmm_prepared, bsr_spmm_xla,
                                    prepare_bsr as j_prepare_bsr)
from sgp_tpu.ops.spmm import BSROperator as JBSROperator
from sgp_tpu.ops.spmm import GlobalMeanOperator as JGlobalMean

import sgp_tpu_torch.graph as tg
from sgp_tpu_torch.ops import (BSROperator, GlobalMeanOperator, bsr_spmm,
                               bsr_spmm_plain, build_operator)
from sgp_tpu_torch.ops.bsr_kernel import kept_transpose

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _graphs(rng, n, e, n_active=None):
    """A coalesced, row-normalized random graph in both packages; edges
    only among the first ``n_active`` nodes leave later block rows
    empty."""
    m = n_active or n
    src, dst = rng.integers(0, m, e), rng.integers(0, m, e)
    w = rng.random(e).astype(np.float32)
    return (jg.normalize_adj(jg.coalesce(jg.Graph(src, dst, w, n))),
            tg.normalize_adj(tg.coalesce(tg.Graph(src, dst, w, n))))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


CASES = [  # (n, edges, active nodes, F): ragged N and F, empty block rows
    (300, 3000, None, 96),
    (257, 2000, None, 130),
    (400, 500, 100, 32),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,e,active,f", CASES)
def test_bsr_plain_matches_jax(rng, n, e, active, f, dtype):
    jgr, tgr = _graphs(rng, n, e, active)
    x = rng.standard_normal((n, f)).astype(np.float32)
    blocks, cols, ptr = jgr.to_bsr(128)
    jb, jc, jp = j_prepare_bsr(blocks, cols, ptr, getattr(jnp, dtype))
    n_br = len(ptr) - 1
    rows = np.repeat(np.arange(n_br, dtype=np.int32), np.diff(ptr))
    pallas = bsr_spmm_prepared(jnp.asarray(jb), jnp.asarray(jc),
                               jnp.asarray(jp), jnp.asarray(x), n, n_br)
    xla = bsr_spmm_xla(jnp.asarray(jb), jnp.asarray(jc), jnp.asarray(rows),
                       jnp.asarray(x), n, n_br)

    op = build_operator(tgr, "bsr",
                        precision="default" if dtype == "bfloat16"
                        else "highest")
    assert op.blocks.dtype == getattr(torch, dtype)
    got = bsr_spmm_plain(op.blocks, op.block_cols, op.block_rows, n_br,
                         torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == (n, f)
    assert _rel(got, pallas) <= TOL[dtype]
    assert _rel(got, xla) <= TOL[dtype]
    # the entry takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        (op @ torch.as_tensor(x)).numpy(), got.numpy())
    if dtype == "float32":
        assert _rel(got, jgr.to_dense() @ x) <= TOL[dtype]


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bsr_operator_leading_axes_match_jax_pallas(rng, lead, dtype):
    """``[..., N, F]`` inputs fold into one ``[N, prod(lead) * F]``
    product; JAX's operator vmaps the Pallas kernel over them."""
    n, f = 200, 24
    jgr, tgr = _graphs(rng, n, 1500)
    x = rng.standard_normal(lead + (n, f)).astype(np.float32)
    prec = "default" if dtype == "bfloat16" else "highest"
    jop = j_build_operator(jgr, "bsr", precision=prec)
    jop._variant = "pallas"
    ref = np.asarray(jop @ jnp.asarray(x))
    got = build_operator(tgr, "bsr", precision=prec) @ torch.as_tensor(x)
    assert got.shape == x.shape
    assert _rel(got, ref) <= TOL[dtype]


@pytest.mark.parametrize("mode", ["dense", "coo", "auto"])
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_dense_and_coo_operators_match_jax(rng, mode, lead):
    n, f = 50, 8
    jgr, tgr = _graphs(rng, n, 300)
    x = rng.standard_normal(lead + (n, f)).astype(np.float32)
    ref = np.asarray(j_build_operator(jgr, mode) @ jnp.asarray(x))
    op = build_operator(tgr, mode)
    assert type(op).__name__ == type(j_build_operator(jgr, mode)).__name__
    np.testing.assert_allclose((op @ torch.as_tensor(x)).numpy(), ref,
                               rtol=1e-5, atol=1e-6)


def test_dense_operator_transpose_and_global_mean(rng):
    n = 30
    jgr, tgr = _graphs(rng, n, 120)
    x = rng.standard_normal((4, n, 3)).astype(np.float32)
    np.testing.assert_allclose(
        (build_operator(tgr, "dense").transpose() @ torch.as_tensor(x)
         ).numpy(),
        np.asarray(j_build_operator(jgr, "dense").transpose()
                   @ jnp.asarray(x)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        (GlobalMeanOperator(n) @ torch.as_tensor(x)).numpy(),
        np.asarray(JGlobalMean(n) @ jnp.asarray(x)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bsr_gradients_match_jax(rng, lead, dtype):
    """The gradients of ``sum((A @ x)^2)`` with respect to x and to the
    tiles, from the port's autograd Function (the transposed block SpMM
    and the SDDMM, plain versions on the CPU), against ``jax.grad`` of the
    JAX ``BSROperator``; ragged N and an empty block row."""
    n, f = 300, 20
    jgr, tgr = _graphs(rng, n, 2500, n_active=200)
    x = rng.standard_normal(lead + (n, f)).astype(np.float32)
    prec = "default" if dtype == "bfloat16" else "highest"
    jop = j_build_operator(jgr, "bsr", precision=prec)
    n_br = int(jop.row_ptr.shape[0]) - 1

    def loss(blocks, xj):
        op = JBSROperator(blocks, jop.block_cols, jop.row_ptr,
                          jop.block_rows, n, n_br)
        return jnp.sum((op @ xj) ** 2)

    want_b, want_x = jax.grad(loss, argnums=(0, 1))(jop.blocks,
                                                    jnp.asarray(x))
    op = build_operator(tgr, "bsr", precision=prec)
    tiles = op.blocks.clone().requires_grad_()
    trainable = BSROperator(tiles, op.block_cols, op.row_ptr, op.block_rows,
                            n)
    xt = torch.tensor(x, requires_grad=True)
    (trainable @ xt).square().sum().backward()
    assert tiles.grad.dtype == tiles.dtype and xt.grad.dtype == xt.dtype
    assert _rel(xt.grad, want_x) <= TOL[dtype]
    assert _rel(tiles.grad.float(), np.asarray(want_b, np.float32)) \
        <= TOL[dtype]
    kept = kept_transpose(op.block_cols)        # shared by both operators
    assert kept._tiles is None                  # trainable: not kept
    # constant tiles: the transposed tiles are built once and kept
    x2 = torch.tensor(x, requires_grad=True)
    (op @ x2).square().sum().backward()
    tiles_t = kept._tiles
    assert tiles_t is not None and tiles_t.dtype == torch.float32
    x3 = torch.tensor(x, requires_grad=True)
    (op @ x3).square().sum().backward()
    assert kept._tiles is tiles_t
    np.testing.assert_array_equal(x3.grad.numpy(), x2.grad.numpy())
    np.testing.assert_array_equal(x2.grad.numpy(), xt.grad.numpy())


def test_kernel_launch_count_stays_zero_on_cpu(rng):
    _, tgr = _graphs(rng, 260, 2000)
    before = bsr_spmm.launches
    op = build_operator(tgr, "bsr")
    op @ torch.as_tensor(rng.standard_normal((260, 16)).astype(np.float32))
    op @ torch.zeros(2, 260, 16)
    assert bsr_spmm.launches == before


def test_bsr_from_bsr_rejects_bad_indices(rng):
    _, tgr = _graphs(rng, 260, 2000)
    blocks, cols, ptr = tgr.to_bsr(128)
    bad_cols = cols.copy()
    bad_cols[0] = len(ptr) - 1
    with pytest.raises(ValueError):
        BSROperator.from_bsr(blocks, bad_cols, ptr, 260)
    with pytest.raises(ValueError):
        BSROperator.from_bsr(blocks, cols, ptr[::-1].copy(), 260)
    with pytest.raises(ValueError):
        BSROperator.from_bsr(blocks[:, :64], cols, ptr, 260)
