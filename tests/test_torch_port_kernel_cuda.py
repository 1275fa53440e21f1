"""The CUDA kernels (K1 BSR SpMM, K4 GatedGN ELL) against their plain
PyTorch versions, on the card.

These tests need a CUDA device and ``nvcc``; they skip elsewhere. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernel_cuda.py

Tolerances for K1: f32 tiles 1e-5 of the largest value (order of
summation); bf16 tiles 1e-2 (both round the output to bf16; one ulp is
2^-8). K4's are stated beside its tests.
"""
import numpy as np
import pytest
import torch

from sgp_tpu_torch.graph import Graph, coalesce, normalize_adj
from sgp_tpu_torch.ops import (bsr_spmm, bsr_spmm_plain, build_operator,
                               gn_ell)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _graph(rng, n, e, active=None):
    m = active or n
    return normalize_adj(coalesce(Graph(
        rng.integers(0, m, e), rng.integers(0, m, e),
        rng.random(e).astype(np.float32), n)))


@pytest.mark.parametrize("precision,tol", [("highest", 1e-5),
                                           ("default", 1e-2)])
@pytest.mark.parametrize("n,e,active,lead,f", [
    (1000, 20000, None, (), 128),      # ragged N
    (1000, 6000, 300, (), 200),        # empty block rows, ragged F
    (515, 8000, None, (3,), 40),       # leading axis folded into F
    (128, 500, None, (), 1),           # one block, one column
])
def test_kernel_matches_plain(cuda, precision, tol, n, e, active, lead, f):
    rng = np.random.default_rng(0)
    op = build_operator(_graph(rng, n, e, active), "bsr",
                        precision=precision, device=cuda)
    x = torch.as_tensor(rng.standard_normal(lead + (n, f)).astype(
        np.float32), device=cuda)
    before = bsr_spmm.launches
    got = op @ x
    torch.cuda.synchronize()
    assert bsr_spmm.launches == before + 1
    n_br = op.row_ptr.numel() - 1
    folded = x.reshape(-1, n, f).transpose(0, 1).reshape(n, -1)
    ref = bsr_spmm_plain(op.blocks, op.block_cols, op.block_rows, n_br,
                         folded).reshape(n, -1, f).transpose(0, 1
                                                             ).reshape(x.shape)
    assert got.shape == x.shape and got.dtype == x.dtype
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    assert err <= tol


def test_kernel_wrapper_rejects_bad_inputs(cuda):
    rng = np.random.default_rng(1)
    op = build_operator(_graph(rng, 300, 3000), "bsr", device=cuda)
    x = torch.zeros(300, 8, device=cuda)
    with pytest.raises(ValueError):        # int64 block columns
        bsr_spmm(op.blocks, op.block_cols.long(), op.row_ptr,
                 op.block_rows, x)
    with pytest.raises(ValueError):        # blocks on another device
        bsr_spmm(op.blocks.cpu(), op.block_cols, op.row_ptr,
                 op.block_rows, x)
    with pytest.raises(ValueError):        # more rows than block rows hold
        bsr_spmm(op.blocks, op.block_cols, op.row_ptr, op.block_rows,
                 torch.zeros(400, 8, device=cuda))


# -- K4: the GatedGN ELL kernel, forward and backward ----------------------
# Tolerances, relative to the plain version's largest value: f32 2e-5
# (the same f32 products summed in another order, over up to 100 slots);
# bf16 inputs 2e-2 (both round t and dmt to bf16, so one input rounded the
# other way moves a result by a bf16 ulp, 2^-8).

def _ell_inputs(rng, b, n, d, h2, h, dtype, cuda, empty_row=None):
    mk = lambda *s, sc=1.0: torch.as_tensor(
        (rng.standard_normal(s) * sc).astype(np.float32), device=cuda)
    nmask = torch.as_tensor(rng.random((n, d)) < 0.9, device=cuda)
    if empty_row is not None:
        nmask[empty_row] = False
    return (mk(b, n, h2).to(dtype), mk(b, n, d, h2).to(dtype), nmask,
            mk(h2, h, sc=0.3), mk(h, sc=0.1), mk(h, 1, sc=0.3),
            mk(1, sc=0.1))


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    return (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


@pytest.mark.parametrize("activation", ["silu", "tanh", "relu", "elu"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,n,d,h2,h", [
    (2, 1000, 100, 32, 64),            # the slice's widths
    (3, 77, 7, 32, 64),                # ragged N, D = 7, one empty row
    (1, 50, 5, 5, 11),                 # narrow widths, zero-padded lanes
])
def test_gn_ell_kernel_matches_plain(cuda, activation, dtype, tol, b, n, d,
                                     h2, h):
    rng = np.random.default_rng(2)
    args = _ell_inputs(rng, b, n, d, h2, h, dtype, cuda, empty_row=n // 2)
    ghat = torch.as_tensor(rng.standard_normal((b, n, h)).astype(
        np.float32), device=cuda)
    f0, b0 = gn_ell.gn_ell_fwd.launches, gn_ell.gn_ell_bwd.launches
    out = gn_ell.gn_ell_fwd(*args, activation)
    grads = gn_ell.gn_ell_bwd(*args, ghat, activation)
    torch.cuda.synchronize()
    assert (gn_ell.gn_ell_fwd.launches, gn_ell.gn_ell_bwd.launches) == \
        (f0 + 1, b0 + 1)
    ref = gn_ell.gn_ell_fwd_plain(*args, activation)
    refg = gn_ell.gn_ell_bwd_plain(*args, ghat, activation)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert _rel(out, ref) <= tol
    assert not out[:, n // 2].any()
    for g, r, name in zip(grads, refg, ("dpi", "dpjn", "dw2", "db2", "dwg",
                                        "dbg")):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert torch.isfinite(g).all(), name
        assert _rel(g, r) <= tol, (name, _rel(g, r))


def test_gn_ell_backward_is_deterministic(cuda):
    rng = np.random.default_rng(3)
    args = _ell_inputs(rng, 2, 600, 30, 32, 64, torch.float32, cuda)
    ghat = torch.randn(2, 600, 64, device=cuda)
    first = gn_ell.gn_ell_bwd(*args, ghat)
    again = gn_ell.gn_ell_bwd(*args, ghat)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_gn_ell_wrapper_rejects_bad_inputs(cuda):
    rng = np.random.default_rng(4)
    args = list(_ell_inputs(rng, 1, 10, 3, 32, 64, torch.float32, cuda))
    with pytest.raises(ValueError):        # h above the kernel's 64
        wide = list(args)
        wide[3], wide[4], wide[5] = (torch.zeros(32, 80, device=cuda),
                                     torch.zeros(80, device=cuda),
                                     torch.zeros(80, 1, device=cuda))
        gn_ell.gn_ell_fwd(*wide)
    with pytest.raises(ValueError):        # weights on another device
        cpu = list(args)
        cpu[3] = cpu[3].cpu()
        gn_ell.gn_ell_fwd(*cpu)
