"""The BSR SpMM CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA device and ``nvcc``; they skip elsewhere. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernel_cuda.py

Tolerances: f32 tiles 1e-5 of the largest value (order of summation);
bf16 tiles 1e-2 (both round the output to bf16; one ulp is 2^-8).
"""
import numpy as np
import pytest
import torch

from sgp_tpu_torch.graph import Graph, coalesce, normalize_adj
from sgp_tpu_torch.ops import bsr_spmm, bsr_spmm_plain, build_operator

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
