"""The forecaster export and K1's custom op, on the CPU.

- ``export_forecaster`` / ``load_forecaster``: the loaded artifact steps
  like the port's live ``OnlineForecaster`` (the same bits on the CPU) and
  like the JAX package's live forecaster (1e-5 of the largest forecast, as
  ``tests/test_torch_port_serve.py`` holds the live ones), on dense and BSR
  operators (the port's through K1's plain version, the JAX ones through
  the Pallas kernel, interpreted), with 1 and S streams, with exogenous
  input (and the ``ValueError`` without ``example_u``), and for
  ``OnlineGESNForecaster``; as ``tests/test_serve.py`` holds the JAX
  artifacts.
- ``sgp::bsr_spmm`` passes ``torch.library.opcheck`` (schema, autograd
  registration, fake tensors, AOT dispatch with gradients), and its
  gradients equal autograd's through the plain version.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_serve import EXOG, N, C, _gesn_setup, _setup

import sgp_tpu_torch.graph as tg
from sgp_tpu_torch.ops import bsr_spmm, build_operator
from sgp_tpu_torch.ops.bsr_kernel import bsr_spmm_plain
from sgp_tpu_torch.serve import (OnlineGESNForecaster, export_forecaster,
                                 load_forecaster)
from sgp_tpu.serve import OnlineGESNForecaster as JGESNForecaster

torch.set_num_threads(1)

TOL = 1e-5
T_STEP = 5


def _stream(rng, lead, t=T_STEP):
    return (rng.standard_normal((t,) + lead + (N, C)) * 3 + 1
            ).astype(np.float32)


CASES = [("bsr", None, False), ("bsr", 3, False), ("dense", None, False),
         ("dense", 2, True), ("bsr", None, True)]


@pytest.mark.parametrize("mode,n_streams,with_u", CASES)
def test_exported_forecaster_matches_live(rng, tmp_path, mode, n_streams,
                                          with_u):
    jfc, tfc = _setup(rng, mode, n_streams, None, with_u)
    lead = () if n_streams is None else (n_streams,)
    path = str(tmp_path / "fc.pt2")
    if with_u:
        with pytest.raises(ValueError, match="exog"):
            export_forecaster(tfc, path)
    size = export_forecaster(
        tfc, path, example_u=np.zeros(lead + (EXOG,), np.float32)
        if with_u else None)
    assert size > 0
    loaded = load_forecaster(path)
    assert loaded.input_shape == lead + (N, C)
    assert loaded.u_shape == ((lead + (EXOG,)) if with_u else None)
    if with_u:
        with pytest.raises(ValueError, match="exogenous"):
            loaded.step(_stream(rng, lead, 1)[0])   # u required, missing
    # the operators and weights are buffers and parameters, not constants
    program = torch.export.load(path)
    assert not program.constants
    assert len(program.state_dict) > 4
    obs = _stream(rng, lead)
    u = rng.standard_normal((T_STEP,) + lead + (EXOG,)).astype(np.float32)
    for t in range(T_STEP):
        ut = u[t] if with_u else None
        live = tfc.step(obs[t], None if ut is None else torch.as_tensor(ut))
        got = loaded.step(obs[t], ut)
        ref = np.asarray(jfc.step(obs[t], None if ut is None
                                  else jnp.asarray(ut)))
        assert got.shape == live.shape == ref.shape
        torch.testing.assert_close(got, live, rtol=0, atol=0)
        assert np.abs(got.numpy() - ref).max() <= TOL * np.abs(ref).max(), t
    loaded.reset()
    assert not any(h.any() for h in loaded.state)


@pytest.mark.parametrize("mode,n_streams", [("bsr", None), ("dense", None),
                                            ("bsr", 3)])
def test_exported_gesn_forecaster_matches_live(rng, tmp_path, mode,
                                               n_streams):
    (je, jgr, jsc), (te, tgr, tsc), readouts = _gesn_setup(rng, mode)
    jfc = JGESNForecaster(je, jgr, readouts, jsc, n_streams=n_streams)
    tfc = OnlineGESNForecaster(te, tgr, readouts, tsc, n_streams=n_streams,
                               device="cpu")
    path = str(tmp_path / "gesn.pt2")
    with pytest.raises(ValueError, match="exogenous"):
        export_forecaster(tfc, path, example_u=np.zeros(2, np.float32))
    export_forecaster(tfc, path)
    loaded = load_forecaster(path)
    lead = () if n_streams is None else (n_streams,)
    assert loaded.input_shape == lead + (N, C)
    obs = _stream(rng, lead)
    for t in range(T_STEP):
        live, got = tfc.step(obs[t]), loaded.step(obs[t])
        ref = np.asarray(jfc.step(obs[t]))
        torch.testing.assert_close(got, live, rtol=0, atol=0)
        assert np.abs(got.numpy() - ref).max() <= TOL * np.abs(ref).max(), t


def test_artifact_metadata_and_atomic_write(rng, tmp_path):
    """One file, written through ``.tmp``; the shapes in its extra file."""
    _, tfc = _setup(rng, "dense", 2, None, False)
    path = tmp_path / "sub" / "fc.pt2"
    size = export_forecaster(tfc, str(path))
    assert path.stat().st_size == size
    assert sorted(p.name for p in path.parent.iterdir()) == ["fc.pt2"]
    extra = {"sgp_forecaster.json": ""}
    torch.export.load(str(path), extra_files=extra)
    meta = json.loads(extra["sgp_forecaster.json"])
    assert meta["input_shape"] == [2, N, C] and meta["u_shape"] is None
    assert meta["state_shapes"] == [list(h.shape) for h in tfc.state]
    assert meta["device"] == "cpu"


# -- the custom op ----------------------------------------------------------

def _bsr(rng, n=300, edges=2500, f=12):
    g = tg.coalesce(tg.Graph(rng.integers(0, n, edges),
                             rng.integers(0, n, edges),
                             rng.random(edges).astype(np.float32), n))
    op = build_operator(g, "bsr", device="cpu")
    x = torch.as_tensor(rng.standard_normal((n, f)).astype(np.float32))
    return op, x


@pytest.mark.parametrize("grads", [(True, True), (False, True),
                                   (False, False)])
def test_opcheck_bsr_spmm(rng, grads):
    op, x = _bsr(rng)
    blocks = op.blocks.clone().requires_grad_(grads[0])
    x = x.requires_grad_(grads[1])
    torch.library.opcheck(torch.ops.sgp.bsr_spmm.default,
                          (blocks, op.block_cols, op.row_ptr, op.block_rows,
                           x))


def test_opcheck_bsr_spmm_bf16(rng):
    op, x = _bsr(rng)
    torch.library.opcheck(torch.ops.sgp.bsr_spmm.default,
                          (op.blocks.bfloat16(), op.block_cols, op.row_ptr,
                           op.block_rows, x))


@pytest.mark.parametrize("n,f", [(300, 12), (260, 1), (129, 40)])
def test_op_gradients_match_plain(rng, n, f):
    """The op's backward (the transposed structure's SpMM and the SDDMM)
    against autograd through the plain version's gather, bmm and
    ``index_add_``."""
    op, x = _bsr(rng, n, 8 * n, f)
    w = torch.as_tensor(rng.standard_normal((n, f)).astype(np.float32))
    nbr = op.row_ptr.numel() - 1

    def grads(fn):
        blocks = op.blocks.clone().requires_grad_()
        xg = x.clone().requires_grad_()
        (fn(blocks, xg) * w).sum().backward()
        return blocks.grad, xg.grad

    got = grads(lambda b, xg: bsr_spmm(b, op.block_cols, op.row_ptr,
                                       op.block_rows, xg))
    want = grads(lambda b, xg: bsr_spmm_plain(b, op.block_cols,
                                              op.block_rows, nbr, xg))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
