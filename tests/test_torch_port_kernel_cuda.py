"""The CUDA kernels (K1 BSR SpMM, K2 block-sampled SDDMM, K3 GatedGN
all-pairs, K4 GatedGN ELL) against their plain PyTorch versions, on the
card.

These tests need a CUDA device and ``nvcc``; they skip elsewhere. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernel_cuda.py

Tolerances for K1: f32 tiles 1e-5 of the largest value (order of
summation); bf16 tiles 1e-2 (both round the output to bf16; one ulp is
2^-8). K2's, K3's and K4's are stated beside their tests.
"""
import numpy as np
import pytest
import torch

from sgp_tpu_torch.graph import Graph, coalesce, normalize_adj
from sgp_tpu_torch.graph import band_windows
from sgp_tpu_torch.models import GatedGraphNetwork
from sgp_tpu_torch.ops import (BSROperator, bsr_spmm, bsr_spmm_plain,
                               build_operator, gn_allpairs, gn_ell, sddmm)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _no_tf32():
    """Every test starts with the package's matmul settings (no TF32 in
    matmuls or cuDNN) and must leave them so: a test that turned TF32 on
    fails here, and the next one starts with it off again."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    for f in flags:
        f.allow_tf32 = False
    yield
    left = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    assert not any(left), f"the test left TF32 on: {left}"


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
    (1000, 20000, None, (), 16),       # the attention path's widths (F = D)
    (1000, 6000, 300, (), 40),
    (700, 9000, None, (), 64),
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


def _skewed_operator(rng, dtype, cuda):
    """Block row 5 of 48 holds 40 tiles, rows 11 and 30 one each, the rest
    none; N = 6,100 leaves the last block row ragged."""
    n, n_br = 6100, 48
    counts = np.zeros(n_br, np.int64)
    counts[[5, 11, 30]] = (40, 1, 1)
    cols = np.concatenate([rng.choice(n_br, c, replace=False)
                           for c in counts]).astype(np.int32)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    blocks = rng.standard_normal((len(cols), 128, 128)).astype(np.float32)
    return BSROperator.from_bsr(blocks / 128, cols, ptr, n, dtype=dtype,
                                device=cuda)


@pytest.mark.parametrize("precision,tol", [("highest", 1e-5),
                                           ("default", 1e-2)])
@pytest.mark.parametrize("structure", ["skewed", "full"])
@pytest.mark.parametrize("f", [8, 24, 512])
def test_kernel_spreads_any_structure(cuda, precision, tol, structure, f):
    """K1's tiles spread over every SM whatever the rows hold: one block row
    with most tiles and the rest empty, or every block position stored (the
    SGP slice's shape at 1,000 nodes). Two calls give the same bits, and the
    f32 output's mean error stays within 1e-7 of its largest value (the
    tensor cores' truncation kept out of the block row's sum)."""
    rng = np.random.default_rng(14)
    dtype = torch.float32 if precision == "highest" else torch.bfloat16
    if structure == "skewed":
        op = _skewed_operator(rng, dtype, cuda)
    else:
        op = build_operator(_graph(rng, 1000, 60000), "bsr",
                            precision=precision, device=cuda)
        assert op.blocks.shape[0] == 64          # all 8 x 8 positions
    n = op.num_nodes
    x = torch.as_tensor(rng.standard_normal((n, f)).astype(np.float32),
                        device=cuda)
    args = (op.blocks, op.block_cols, op.row_ptr, op.block_rows)
    before = bsr_spmm.launches
    got = bsr_spmm(*args, x)
    again = bsr_spmm(*args, x)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == before + 2
    n_br = op.row_ptr.numel() - 1
    ref = bsr_spmm_plain(op.blocks, op.block_cols, op.block_rows, n_br, x)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert torch.equal(got, again)
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() / scale <= tol
    if structure == "skewed":                   # rows without tiles: zeros
        empty = torch.ones(n, dtype=torch.bool, device=cuda)
        for r in (5, 11, 30):
            empty[r * 128:(r + 1) * 128] = False
        assert not got[empty].any()
    if precision == "highest":
        assert abs((got - ref).mean().item()) / scale <= 1e-7


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
    xg = x.clone().requires_grad_()        # a gradient, no longer a raise
    bsr_spmm(op.blocks, op.block_cols, op.row_ptr, op.block_rows,
             xg).sum().backward()
    assert xg.grad is not None and xg.grad.shape == x.shape


@pytest.mark.parametrize("precision,tol", [("highest", 1e-5),
                                           ("default", 1e-2)])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_bsr_spmm_gradients_match_plain(cuda, precision, tol, lead):
    """``bsr_spmm``'s backward on CUDA tensors (K1 on the transposed
    structure for dx, K2 for the tiles) against the same Function on the
    CPU, where it runs the plain versions; ragged N, empty block rows."""
    rng = np.random.default_rng(13)
    n, f = 1000, 40
    g = _graph(rng, n, 6000, 300)
    x = rng.standard_normal(lead + (n, f)).astype(np.float32)
    w = rng.standard_normal(lead + (n, f)).astype(np.float32)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        op = build_operator(g, "bsr", precision=precision, device=dev)
        tiles = op.blocks.clone().requires_grad_()
        trainable = type(op)(tiles, op.block_cols, op.row_ptr,
                             op.block_rows, n)
        xt = torch.tensor(x, device=dev, requires_grad=True)
        k1, k2 = bsr_spmm.launches, sddmm.bsr_sddmm_kernel.launches
        ((trainable @ xt) * torch.as_tensor(w, device=dev)).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (bsr_spmm.launches - k1,
                    sddmm.bsr_sddmm_kernel.launches - k2) == (2, 1)
        assert tiles.grad.dtype == tiles.dtype and xt.grad.dtype == xt.dtype
        grads[dev.type] = (xt.grad.cpu(), tiles.grad.cpu())
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert _rel(got, want) <= tol


# K1 at the streaming encode's width: a hop of a 64-step chunk of 8 x 16
# reservoir states folds to F = 8,192 columns. f32: the mean signed error
# within TOL_K1_BIAS of the largest output (a coherent bias of the tensor
# cores' truncation would hide under the max error).
TOL_K1_BIAS = 1e-7


@pytest.mark.parametrize("precision,tol", [("highest", 1e-5),
                                           ("default", 1e-2)])
@pytest.mark.parametrize("f", [8192, 8200])
def test_kernel_at_the_encode_width(cuda, precision, tol, f):
    """N 5,016 with every one of the 40 x 40 block positions stored, as the
    100-nn graph in random node order gives; F 8,192 and a ragged 8,200."""
    rng = np.random.default_rng(5)
    n = 5016
    op = build_operator(_graph(rng, n, 100 * n), "bsr", precision=precision,
                        device=cuda)
    assert op.blocks.shape[0] == 40 * 40
    x = torch.as_tensor(rng.standard_normal((n, f)).astype(np.float32),
                        device=cuda)
    args = (op.blocks, op.block_cols, op.row_ptr, op.block_rows)
    got = bsr_spmm(*args, x)
    again = bsr_spmm(*args, x)
    ref = bsr_spmm_plain(op.blocks, op.block_cols, op.block_rows, 40, x)
    torch.cuda.synchronize()
    assert got.shape == (n, f) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert _rel(got, ref) <= tol
    if precision == "highest":
        bias = ((got - ref).mean() / ref.abs().max()).item()
        assert abs(bias) <= TOL_K1_BIAS, bias


@pytest.mark.parametrize("f", [256, 2304, 2300])
def test_kernel_at_the_diffconv_widths(cuda, f):
    """K1 at DiffConv's hop widths on the 100-nn graph's 1,600 tiles: DCRNN
    training's F 256 (``[x, h]``, batch 2 x 128 channels), GraphWaveNet's F
    2,304 (batch 2 x 36 steps x 32 channels) and a ragged 2,300; the max
    error within 1e-5 and the mean signed error within TOL_K1_BIAS of the
    largest output."""
    rng = np.random.default_rng(6)
    n = 5016
    op = build_operator(_graph(rng, n, 100 * n), "bsr", device=cuda)
    assert op.blocks.shape[0] == 40 * 40
    x = torch.as_tensor(rng.standard_normal((n, f)).astype(np.float32),
                        device=cuda)
    args = (op.blocks, op.block_cols, op.row_ptr, op.block_rows)
    got = bsr_spmm(*args, x)
    ref = bsr_spmm_plain(op.blocks, op.block_cols, op.block_rows, 40, x)
    torch.cuda.synchronize()
    assert got.shape == (n, f) and torch.isfinite(got).all()
    assert torch.equal(got, bsr_spmm(*args, x))
    assert _rel(got, ref) <= 1e-5
    bias = ((got - ref).mean() / ref.abs().max()).item()
    print(f"K1 at F {f}: max rel err {_rel(got, ref):.3e}, mean signed err "
          f"{bias:.3e} of the largest output")
    assert abs(bias) <= TOL_K1_BIAS, bias


def test_dcrnn_step_on_bsr_supports_matches_dense(cuda):
    """One ``Predictor`` step of ``DCRNNModel`` on BSR supports (K1 forward
    and backward: 2 supports x 2 hops x 2 products a cell call, each once
    more in the backward) against the same step on dense supports, on the
    card: the loss and each gradient within 1e-4 of its largest value."""
    from sgp_tpu_torch.data.scalers import ScalerParams
    from sgp_tpu_torch.models import DCRNNModel, diff_conv_support
    from sgp_tpu_torch.train import Predictor
    rng = np.random.default_rng(7)
    n, b, s, c, u = 600, 2, 6, 1, 3
    g = coalesce(Graph(rng.integers(0, n, 20 * n), rng.integers(0, n, 20 * n),
                       rng.random(20 * n).astype(np.float32), n))
    batch = {"x": rng.standard_normal((b, s, n, c)).astype(np.float32),
             "u": rng.standard_normal((b, s, u)).astype(np.float32),
             "y": rng.standard_normal((b, 4, n, c)).astype(np.float32),
             "mask": rng.random((b, 4, n, c)) > 0.1}

    def call(batch, training):
        return (batch["x"], batch["supports"]), {"u": batch["u"],
                                                 "training": training}
    out = {}
    for mode in ("bsr", "dense"):
        model = DCRNNModel(c, 16, 32, c, 4, exog_size=u)
        pred = Predictor(model, batch_to_call=call, seed=0, device=cuda,
                         static_batch={"supports": diff_conv_support(
                             g, operator_mode=mode, device=cuda)})
        pred.init(None, ScalerParams(torch.zeros(1, device=cuda),
                                     torch.ones(1, device=cuda)))
        before = bsr_spmm.launches
        loss = float(pred.train_step(batch))
        out[mode] = (loss, {k: p.grad.clone()
                            for k, p in model.named_parameters()},
                     bsr_spmm.launches - before)
    (loss, grads, launches), (d_loss, d_grads, d_launches) = \
        out["bsr"], out["dense"]
    assert launches == s * 2 * 2 * 2 * 2 and d_launches == 0
    assert abs(loss - d_loss) <= 1e-4 * abs(d_loss)
    for k, gd in d_grads.items():
        assert _rel(grads[k], gd) <= 1e-4, k


ENCODE_PARTS = ("states", "hop1", "hop2", "mean")


def _encode_case():
    """The streaming encode's inputs: N 1,000 (8 block rows), T 40 in
    chunks of 16 (a shorter tail), 3 input channels, one target lane."""
    rng = np.random.default_rng(8)
    n, t = 1000, 40
    g = _graph(rng, n, 20 * n)
    return (g, rng.standard_normal((t, n, 3)).astype(np.float32),
            rng.standard_normal((t, n, 1)).astype(np.float32),
            rng.random((t, n, 1)) > 0.1)


def _encode_run(dev, case, chunk=16):
    """The SGP streaming encode (reservoir, 2 hops through K1, global
    mean) on ``dev``, once with an f32 output and once packed with the
    target and mask lanes: both on the CPU. On the card it also checks K1's
    launches (twice a chunk)."""
    from sgp_tpu_torch.encode import SGPEncoder, streaming_encode
    from sgp_tpu_torch.train.iid import pack_iid_data
    g, x, y, m = case
    t, n = x.shape[:2]
    enc = SGPEncoder(input_size=3, reservoir_size=16, reservoir_layers=3,
                     receptive_field=2, global_attr=True, alpha_decay=True,
                     seed=1, operator_mode="bsr", device=dev)
    lanes = pack_iid_data(
        torch.zeros((t, n, 0), dtype=torch.bfloat16, device=dev),
        torch.as_tensor(y, device=dev), torch.as_tensor(m, device=dev),
        [1, 3])
    xt = torch.as_tensor(x, device=dev)
    before = bsr_spmm.launches
    f32 = streaming_encode(enc, xt, g, time_chunk=chunk,
                           out_dtype=torch.float32)
    packed = streaming_encode(enc, xt, g, time_chunk=chunk,
                              extra_lanes=lanes)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        assert bsr_spmm.launches - before == 2 * 2 * -(-t // chunk)
    return f32.cpu(), packed.cpu()


def _encode_errors(got, want) -> dict:
    """Each f32 part's error relative to its largest value (``ENCODE_PARTS``,
    and ``f32`` over all of them), and whether the packed output holds:
    features within one bf16 ulp of the larger value, or 1e-5 of the
    largest (values near 0, whose ulp lies below the f32 sums' own
    difference), and the lanes bit for bit."""
    (f32, packed), (f32_cpu, packed_cpu) = got, want
    width = f32.shape[-1] // len(ENCODE_PARTS)
    errs = {name: _rel(f32[..., i * width:(i + 1) * width],
                       f32_cpu[..., i * width:(i + 1) * width])
            for i, name in enumerate(ENCODE_PARTS)}
    errs["f32"] = _rel(f32, f32_cpu)
    d = f32.shape[-1]
    a, b = packed[..., :d].float(), packed_cpu[..., :d].float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    errs["packed_ok"] = bool(
        ((a - b).abs() <= ulp.clamp_min(1e-5 * b.abs().max())).all()
        and torch.equal(packed[..., d:].view(torch.int16),
                        packed_cpu[..., d:].view(torch.int16)))
    return errs


@pytest.mark.parametrize("poisoned", [False, True],
                         ids=["plain", "poisoned"])
def test_streaming_encode_on_the_card_matches_cpu(cuda, monkeypatch,
                                                  poisoned):
    """The SGP streaming encode on the card against the port on the CPU
    (``_encode_run``): f32 output at 1e-5 of the largest value, the bf16
    packed output as ``_encode_errors`` holds it. ``poisoned``: every
    ``torch.empty`` of the card's run handed out filled (``_poison``), so
    that an element no thread writes, K1's workspace included, shows."""
    case = _encode_case()
    if poisoned:
        empty = torch.empty
        monkeypatch.setattr(torch, "empty",
                            lambda *a, **k: _poison(empty(*a, **k)))
    got = _encode_run(cuda, case)
    monkeypatch.undo()
    want = _encode_run(torch.device("cpu"), case)
    errs = _encode_errors(got, want)
    steps = [_rel(got[0][s], want[0][s]) for s in range(got[0].shape[0])]
    assert errs["f32"] <= 1e-5, (errs, steps)
    assert errs["packed_ok"], errs


ENCODE_REPEATS = 200


def test_streaming_encode_repeated_on_the_card(cuda, monkeypatch):
    """The case above ``ENCODE_REPEATS`` times in one process, each part's
    error against the CPU port printed at every repeat (``-s``); every
    other repeat with ``torch.empty`` poisoned, as in
    :func:`test_attention_repeated_on_the_card`. The parts whose card bits
    move from the first repeat's are printed too."""
    case = _encode_case()
    want = _encode_run(torch.device("cpu"), case)
    empty = torch.empty

    def poisoned(*shape, **kw):
        return _poison(empty(*shape, **kw))

    failures, first, moved = [], None, set()
    worst = dict.fromkeys(ENCODE_PARTS + ("f32",), 0.0)
    for rep in range(ENCODE_REPEATS):
        if rep % 2:
            monkeypatch.setattr(torch, "empty", poisoned)
        got = _encode_run(cuda, case)
        monkeypatch.setattr(torch, "empty", empty)
        errs = _encode_errors(got, want)
        print(f"repeat {rep} {'poisoned' if rep % 2 else 'plain'}: "
              + " ".join(f"{k} {v:.3e}" for k, v in errs.items()
                         if k in worst)
              + f" packed_ok {errs['packed_ok']}")
        if not (errs["f32"] <= 1e-5 and errs["packed_ok"]):
            failures.append((rep, errs))
        worst = {k: max(worst[k], errs[k]) if errs[k] == errs[k]
                 else errs[k] for k in worst}
        first = first or got
        width = got[0].shape[-1] // len(ENCODE_PARTS)
        moved |= {name for i, name in enumerate(ENCODE_PARTS)
                  if not torch.equal(got[0][..., i * width:(i + 1) * width],
                                     first[0][..., i * width:
                                              (i + 1) * width])}
        if not torch.equal(got[1].view(torch.int16),   # lanes hold NaN
                           first[1].view(torch.int16)):  # bit patterns
            moved.add("packed")
    print(f"largest error over {ENCODE_REPEATS} repeats: "
          + " ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; bits moved between repeats: {sorted(moved)}; failures: "
          f"{len(failures)}")
    assert not failures, failures


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


def _counted_mask(rng, n, d, counts, cuda):
    """An ``[n, d]`` slot mask whose row i holds ``counts[i % len(counts)]``
    valid slots at random places."""
    mask = np.zeros((n, d), bool)
    for i in range(n):
        mask[i, rng.choice(d, counts[i % len(counts)], replace=False)] = True
    return torch.as_tensor(mask, device=cuda)


@pytest.mark.parametrize("activation", ["silu", "tanh", "relu", "elu"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,n,d,h2,h,counts", [
    (2, 1000, 100, 32, 64, None),      # the slice's widths
    (3, 77, 7, 32, 64, None),          # ragged N, D = 7, one empty row
    (2, 300, 37, 32, 64, None),        # D over one 32-slot mask word, not
                                       # a multiple of 16
    (1, 50, 5, 5, 11, None),           # narrow widths, zero-padded lanes
    # rows with 0, 1, 15, 16, 17, 33 and 100 valid slots: the kernels'
    # 16-pair batches end full, one short, one over and empty
    (2, 140, 100, 32, 64, (0, 1, 15, 16, 17, 33, 100)),
])
def test_gn_ell_kernel_matches_plain(cuda, activation, dtype, tol, b, n, d,
                                     h2, h, counts):
    rng = np.random.default_rng(2)
    args = _ell_inputs(rng, b, n, d, h2, h, dtype, cuda, empty_row=n // 2)
    if counts is not None:
        args = (*args[:2], _counted_mask(rng, n, d, counts, cuda), *args[3:])
        args[2][n // 2] = False
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
    assert not grads[0][:, n // 2].any()            # no valid slot: no d_pi
    assert not grads[1][:, ~args[2]].any()          # padding slots: exactly 0
    for g, r, name in zip(grads, refg, ("dpi", "dpjn", "dw2", "db2", "dwg",
                                        "dbg")):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert torch.isfinite(g).all(), name
        assert _rel(g, r) <= tol, (name, _rel(g, r))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_gn_ell_relu_near_zero(cuda, dtype, tol):
    """relu's derivative jumps at 0. Channels 0-7 of w2 and b2 are 0 (mt is
    exactly 0: both take relu'(0) = 0); channels 8-15 are scaled by 1e-6
    (every |mt| below the kernel's 1e-4, where it settles the branch with
    an FFMA recompute). The rest is the slice's chain."""
    rng = np.random.default_rng(7)
    args = list(_ell_inputs(rng, 2, 300, 40, 32, 64, dtype, cuda))
    w2, b2 = args[3].clone(), args[4].clone()
    w2[:, :8], b2[:8] = 0.0, 0.0
    w2[:, 8:16] *= 1e-6
    b2[8:16] = 0.0
    args[3], args[4] = w2, b2
    ghat = torch.as_tensor(rng.standard_normal((2, 300, 64)).astype(
        np.float32), device=cuda)
    out = gn_ell.gn_ell_fwd(*args, "relu")
    grads = gn_ell.gn_ell_bwd(*args, ghat, "relu")
    ref = gn_ell.gn_ell_fwd_plain(*args, "relu")
    refg = gn_ell.gn_ell_bwd_plain(*args, ghat, "relu")
    torch.cuda.synchronize()
    assert _rel(out, ref) <= tol
    for g, r, name in zip(grads, refg, ("dpi", "dpjn", "dw2", "db2", "dwg",
                                        "dbg")):
        assert torch.isfinite(g).all(), name
        assert _rel(g, r) <= tol, (name, _rel(g, r))
    assert not grads[3][:8].any()                   # db2 of mt == 0: exactly 0


def test_gn_ell_forward_is_deterministic(cuda):
    rng = np.random.default_rng(16)
    args = _ell_inputs(rng, 2, 600, 30, 32, 64, torch.float32, cuda)
    first = gn_ell.gn_ell_fwd(*args)
    again = gn_ell.gn_ell_fwd(*args)
    assert torch.equal(first, again)


def test_gn_ell_forward_has_no_bias(cuda):
    """At the slice's widths (h2 32, h 64, D 100, every slot valid, f32) the
    forward's mean error stays within 1e-7 of its largest value: mt's k
    steps and the sums over slots are kept out of the tensor cores'
    truncating accumulator, so no bias a training run would sum over every
    node hides under the max error."""
    rng = np.random.default_rng(17)
    args = _ell_inputs(rng, 2, 1000, 100, 32, 64, torch.float32, cuda)
    args[2].fill_(True)
    out = gn_ell.gn_ell_fwd(*args)
    ref = gn_ell.gn_ell_fwd_plain(*args)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    assert _rel(out, ref) <= 2e-5
    assert abs((out - ref).mean().item()) / scale <= 1e-7


def test_gn_ell_backward_as_close_to_float64_as_plain(cuda):
    """At the slice's widths (h2 32, h 64, D 100, f32) the backward's d_pi
    and d_pjn lie within 3x the plain version's distance from float64
    autograd: mt's and dt's k steps are kept out of the tensor cores'
    truncating accumulator (summed inside it, they put d_pi 4-6x as far
    off as the plain version on the training slice's inputs)."""
    rng = np.random.default_rng(18)
    args = _ell_inputs(rng, 2, 1000, 100, 32, 64, torch.float32, cuda)
    ghat = torch.as_tensor(rng.standard_normal((2, 1000, 64)).astype(
        np.float32), device=cuda)
    p_i, pjn, w2, b2, wg, bg = (t.double().requires_grad_(True)
                                for i, t in enumerate(args) if i != 2)
    silu = torch.nn.functional.silu
    mb = silu(silu(p_i.unsqueeze(-2) + pjn) @ w2 + b2)
    g = torch.sigmoid(mb @ wg + bg)
    out = (g * mb * args[2].double().unsqueeze(-1)).sum(-2)
    want = torch.autograd.grad((out * ghat.double()).sum(), (p_i, pjn))
    got = gn_ell.gn_ell_bwd(*args, ghat)[:2]
    plain = gn_ell.gn_ell_bwd_plain(*args, ghat)[:2]
    torch.cuda.synchronize()
    for name, k, pl, w in zip(("d_pi", "d_pjn"), got, plain, want):
        err = [(x.double() - w).abs().max().item() / w.abs().max().item()
               for x in (k, pl)]
        assert err[0] <= 3 * err[1], (name, err)


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


# -- K3: the GatedGN all-pairs kernel, forward and backward ----------------
# Tolerances, relative to the plain version's largest value: f32 2e-5 (the
# same f32 products summed in another order, over up to N pairs a row and
# every pair for the weight gradients); bf16 inputs 2e-2 (both round t,
# ghat and dmt at the same places, so one value rounded the other way moves
# a result by a bf16 ulp, 2^-8). relu's gradients 5e-3: its derivative
# jumps at 0, and among the ~2e7 values of mt a few lie within rounding of
# 0, so the two sums take the other branch there; each such pair moves a
# row's sum by one w2 * ghat term, ~1e-3 of the largest row sum.

def _allpairs_inputs(rng, b, n, h2, h, dtype, cuda, density=0.15,
                     empty_row=None, reach=None):
    """Random K3 inputs at a GatedGN layer's scales and an asymmetric mask;
    ``reach`` keeps only the edges with ``-reach <= j - i <= reach // 2``."""
    mk = lambda *s, sc=1.0: torch.as_tensor(
        (rng.standard_normal(s) * sc).astype(np.float32), device=cuda)
    mask = rng.random((n, n)) < density
    if reach is not None:
        i, j = np.indices((n, n))
        mask &= (j - i >= -reach) & (j - i <= reach // 2)
    if empty_row is not None:
        mask[empty_row] = False
    return (mk(b, n, h2).to(dtype), mk(b, n, h2).to(dtype),
            torch.as_tensor(mask, device=cuda), mk(h2, h, sc=0.3),
            mk(h, sc=0.1), mk(h, 1, sc=0.3), mk(1, sc=0.1)), mask


@pytest.mark.parametrize("activation", ["silu", "tanh", "relu", "elu"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,n,h2,h,layout", [
    (1, 1500, 32, 64, "full"),         # the slice's widths
    (3, 1001, 32, 64, "full"),         # ragged N, B > 1, one empty row
    (2, 700, 32, 64, "band"),          # per-block windows
    (1, 300, 5, 11, "uniform band"),   # narrow widths, zero-padded lanes
])
def test_gn_allpairs_kernel_matches_plain(cuda, activation, dtype, tol, b, n,
                                          h2, h, layout):
    rng = np.random.default_rng(5)
    band_mask = layout != "full"
    args, mask = _allpairs_inputs(rng, b, n, h2, h, dtype, cuda,
                                  empty_row=n // 2,
                                  reach=60 if band_mask else None)
    band = None if not band_mask else band_windows(
        mask, block=64, width_mult=32, uniform=layout == "uniform band")
    ghat = torch.as_tensor(rng.standard_normal((b, n, h)).astype(
        np.float32), device=cuda)
    f0, b0 = gn_allpairs.gn_allpairs_fwd.launches, \
        gn_allpairs.gn_allpairs_bwd.launches
    out = gn_allpairs.gn_allpairs_fwd(*args, activation, band)
    grads = gn_allpairs.gn_allpairs_bwd(*args, ghat, activation, band)
    torch.cuda.synchronize()
    assert (gn_allpairs.gn_allpairs_fwd.launches,
            gn_allpairs.gn_allpairs_bwd.launches) == (f0 + 1, b0 + 1)
    ref = gn_allpairs.gn_allpairs_fwd_plain(*args, activation, band)
    refg = gn_allpairs.gn_allpairs_bwd_plain(*args, ghat, activation, band)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert _rel(out, ref) <= tol
    assert not out[:, n // 2].any()
    gtol = max(tol, 5e-3) if activation == "relu" else tol
    for g, r, name in zip(grads, refg, ("dpi", "dpj", "dw2", "db2", "dwg",
                                        "dbg")):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert torch.isfinite(g).all(), name
        assert _rel(g, r) <= gtol, (name, _rel(g, r))


@pytest.mark.parametrize("activation", ["silu", "elu"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_gn_allpairs_kernel_pads_pair_batches(cuda, activation, dtype, tol):
    """Rows and columns holding 0, 1, 15, 16, 17 and 33 set entries: the
    16-pair batches of the forward and the backward end full, one short,
    one over and empty, and their padding slots must add nothing."""
    rng = np.random.default_rng(14)
    n, degrees = 240, (0, 1, 15, 16, 17, 33)
    mask = np.zeros((n, n), bool)
    for i in range(n):
        mask[i, rng.choice(n, degrees[i % 6], replace=False)] = True
    for j, d in zip(range(0, n, 7), degrees * 6):    # columns of each count
        mask[:, j] = False
        mask[rng.choice(n, d, replace=False), j] = True
    args, _ = _allpairs_inputs(rng, 2, n, 32, 64, dtype, cuda)
    args = (*args[:2], torch.as_tensor(mask, device=cuda), *args[3:])
    ghat = torch.as_tensor(rng.standard_normal((2, n, 64)).astype(
        np.float32), device=cuda)
    out = gn_allpairs.gn_allpairs_fwd(*args, activation)
    ref = gn_allpairs.gn_allpairs_fwd_plain(*args, activation)
    grads = gn_allpairs.gn_allpairs_bwd(*args, ghat, activation)
    refg = gn_allpairs.gn_allpairs_bwd_plain(*args, ghat, activation)
    torch.cuda.synchronize()
    empty_rows = torch.as_tensor(~mask.any(1), device=cuda)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert _rel(out, ref) <= tol, ("out", _rel(out, ref))
    assert not out[:, empty_rows].any()
    assert not grads[0][:, empty_rows].any()
    for g, r, name in zip(grads, refg, ("dpi", "dpj", "dw2", "db2", "dwg",
                                        "dbg")):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert torch.isfinite(g).all(), name
        assert _rel(g, r) <= tol, (name, _rel(g, r))


def test_gn_allpairs_forward_is_deterministic(cuda):
    rng = np.random.default_rng(15)
    args, _ = _allpairs_inputs(rng, 2, 900, 32, 64, torch.float32, cuda)
    first = gn_allpairs.gn_allpairs_fwd(*args)
    again = gn_allpairs.gn_allpairs_fwd(*args)
    assert torch.equal(first, again)


def test_gn_allpairs_backward_is_deterministic(cuda):
    rng = np.random.default_rng(6)
    args, _ = _allpairs_inputs(rng, 2, 900, 32, 64, torch.float32, cuda)
    ghat = torch.randn(2, 900, 64, device=cuda)
    first = gn_allpairs.gn_allpairs_bwd(*args, ghat)
    again = gn_allpairs.gn_allpairs_bwd(*args, ghat)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("with_band", [False, True])
def test_gatedgn_layer_runs_k3_on_the_card(cuda, with_band):
    """``GatedGraphNetwork(adj=...)`` on CUDA tensors launches K3 forward
    and backward, with and without the window table."""
    rng = np.random.default_rng(7)
    n = 400
    _, mask = _allpairs_inputs(rng, 1, n, 32, 64, torch.float32, cuda,
                               reach=40)
    band = band_windows(mask, block=64, width_mult=32, uniform=False) \
        if with_band else None
    layer = GatedGraphNetwork(64, 64).to(cuda)
    x = torch.randn(2, n, 64, device=cuda)
    f0, b0 = gn_allpairs.gn_allpairs_fwd.launches, \
        gn_allpairs.gn_allpairs_bwd.launches
    layer(x, adj=torch.as_tensor(mask, device=cuda), adj_band=band
          ).square().sum().backward()
    torch.cuda.synchronize()
    assert (gn_allpairs.gn_allpairs_fwd.launches,
            gn_allpairs.gn_allpairs_bwd.launches) == (f0 + 1, b0 + 1)
    assert all(torch.isfinite(p.grad).all() for p in layer.parameters())


def test_gn_allpairs_wrapper_rejects_bad_inputs(cuda):
    rng = np.random.default_rng(8)
    args = list(_allpairs_inputs(rng, 1, 10, 32, 64, torch.float32, cuda)[0])
    with pytest.raises(ValueError):        # h above the kernel's 64
        wide = list(args)
        wide[3], wide[4], wide[5] = (torch.zeros(32, 80, device=cuda),
                                     torch.zeros(80, device=cuda),
                                     torch.zeros(80, 1, device=cuda))
        gn_allpairs.gn_allpairs_fwd(*wide)
    with pytest.raises(ValueError):        # mask on another device
        cpu = list(args)
        cpu[2] = cpu[2].cpu()
        gn_allpairs.gn_allpairs_fwd(*cpu)


# -- K2: the block-sampled SDDMM --------------------------------------------
# Tolerances, relative to the plain version's largest value: f32 1e-5 (the
# same f32 products summed in another order over D); bf16 inputs 2e-2 (both
# multiply the bf16 values exactly in f32, so only the order differs; the
# bound leaves room for one bf16 ulp).

def _attention_graph(rng, n, e, empty_block_row=False):
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    if empty_block_row:                # no edge ends in nodes 128..255
        dst = np.where((dst >= 128) & (dst < 256), dst % 128, dst)
    return coalesce(Graph(src, dst, rng.random(e).astype(np.float32), n))


def _check_sddmm(st, q, k, tol):
    """K2 once through ``bsr_sddmm`` and once more, against the plain
    version: one launch, the same bits twice, the padding (rows and columns
    past N) exactly 0. Returns ``(got, ref)``."""
    n = q.shape[0]
    before = sddmm.bsr_sddmm_kernel.launches
    got = sddmm.bsr_sddmm(q, k, st)
    torch.cuda.synchronize()
    assert sddmm.bsr_sddmm_kernel.launches == before + 1
    again = sddmm.bsr_sddmm_kernel(q, k, st.block_rows, st.block_cols,
                                   st.n_block_rows)
    ref = sddmm.bsr_sddmm_plain(q, k, st.block_rows, st.block_cols,
                                st.n_block_rows)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= tol
    assert torch.equal(got, again)
    pad = n % 128
    if pad:
        last = st.n_block_rows - 1
        assert not got[st.block_rows == last, pad:].any()
        assert not got[st.block_cols == last][:, :, pad:].any()
    return got, ref


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,e,d,empty", [
    (1001, 30000, 40, True),           # ragged N and D, an empty block row
    (640, 20000, 64, False),           # the slice's D
    (300, 3000, 16, False),
    (128, 500, 1, False),              # one block row, D = 1
    (700, 9000, 3, False),             # D inside one 16-byte copy
    (1001, 30000, 128, True),          # Q resident in bf16 only
    (515, 12000, 200, False),          # Q streamed, a ragged last slab
])
def test_sddmm_kernel_matches_plain(cuda, dtype, tol, n, e, d, empty):
    rng = np.random.default_rng(9)
    st = sddmm.bsr_attention_structure(_attention_graph(rng, n, e, empty),
                                       device=cuda)
    q, k = (torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32),
                            device=cuda).to(dtype) for _ in range(2))
    got, ref = _check_sddmm(st, q, k, tol)
    if empty:
        assert not (st.block_rows == 1).any()
    if dtype == torch.float32 and d == 64:
        # a coherent bias (the tensor cores truncate their sums) shows in
        # the mean error and hides under the max
        bias = (got - ref).mean() / ref.abs().max()
        assert abs(bias.item()) <= 1e-7


def _block_pattern_graph(rng, n, pattern):
    """A graph whose stored blocks are exactly ``pattern`` (block row ->
    block columns): one edge in each, at random nodes of the two blocks."""
    dst, src = [], []
    for r, cols in pattern.items():
        for c in cols:
            dst.append(r * 128 + rng.integers(0, min(128, n - r * 128)))
            src.append(c * 128 + rng.integers(0, min(128, n - c * 128)))
    return coalesce(Graph(np.array(src), np.array(dst), None, n))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [16, 64, 200])
def test_sddmm_kernel_spreads_any_structure(cuda, dtype, tol, d):
    """60 block rows, N ragged: rows 0, 10, 11 and 12 store all 60 blocks
    (each longer than a CTA's range of the 296, so ranges cut inside a
    row), row 7 none, the rest one block each."""
    rng = np.random.default_rng(14)
    n, n_br = 60 * 128 - 37, 60
    pattern = {r: (range(n_br) if r in (0, 10, 11, 12) else
                   [int(rng.integers(0, n_br))]) for r in range(n_br)
               if r != 7}
    st = sddmm.bsr_attention_structure(_block_pattern_graph(rng, n, pattern),
                                       device=cuda)
    assert st.block_rows.numel() == 4 * 60 + 55
    q, k = (torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32),
                            device=cuda).to(dtype) for _ in range(2))
    _check_sddmm(st, q, k, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_sddmm_kernel_unaligned_head_view(cuda, dtype, tol):
    """``q[:, h]`` of ``[N, 3, 5]``: rows 15 elements apart, starting off
    16 bytes; the wrapper pads them into an aligned copy, and each head
    gives the bits of its contiguous copy."""
    rng = np.random.default_rng(15)
    n = 700
    st = sddmm.bsr_attention_structure(_attention_graph(rng, n, 9000),
                                       device=cuda)
    q, k = (torch.as_tensor(rng.standard_normal((n, 3, 5)).astype(
        np.float32), device=cuda).to(dtype) for _ in range(2))
    for h in range(3):
        got, _ = _check_sddmm(st, q[:, h], k[:, h], tol)
        want = sddmm.bsr_sddmm(q[:, h].contiguous(), k[:, h].contiguous(), st)
        assert torch.equal(got, want)


def test_sddmm_kernel_strided_head_view(cuda):
    """``q[:, h]`` of ``[N, H, D]`` runs without a copy and gives the bits
    of its contiguous copy."""
    rng = np.random.default_rng(10)
    n = 700
    st = sddmm.bsr_attention_structure(_attention_graph(rng, n, 9000),
                                       device=cuda)
    q, k = (torch.as_tensor(rng.standard_normal((n, 4, 16)).astype(
        np.float32), device=cuda) for _ in range(2))
    for h in range(4):
        got = sddmm.bsr_sddmm(q[:, h], k[:, h], st)
        want = sddmm.bsr_sddmm(q[:, h].contiguous(), k[:, h].contiguous(), st)
        assert torch.equal(got, want)


def test_sddmm_kernel_nnzb_zero(cuda):
    st = sddmm.bsr_attention_structure(
        Graph(np.zeros(0, np.int32), np.zeros(0, np.int32), None, 200),
        device=cuda)
    q = torch.ones(200, 8, device=cuda)
    before = sddmm.bsr_sddmm_kernel.launches
    out = sddmm.bsr_sddmm_kernel(q, q, st.block_rows, st.block_cols,
                                 st.n_block_rows)
    assert out.shape == (0, 128, 128) and out.is_cuda
    assert sddmm.bsr_sddmm_kernel.launches == before
    att = sddmm.bsr_multi_head_attention(q[:, None], q[:, None], q[:, None],
                                         st)
    assert att.shape == (200, 1, 8) and not att.any()


def _poison(t: torch.Tensor) -> torch.Tensor:
    """Fill a fresh buffer so that an element no thread writes shows as a
    NaN: floats with NaN, bytes (K1's workspace of f32 partial sums) with
    0xFF."""
    if t.is_floating_point():
        return t.fill_(float("nan"))
    return t.fill_(255) if t.dtype == torch.uint8 else t


ATTENTION_TENSORS = ("out", "dq", "dk", "dv", "scores", "scores_dq",
                     "scores_dk")


def _attention_run(dev, g, arrays):
    """The attention op and its backward on ``dev``, then the SDDMM's own
    gradients: the seven tensors of ``ATTENTION_TENSORS`` on the CPU. On the
    card it also checks the launches and the op against the edge list."""
    from sgp_tpu_torch.ops import sparse_multi_head_attention
    n, h = arrays[0].shape[:2]
    st = sddmm.bsr_attention_structure(g, device=dev)
    q, k, v = (torch.tensor(a, device=dev, requires_grad=True)
               for a in arrays[:3])
    w = torch.as_tensor(arrays[3], device=dev)
    k2, k1 = sddmm.bsr_sddmm_kernel.launches, bsr_spmm.launches
    out = sddmm.bsr_multi_head_attention(q, k, v, st)
    (out * w).sum().backward()
    scores = sddmm.bsr_sddmm(q[:, 0], k[:, 0], st)
    dq, dk = torch.autograd.grad((scores * scores).sum(), (q, k))
    if dev.type == "cuda":
        torch.cuda.synchronize()
        assert sddmm.bsr_sddmm_kernel.launches - k2 == 2 * h + 1
        # a head: the forward, dv, and the SDDMM's dq and dk; the scores'
        # own dq and dk
        assert bsr_spmm.launches - k1 == 4 * h + 2
        edge = sparse_multi_head_attention(
            q, k, v, torch.as_tensor(g.src, device=dev),
            torch.as_tensor(g.dst, device=dev), n)
        assert (out - edge).abs().max().item() <= 1e-4
    return [t.detach().cpu() for t in (
        out, q.grad, k.grad, v.grad, scores, dq, dk)]


def _attention_case():
    rng = np.random.default_rng(11)
    n, h, d = 1001, 2, 40
    g = _attention_graph(rng, n, 30000, empty_block_row=True)
    return g, [rng.standard_normal((n, h, d)).astype(np.float32)
               for _ in range(4)]


def test_sddmm_gradients_and_attention_on_the_card(cuda):
    """``bsr_sddmm``'s autograd Function and the whole attention op on CUDA
    tensors (K2 and K1 forward, K2 and K1 in the SpMM's backward, K1 in the
    SDDMM's) against the port on the CPU; the op against the edge-list
    form on the card."""
    g, arrays = _attention_case()
    results = {dev.type: _attention_run(dev, g, arrays)
               for dev in (cuda, torch.device("cpu"))}
    errs = {name: _rel(got, want) for name, got, want in
            zip(ATTENTION_TENSORS, results["cuda"], results["cpu"])}
    assert all(v <= 1e-5 for v in errs.values()), errs


ATTENTION_REPEATS = 200


def test_attention_repeated_on_the_card(cuda, monkeypatch):
    """The case above ``ATTENTION_REPEATS`` times in one process, each
    tensor's error against the CPU port printed at every repeat (``-s``).
    Every other repeat runs with the port's ``torch.empty`` poisoned (the
    buffers it hands the kernels filled with NaN, K1's byte workspace with
    0xFF, a NaN's bits), so that an element no thread writes shows as NaN;
    the other repeats see whatever the caching allocator left there. Card results are also held to the first repeat's
    bits: the SDDMM and its backward (K2, and K1 over the structure and its
    transpose) sum in a fixed order, so ``scores``, ``scores_dq`` and
    ``scores_dk`` never move; only what lies downstream of the softmax's
    row sums (an ``index_add_``) may."""
    g, arrays = _attention_case()
    want = _attention_run(torch.device("cpu"), g, arrays)
    empty = torch.empty

    def poisoned(*shape, **kw):
        return _poison(empty(*shape, **kw))

    failures, first, moved = [], None, set()
    worst = dict.fromkeys(ATTENTION_TENSORS, 0.0)
    for rep in range(ATTENTION_REPEATS):
        if rep % 2:
            monkeypatch.setattr(torch, "empty", poisoned)
        got = _attention_run(cuda, g, arrays)
        monkeypatch.setattr(torch, "empty", empty)
        errs = {name: _rel(a, b) for name, a, b in
                zip(ATTENTION_TENSORS, got, want)}
        print(f"repeat {rep} {'poisoned' if rep % 2 else 'plain'}: "
              + " ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        failures += [(rep, k, v) for k, v in errs.items()
                     if not v <= 1e-5]
        worst = {k: v if not v <= worst[k] else worst[k]
                 for k, v in errs.items()}
        first = first or got
        moved |= {name for name, a, b in zip(ATTENTION_TENSORS, got, first)
                  if not torch.equal(a, b)}
    print(f"largest error over {ATTENTION_REPEATS} repeats: "
          + " ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; bits moved between repeats: {sorted(moved)}; failures: "
          f"{len(failures)}")
    assert not failures, failures
    assert not moved & {"scores", "scores_dq", "scores_dk"}, sorted(moved)


def test_sddmm_wrapper_rejects_bad_inputs(cuda):
    rng = np.random.default_rng(12)
    st = sddmm.bsr_attention_structure(_attention_graph(rng, 300, 3000),
                                       device=cuda)
    q = torch.zeros(300, 8, device=cuda)
    args = (st.block_rows, st.block_cols, st.n_block_rows)
    with pytest.raises(ValueError):        # int64 block rows
        sddmm.bsr_sddmm_kernel(q, q, st.block_rows.long(), *args[1:])
    with pytest.raises(ValueError):        # block indices on the CPU
        sddmm.bsr_sddmm_kernel(q, q, st.block_rows.cpu(), *args[1:])
    with pytest.raises(ValueError):        # a column stride other than 1
        wide = torch.zeros(8, 300, device=cuda)
        sddmm.bsr_sddmm_kernel(wide.T, wide.T, *args)
    with pytest.raises(TypeError):         # float16
        sddmm.bsr_sddmm_kernel(q.half(), q.half(), *args)
    with pytest.raises(ValueError):        # k of another width
        sddmm.bsr_sddmm_kernel(q, torch.zeros(300, 9, device=cuda), *args)
    with pytest.raises(ValueError):        # more rows than block rows hold
        big = torch.zeros(400, 8, device=cuda)
        sddmm.bsr_sddmm_kernel(big, big, *args)


def test_support_operators_on_the_card_match_cpu(cuda):
    """The traffic runner's loader-side supports (``operator_mode="bsr"``:
    A, A^2, A', A'^2 and the 1/N graph) through ``apply_support`` and
    ``SGPLoader``-shaped batches ``[B, W, N, C]``: one K1 launch a support
    on the card, the result within 1e-5 of the largest value of the CPU
    port's (K1's plain version)."""
    from sgp_tpu_torch.data.sgp_loader import (apply_support,
                                               build_support_operators)
    rng = np.random.default_rng(3)
    g = coalesce(Graph(rng.integers(0, 700, 14000),
                       rng.integers(0, 700, 14000),
                       rng.random(14000).astype(np.float32), 700))
    kw = dict(k=2, bidirectional=True, global_attr=True,
              operator_mode="bsr")
    ops = build_support_operators(g, device=cuda, **kw)
    cpu_ops = build_support_operators(g, device="cpu", **kw)
    x = rng.standard_normal((8, 2, 700, 24)).astype(np.float32)
    before = bsr_spmm.launches
    got = apply_support(torch.as_tensor(x, device=cuda), ops)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == before + len(ops) == before + 5
    ref = apply_support(torch.as_tensor(x), cpu_ops)
    err = (got.cpu() - ref).abs().max() / ref.abs().max()
    assert got.shape == (8, 2, 700, 24 * 6) and err <= 1e-5, err


@pytest.mark.parametrize("streams", [None, 3])
def test_gesn_encode_on_bsr_matches_dense_and_cpu(cuda, streams):
    """The DynGESN encode (``GESNEncoder``, 3 layers x 32 units on 700
    nodes, 24 steps) with ``operator_mode="bsr"``: one K1 launch a
    layer-step (T x L), none on the dense route; the states within 1e-5 of
    the largest value of the dense operator's on the card and of the CPU
    port's (K1's plain version). With ``streams``, a ``[T, S, N, F]``
    series: each layer-step is still one launch, at F = S x 32."""
    from sgp_tpu_torch.encode import GESNEncoder
    rng = np.random.default_rng(4)
    g = coalesce(Graph(rng.integers(0, 700, 7000),
                       rng.integers(0, 700, 7000),
                       rng.random(7000).astype(np.float32), 700))
    t, lead = 24, (() if streams is None else (streams,))
    x = rng.standard_normal((t,) + lead + (700, 3)).astype(np.float32)
    kw = dict(input_size=3, reservoir_size=32, reservoir_layers=3,
              alpha_decay=True, density=1.0, seed=2)
    out = {}
    for mode, dev in (("bsr", cuda), ("dense", cuda), ("bsr", "cpu")):
        enc = GESNEncoder(**kw, operator_mode=mode, device=dev)
        before = bsr_spmm.launches
        out[mode, str(dev)] = enc(torch.as_tensor(x, device=dev), g).cpu()
        torch.cuda.synchronize()
        launches = bsr_spmm.launches - before
        assert launches == (t * 3 if (mode, dev) == ("bsr", cuda) else 0), \
            (mode, dev, launches)
    got = out["bsr", str(cuda)]
    assert got.shape == (t,) + lead + (700, 96)
    for key in (("dense", str(cuda)), ("bsr", "cpu")):
        ref = out[key]
        err = (got - ref).abs().max() / ref.abs().max()
        assert err <= 1e-5, (key, float(err))


@pytest.mark.parametrize("streams", [None, 4])
def test_exported_bsr_forecaster_launches_k1(cuda, tmp_path, streams):
    """``export_forecaster`` / ``load_forecaster`` of an ``OnlineForecaster``
    on BSR operators on the card (4 layers of 16 units, receptive field 2,
    bidirectional: 4 hops a step, 700 nodes): the loaded program runs K1
    through ``sgp::bsr_spmm``, one launch a hop (counted inside the
    program), and its forecasts lie within 1e-5 of the largest of the live
    forecaster's."""
    from sgp_tpu_torch.encode import SGPEncoder
    from sgp_tpu_torch.data import ScalerParams
    from sgp_tpu_torch.models import SGPModel
    from sgp_tpu_torch.serve import (OnlineForecaster, export_forecaster,
                                     load_forecaster)
    rng = np.random.default_rng(5)
    n = 700
    g = coalesce(Graph(rng.integers(0, n, 7000), rng.integers(0, n, 7000),
                       rng.random(7000).astype(np.float32), n))
    enc = SGPEncoder(input_size=1, reservoir_size=16, reservoir_layers=4,
                     receptive_field=2, bidirectional=True,
                     operator_mode="bsr", seed=3, device=cuda)
    model = SGPModel(input_size=enc.output_size, order=enc.output_size // 16,
                     n_nodes=n, hidden_size=32, mlp_size=16, output_size=1,
                     n_layers=1, horizon=3,
                     generator=torch.Generator().manual_seed(0))
    scaler = ScalerParams(torch.full((1, 1, 1), 0.5, device=cuda),
                          torch.full((1, 1, 1), 2.0, device=cuda))
    fc = OnlineForecaster(enc, g, model.to(cuda), scaler,
                          n_streams=streams, device=cuda)
    path = str(tmp_path / "fc.pt2")
    export_forecaster(fc, path)
    loaded = load_forecaster(path)
    lead = () if streams is None else (streams,)
    obs = rng.standard_normal((6,) + lead + (n, 1)).astype(np.float32)
    for t in range(6):
        live = fc.step(obs[t])
        before = bsr_spmm.launches
        got = loaded.step(obs[t])
        torch.cuda.synchronize()
        assert bsr_spmm.launches - before == 4
        assert got.device.type == "cuda" and got.shape == live.shape
        err = (got - live).abs().max() / live.abs().max()
        assert err <= 1e-5, (t, float(err))


def test_grin_step_on_bsr_supports_matches_dense(cuda):
    """One GRIN train step (``train/imputer.py``, the whitening mask drawn
    once and handed to both) on BSR supports (K1 forward and backward)
    against the same step on the dense supports, from the same weights:
    the losses within 1e-5 relative, every gradient within 1e-4 of its
    parameter's largest (f32 sums in other orders through 6 recurrent
    steps), and 10 K1 launches a step and direction forward."""
    import copy
    from sgp_tpu_torch.models import GRINModel, diff_conv_support
    from sgp_tpu_torch.train.imputer import draw_keep, imputer_loss
    rng = np.random.default_rng(6)
    n, s = 700, 6
    g = coalesce(Graph(rng.integers(0, n, 7000), rng.integers(0, n, 7000),
                       rng.random(7000).astype(np.float32), n))
    x = torch.as_tensor(rng.standard_normal((2, s, n, 1)).astype(
        np.float32), device=cuda)
    batch = {"x": x, "y": x + 0.1, "mask": torch.as_tensor(
        rng.random((2, s, n, 1)) > 0.2, device=cuda)}
    keep = draw_keep(batch["mask"], 0.05,
                     torch.Generator(device=cuda).manual_seed(0))
    model = GRINModel(1, 16, n_nodes=n, ff_size=16,
                      generator=torch.Generator().manual_seed(0)).to(cuda)
    out = {}
    for mode in ("bsr", "dense"):
        sup = diff_conv_support(g, operator_mode=mode, device=cuda)
        m = copy.deepcopy(model)
        before = bsr_spmm.launches
        loss = imputer_loss(m, batch, lambda b, tr: (
            (b["x"], sup), {"mask": b["mask"]}), keep)
        torch.cuda.synchronize()
        fwd = bsr_spmm.launches - before
        loss.backward()
        out[mode] = (float(loss.detach()), fwd, {k: p.grad for k, p in
                                         m.named_parameters()})
    assert out["bsr"][1] == 2 * s * 10 and out["dense"][1] == 0
    assert abs(out["bsr"][0] - out["dense"][0]) <= 1e-5 * out["dense"][0]
    for k, want in out["dense"][2].items():
        got = out["bsr"][2][k]
        assert float((got - want).abs().max()) <= \
            1e-4 * max(float(want.abs().max()), 1e-6), k


def _graph_conv_step(cuda, model, n, s):
    """One masked-MAE step of ``model`` (``STCNModel`` or
    ``RNNEncGCNDecModel``, the traffic runner's call ``(x, op), {u}``) on
    a BSR operator and on the dense one from the same weights and batch:
    ``{mode: (loss, K1 launches forward, K1 launches in all, grads)}``."""
    import copy
    rng = np.random.default_rng(7)
    g = _graph(rng, n, 12 * n)
    x = torch.as_tensor(rng.standard_normal((4, s, n, 2)).astype(
        np.float32), device=cuda)
    u = torch.as_tensor(rng.standard_normal((4, s, 3)).astype(np.float32),
                        device=cuda)
    y = torch.as_tensor(rng.standard_normal((4, 3, n, 2)).astype(
        np.float32), device=cuda)
    out = {}
    for mode in ("bsr", "dense"):
        op = build_operator(g, mode, device=cuda)
        m = copy.deepcopy(model)
        before = bsr_spmm.launches
        loss = (m(x, op, u=u) - y).abs().mean()
        torch.cuda.synchronize()
        fwd = bsr_spmm.launches - before
        loss.backward()
        torch.cuda.synchronize()
        out[mode] = (float(loss.detach()), fwd, bsr_spmm.launches - before,
                     {k: p.grad for k, p in m.named_parameters()})
    return out


def _bsr_step_matches_dense(out, launches):
    """The losses within 1e-5 relative, every gradient within 1e-4 of its
    parameter's largest (f32 sums in other orders: K1's tiles against the
    SGEMM's k-split), K1 once forward and once (transposed) backward a
    GraphConv, none on the dense route."""
    assert out["bsr"][1] == launches and out["bsr"][2] == 2 * launches
    assert out["dense"][2] == 0
    assert abs(out["bsr"][0] - out["dense"][0]) <= 1e-5 * out["dense"][0]
    for k, want in out["dense"][3].items():
        got = out["bsr"][3][k]
        assert float((got - want).abs().max()) <= \
            1e-4 * max(float(want.abs().max()), 1e-6), k


def test_stcn_step_on_bsr_matches_dense(cuda):
    """``STCNModel`` with two blocks (F = batch x window x hidden at each
    GraphConv) on a ragged 700-node graph."""
    from sgp_tpu_torch.models import STCNModel
    model = STCNModel(5, 16, 32, 2, 3, n_layers=2,
                      generator=torch.Generator().manual_seed(0)).to(cuda)
    _bsr_step_matches_dense(_graph_conv_step(cuda, model, 700, 6), 2)


def test_rnn2gcn_step_on_bsr_matches_dense(cuda):
    """``RNNEncGCNDecModel`` with two decoder GraphConvs (F = batch x
    hidden) on a ragged 700-node graph."""
    from sgp_tpu_torch.models import RNNEncGCNDecModel
    model = RNNEncGCNDecModel(5, 16, 2, 3, gcn_layers=2,
                              generator=torch.Generator().manual_seed(0)
                              ).to(cuda)
    _bsr_step_matches_dense(_graph_conv_step(cuda, model, 700, 6), 2)


@pytest.mark.parametrize("period,masked", [(336, True), (2016, False)])
def test_correntropy_on_the_card_matches_cpu(cuda, period, masked):
    """The windowed correntropy at CER-En's and PV-US's weekly periods
    (1,024 nodes, 4 windows of a shared daily course plus noise) on the
    card against the CPU port, and against float64 on the card: 1e-5."""
    from sgp_tpu_torch.graph.similarities import correntropy
    rng = np.random.default_rng(0)
    t, n = 4 * period + 1, 1024
    day = np.sin(2 * np.pi * np.arange(t) / (period // 7))[:, None]
    x = (day * (0.95 + 0.1 * rng.random(n))
         + 0.1 * rng.standard_normal((t, n))).astype(np.float32)
    x = (x - x.mean()) / x.std()
    mask = rng.random((t, n)) > 0.001 if masked else None
    got = correntropy(x, period, mask=mask, device=cuda)
    cpu = correntropy(x, period, mask=mask, device="cpu")
    exact = correntropy(x.astype(np.float64), period, mask=mask, device=cuda)
    assert np.abs(got - cpu).max() <= 1e-5
    assert np.abs(got - exact).max() <= 1e-5
    if mask is None:                      # (masked pairs may share no
        assert (got > 0).mean() > 0.99    # valid window: 0) off underflow


def test_k1_on_the_cer_graph_matches_plain(cuda):
    """K1 at N 6,435 (a ragged last block row: 50 x 128 + 35) on a 100-nn
    graph that fills every block position, F 128 and 6,144, f32 and bf16
    tiles, against its plain version; two calls give the same bits."""
    from sgp_tpu_torch.graph.similarities import top_k
    rng = np.random.default_rng(0)
    n = 6435
    sim = rng.random((n, n)).astype(np.float32)
    g = normalize_adj(Graph.from_dense(top_k(sim, 100, keep_values=True)))
    for precision, tol in (("highest", 1e-5), ("default", 1e-2)):
        op = build_operator(g, "bsr", precision=precision, device=cuda)
        assert op.blocks.shape[0] == 51 * 51
        n_br = op.row_ptr.numel() - 1
        for f in (128, 6144):
            x = torch.as_tensor(rng.standard_normal((n, f)).astype(
                np.float32), device=cuda)
            args = (op.blocks, op.block_cols, op.row_ptr, op.block_rows)
            got, again = bsr_spmm(*args, x), bsr_spmm(*args, x)
            ref = torch.cat([bsr_spmm_plain(
                op.blocks, op.block_cols, op.block_rows, n_br,
                x[:, s:s + 2048]) for s in range(0, f, 2048)], dim=1)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            err = (got.float() - ref.float()).abs().max()
            assert err <= tol * ref.float().abs().max(), (precision, f, err)
