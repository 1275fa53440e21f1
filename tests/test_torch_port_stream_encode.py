"""The port's streaming SGP encode and dataset encode against the JAX
package's, on the same numpy inputs and seeds.

Tolerances: f32 output within 1e-5 of the largest value (the same f32
products in another order); bf16 output within one bf16 ulp of the larger
of the two values (a value near a rounding boundary may round the other
way after a different f32 order); the packed target and mask lanes bit for
bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgp_tpu.graph as jg
from sgp_tpu.data import SpatioTemporalDataset as JDataset
from sgp_tpu.data import RobustScaler as JRobustScaler
from sgp_tpu.data import Windowing as JWindowing
from sgp_tpu.data.datasets import SyntheticDiffusion as JSynthetic
from sgp_tpu.encode import SGPEncoder as JEncoder
from sgp_tpu.encode import SGPTemporalEncoder as JTemporal
from sgp_tpu.encode import build_streaming_ops as j_ops
from sgp_tpu.encode import encode_dataset as j_encode_dataset
from sgp_tpu.encode import streaming_encode as j_stream
from sgp_tpu.train.iid import pack_iid_data as j_pack

import sgp_tpu_torch.graph as tg
from sgp_tpu_torch.data import (RobustScaler, SpatioTemporalDataset,
                                Windowing)
from sgp_tpu_torch.data.datasets import SyntheticDiffusion
from sgp_tpu_torch.encode import (GESNEncoder, SGPEncoder,
                                  SGPSpatialEncoder, SGPTemporalEncoder,
                                  build_streaming_ops,
                                  encode_dataset, get_encoder_class,
                                  streaming_encode)
from sgp_tpu_torch.ops import build_operator
from sgp_tpu_torch.train.iid import pack_iid_data

torch.set_num_threads(1)

N, T, F = 150, 21, 2


def _graphs(rng, n=N, e=900):
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    return (jg.normalize_adj(jg.coalesce(jg.Graph(src, dst, w, n))),
            tg.normalize_adj(tg.coalesce(tg.Graph(src, dst, w, n))))


def _encoders(**kw):
    common = dict(input_size=F, reservoir_size=5, reservoir_layers=2,
                  alpha_decay=True, seed=3, receptive_field=2, **kw)
    return JEncoder(**common), SGPEncoder(**common, device="cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_within_bf16_ulp(got, want):
    got, want = _f32(got), _f32(want)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), (np.abs(got - want)[bad].max(), bad.sum())


def assert_f32_close(got, want, tol=1e-5):
    got, want = _f32(got), _f32(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


CASES = [
    dict(operator_mode="bsr", global_attr=True),
    dict(operator_mode="dense", global_attr=True),
    dict(operator_mode="dense", bidirectional=True),
    dict(operator_mode="bsr", bidirectional=True, global_attr=True),
]


@pytest.mark.parametrize("chunk", [4, 7, 64], ids=lambda c: f"chunk{c}")
@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_streaming_encode_matches_jax(rng, kw, chunk):
    """T = 21 is no multiple of 4 or 7, and below 64: a short tail chunk,
    and a single chunk."""
    jgr, tgr = _graphs(rng)
    x = rng.standard_normal((T, N, F)).astype(np.float32)
    je, te = _encoders(**kw)
    want = j_stream(je, jnp.asarray(x), jgr, time_chunk=chunk,
                    out_dtype=jnp.float32)
    got = streaming_encode(te, torch.as_tensor(x), tgr, time_chunk=chunk,
                           out_dtype=torch.float32)
    assert got.shape == want.shape == (T, N, te.output_size)
    assert_f32_close(got, want)
    # and the encoder's own whole-series forward
    assert_f32_close(got, te(torch.as_tensor(x), tgr))
    got16 = streaming_encode(te, torch.as_tensor(x), tgr, time_chunk=chunk)
    want16 = j_stream(je, jnp.asarray(x), jgr, time_chunk=chunk)
    assert got16.dtype == torch.bfloat16
    assert_within_bf16_ulp(got16, want16)


@pytest.mark.parametrize("mode", ["dense", "bsr"])
def test_streaming_encode_emits_the_packed_layout(rng, mode):
    """``extra_lanes`` (the packed target and mask lanes) are appended to
    every row as they are; the features as without them."""
    jgr, tgr = _graphs(rng)
    x = rng.standard_normal((T, N, F)).astype(np.float32)
    y = (rng.standard_normal((T, N, 1)) * 5).astype(np.float32)
    m = rng.random((T, N, 1)) > 0.2
    h_off = np.array([1, 3, 5])
    je, te = _encoders(operator_mode=mode, global_attr=True)
    j_lanes = j_pack(jnp.zeros((T, N, 0), jnp.bfloat16), jnp.asarray(y),
                     jnp.asarray(m), h_off)
    t_lanes = pack_iid_data(torch.zeros((T, N, 0), dtype=torch.bfloat16),
                            torch.as_tensor(y), torch.as_tensor(m), h_off)
    want = j_stream(je, jnp.asarray(x), jgr, time_chunk=8,
                    extra_lanes=j_lanes)
    got = streaming_encode(te, torch.as_tensor(x), tgr, time_chunk=8,
                           extra_lanes=t_lanes)
    d = te.output_size
    assert got.shape == want.shape == (T, N, d + 9)
    lanes = got[..., d:].contiguous().view(torch.int16).numpy()
    np.testing.assert_array_equal(
        lanes, t_lanes.view(torch.int16).numpy())
    # JAX's lanes differ only at low halves that read as a bf16 NaN,
    # whose payload its CPU backend canonicalizes (test_torch_port_iid)
    u16 = lanes.view(np.uint16)
    differ = u16 != np.asarray(want[..., d:]).view(np.uint16)
    assert (((u16[differ] & 0x7F80) == 0x7F80)
            & ((u16[differ] & 0x7F) != 0)).all()
    assert_within_bf16_ulp(got[..., :d], want[..., :d])


def test_dense_operator_default_precision_is_one_bf16_pass(rng):
    """The dense operator at ``precision="default"`` multiplies operands
    rounded to bf16 and sums in f32 (within 1e-6 of the largest value of a
    float64 product of the rounded operands), as the BSR operator's bf16
    tiles do; the streaming encode's dense route follows the flag."""
    _, tgr = _graphs(rng)
    x = torch.as_tensor(rng.standard_normal((3, N, 7)).astype(np.float32))
    dense = build_operator(tgr, "dense", precision="default",
                              device="cpu")
    full = build_operator(tgr, "dense", device="cpu")
    bf = lambda t: t.to(torch.bfloat16).double()
    want = torch.matmul(bf(full.mat), bf(x))
    got = dense @ x
    assert got.dtype == torch.float32 and dense.precision == "default"
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    assert not torch.equal(got, full @ x)
    with pytest.raises(ValueError, match="precision"):
        build_operator(tgr, "dense", precision="high", device="cpu")
    _, te = _encoders(operator_mode="dense")
    xs = torch.as_tensor(rng.standard_normal((T, N, F)).astype(np.float32))
    hi = streaming_encode(te, xs, tgr, out_dtype=torch.float32)
    lo = streaming_encode(te, xs, tgr, out_dtype=torch.float32,
                          precision="default")
    assert not torch.equal(hi, lo)
    torch.testing.assert_close(lo, hi, rtol=0, atol=2e-2)


def test_streaming_encode_checks_prebuilt_ops(rng):
    jgr, tgr = _graphs(rng)
    x = torch.as_tensor(rng.standard_normal((T, N, F)).astype(np.float32))
    _, te = _encoders(operator_mode="bsr")
    ops = build_streaming_ops(te, tgr, device="cpu")
    assert ops[0].precision == "highest"
    got = streaming_encode(te, x, tgr, ops=ops)
    torch.testing.assert_close(got, streaming_encode(te, x, tgr),
                               rtol=0, atol=0)
    _, other = _graphs(np.random.default_rng(1), n=N + 1)
    with pytest.raises(ValueError, match="nodes"):
        streaming_encode(te, x, tgr, ops=build_streaming_ops(
            te, other, device="cpu"))
    with pytest.raises(ValueError, match="precision"):
        streaming_encode(te, x, tgr, ops=ops, precision="default")
    _, dense = _encoders(operator_mode="dense")
    with pytest.raises(ValueError, match="precision"):
        streaming_encode(dense, x, tgr, precision="default",
                         ops=build_streaming_ops(dense, tgr, device="cpu"))
    # the JAX package refuses the same node-count mismatch
    je, _ = _encoders(operator_mode="bsr")
    with pytest.raises(ValueError, match="nodes"):
        j_stream(je, jnp.asarray(x.numpy()), jgr,
                 ops=j_ops(je, _graphs(np.random.default_rng(1),
                                       n=N + 1)[0]))


def test_temporal_encoder_and_registry(rng):
    x = rng.standard_normal((T, N, F)).astype(np.float32)
    kw = dict(input_size=F, reservoir_size=5, reservoir_layers=2, seed=4)
    je, te = JTemporal(**kw), SGPTemporalEncoder(**kw, device="cpu")
    assert je.output_size == te.output_size == 10
    assert_f32_close(te(torch.as_tensor(x)), je(jnp.asarray(x)))
    assert get_encoder_class("sgp") is SGPEncoder
    assert get_encoder_class("time") is SGPTemporalEncoder
    assert get_encoder_class("space") is SGPSpatialEncoder
    assert get_encoder_class("gesn") is GESNEncoder


def _datasets():
    out = []
    for synth, dset, win, scaler in (
            (JSynthetic, JDataset, JWindowing, JRobustScaler),
            (SyntheticDiffusion, SpatioTemporalDataset, Windowing,
             RobustScaler)):
        d = synth(num_nodes=12, num_steps=60)
        g = d.get_connectivity(knn=4, threshold=None, include_self=False)
        ds = dset(d.target, index=d.index, mask=d.mask, graph=g,
                  covariates={"u": d.datetime_encoded("day")},
                  windowing=win(window=1, horizon=6, horizon_lag=2))
        ds.fit_scaler(scaler(axis=(0, 1), quantile_range=(10., 90.)))
        out.append(ds)
    return out


@pytest.mark.parametrize("encode_exogenous,keep_raw",
                         [(True, True), (False, True), (True, False),
                          (False, False)])
def test_encode_dataset_rewires_like_jax(encode_exogenous, keep_raw):
    jds, tds = _datasets()
    kw = dict(input_size=1 + 2 * encode_exogenous, reservoir_size=4,
              receptive_field=1, global_attr=True, seed=2)
    j_encode_dataset(jds, JEncoder(**kw), encode_exogenous=encode_exogenous,
                     keep_raw=keep_raw, time_chunk=16)
    encode_dataset(tds, SGPEncoder(**kw, device="cpu"),
                   encode_exogenous=encode_exogenous, keep_raw=keep_raw,
                   time_chunk=16)
    assert tds.input_keys == jds.input_keys == ["encoded_x"]
    assert tds.exog_keys == jds.exog_keys
    assert_f32_close(tds.input_array(), np.asarray(jds.input_array()))
    ju, tu = jds.exog_array(), tds.exog_array()
    assert (ju is None) == (tu is None)
    if tu is not None:
        np.testing.assert_array_equal(tu, np.asarray(ju))


def test_encode_dataset_cache_and_store_dtype(tmp_path):
    """``store_dtype="bfloat16"`` rounds the encoding as JAX's does (held
    within a bf16 ulp); a second call loads the ``.npz`` it wrote, bit for
    bit, without encoding, onto the host or (``device_resident``) as a
    tensor on the device."""
    jds, tds = _datasets()
    kw = dict(input_size=3, reservoir_size=4, receptive_field=2, seed=2)
    path = str(tmp_path / "enc.npz")
    j_encode_dataset(jds, JEncoder(**kw), store_dtype="bfloat16")
    encode_dataset(tds, SGPEncoder(**kw, device="cpu"),
                   store_dtype="bfloat16", save_path=path)
    first = tds.input_array().copy()
    assert_within_bf16_ulp(torch.as_tensor(first),
                           np.asarray(jds.input_array(), np.float32))
    _, again = _datasets()

    class Refuses:
        def __call__(self, *a, **k):
            raise AssertionError("encoded instead of loading the cache")

    encode_dataset(again, Refuses(), store_dtype="bfloat16", save_path=path)
    np.testing.assert_array_equal(again.input_array(), first)
    # device_resident: the cached encoding goes to the device as a tensor
    # in the store dtype, holding the same values
    _, resident = _datasets()
    encode_dataset(resident, Refuses(), store_dtype="bfloat16",
                   save_path=path, device_resident=True, device="cpu")
    value = resident.covariates["encoded_x"].value
    assert isinstance(value, torch.Tensor)
    assert value.dtype == torch.bfloat16
    np.testing.assert_array_equal(value.float().numpy(), first)
