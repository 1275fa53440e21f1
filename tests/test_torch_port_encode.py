"""The port's spatial embedding and SGP encoder against the JAX package
(f32, rtol 1e-5 / atol 1e-6: the same products in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgp_tpu.graph as jg
from sgp_tpu.encode import SGPEncoder as JEncoder
from sgp_tpu.encode import prepare_propagation_graphs as j_prep
from sgp_tpu.encode import sgp_spatial_embedding as j_embed

import sgp_tpu_torch.graph as tg
from sgp_tpu_torch.encode import SGPEncoder, prepare_propagation_graphs
from sgp_tpu_torch.encode import sgp_spatial_embedding

torch.set_num_threads(1)


def _graphs(rng, n=40, e=200):
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    return (jg.coalesce(jg.Graph(src, dst, w, n)),
            tg.coalesce(tg.Graph(src, dst, w, n)))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(b, np.float32),
                               np.asarray(a, np.float32),
                               rtol=1e-5, atol=1e-6)


FLAGS = [dict(), dict(bidirectional=True), dict(undirected=True),
         dict(add_loops=True, bidirectional=True), dict(remove_loops=True)]


@pytest.mark.parametrize("flags", FLAGS)
def test_prepare_propagation_graphs_bit_exact(rng, flags):
    jgr, tgr = _graphs(rng)
    a, b = j_prep(jgr, **flags), prepare_propagation_graphs(tgr, **flags)
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        for name in ("src", "dst", "weight"):
            np.testing.assert_array_equal(getattr(ga, name),
                                          getattr(gb, name))


@pytest.mark.parametrize("mode", ["dense", "bsr", "coo"])
@pytest.mark.parametrize("flags", FLAGS[:3])
def test_spatial_embedding_matches(rng, mode, flags):
    jgr, tgr = _graphs(rng)
    x = rng.standard_normal((3, 40, 5)).astype(np.float32)
    a = j_embed(jnp.asarray(x), jgr, k=2, operator_mode=mode, **flags)
    b = sgp_spatial_embedding(torch.as_tensor(x), tgr, k=2,
                              operator_mode=mode, **flags)
    assert len(a) == len(b)
    for ya, yb in zip(a, b):
        _close(ya, yb)


@pytest.mark.parametrize("kw", [
    dict(receptive_field=2, global_attr=True, operator_mode="bsr"),
    dict(receptive_field=1, bidirectional=True, operator_mode="dense"),
])
def test_sgp_encoder_matches(rng, kw):
    jgr, tgr = _graphs(rng)
    x = rng.standard_normal((12, 40, 2)).astype(np.float32)
    common = dict(input_size=2, reservoir_size=6, reservoir_layers=2,
                  alpha_decay=True, seed=5, **kw)
    je, te = JEncoder(**common), SGPEncoder(**common, device="cpu")
    assert je.output_size == te.output_size
    _close(je(jnp.asarray(x), jgr), te(torch.as_tensor(x), tgr))
    _close(je(jnp.asarray(x), jgr, time_chunk=5),
           te(torch.as_tensor(x), tgr, time_chunk=5))
