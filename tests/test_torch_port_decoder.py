"""The port's ``SGPModel`` against flax's ``model.apply`` with the same
weights, carried across by ``models/bridge.py`` (f32, rtol 1e-5 /
atol 1e-5: the same products in another order)."""
import jax
import numpy as np
import pytest
import torch

from sgp_tpu.models import SGPModel as JModel

from sgp_tpu_torch.models import SGPModel, flax_to_torch

torch.set_num_threads(1)

N, D, ORDER, HORIZON = 7, 24, 4, 3


def _models(**kw):
    common = dict(input_size=D, order=ORDER, n_nodes=N, hidden_size=14,
                  mlp_size=8, output_size=2, n_layers=2, horizon=HORIZON)
    common.update(kw)
    return JModel(**common), SGPModel(**common)


def _bridge(jm, tm, x, **kwargs):
    params = jm.init(jax.random.PRNGKey(0), x, **kwargs)
    flax_to_torch(jax.tree.map(np.asarray, params), tm.eval())
    return params


def _close(a, b):
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("resnet", [True, False])
@pytest.mark.parametrize("positional_encoding", [True, False])
@pytest.mark.parametrize("with_u", [True, False])
def test_full_graph_forward_matches(rng, resnet, positional_encoding,
                                    with_u):
    exog = 3 if with_u else 0
    jm, tm = _models(resnet=resnet, positional_encoding=positional_encoding,
                     exog_size=exog)
    x = rng.standard_normal((5, 1, N, D)).astype(np.float32)  # [b w n f]
    u = rng.standard_normal((5, 1, exog)).astype(np.float32) \
        if with_u else None
    kw = {"u": u} if with_u else {}
    params = _bridge(jm, tm, x, **kw)
    ref = jm.apply(params, x, training=False, **kw)
    got = tm(torch.as_tensor(x),
             u=None if u is None else torch.as_tensor(u))
    assert got.shape == (5, HORIZON, N, 2)
    _close(ref, got)


@pytest.mark.parametrize("with_u", [True, False])
def test_iid_forward_matches(rng, with_u):
    jm, tm = _models(resnet=True, exog_size=3 if with_u else 0)
    x0 = rng.standard_normal((1, N, D)).astype(np.float32)
    params = _bridge(jm, tm, x0, **({"u": np.zeros((1, 3), np.float32)}
                                    if with_u else {}))
    x = rng.standard_normal((9, D)).astype(np.float32)       # [b f]
    idx = rng.integers(0, N, 9)
    u = rng.standard_normal((9, 1, 3)).astype(np.float32) if with_u \
        else None
    kw = {"u": u} if with_u else {}
    ref = jm.apply(params, x, node_index=idx, iid=True, training=False, **kw)
    got = tm(torch.as_tensor(x), node_index=torch.as_tensor(idx), iid=True,
             u=None if u is None else torch.as_tensor(u))
    assert got.shape == (9, HORIZON, 2)
    _close(ref, got)


@pytest.mark.parametrize("kw", [dict(fully_connected=True, resnet=True),
                                dict(fully_connected=True, n_layers=1)])
def test_fully_connected_forward_matches(rng, kw):
    jm, tm = _models(**kw)
    x = rng.standard_normal((4, N, D)).astype(np.float32)
    params = _bridge(jm, tm, x)
    _close(jm.apply(params, x), tm(torch.as_tensor(x)))


def test_bridge_rejects_missing_and_extra_keys(rng):
    jm, tm = _models(resnet=True)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), np.zeros((1, N, D), np.float32)))
    inner = dict(params["params"])
    extra = {**inner, "Dense_9": {"kernel": np.zeros((2, 2))}}
    with pytest.raises(KeyError):
        flax_to_torch({"params": extra}, tm)
    del inner["StaticGraphEmbedding_0"]
    with pytest.raises(KeyError):
        flax_to_torch(inner, tm)
    _, other = _models(resnet=False)
    with pytest.raises(KeyError):
        flax_to_torch(params, other)


def test_port_init_draws_flax_distributions():
    """lecun-normal kernels (truncated normal, std 1/sqrt(fan_in)), zero
    biases, U(±1/sqrt(emb)) embedding; a generator fixes the draw."""
    kw = dict(input_size=256, order=4, n_nodes=500, hidden_size=512,
              mlp_size=256, output_size=1, n_layers=1, horizon=4,
              resnet=True, emb_size=16)
    m = SGPModel(**kw, generator=torch.Generator().manual_seed(0))
    again = SGPModel(**kw, generator=torch.Generator().manual_seed(0))
    for a, b in zip(m.parameters(), again.parameters()):
        assert torch.equal(a, b)
    w = m.encoder.weight                     # [g, in/g, out/g], fan_in 256
    assert w.shape == (4, 64, 128)
    assert abs(w.std().item() - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert w.abs().max().item() <= 2 * 256 ** -0.5 / 0.8796 + 1e-6
    assert not m.encoder.bias.any() and not m.readout.linear.bias.any()
    assert m.emb.emb.abs().max().item() <= 16 ** -0.5
    lin = m.mlp.layers[0].linear.weight      # [out, in], fan_in 256
    assert abs(lin.std().item() - 256 ** -0.5) < 0.05 * 256 ** -0.5


@pytest.mark.parametrize("kind,kw", [
    ("MLP", dict(n_layers=2, output_size=3)),
    ("ResidualMLP", dict(n_layers=3, output_size=3)),
    ("ResidualMLP", dict(n_layers=2, parametrized_skip=True)),
])
def test_trunk_blocks_match_flax(rng, kind, kw):
    """The trunks SGPModel does not build (readout, identity skips), held
    against flax through the bridge's trunk mapping."""
    from sgp_tpu.models import blocks as jb

    from sgp_tpu_torch.models import blocks as tb
    from sgp_tpu_torch.models.bridge import _load, _trunk
    x = rng.standard_normal((4, 5, 6)).astype(np.float32)
    u = rng.standard_normal((4, 2)).astype(np.float32)
    jm = getattr(jb, kind)(hidden_size=6, activation="elu", **kw)
    tm = getattr(tb, kind)(input_size=8, hidden_size=6, activation="elu",
                           **kw)
    params = jm.init(jax.random.PRNGKey(3), x, u)
    targets = {}
    _trunk(targets, (), tm)
    _load(jax.tree.map(np.asarray, params), targets)
    _close(jm.apply(params, x, u), tm(torch.as_tensor(x), torch.as_tensor(u)))
