"""The port's ``GatedGraphNetwork`` layer and ``GatedGraphNetworkMLPModel``
against flax with the same weights (carried across by ``models/bridge.py``),
forward and gradients.

The JAX side runs its fused ELL kernel through the Pallas interpreter
(``graph_layers.ELL_PALLAS = True``, set and restored here); the port runs
``gn_ell_aggregate``'s plain version, the CPU side of kernel K4. The dense
all-pairs layout (``adj=``, ``adj_band=``) is held against both JAX paths:
its blocked XLA math and its Pallas kernel (``ALLPAIRS_PALLAS = True``); the
port runs ``gn_allpairs_aggregate``'s plain version, the CPU side of kernel
K3. Tolerance 1e-4 (f32; the same products summed in other orders through
two layers).

Also ``GatedGraphNetworkConvModel`` (the CNN window encoder) on carried
weights at 1e-5, and with ``neigh``/``adj`` passed, which both packages'
conv models ignore; and ``compute_dtype="bfloat16"`` on the edge, ELL and
all-pairs layouts at 2e-2 of the largest output (see
``test_model_bf16_matches_flax``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.graph.sparse import padded_incoming as j_padded_incoming
from sgp_tpu.models import graph_layers as j_graph_layers
from sgp_tpu.models.gated_gn import GatedGraphNetworkConvModel as JConvModel
from sgp_tpu.models.gated_gn import GatedGraphNetworkMLPModel as JModel
from sgp_tpu.models.graph_layers import GatedGraphNetwork as JLayer

from sgp_tpu_torch.graph import Graph, band_windows, coalesce, padded_incoming
from sgp_tpu_torch.models import (GatedGraphNetwork,
                                  GatedGraphNetworkConvModel,
                                  GatedGraphNetworkMLPModel, flax_to_torch)
from sgp_tpu_torch.models import graph_layers
from sgp_tpu_torch.models.bridge import (_gated_gn_targets, _gn_layer, _load,
                                         targets, to_torch_layout)
from sgp_tpu_torch.ops import gn_ell

torch.set_num_threads(1)

N = 12
TOL = 1e-4


def _graph(seed=0, n=N, max_deg=5):
    """Each node takes 0..max_deg distinct sources; node 3 takes none."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for i in range(n):
        k = 0 if i == 3 else int(rng.integers(1, max_deg + 1))
        src += list(rng.choice(n, k, replace=False))
        dst += [i] * k
    return coalesce(Graph(np.asarray(src), np.asarray(dst),
                          np.ones(len(src), np.float32), n))


def _neigh(g):
    si, nm = padded_incoming(g)
    return (si, nm), (torch.as_tensor(si), torch.as_tensor(nm))


def _ell_pallas(fn):
    j_graph_layers.ELL_PALLAS = True
    try:
        return fn()
    finally:
        j_graph_layers.ELL_PALLAS = None


def _allpairs_pallas(fn):
    j_graph_layers.ALLPAIRS_PALLAS = True
    try:
        return fn()
    finally:
        j_graph_layers.ALLPAIRS_PALLAS = None


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=name)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _check_grads(targets, jgrads):
    flat = _flat(jgrads["params"])
    assert set(flat) == set(targets)
    for path, (param, transpose) in targets.items():
        want = flat[path].T if transpose else flat[path]
        _close(param.grad, want, TOL, "/".join(path))


def test_padded_incoming_matches_jax():
    g = _graph(1)
    for pad_to in (None, 9):
        si, nm = padded_incoming(g, pad_to)
        jsi, jnm = j_padded_incoming(g, pad_to)
        assert si.dtype == jsi.dtype and nm.dtype == jnm.dtype
        assert np.array_equal(si, jsi) and np.array_equal(nm, jnm)
    with pytest.raises(ValueError):
        padded_incoming(g, 2)


@pytest.mark.parametrize("in_size,activation", [(6, "silu"), (16, "tanh"),
                                                (6, "elu")])
def test_layer_ell_matches_flax(in_size, activation):
    rng = np.random.default_rng(2)
    (si, nm), tneigh = _neigh(_graph(2))
    x = rng.standard_normal((2, N, in_size)).astype(np.float32)
    jl = JLayer(output_size=16, activation=activation)
    params = jl.init(jax.random.PRNGKey(0), x, neigh=(si, nm))
    tl = GatedGraphNetwork(in_size, 16, activation)
    targets = {}
    _gn_layer(targets, (), tl)
    _load(jax.tree.map(np.asarray, params), targets)
    assert (tl.skip is None) == (in_size == 16)

    def loss_j(p):
        return jnp.sum(jnp.sin(jl.apply(p, x, neigh=(si, nm))))

    want = _ell_pallas(lambda: jl.apply(params, x, neigh=(si, nm)))
    jgrads = _ell_pallas(lambda: jax.grad(loss_j)(params))
    got = tl(torch.as_tensor(x), neigh=tneigh)
    _close(got, want)
    torch.sin(got).sum().backward()
    _check_grads(targets, jgrads)


def test_layer_edge_list_matches_flax_and_ell():
    rng = np.random.default_rng(3)
    g = _graph(3)
    _, tneigh = _neigh(g)
    x = rng.standard_normal((3, N, 8)).astype(np.float32)
    src, dst = g.src.astype(np.int32), g.dst.astype(np.int32)
    jl = JLayer(output_size=8, sorted_edges=True)
    params = jl.init(jax.random.PRNGKey(1), x, src, dst)
    tl = GatedGraphNetwork(8, 8)
    targets = {}
    _gn_layer(targets, (), tl)
    _load(jax.tree.map(np.asarray, params), targets)
    got = tl(torch.as_tensor(x), torch.as_tensor(src), torch.as_tensor(dst))
    _close(got, jl.apply(params, x, src, dst))
    ell = tl(torch.as_tensor(x), neigh=tneigh)
    _close(ell, got.detach().numpy(), 2e-5)
    # padding edges masked out of the edge list change nothing
    pad_src = np.concatenate([src, [0, 5]]).astype(np.int64)
    pad_dst = np.concatenate([dst, [1, 2]]).astype(np.int64)
    em = torch.as_tensor(np.r_[np.ones(len(src)), [0, 0]].astype(np.float32))
    padded = tl(torch.as_tensor(x), torch.as_tensor(pad_src),
                torch.as_tensor(pad_dst), edge_mask=em)
    _close(padded, got.detach().numpy(), 1e-6)


def test_layer_plain_ell_math_matches_kernel_path(monkeypatch):
    """The layer's plain ELL math (taken by an activation outside the
    kernel's table) and the unfused ``gn_ell_reference`` swapped in for
    ``gn_ell_aggregate`` (the reference ``chip_smoke.py`` holds the card's
    training run against) agree with the kernel path, values and
    gradients."""
    rng = np.random.default_rng(4)
    g = _graph(4)
    _, tneigh = _neigh(g)
    x = torch.as_tensor(rng.standard_normal((2, N, 8)).astype(np.float32))
    tl = GatedGraphNetwork(8, 16)
    tl.reset_parameters(torch.Generator().manual_seed(0))

    def run():
        tl.zero_grad()
        out = tl(x, neigh=tneigh)
        out.square().sum().backward()
        return out.detach().numpy(), {k: p.grad.numpy().copy()
                                      for k, p in tl.named_parameters()}

    want, want_g = run()
    for name, value in (("ACTIVATIONS", {}),
                        ("gn_ell_aggregate", gn_ell.gn_ell_reference)):
        with monkeypatch.context() as m:
            m.setattr(graph_layers, name, value)
            got, got_g = run()
        _close(torch.as_tensor(got), want, 2e-5)
        for k in want_g:
            _close(torch.as_tensor(got_g[k]), want_g[k], 5e-5)
    tl.activation = "gelu"
    assert torch.isfinite(tl(x, neigh=tneigh)).all()
    # outside the table the dense layout takes the blocked plain math, the
    # same function as the edge list
    edges = tl(x, torch.as_tensor(g.src), torch.as_tensor(g.dst))
    _close(tl(x, adj=torch.as_tensor(g.to_dense())), edges.detach().numpy(),
           2e-5)


def _adj_band(g, uniform):
    """The dense mask of ``g`` and its band windows (blocks of 4 rows)."""
    adj = g.to_dense()
    if uniform is None:
        return adj, None
    return adj, band_windows(adj, block=4, width_mult=4, uniform=uniform)


def _local_graph(seed=9, n=2 * N):
    """Sources within 3 of each destination: the windows cut columns."""
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(n), 3)
    src = np.clip(dst + rng.integers(-3, 4, len(dst)), 0, n - 1)
    return coalesce(Graph(src, dst, np.ones(len(src), np.float32), n))


@pytest.mark.parametrize("activation,jax_path,uniform", [
    ("silu", "xla", None), ("tanh", "pallas", None), ("elu", "xla", True),
    ("relu", "xla", False), ("gelu", "xla", False)])
def test_layer_allpairs_matches_flax(activation, jax_path, uniform):
    """``adj`` (and ``adj_band``) against the flax layer's blocked XLA path
    or its Pallas kernel (a full sweep only), values and gradients; gelu
    takes both sides' plain math."""
    rng = np.random.default_rng(10)
    g = _local_graph()
    adj, band = _adj_band(g, uniform)
    if band is not None:
        widths = band[1] if uniform is False else (band[1],)
        assert max(widths) < 2 * N
    x = rng.standard_normal((2, 2 * N, 6)).astype(np.float32)
    jl = JLayer(output_size=16, activation=activation)
    params = jl.init(jax.random.PRNGKey(6), x, adj=adj, adj_band=band)
    tl = GatedGraphNetwork(6, 16, activation)
    targets = {}
    _gn_layer(targets, (), tl)
    _load(jax.tree.map(np.asarray, params), targets)

    def loss_j(p):
        return jnp.sum(jnp.sin(jl.apply(p, x, adj=adj, adj_band=band)))

    run = _allpairs_pallas if jax_path == "pallas" else (lambda fn: fn())
    want = run(lambda: jl.apply(params, x, adj=adj, adj_band=band))
    jgrads = run(lambda: jax.grad(loss_j)(params))
    got = tl(torch.as_tensor(x), adj=torch.as_tensor(adj), adj_band=band)
    _close(got, want)
    torch.sin(got).sum().backward()
    _check_grads(targets, jgrads)


def _models(**kw):
    common = dict(input_window_size=4, hidden_size=16, output_size=1,
                  horizon=3, n_nodes=N, enc_layers=2, gnn_layers=2,
                  positional_encoding=True, activation="silu")
    common.update(kw)
    jm = JModel(**common)
    tm = GatedGraphNetworkMLPModel(input_size=3, **common)
    return jm, tm


def _model_inputs(seed=5, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 6, n, 1)).astype(np.float32)   # [b s n f]
    u = rng.standard_normal((2, 6, 2)).astype(np.float32)      # global exog
    return x, u


@pytest.mark.parametrize("positional_encoding", [True, False])
def test_model_ell_matches_flax(positional_encoding):
    (si, nm), tneigh = _neigh(_graph(5))
    x, u = _model_inputs()
    jm, tm = _models(positional_encoding=positional_encoding)
    params = jm.init(jax.random.PRNGKey(2), x, u=u, neigh=(si, nm))
    flax_to_torch(jax.tree.map(np.asarray, params), tm)

    def loss_j(p):
        return jnp.sum(jnp.abs(jm.apply(p, x, u=u, neigh=(si, nm)) - 0.3))

    want = _ell_pallas(lambda: jm.apply(params, x, u=u, neigh=(si, nm)))
    jgrads = _ell_pallas(lambda: jax.grad(loss_j)(params))
    got = tm(torch.as_tensor(x), u=torch.as_tensor(u), neigh=tneigh)
    assert got.shape == (2, 3, N, 1)
    _close(got, want)
    (got - 0.3).abs().sum().backward()
    _check_grads(_gated_gn_targets(tm), jgrads)


def test_model_full_graph_matches_flax():
    """No graph given: both build the all-pairs edge list."""
    x, u = _model_inputs(6)
    jm, tm = _models(gnn_layers=1, enc_layers=1, activation="tanh")
    params = jm.init(jax.random.PRNGKey(3), x, u=u)
    flax_to_torch(jax.tree.map(np.asarray, params), tm)
    _close(tm(torch.as_tensor(x), u=torch.as_tensor(u)),
           jm.apply(params, x, u=u))


@pytest.mark.parametrize("uniform", [None, False])
def test_model_allpairs_matches_flax(uniform):
    """The whole model on the dense mask (and windows), values and
    gradients, against flax's blocked XLA path."""
    g = _local_graph(11)
    adj, band = _adj_band(g, uniform)
    x, u = _model_inputs(11, 2 * N)
    jm, tm = _models(n_nodes=2 * N)
    params = jm.init(jax.random.PRNGKey(7), x, u=u, adj=adj, adj_band=band)
    flax_to_torch(jax.tree.map(np.asarray, params), tm)

    def loss_j(p):
        return jnp.sum(jnp.abs(jm.apply(p, x, u=u, adj=adj, adj_band=band)
                               - 0.3))

    want = jm.apply(params, x, u=u, adj=adj, adj_band=band)
    jgrads = jax.grad(loss_j)(params)
    got = tm(torch.as_tensor(x), u=torch.as_tensor(u),
             adj=torch.as_tensor(adj), adj_band=band)
    assert got.shape == (2, 3, 2 * N, 1)
    _close(got, want)
    (got - 0.3).abs().sum().backward()
    _check_grads(_gated_gn_targets(tm), jgrads)


def test_bridge_serves_every_layout():
    """One parameter tree for every aggregation layout: flax inits with the
    ELL table and with the dense mask give the same tree, and the port,
    loaded once through the bridge, gives JAX's output with ``neigh``,
    ``adj`` and the edge list alike."""
    g = _graph(12)
    (si, nm), tneigh = _neigh(g)
    adj = g.to_dense()
    x, u = _model_inputs(12)
    jm, tm = _models()
    p_ell = jm.init(jax.random.PRNGKey(8), x, u=u, neigh=(si, nm))
    p_adj = jm.init(jax.random.PRNGKey(8), x, u=u, adj=adj)
    assert jax.tree.structure(p_ell) == jax.tree.structure(p_adj)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(p_ell),
                                                   jax.tree.leaves(p_adj)))
    flax_to_torch(jax.tree.map(np.asarray, p_ell), tm)
    want = np.asarray(jm.apply(p_ell, x, u=u, adj=adj))
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    src, dst = torch.as_tensor(g.src), torch.as_tensor(g.dst)
    for kw in (dict(adj=torch.as_tensor(adj)), dict(neigh=tneigh),
               dict(src=src, dst=dst)):
        _close(tm(tx, u=tu, **kw), want)


def test_bridge_pins_the_encoder_block_order():
    """Inside ``Dense(h)(act(Dense(h)(h)))`` the outer Dense is
    ``Dense_1``: loading it into the inner Linear changes the output."""
    (si, nm), tneigh = _neigh(_graph(7))
    x, u = _model_inputs(7)
    jm, tm = _models(enc_layers=1)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(4), x, u=u, neigh=(si, nm)))
    flax_to_torch(params, tm)
    want = np.asarray(jm.apply(params, x, u=u, neigh=(si, nm)))
    _close(tm(torch.as_tensor(x), u=torch.as_tensor(u), neigh=tneigh), want)
    inner = params["params"]
    inner["Dense_1"], inner["Dense_2"] = inner["Dense_2"], inner["Dense_1"]
    flax_to_torch(params, tm)
    swapped = tm(torch.as_tensor(x), u=torch.as_tensor(u), neigh=tneigh)
    assert np.abs(swapped.detach().numpy() - want).max() > 1e-3


def test_bridge_rejects_missing_extra_and_misshapen_keys():
    x, u = _model_inputs(8)
    jm, tm = _models()
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5), x, u=u))
    inner = dict(params["params"])
    with pytest.raises(KeyError):
        flax_to_torch({**inner, "Dense_9": {"kernel": np.zeros((2, 2))}}, tm)
    missing = {k: v for k, v in inner.items()
               if k != "StaticGraphEmbedding_0"}
    with pytest.raises(KeyError):
        flax_to_torch(missing, tm)
    gn0 = dict(inner["GatedGraphNetwork_0"])
    gn0["Dense_1"] = {"kernel": np.zeros((16, 9), np.float32)}
    with pytest.raises(ValueError):
        flax_to_torch({**inner, "GatedGraphNetwork_0": gn0}, tm)
    _, other = _models(gnn_layers=1)
    with pytest.raises(KeyError):
        flax_to_torch(params, other)
    with pytest.raises(TypeError):
        flax_to_torch(params, torch.nn.Linear(2, 2))


TOL_BF16 = 2e-2        # of the largest output: a bf16 ulp is 2^-8
TOL_BF16_GRAD = 6e-2   # of each gradient's largest value


def _bf16_case(layout):
    """A graph, inputs and the graph keywords of ``layout`` for both
    packages."""
    g, n = (_local_graph(11), 2 * N) if layout.startswith("dense") \
        else (_graph(5), N)
    x, u = _model_inputs(5, n)
    if layout == "edges":
        s, d = g.src.astype(np.int32), g.dst.astype(np.int32)
        return n, x, u, dict(src=s, dst=d), dict(src=torch.as_tensor(s),
                                                 dst=torch.as_tensor(d))
    if layout == "ell":
        (si, nm), tneigh = _neigh(g)
        return n, x, u, dict(neigh=(si, nm)), dict(neigh=tneigh)
    adj = g.to_dense()
    return n, x, u, dict(adj=adj), dict(adj=torch.as_tensor(adj))


@pytest.mark.parametrize("layout", ["edges", "ell", "dense-xla",
                                    "dense-pallas"])
def test_model_bf16_matches_flax(monkeypatch, layout):
    """``compute_dtype="bfloat16"`` against flax's on the same weights:
    the output within TOL_BF16 of its largest value (measured 4.0e-3 to
    5.4e-3: bf16 roundings at other places, the ELL layout against the
    Pallas kernel, the dense one against both JAX paths), the gradients
    within TOL_BF16_GRAD of each tensor's largest (measured 1.3e-2 to
    3.5e-2). The kernels' entries get bf16 projections, and the output
    differs from the float32 model's."""
    n, x, u, kw_j, kw_t = _bf16_case(layout)
    jm, tm = _models(n_nodes=n, compute_dtype="bfloat16")
    _, tm32 = _models(n_nodes=n)
    params = jm.init(jax.random.PRNGKey(2), x, u=u, **kw_j)
    flax_to_torch(jax.tree.map(np.asarray, params), tm)
    flax_to_torch(jax.tree.map(np.asarray, params), tm32)
    run = {"ell": _ell_pallas, "dense-pallas": _allpairs_pallas}.get(
        layout, lambda fn: fn())

    def loss_j(p):
        return jnp.sum(jnp.abs(jm.apply(p, x, u=u, **kw_j) - 0.3))

    want = run(lambda: jm.apply(params, x, u=u, **kw_j))
    jgrads = run(lambda: jax.jit(jax.grad(loss_j))(params))
    seen = []
    for name in ("gn_ell_aggregate", "gn_allpairs_aggregate"):
        fn = getattr(graph_layers, name)
        monkeypatch.setattr(graph_layers, name,
                            lambda *a, fn=fn: seen.append(a[1].dtype)
                            or fn(*a))
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    got = tm(tx, u=tu, **kw_t)
    assert got.dtype == torch.float32
    assert seen == ([] if layout == "edges" else [torch.bfloat16] * 2)
    top = float(np.abs(np.asarray(want)).max())
    _close(got, want, TOL_BF16 * top)
    f32 = tm32(tx, u=tu, **kw_t).detach().numpy()
    assert np.abs(got.detach().numpy() - f32).max() > 1e-3 * top
    (got - 0.3).abs().sum().backward()
    flat = _flat(jax.tree.map(np.asarray, jgrads)["params"])
    for path, (param, transpose) in _gated_gn_targets(tm).items():
        w = flat[path].T if transpose else flat[path]
        _close(param.grad, w, TOL_BF16_GRAD * float(np.abs(w).max()),
               "/".join(path))


def test_model_options_not_ported_raise():
    """bf16 is ported (``test_model_bf16_matches_flax``); a compute dtype
    neither float32 nor bf16 raises."""
    _, tm = _models(compute_dtype="bfloat16")
    assert all(layer.dtype == torch.bfloat16 for layer in tm.gnn)
    assert _models(compute_dtype="float32")[1].gnn[0].dtype is None
    with pytest.raises(ValueError):
        _models(compute_dtype="float16")


def _conv_models(**kw):
    common = dict(input_window_size=12, hidden_size=16, output_size=1,
                  horizon=3, n_nodes=N, enc_layers=2, gnn_layers=2,
                  positional_encoding=True, activation="silu")
    common.update(kw)
    return JConvModel(**common), GatedGraphNetworkConvModel(input_size=3,
                                                            **common)


@pytest.mark.parametrize("window", [12, 36, 1])
def test_conv_model_matches_flax(window):
    """``GatedGraphNetworkConvModel`` (the strided residual CNN encoder,
    flax ``nn.Conv`` kernels carried into ``Conv1d``) against flax on the
    edge list, values and gradients at 1e-5 relative to the largest
    (f32). Window 36 runs the config's three layers, 36 -> 8 -> 2 -> 1."""
    g = _graph(13)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, max(window, 6), N, 1)).astype(np.float32)
    u = rng.standard_normal((2, max(window, 6), 2)).astype(np.float32)
    s, d = g.src.astype(np.int32), g.dst.astype(np.int32)
    jm, tm = _conv_models(input_window_size=window)
    params = jm.init(jax.random.PRNGKey(9), x, s, d, u=u)
    flax_to_torch(jax.tree.map(np.asarray, params), tm)
    if window == 36:
        assert [c.weight.shape[0] for c in tm.cnn.convs] == [16, 32, 64]
        assert tm.cnn.pads == [4, 2, 3]

    def loss_j(p):
        return jnp.sum(jnp.abs(jm.apply(p, x, s, d, u=u) - 0.3))

    want = jm.apply(params, x, s, d, u=u)
    jgrads = jax.jit(jax.grad(loss_j))(params)
    got = tm(torch.as_tensor(x), torch.as_tensor(s), torch.as_tensor(d),
             u=torch.as_tensor(u))
    top = float(np.abs(np.asarray(want)).max())
    _close(got, want, 1e-5 * top)
    (got - 0.3).abs().sum().backward()
    flat = _flat(jax.tree.map(np.asarray, jgrads)["params"])
    for path, (param, how) in targets(tm).items():
        w = to_torch_layout(flat[path], how)
        _close(param.grad, w, 1e-5 * float(np.abs(w).max()), "/".join(path))


def test_conv_model_ignores_neigh_and_adj():
    """The JAX conv model takes ``neigh``/``adj`` in ``**kwargs`` and drops
    them, so without ``src`` it runs the all-pairs edge list: the port
    computes the same (1e-5), whatever graph is passed that way."""
    (si, nm), tneigh = _neigh(_graph(14))
    adj = _graph(15).to_dense()
    x, u = _model_inputs(14)
    x = np.concatenate([x, x], 1)                       # window 12
    u = np.concatenate([u, u], 1)
    jm, tm = _conv_models()
    params = jm.init(jax.random.PRNGKey(10), x, u=u)
    flax_to_torch(jax.tree.map(np.asarray, params), tm)
    want = np.asarray(jm.apply(params, x, u=u))
    top = float(np.abs(want).max())
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    for j_kw, t_kw in ((dict(neigh=(si, nm)), dict(neigh=tneigh)),
                       (dict(adj=adj), dict(adj=torch.as_tensor(adj))),
                       ({}, {})):
        np.testing.assert_allclose(np.asarray(jm.apply(params, x, u=u,
                                                       **j_kw)), want)
        _close(tm(tx, u=tu, **t_kw), want, 1e-5 * top)
