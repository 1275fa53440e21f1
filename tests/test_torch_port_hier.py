"""The port's two-level (host, chip) halo exchange
(``sgp_tpu_torch.parallel.halo``, ``build_halo_spec(chips_per_host=)``,
``halo_khop(axis=("host", "chip"))``) against the JAX package's.

The plan is held array for array (exact: both build it in numpy from the
same boundary sets), with ``dcn_bytes_per_hop``. ``halo_khop`` runs on a
2 x 2 gloo grid (``make_hier_mesh``; one spawn of 4 ranks for the whole
file) against JAX's on a 2 x 2 virtual mesh ``("host", "chip")``: f32
within 1e-5 of the largest value, the bf16 and int8 wire formats within
``tests/test_halo.py``'s 2e-2 and 8e-2 of the f32 hops; the flat exchange
on the same ranks and plan gives the same f32 bits. The sharded encode
with ``chips_per_host=2`` on that grid within 1e-5 of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from sgp_tpu.encode import Reservoir as JReservoir
from sgp_tpu.graph import Graph as JGraph
from sgp_tpu.parallel.encode import encode_series_sharded as j_encode
from sgp_tpu.parallel.halo import build_halo_spec as j_build
from sgp_tpu.parallel.halo import halo_khop as j_khop
from sgp_tpu.parallel.halo import shard_nodes as j_shard

from sgp_tpu_torch.graph import Graph, coalesce, normalize_adj
from sgp_tpu_torch.parallel import build_halo_spec, make_mesh, run_ranks
from sgp_tpu_torch.parallel.halo import halo_khop
from sgp_tpu_torch.parallel.workers import jobs_worker

torch.set_num_threads(1)

TOL = 1e-5
PAYLOAD_TOL = {"bfloat16": 2e-2, "int8": 8e-2}
HOSTS, CHIPS = 2, 2
BOTH = ("host", "chip")


def random_graph(rng, n, e):
    return normalize_adj(coalesce(Graph(
        rng.integers(0, n, e), rng.integers(0, n, e),
        rng.random(e).astype(np.float32), n)), "row")


def ring_graph(n, width, wrap=True):
    """Each node's ``width`` successors (and predecessors) along a ring;
    without ``wrap`` a path, whose first and last shards reach no other
    host."""
    src, dst = [], []
    for d in range(1, width + 1):
        a = np.arange(n if wrap else n - d)
        src += [a, (a + d) % n]
        dst += [(a + d) % n, a]
    return normalize_adj(coalesce(Graph(np.concatenate(src),
                                        np.concatenate(dst), None, n)),
                         "row")


def to_jax(g):
    return JGraph(g.src, g.dst, g.weight, g.num_nodes)


def jax_hier_mesh():
    return JMesh(np.array(jax.devices()[:HOSTS * CHIPS]).reshape(
        HOSTS, CHIPS), BOTH)


@pytest.mark.parametrize("payload", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("order", ["natural", "rcm"])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("s, c", [(8, 4), (8, 8), (8, 2)])
def test_hier_plan_matches_jax(rng, s, c, depth, order, payload):
    """``send_intra``, ``send_cross``, ``assemble``, C, H, ``b_intra``,
    ``b_cross`` and ``dcn_bytes_per_hop``, on a random graph (every shard
    pair talks) and a ring (only neighbours); one host (8, 8) builds the
    plan with H 1 and no cross-host bytes."""
    for g in (random_graph(rng, 150, 1200), ring_graph(96, 3)):
        got = build_halo_spec(g, s, order=order, depth=depth,
                              payload_dtype=payload, chips_per_host=c)
        want = j_build(to_jax(g), s, order=order, depth=depth,
                       payload_dtype=payload, chips_per_host=c,
                       host_only=True)
        assert len(got.hier) == len(want.hier) == 7
        for a, b in zip(got.hier, want.hier):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for f in (1, 16, 128):
            assert got.dcn_bytes_per_hop(f) == want.dcn_bytes_per_hop(f)
            assert got.bytes_per_hop(f) == want.bytes_per_hop(f)
        if s == c:
            assert got.hier[4] == 1 and got.dcn_bytes_per_hop(16) == 0


def test_hier_plan_edges(rng):
    """Shards that are no multiple of the chips a host raise as in JAX;
    fewer shards than chips build no two-level plan; a tuple axis without
    a two-level plan raises; a flat plan sends nothing across hosts."""
    g = random_graph(rng, 40, 200)
    for build in (build_halo_spec, lambda *a, **k: j_build(
            to_jax(a[0]), *a[1:], host_only=True, **k)):
        with pytest.raises(ValueError, match="multiple of chips_per_host"):
            build(g, 6, chips_per_host=4)
        assert build(g, 2, chips_per_host=4).hier is None
    spec = build_halo_spec(g, 1)
    assert spec.dcn_bytes_per_hop(16) == 0
    x = torch.zeros(spec.nodes_per_shard, 3)
    with pytest.raises(ValueError, match="chips_per_host"):
        halo_khop(spec, x, make_mesh(1, 1), axis=BOTH)
    # the ring's first and last shards need no other host: their cross
    # sections stay empty and every slot they read is an intra-host one
    path = build_halo_spec(ring_graph(64, 2, wrap=False), 4,
                           chips_per_host=2)
    send_intra, send_cross, assemble, c, h, bi, bc = path.hier
    for i in (0, 3):
        peers = np.nonzero(path.boundary_counts[i])[0]
        assert all(j // c == i // c for j in peers)
        used = np.concatenate([assemble[i, j * path.b_max:j * path.b_max
                                        + path.boundary_counts[i, j]]
                               for j in peers])
        assert (used < c * bi).all()


# (graph, build kwargs, k, concat) of each case on the 2 x 2 grid
CASES = [
    ("ring", dict(mode="dense"), 2, False),
    ("random", dict(mode="coo", payload_dtype="bfloat16"), 1, False),
    ("ring", dict(mode="dense", payload_dtype="int8"), 1, False),
    ("random", dict(mode="coo", depth=2, order="rcm"), 3, True),
    ("path", dict(mode="bsr"), 2, True),
]


def _jax_hier(g, x, case, k, concat):
    mesh = jax_hier_mesh()
    spec = j_build(to_jax(g), HOSTS * CHIPS, chips_per_host=CHIPS, **case)
    pad = spec.n_shards * spec.nodes_per_shard - g.num_nodes
    xp = np.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, pad), (0, 0)])
    with mesh:
        out = j_khop(spec, j_shard(jnp.asarray(xp), mesh, BOTH), mesh, k=k,
                     axis=BOTH, concat=concat)
    return np.asarray(out)[..., :g.num_nodes, :]


def test_two_level_halo_khop_and_encode_match_jax(rng, tmp_path):
    """One spawn of 4 gloo ranks as (host 2, chip 2): each case of
    ``CASES`` (dense, coo, bsr through K1's plain version; the three wire
    formats; depth 2 under RCM; a path graph whose end shards need no
    other host) against float64 hops, JAX's two-level K-hop and the flat
    exchange on the same plan (f32: the same bits); then
    ``encode_series_sharded(chips_per_host=2)`` against JAX's."""
    graphs = {"ring": ring_graph(96, 3), "random": random_graph(rng, 64, 700),
              "path": ring_graph(300, 2, wrap=False)}
    paths, xs = {}, {}
    for name, g in graphs.items():
        xs[name] = rng.standard_normal((2, g.num_nodes, 8)).astype(
            np.float32)
        paths[name] = str(tmp_path / f"{name}.npz")
        np.savez(paths[name], src=g.src, dst=g.dst, weight=g.weight,
                 num_nodes=g.num_nodes, x=xs[name])
    cases = [dict(case, k=k, concat=concat, path=paths[name])
             for name, case, k, concat in CASES]
    n, t, f = 30, 10, 3
    g_enc = random_graph(rng, n, 200)
    x_series = rng.standard_normal((t, n, f)).astype(np.float32)
    enc_path = tmp_path / "enc.npz"
    np.savez(enc_path, src=g_enc.src, dst=g_enc.dst, weight=g_enc.weight,
             num_nodes=n, x_series=x_series)
    res_kw = dict(input_size=f, hidden_size=5, num_layers=2, seed=3)
    enc_kw = dict(k=2, bidirectional=True, global_attr=True)
    halo, enc = run_ranks(jobs_worker, HOSTS * CHIPS, "gloo", "cpu", [
        ("hier_worker", paths["ring"], {"device": "cpu", "hosts": HOSTS,
                                        "cases": cases}),
        ("encode_worker", str(enc_path), {
            "device": "cpu", "hosts": HOSTS, "reservoir": res_kw,
            "encode": enc_kw})])[0]
    for (name, case, k, concat), (got, flat) in zip(CASES, halo):
        g, x = graphs[name], xs[name]
        a = g.to_dense().astype(np.float64)
        hops = [x.astype(np.float64)]
        for _ in range(k):
            hops.append(a @ hops[-1])
        ref = np.concatenate(hops, -1) if concat else hops[-1]
        payload = case.get("payload_dtype", "float32")
        atol = PAYLOAD_TOL.get(payload, TOL * np.abs(ref).max())
        assert got.shape == ref.shape and np.abs(got - ref).max() <= atol, \
            (name, case)
        want = _jax_hier(g, x, case, k, concat)
        assert np.abs(got - want).max() <= atol, (name, case)
        if payload == "float32":
            np.testing.assert_array_equal(got, flat)
        else:       # the same rows quantized alike by either exchange
            np.testing.assert_allclose(got, flat, rtol=0, atol=1e-6)
    with jax_hier_mesh():
        want = np.asarray(j_encode(
            JReservoir(**res_kw), x_series, to_jax(g_enc), jax_hier_mesh(),
            axis=BOTH, chips_per_host=CHIPS, **enc_kw))[:, :n]
    assert enc.shape == want.shape
    assert np.abs(enc - want).max() <= TOL * np.abs(want).max()

