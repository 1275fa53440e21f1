"""The port's boundary-halo plan and K-hop (``sgp_tpu_torch.parallel.halo``)
against the JAX package's, on the same numpy graphs and inputs.

The host plan is held array for array (exact: both build it in numpy from
the same CSR slices). ``halo_khop`` runs on 2 and 4 gloo ranks on the CPU
(``run_ranks``, one spawn a test) against JAX's ``halo_khop`` on as many
virtual devices: f32 results within 1e-5 of the largest value (sums in
another order), the bf16 and int8 wire formats within the tolerances of
``tests/test_halo.py::test_halo_payload_compression`` (2e-2, 8e-2) of the
f32 result, and of JAX's quantized result. In ``bsr`` mode each rank runs
its tiles through K1's op (its plain version here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgp_tpu.graph import Graph as JGraph
from sgp_tpu.parallel import make_mesh as j_make_mesh
from sgp_tpu.parallel.halo import build_halo_spec as j_build
from sgp_tpu.parallel.halo import halo_khop as j_khop
from sgp_tpu.parallel.halo import shard_nodes as j_shard

from sgp_tpu_torch.graph import Graph, coalesce, normalize_adj
from sgp_tpu_torch.ops.bsr_kernel import bsr_spmm_plain
from sgp_tpu_torch.parallel import (build_halo_spec, make_hier_mesh,
                                    make_mesh, run_ranks)
from sgp_tpu_torch.parallel.halo import halo_khop
from sgp_tpu_torch.parallel.workers import halo_worker, mesh_worker

torch.set_num_threads(1)

TOL = 1e-5
PAYLOAD_TOL = {"bfloat16": 2e-2, "int8": 8e-2}


def random_graph(rng, n=37, e=300):
    return normalize_adj(coalesce(Graph(
        rng.integers(0, n, e), rng.integers(0, n, e),
        rng.random(e).astype(np.float32), n)), "row")


def to_jax(g):
    return JGraph(g.src, g.dst, g.weight, g.num_nodes)


def assert_same_plan(got, want):
    for name in ("mode", "n_shards", "nodes_per_shard", "num_nodes",
                 "b_max", "depth", "b_max_hop1", "payload_dtype"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_array_equal(got.boundary_counts, want.boundary_counts)
    np.testing.assert_array_equal(got.send_idx, np.asarray(want.send_idx))
    for part in ("local", "halo", "ext"):
        g, w = getattr(got, part), getattr(want, part)
        assert len(g) == len(w), part
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=part)
    if want.perm is None:
        assert got.perm is None
    else:
        np.testing.assert_array_equal(got.perm, want.perm)
    for f in (1, 16):
        assert got.bytes_per_hop(f) == want.bytes_per_hop(f)
        assert got.dense_gather_bytes(f) == want.dense_gather_bytes(f)
    assert got.plan_bytes_per_device() == want.plan_bytes_per_device()
    assert got.ext_edges_max() == want.ext_edges_max()


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("order", ["natural", "rcm"])
@pytest.mark.parametrize("mode", ["dense", "bsr", "coo"])
def test_build_halo_spec_matches_jax(rng, mode, order, depth):
    """Every plan array and accessor, on 37 nodes over 4 shards (not a
    multiple) and 300 nodes over 3 (bsr: 128-row shards)."""
    for n, s, e in ((37, 4, 300), (300, 3, 2500)):
        g = random_graph(rng, n, e)
        got = build_halo_spec(g, s, mode=mode, order=order, depth=depth)
        want = j_build(to_jax(g), s, mode=mode, order=order, depth=depth,
                       host_only=True)
        assert_same_plan(got, want)


@pytest.mark.parametrize("payload", ["float32", "bfloat16", "int8"])
def test_build_halo_spec_auto_perm_and_payload(rng, payload):
    """``auto`` (dense at Nl <= 4096), an explicit permutation and each
    wire format's byte count."""
    g = random_graph(rng, 50, 400)
    perm = rng.permutation(50)
    got = build_halo_spec(g, 8, order=perm, payload_dtype=payload)
    want = j_build(to_jax(g), 8, order=perm, payload_dtype=payload,
                   host_only=True)
    assert got.mode == "dense"
    assert_same_plan(got, want)
    assert got.payload_itemsize() == want.payload_itemsize()


def test_bsr_padding_tiles_and_two_level_calls(rng):
    """The bsr pack pads each shard's tile list with zero tiles at block
    row 0 after the real ones (so its rows are not sorted): the plain K1
    over all tiles equals the plain K1 over the real ones, which is what a
    rank runs (``HaloSpec.shard``: sorted rows, row_ptr from them). The
    two-level plan builds (4 shards, 2 a host), and the two-level K-hop on
    a one-rank (host, chip) grid gives the flat one's bits."""
    n = 700
    band = np.arange(n)
    # a band, and random edges among the first shard's nodes only
    extra = rng.integers(0, 300, (2, 400))
    src = np.concatenate([band, band, extra[0]])
    dst = np.concatenate([band, (band + 1) % n, extra[1]])
    g = normalize_adj(coalesce(Graph(src, dst, None, n)), "row")
    spec = build_halo_spec(g, 2, mode="bsr")
    assert spec.bsr_tiles.min() < spec.local[0].shape[1]    # padded shard
    x = torch.as_tensor(rng.standard_normal((spec.nodes_per_shard, 5)),
                        dtype=torch.float32)
    n_br = spec.nodes_per_shard // 128
    for i in range(2):
        blocks, brows, bcols = (torch.as_tensor(a[i]) for a in spec.local)
        padded = bsr_spmm_plain(blocks, bcols, brows, n_br, x)
        blocks_r, cols_r, ptr_r, rows_r = spec.shard(i, "cpu")["local"]
        assert (torch.diff(rows_r) >= 0).all()
        assert ptr_r[-1] == spec.bsr_tiles[i] == len(cols_r)
        real = bsr_spmm_plain(blocks_r, cols_r, rows_r, n_br, x)
        torch.testing.assert_close(real, padded, rtol=0, atol=0)
    hier = build_halo_spec(g, 4, mode="bsr", chips_per_host=2).hier
    assert hier is not None and hier[3:5] == (2, 2)
    one = build_halo_spec(g, 1, mode="bsr", chips_per_host=1)
    x1 = torch.as_tensor(rng.standard_normal((one.nodes_per_shard, 5)),
                         dtype=torch.float32)
    two_level = halo_khop(one, x1, make_hier_mesh(1, 1), k=2,
                          axis=("host", "chip"))
    flat = halo_khop(one, x1, make_mesh(1, 1), k=2)
    torch.testing.assert_close(two_level, flat, rtol=0, atol=0)


# (build kwargs, k, concat; the worlds at which JAX runs the case too) of
# each case. Every case is held to float64 at both worlds; JAX's shard_map
# compiles a case in 3-20 s on the CPU, so each feature runs through JAX
# at one world
CASES = [
    (dict(mode="dense", k=1), (4,)),
    (dict(mode="dense", k=3, concat=True), (2,)),
    (dict(mode="bsr", k=2, concat=True), (2,)),
    (dict(mode="coo", k=3), ()),
    (dict(mode="dense", order="rcm", k=2), (4,)),
    (dict(mode="coo", depth=2, k=3, concat=True), ()),
    (dict(mode="dense", depth=2, order="rcm", k=3, concat=True), (4,)),
    (dict(mode="bsr", depth=2, order="rcm", k=3), ()),
    (dict(mode="dense", payload_dtype="bfloat16", k=2), (2,)),
    (dict(mode="dense", payload_dtype="int8", k=2), (4,)),
]


def _jax_khop(g, x, s, case):
    case = dict(case)
    k, concat = case.pop("k"), case.pop("concat", False)
    mesh = j_make_mesh(1, s)
    spec = j_build(to_jax(g), s, **case)
    # the plan's padded node count (bsr rounds a shard up to 128 rows)
    pad = spec.n_shards * spec.nodes_per_shard - g.num_nodes
    x = np.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, pad), (0, 0)])
    with mesh:
        out = j_khop(spec, j_shard(jnp.asarray(x), mesh, "model"), mesh,
                     k=k, axis="model", concat=concat)
    return np.asarray(out)[..., :g.num_nodes, :]


@pytest.mark.parametrize("world", [2, 4])
def test_halo_khop_matches_jax(rng, tmp_path, world):
    """``halo_khop`` on ``world`` gloo ranks, for every case of ``CASES``
    on a [3, N, 8] input (dense, bsr through K1's plain version, coo, RCM,
    depth 2, concat, the compressed wire formats), against float64 and,
    at the case's worlds, against JAX's on as many virtual devices; and an
    RCM plan fed a natural-ordered input pre-padded to S * Nl
    (``tests/test_halo.py:288``), against float64."""
    n = 150
    g = random_graph(rng, n, 1200)
    x = rng.standard_normal((3, n, 8)).astype(np.float32)
    path = tmp_path / "halo.npz"
    np.savez(path, src=g.src, dst=g.dst, weight=g.weight, num_nodes=n, x=x)
    # an RCM plan fed a natural-ordered input pre-padded to S * Nl
    n2 = 50
    g2 = random_graph(rng, n2, 300)
    x2 = np.zeros((world * -(-n2 // world), 8), np.float32)
    x2[:n2] = rng.standard_normal((n2, 8))
    padded = tmp_path / "padded.npz"
    np.savez(padded, src=g2.src, dst=g2.dst, weight=g2.weight,
             num_nodes=n2, x=x2)
    outs = run_ranks(halo_worker, world, "gloo", "cpu", str(path), {
        "device": "cpu", "cases": [c for c, _ in CASES]
        + [dict(order="rcm", k=1, path=str(padded))]})[0]
    a = g.to_dense().astype(np.float64)
    hops = [x.astype(np.float64)]
    for _ in range(3):
        hops.append(a @ hops[-1])
    for (case, jax_worlds), got in zip(CASES, outs):
        ref = (np.concatenate(hops[:case["k"] + 1], -1)
               if case.get("concat") else hops[case["k"]])
        payload = case.get("payload_dtype", "float32")
        # f32 relative to the largest value, the wire formats absolute
        atol = PAYLOAD_TOL.get(payload, TOL * np.abs(ref).max())
        assert got.shape == ref.shape and np.abs(got - ref).max() <= atol, \
            case
        if world in jax_worlds:
            want = _jax_khop(g, x, world, case)
            assert np.abs(got - want).max() <= atol, case
    want = g2.to_dense().astype(np.float64) @ x2[:n2]
    np.testing.assert_allclose(outs[-1], want,
                               atol=TOL * np.abs(want).max())


def test_mesh_groups_on_four_ranks(tmp_path):
    """``make_mesh(2, 2)`` on 4 gloo ranks: rank r at (r // 2, r % 2), and
    an all_reduce on each axis's group sums over that axis only."""
    grid = run_ranks(mesh_worker, 4, "gloo", "cpu", None, {"shape": (2, 2)})
    for r, (index, sums) in enumerate(grid):
        assert index == {"data": r // 2, "model": r % 2}
        col = [i * 2 + r % 2 for i in range(2)]
        row = [(r // 2) * 2 + j for j in range(2)]
        assert sums == {"data": float(sum(c + 1 for c in col)),
                        "model": float(sum(c + 1 for c in row))}
