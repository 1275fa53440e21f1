"""The port's scaling model (``sgp_tpu_torch.obs.scaling``), placements and
tensor parallelism (``sgp_tpu_torch.parallel.sharding``) against the JAX
package's.

- ``host_boundary_ledger`` and ``project_scaling`` exactly (the same
  numpy plan; the projection with the JAX module's interconnect constants
  passed to the port's link arguments);
- in one spawn of 4 gloo ranks as a (data 2, model 2) grid:
  ``propagation_scaling``'s ledger on 2 and 4 ranks equal to JAX's
  (edges/s are timings, not compared); the all-gather K-hop
  (``shard_operator``, ``sharded_spmm``) within 1e-5 of the largest
  value of JAX's; ``shard_batch`` the slices JAX places; ``replicate``
  rank 0's values; ``sharded_ridge`` within max(1e-5 of the largest, 3 x
  JAX's distance) of a float64 fit; one DP+TP decoder step on weights
  carried from JAX against JAX's ``shard_params_tp`` + ``shard_batch``
  step on a 2 x 2 virtual mesh (the clip at 0.05, so that it acts): the
  loss within 1e-5 relative, the clipped gradients within 1e-5 of the
  largest, each updated weight within 1e-5, every rank's whole weights
  the same bits.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sgp_tpu.obs.scaling as jscaling
from sgp_tpu.graph import Graph as JGraph
from sgp_tpu.models import SGPModel as JSGPModel
from sgp_tpu.ops.spmm import build_operator as j_build_operator
from sgp_tpu.parallel import make_mesh as j_make_mesh
from sgp_tpu.parallel import shard_batch as j_shard_batch
from sgp_tpu.parallel import shard_operator as j_shard_operator
from sgp_tpu.parallel import shard_params_tp as j_shard_params_tp
from sgp_tpu.parallel import sharded_spmm as j_sharded_spmm
from sgp_tpu.parallel.sharding import sharded_ridge as j_sharded_ridge
from sgp_tpu.train.metrics import _abs_err, _masked_reduce

from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.graph import Graph, coalesce, normalize_adj
from sgp_tpu_torch.models import SGPModel, flax_to_torch
from sgp_tpu_torch.obs import scaling
from sgp_tpu_torch.parallel import make_mesh, run_ranks, shard_batch
from sgp_tpu_torch.parallel.workers import jobs_worker

torch.set_num_threads(1)

TOL = 1e-5
# the JAX module's interconnect figures, passed to the port's arguments
JAX_LINKS = dict(chips_per_host=jscaling.CHIPS_PER_HOST,
                 intra_bytes_per_s=jscaling.ICI_BYTES_PER_S,
                 cross_bytes_per_s=jscaling.DCN_BYTES_PER_S,
                 intra_latency_s=jscaling.ICI_LATENCY_S,
                 cross_latency_s=jscaling.DCN_LATENCY_S)
LEDGER_KEYS = ("n_devices", "halo_bytes_per_hop_per_device",
               "allgather_bytes_per_hop_per_device", "halo_comm_fraction",
               "boundary_b_max")
MODEL = dict(input_size=24, order=3, n_nodes=16, hidden_size=64,
             mlp_size=32, output_size=1, n_layers=1, horizon=4,
             positional_encoding=True)


def random_graph(rng, n, e):
    return normalize_adj(coalesce(Graph(
        rng.integers(0, n, e), rng.integers(0, n, e),
        rng.random(e).astype(np.float32), n)), "row")


def ring_graph(n, width):
    src = np.concatenate([np.arange(n)] * width)
    dst = np.concatenate([(np.arange(n) + d + 1) % n for d in range(width)])
    return normalize_adj(coalesce(Graph(src, dst, None, n)), "row")


def to_jax(g):
    return JGraph(g.src, g.dst, g.weight, g.num_nodes)


@pytest.mark.parametrize("order", ["natural", "rcm"])
@pytest.mark.parametrize("s, c", [(16, 4), (32, 8), (12, 8)])
def test_host_boundary_ledger_matches_jax(rng, s, c, order):
    for g in (ring_graph(2048, 16), random_graph(rng, 300, 2000)):
        assert scaling.host_boundary_ledger(g, s, c, order) == \
            jscaling.host_boundary_ledger(to_jax(g), s, c, order)


@pytest.mark.parametrize("payload", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("hierarchical", [True, False])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_project_scaling_matches_jax(depth, hierarchical, payload):
    """Every row at 1, 8, 16 and 32 cards (within a host, two-level, and
    flat across hosts), equal to JAX's."""
    g = ring_graph(2048, 16)
    kw = dict(n_chips_list=(1, 8, 16, 32), k=2, depth=depth,
              hierarchical=hierarchical, payload_dtype=payload)
    got = scaling.project_scaling(g, 128, 1e9, **kw, **JAX_LINKS)
    want = jscaling.project_scaling(to_jax(g), 128, 1e9, **kw)
    assert got == want


def test_project_scaling_defaults_are_the_h100s():
    """The defaults price the links at NVLink 4 and NDR InfiniBand, 8 GPUs
    a host: a two-level row crosses hosts past 8 cards."""
    g = ring_graph(2048, 16)
    rows = scaling.project_scaling(g, 128, 1e9, n_chips_list=(8, 32))
    assert "dcn_bytes_per_hop" not in rows["8"]
    assert rows["32"]["dcn_bytes_per_hop"] > 0
    assert scaling.NVLINK_BYTES_PER_S == 450e9
    assert scaling.IB_BYTES_PER_S == 50e9 and scaling.GPUS_PER_HOST == 8


CLIP = 0.05


def _jax_tp_step(params, batch):
    """JAX's DP+TP step: ``shard_params_tp`` + ``shard_batch`` on a 2 x 2
    virtual mesh, the clip at ``CLIP`` and Adam at 1e-3 (as
    ``__graft_entry__.py``'s dry run, which clips at 5); returns the loss,
    the updated weights, the clipped gradients and their norm before the
    clip."""
    mesh = j_make_mesh(2, 2, jax.devices()[:4])
    model = JSGPModel(**MODEL)
    p = j_shard_params_tp(jax.tree.map(jnp.asarray, params), mesh)
    b = j_shard_batch(batch, mesh)
    clip = optax.clip_by_global_norm(CLIP)
    opt = optax.chain(clip, optax.adam(1e-3))

    def loss_fn(p, b):
        v, n = _masked_reduce(_abs_err, model.apply(p, b["x"]), b["y"],
                              b["mask"])
        return v / jnp.maximum(n, 1.0)

    @jax.jit
    def step(p, s, b):
        loss, grads = jax.value_and_grad(loss_fn)(p, b)
        clipped, _ = clip.update(grads, clip.init(p))
        updates, s = opt.update(grads, s, p)
        return (optax.apply_updates(p, updates), s, loss, clipped,
                optax.global_norm(grads))

    with mesh:
        p, _, loss, clipped, norm = step(p, opt.init(p), b)
    return (float(loss), jax.tree.map(np.asarray, p),
            jax.tree.map(np.asarray, clipped), float(norm))


def _ridge64(x, y, alpha):
    x, y = x.astype(np.float64), y.astype(np.float64)
    return np.linalg.solve(x.T @ x + alpha * np.eye(x.shape[1]), x.T @ y)


def test_placements_scaling_and_tp_step_match_jax(rng, tmp_path):
    """One spawn of 4 gloo ranks as (data 2, model 2); see the module
    docstring."""
    g = random_graph(rng, 30, 200)
    x = rng.standard_normal((3, 30, 8)).astype(np.float32)
    batch = rng.standard_normal((8, 5)).astype(np.float32)
    x_r = rng.standard_normal((40, 6)).astype(np.float32)
    x_r[:, 0] *= 50                      # an ill-conditioned Gram
    y_r = (x_r @ rng.standard_normal((6, 2)) + 0.1).astype(np.float32)
    g_prop = random_graph(rng, 64, 500)
    path, prop = tmp_path / "place.npz", tmp_path / "prop.npz"
    np.savez(path, src=g.src, dst=g.dst, weight=g.weight, num_nodes=30,
             x=x, batch=batch, x_r=x_r, y_r=y_r)
    np.savez(prop, src=g_prop.src, dst=g_prop.dst, weight=g_prop.weight,
             num_nodes=64)
    # the dry run's decoder step: [B, N, F] windows, [B, H, N, 1] targets
    tp_batch = {"x": rng.standard_normal((4, 16, 24)).astype(np.float32),
                "y": rng.standard_normal((4, 4, 16, 1)).astype(np.float32),
                "mask": rng.random((4, 4, 16, 1)) > 0.1}
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, JSGPModel(**MODEL).init(
        {"params": key, "dropout": key}, tp_batch["x"]))
    params_path = tmp_path / "params.pkl"
    with open(params_path, "wb") as fp:
        pickle.dump(params, fp)
    tp_path = tmp_path / "tp.npz"
    np.savez(tp_path, **tp_batch)
    alpha = 0.5
    ranks = run_ranks(jobs_worker, 4, "gloo", "cpu", [
        ("placement_worker", str(path), {"device": "cpu", "shape": (2, 2),
                                         "k": 3, "alpha": alpha}),
        ("scaling_worker", str(prop), {"device": "cpu", "feat": 16, "k": 2,
                                       "n_devices": (2, 4)}),
        ("tp_worker", str(tp_path), {
            "device": "cpu", "model_axis": 2, "model": MODEL,
            "params": str(params_path), "lr": 1e-3, "clip": CLIP})])
    place = [r[0] for r in ranks]
    scale = [r[1] for r in ranks]
    tp = [r[2] for r in ranks]

    # the all-gather K-hop against JAX's sharded_spmm hops
    mesh = j_make_mesh(2, 2, jax.devices()[:4])
    op_s = j_shard_operator(j_build_operator(to_jax(g), "dense"), mesh)
    cur = jnp.asarray(x)
    with mesh:
        for _ in range(3):
            cur = j_sharded_spmm(op_s, cur, mesh)
    want = np.asarray(cur)
    for p in place:
        assert p["op_rows"] == 15
        assert np.abs(p["hops"] - want).max() <= TOL * np.abs(want).max()
    # shard_batch: data rank d holds the rows JAX places on its devices
    placed = j_shard_batch({"b": batch}, mesh)["b"]
    by_device = {s.device: np.asarray(s.data)
                 for s in placed.addressable_shards}
    for r, p in enumerate(place):
        np.testing.assert_array_equal(
            p["batch"], by_device[mesh.devices[r // 2, r % 2]])
        np.testing.assert_array_equal(p["replicate"], np.zeros(3))
    # sharded_ridge against JAX's, by each one's distance to float64
    with mesh:
        jw = np.asarray(j_sharded_ridge(x_r, y_r, alpha, mesh))
    w64 = _ridge64(x_r, y_r, alpha)
    gap = max(TOL * np.abs(w64).max(), 3 * np.abs(jw - w64).max())
    for p in place:
        np.testing.assert_array_equal(p["ridge"], place[0]["ridge"])
        assert np.abs(p["ridge"] - w64).max() <= gap

    # propagation_scaling's ledger at 2 and 4 ranks
    for i, n in enumerate((2, 4)):
        want = jscaling.propagation_scaling(to_jax(g_prop), feat=16, k=2,
                                            n_devices=n)
        for s in scale:
            got = s[i]
            assert {k: got[k] for k in LEDGER_KEYS} == \
                {k: want[k] for k in LEDGER_KEYS}, n
            assert got["edges_per_s_halo"] > 0 and \
                got["edges_per_s_allgather"] > 0

    # the DP+TP step
    j_loss, j_params, j_grads, j_norm = _jax_tp_step(params, tp_batch)
    assert j_norm > CLIP
    want = flax_to_torch(j_params, SGPModel(**MODEL)).state_dict()
    want_g = dict(flax_to_torch(j_grads, SGPModel(**MODEL))
                  .named_parameters())
    loss, whole, grads, own, split = tp[0]
    assert split, "no linear was split over the model axis"
    assert abs(loss - j_loss) <= TOL * abs(j_loss)
    assert whole.keys() == want.keys()
    for name, w in want.items():
        assert np.abs(whole[name] - w.numpy()).max() <= TOL, name
    g_top = max(float(v.detach().abs().max()) for v in want_g.values())
    for name, gr in want_g.items():
        assert np.abs(grads[name] - gr.detach().numpy()).max() \
            <= TOL * g_top, name
    for r, (loss_r, whole_r, _, own_r, _) in enumerate(tp):
        assert loss_r == loss
        for name in whole:
            np.testing.assert_array_equal(whole_r[name], whole[name])
        # each split layer holds half its rows; data replicas the same bits
        peer = tp[(r + 2) % 4][3]
        for name in own_r:
            np.testing.assert_array_equal(own_r[name], peer[name])
    for layer in split:
        w = tp[0][3][f"{layer}.weight"]
        assert w.shape[0] * 2 == whole[f"{layer}.weight"].shape[0]


def test_shard_batch_keeps_scalers_whole():
    mesh = make_mesh(1, 1)
    sc = ScalerParams(torch.zeros(3), torch.ones(3))
    out = shard_batch({"x": torch.arange(4.0), "scaler": sc}, mesh)
    assert out["scaler"] is sc and torch.equal(out["x"], torch.arange(4.0))


def test_dryrun_on_four_ranks_ends_ok():
    """``python -m sgp_tpu_torch.exp.dryrun 4 --device cpu``: the twin of
    ``__graft_entry__.py::dryrun_multichip`` on 4 gloo ranks, every section
    finite, the two-level K-hop the flat one's bits; rank 0's line ends in
    OK."""
    import subprocess
    import sys
    from pathlib import Path
    proc = subprocess.run(
        [sys.executable, "-m", "sgp_tpu_torch.exp.dryrun", "4", "--device",
         "cpu"], cwd=Path(__file__).resolve().parents[1],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(4): mesh {'data': 2, "
                           "'model': 2}") and line.endswith(
        "hier_halo_ok=True OK"), line
