"""The PyTorch port imports neither JAX, flax, PyYAML, pandas, h5py nor the
JAX package (the card's machine has no PyYAML, pandas or h5py): every
module of ``sgp_tpu_torch`` and ``chip_smoke.py`` is imported in a fresh
interpreter, which must end with none of them in ``sys.modules``; no
import line of the port names pandas (h5py is imported only inside the
functions that read or write ``.h5`` files)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = """
import importlib, pkgutil, sys
import sgp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sgp_tpu_torch.__path__,
                                               "sgp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sgp_tpu",
                                    "yaml", "pandas", "h5py"))
print(len(names), bad, " ".join(names))
assert not bad, bad
"""

# the training slices' modules, which the walk above must reach
TRAINING_SLICE = (
    "sgp_tpu_torch.data.loader", "sgp_tpu_torch.data.spatiotemporal",
    "sgp_tpu_torch.data.splitters", "sgp_tpu_torch.models.gated_gn",
    "sgp_tpu_torch.models.graph_layers", "sgp_tpu_torch.ops._build",
    "sgp_tpu_torch.ops.activations", "sgp_tpu_torch.ops.gn_ell",
    "sgp_tpu_torch.ops.gn_allpairs", "sgp_tpu_torch.graph.sparse",
    "sgp_tpu_torch.ops.spmm", "sgp_tpu_torch.utils.device",
    "sgp_tpu_torch.train.metrics", "sgp_tpu_torch.train.predictor")

# the SGP main path's modules (encode, packed IID training, the fused
# evaluation, checkpoints, the runner and its trial search)
MAIN_PATH = (
    "sgp_tpu_torch.encode.encoders", "sgp_tpu_torch.encode.encode_dataset",
    "sgp_tpu_torch.train.iid", "sgp_tpu_torch.train.fused_window",
    "sgp_tpu_torch.train.checkpoint", "sgp_tpu_torch.utils.config",
    "sgp_tpu_torch.exp.common", "sgp_tpu_torch.exp.run_traffic_sgp",
    "sgp_tpu_torch.exp.run_largescale_sgp", "sgp_tpu_torch.train.multi_trial")

# the baseline runners' modules
BASELINES = (
    "sgp_tpu_torch.data.subgraph", "sgp_tpu_torch.obs.run_logger",
    "sgp_tpu_torch.exp.run_traffic_baselines",
    "sgp_tpu_torch.exp.run_largescale_baselines")

# the attention slice's modules
ATTENTION_SLICE = (
    "sgp_tpu_torch.ops.sddmm", "sgp_tpu_torch.ops.scatter",
    "sgp_tpu_torch.ops.functional", "sgp_tpu_torch.models.attention",
    "sgp_tpu_torch.models.bridge")

# the diffusion baselines' modules (DCRNN, GraphWaveNet, the RNNs, the TCN)
DIFFUSION = (
    "sgp_tpu_torch.models.dcrnn", "sgp_tpu_torch.models.gwnet",
    "sgp_tpu_torch.models.rnn", "sgp_tpu_torch.models.tcn")


# the traffic SGP runner's modules (loader-side supports, the online and
# ESN models)
TRAFFIC_SGP = (
    "sgp_tpu_torch.data.sgp_loader", "sgp_tpu_torch.models.esn",
    "sgp_tpu_torch.models.sgp", "sgp_tpu_torch.encode.spatial",
    "sgp_tpu_torch.exp.run_traffic_sgp")


# DynGESN: the graph reservoir, the ridge readouts, the closed-form runner
# and its online forecaster
GESN = (
    "sgp_tpu_torch.encode.graph_reservoir", "sgp_tpu_torch.train.ridge",
    "sgp_tpu_torch.exp.run_closed_form", "sgp_tpu_torch.serve")


# the imputation runner (GRIN, the RNN imputers, the whitening trainer) and
# the forecaster export
IMPUTATION = (
    "sgp_tpu_torch.data.imputation", "sgp_tpu_torch.models.grin",
    "sgp_tpu_torch.models.rnni", "sgp_tpu_torch.train.imputer",
    "sgp_tpu_torch.exp.run_imputation", "sgp_tpu_torch.serve",
    "sgp_tpu_torch.ops.bsr_kernel")


# the rest of the model zoo, the whiteness test and its monitor, the data
# utilities
ZOO = (
    "sgp_tpu_torch.models.stgn_extra", "sgp_tpu_torch.analysis",
    "sgp_tpu_torch.analysis.whiteness", "sgp_tpu_torch.obs.monitor",
    "sgp_tpu_torch.data.aggregation", "sgp_tpu_torch.data.patterns",
    "sgp_tpu_torch.data.splitters")


# the dataset loaders, the similarities and the public helpers (A9, A13)
DATASETS = (
    "sgp_tpu_torch.data.datasets.build", "sgp_tpu_torch.data.datasets.metr_la",
    "sgp_tpu_torch.data.datasets.pems_bay",
    "sgp_tpu_torch.data.datasets.pv_us", "sgp_tpu_torch.data.datasets.cer_en",
    "sgp_tpu_torch.data.datasets.mts_benchmarks",
    "sgp_tpu_torch.graph.similarities", "sgp_tpu_torch.ops.linalg",
    "sgp_tpu_torch.utils.config")


# the host graph core and the tooling (A12, A11)
TOOLING = (
    "sgp_tpu_torch.native", "sgp_tpu_torch.utils.logging",
    "sgp_tpu_torch.obs.profiling", "sgp_tpu_torch.obs.roofline",
    "sgp_tpu_torch.exp.supervise", "sgp_tpu_torch.exp.hyperopt")


# node-sharded SGP over torch.distributed (A10's first slice) and its
# rank functions, which spawned processes import
PARALLEL = (
    "sgp_tpu_torch.parallel", "sgp_tpu_torch.parallel.mesh",
    "sgp_tpu_torch.parallel.collectives", "sgp_tpu_torch.parallel.halo",
    "sgp_tpu_torch.parallel.encode", "sgp_tpu_torch.parallel.sharding",
    "sgp_tpu_torch.parallel.launch", "sgp_tpu_torch.parallel.workers")

# the rest of A10: the scaling model, the multi-rank dry run and the card's
# rank checks
MULTI_DEVICE = (
    "sgp_tpu_torch.obs.scaling", "sgp_tpu_torch.exp.dryrun",
    "sgp_tpu_torch.parallel.card_checks")

RANKS = """
from sgp_tpu_torch.parallel import run_ranks
from sgp_tpu_torch.parallel.workers import imported_modules
for mods in run_ranks(imported_modules, 2, "gloo", "cpu"):
    bad = [m for m in mods if m in ("jax", "jaxlib", "flax", "sgp_tpu",
                                    "yaml", "pandas", "h5py")]
    assert "sgp_tpu_torch" in mods and not bad, bad
print("ok")
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    words = proc.stdout.split()
    assert int(words[0]) >= 30
    assert set(TRAINING_SLICE) <= set(words[2:])
    assert set(ATTENTION_SLICE) <= set(words[2:])
    assert set(MAIN_PATH) <= set(words[2:])
    assert set(BASELINES) <= set(words[2:])
    assert set(DIFFUSION) <= set(words[2:])
    assert set(TRAFFIC_SGP) <= set(words[2:])
    assert set(GESN) <= set(words[2:])
    assert set(IMPUTATION) <= set(words[2:])
    assert set(ZOO) <= set(words[2:])
    assert set(DATASETS) <= set(words[2:])
    assert set(TOOLING) <= set(words[2:])
    assert set(PARALLEL) <= set(words[2:])
    assert set(MULTI_DEVICE) <= set(words[2:])


def test_spawned_ranks_import_no_jax():
    """A rank process that ``run_ranks`` spawns (the sharded path's
    workers) imports none of them either."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", RANKS], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and "ok" in proc.stdout, \
        proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "sgp_tpu_torch").rglob("*.py")))
def test_port_source_names_no_jax_import(path):
    """No import line of the port names jax, flax, yaml, pandas or
    sgp_tpu (a lazy import inside a function would escape the subprocess
    check)."""
    for line in (ROOT / path).read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            top = words[1].split(".")[0].rstrip(",")
            assert top not in ("jax", "jaxlib", "flax", "sgp_tpu",
                               "yaml", "pandas"), line
