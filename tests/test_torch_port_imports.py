"""The PyTorch port imports neither JAX, flax nor the JAX package: every
module of ``sgp_tpu_torch`` and ``chip_smoke.py`` is imported in a fresh
interpreter, which must end with none of them in ``sys.modules``."""
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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sgp_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "sgp_tpu_torch").rglob("*.py")))
def test_port_source_names_no_jax_import(path):
    """No import line of the port names jax, flax or sgp_tpu (a lazy
    import inside a function would escape the subprocess check)."""
    for line in (ROOT / path).read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            top = words[1].split(".")[0].rstrip(",")
            assert top not in ("jax", "jaxlib", "flax", "sgp_tpu"), line
