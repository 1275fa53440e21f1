"""Build a CUDA source of ``csrc/`` with ``nvcc`` and load it with ``ctypes``.

Each kernel is a shared library with a plain C interface, compiled for
``sm_90a`` at first use into the repository's ``build/`` directory and
keyed on a hash of its source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source or header builds anew
and an unchanged one is loaded as it is. Nothing here runs at import: the
CPU tests import every module of the port, and only the card's machine has
``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, keyed on the source, every header
    of ``csrc/`` (a source may include any of them) and the flags."""
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    key = key.hexdigest()[:16]
    return BUILD_DIR / f"{name}_{key}.so"


def compile_all(names) -> dict:
    """Compile every source of ``names`` that is not built yet, one
    ``nvcc`` process each, all started together. Returns ``{name:
    (seconds, log)}`` for the sources compiled here; raises if any
    failed. :func:`build` then loads them without compiling."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib_path = _lib_path(name)
        if lib_path.exists():
            continue
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (time.perf_counter(), tmp, lib_path, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out, failed = {}, []
    for name, (t0, tmp, lib_path, proc) in procs.items():
        log = proc.communicate()[0]
        out[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def build(name: str):
    """Compile ``csrc/<name>.cu`` once per source hash and load it.

    Returns ``(lib, seconds, log)``: the ``ctypes`` library, the compile
    time (0 when the library was already built) and ``nvcc``'s output,
    which holds ``ptxas``'s register, shared-memory and spill report."""
    seconds, log = compile_all([name]).get(name, (0.0, ""))
    return ctypes.CDLL(str(_lib_path(name))), seconds, log


def bind(lib, name: str, argtypes):
    """Declare a C function of ``lib`` returning an ``int`` error code."""
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
