"""ctypes bindings of the host graph core, ``graphcore.cpp``.

The library is built with ``g++`` at first use (never at import) into the
repository's ``build/`` directory, keyed on a hash of the source and the
flags, and loaded once a process. The flags are the JAX package's build's
(``sgp_tpu/native/__init__.py``), so each function gives that core's bits.
A build that fails raises with g++'s output: there is no quiet fallback.

:func:`sgp_tpu_torch.graph.coalesce` (``reduce="sum"``) takes this route
at 100,000 edges or more, as the JAX function does, and
:func:`sgp_tpu_torch.graph.k_hop_subgraph` at every size. ``csr_spmm`` and
``sample_edges_uniform`` have no caller in the port yet (nor in the JAX
package outside its tests).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "graphcore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def lib_path(src: Path = SRC) -> Path:
    """The library of ``src``, keyed on its bytes and the flags."""
    key = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{key.hexdigest()[:16]}.so"


def compile_library(src: Path, out: Path) -> None:
    """``g++`` ``src`` into the shared library ``out`` (through a file of
    this process's own, renamed into place, so that processes building at
    once do not clash). Raises ``RuntimeError`` with g++'s output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ {src.name} failed ({proc.returncode}):\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)


@functools.lru_cache(maxsize=None)
def load():
    """The loaded library, built first when this source has no build."""
    path = lib_path()
    if not path.exists():
        compile_library(SRC, path)
    lib = ctypes.CDLL(str(path))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i64, u64 = ctypes.c_int64, ctypes.c_uint64
    for name, restype, argtypes in (
            ("coalesce_edges", i64,
             [i32p, i32p, f32p, i64, i64, i32p, i32p, f32p]),
            ("khop_bfs", i64, [i64p, i32p, i64, i32p, i64, i64, u8p]),
            ("csr_spmm", None, [i64p, i32p, f32p, f32p, i64, i64, f32p]),
            ("sample_edges_uniform", None, [i64, i64, u64, i64p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def coalesce_edges(src, dst, weight, num_nodes: int):
    """Edges sorted by ``(dst, src)``, duplicates' weights summed in the
    order of ``std::sort`` (not stable): ``(src, dst, weight)``."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    w = np.ascontiguousarray(weight, np.float32)
    e = len(src)
    if len(dst) != e or len(w) != e:
        raise ValueError("src/dst/weight length mismatch")
    out_s = np.empty(e, np.int32)
    out_d = np.empty(e, np.int32)
    out_w = np.empty(e, np.float32)
    m = load().coalesce_edges(src, dst, w, e, num_nodes, out_s, out_d,
                              out_w)
    return out_s[:m].copy(), out_d[:m].copy(), out_w[:m].copy()


def khop_mask(indptr, indices, num_nodes: int, roots, k: int):
    """Membership mask ``[num_nodes]`` of the nodes within ``k`` hops of
    ``roots`` along the CSR ``(indptr, indices)``: row ``t`` lists the
    nodes a hop reaches from ``t`` (:func:`~sgp_tpu_torch.graph.
    adjacency_rows`). The JAX package's ``khop_mask`` builds that CSR from
    ``(src, dst)`` on every call; here the caller builds it once."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    roots = np.ascontiguousarray(roots, np.int32)
    if indptr.shape != (num_nodes + 1,) or indptr[0] != 0 or \
            indptr[-1] != len(indices):
        raise ValueError(f"indptr must be [{num_nodes + 1}] offsets into "
                         f"{len(indices)} indices")
    for name, ids in (("indices", indices), ("roots", roots)):
        if len(ids) and (ids.min() < 0 or ids.max() >= num_nodes):
            raise ValueError(f"{name} must lie in [0, {num_nodes})")
    mask = np.zeros(num_nodes, np.uint8)
    load().khop_bfs(indptr, indices, num_nodes, roots, len(roots), k, mask)
    return mask.astype(bool)


def csr_spmm(indptr, indices, data, x):
    """``A @ x`` for the CSR ``A`` on the host, in f32 (an oracle)."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float32)
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 2 or len(data) != len(indices) or \
            indptr[-1] != len(indices):
        raise ValueError("csr_spmm takes a CSR (indptr, indices, data) and "
                         "x [N, F]")
    if len(indices) and (indices.min() < 0 or indices.max() >= len(x)):
        raise ValueError(f"indices must lie in [0, {len(x)})")
    n, f = len(indptr) - 1, x.shape[1]
    out = np.empty((n, f), np.float32)
    load().csr_spmm(indptr, indices, data, x, n, f, out)
    return out


def sample_edges_uniform(num_edges: int, max_edges: int, seed: int):
    """``min(max_edges, num_edges)`` distinct edge indices, drawn without
    replacement by a Fisher-Yates prefix on an xorshift generator."""
    out = np.empty(min(max_edges, num_edges), np.int64)
    load().sample_edges_uniform(num_edges, len(out), seed, out)
    return out
