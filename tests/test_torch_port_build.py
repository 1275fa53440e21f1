"""The kernels' build key (``sgp_tpu_torch/ops/_build.py``): a library is
keyed on its source and on every shared header of ``csrc/``, so editing a
header rebuilds each source that may include it. No ``nvcc`` is needed:
only the library paths are compared."""
import re
import shutil

import pytest

from sgp_tpu_torch.ops import _build

SOURCES = ("bsr_spmm", "gn_allpairs", "gn_ell", "sddmm")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_sources_include_only_headers_of_csrc():
    for name in SOURCES:
        text = (_build.CSRC / f"{name}.cu").read_text()
        for header in re.findall(r'#include\s+"([^"]+)"', text):
            assert (_build.CSRC / header).is_file(), (name, header)
    for name in ("gn_allpairs", "gn_ell"):      # K3 and K4 share the tile
        assert '#include "gated_pair.cuh"' in (
            _build.CSRC / f"{name}.cu").read_text()


@pytest.mark.parametrize("name", SOURCES)
def test_library_path_is_stable(csrc, name):
    assert _build._lib_path(name) == _build._lib_path(name)
    assert _build._lib_path(name).parent == _build.BUILD_DIR
    assert _build._lib_path(name).name.startswith(f"{name}_")


@pytest.mark.parametrize("name", ["gn_allpairs", "gn_ell"])
def test_editing_the_shared_header_changes_the_library_path(csrc, name):
    before = _build._lib_path(name)
    header = csrc / "gated_pair.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build._lib_path(name) != before


@pytest.mark.parametrize("name", ["gn_allpairs", "gn_ell"])
def test_editing_the_source_changes_the_library_path(csrc, name):
    before = _build._lib_path(name)
    source = csrc / f"{name}.cu"
    source.write_bytes(source.read_bytes() + b"\n// edited\n")
    assert _build._lib_path(name) != before


def test_a_new_header_changes_the_library_path(csrc):
    before = _build._lib_path("gn_ell")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._lib_path("gn_ell") != before


def test_tf32_helpers_are_defined_once_and_shared():
    """K1 (the block SpMM), K2 (the SDDMM) and the pair tile of K3 and K4
    take the TF32 helpers (``tf32``, ``split``, their integer forms,
    ``mma``, ``mma3``), the bf16 ``mma_bf16``, the ``cp.async`` and
    ``ldmatrix`` helpers and ``allow_smem`` from one header, and no source
    defines its own copy."""
    helpers = ("tf32", "split", "tf32_int", "split_int", "mma", "mma3",
               "mma_bf16", "cp_async16", "cp_async_commit", "cp_async_wait",
               "ldmatrix_x4", "ldmatrix_x4_trans", "allow_smem")
    header = (_build.CSRC / "mma_common.cuh").read_text()
    defines = r"^(?:\S.*)?\b(?:void|int|uint32_t)\s+{}\("
    for fn in helpers:
        assert re.search(defines.format(fn), header, re.M), fn
    for path in (_build.CSRC / "bsr_spmm.cu", _build.CSRC / "sddmm.cu",
                 _build.CSRC / "gated_pair.cuh"):
        text = path.read_text()
        assert '#include "mma_common.cuh"' in text, path.name
        for fn in helpers:
            assert not re.search(defines.format(fn), text, re.M), \
                (path.name, fn)


@pytest.mark.parametrize("name", ["bsr_spmm", "gn_allpairs", "gn_ell",
                                  "sddmm"])
def test_editing_the_tf32_header_changes_the_library_path(csrc, name):
    before = _build._lib_path(name)
    header = csrc / "mma_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build._lib_path(name) != before
