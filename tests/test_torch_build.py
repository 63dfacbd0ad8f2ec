"""PyTorch port: how the CUDA libraries are named, on the CPU.

A library's name hashes its source, every header under ``csrc/`` and the
compiler flags, so an edited header (``mma_bf16.cuh``, which both flash
sources include) can never reuse a stale library.
"""

import pytest

from mmlspark_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "flash_fwd.cu").write_text('#include "mma_bf16.cuh"\n')
    (src / "flash_bwd.cu").write_text('#include "mma_bf16.cuh"\n')
    (src / "hist.cu").write_text("// no header\n")
    (src / "mma_bf16.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_library_path_is_stable_without_edits(csrc):
    first = {n: _build.library_path(n) for n in _build.SOURCES}
    assert {n: _build.library_path(n) for n in _build.SOURCES} == first
    assert len(set(first.values())) == len(first)
    for name, path in first.items():
        assert path.parent == csrc.parent / "build"
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    assert _build.build_log("flash_fwd") == ""       # nothing built


@pytest.mark.parametrize("edit", ["header", "new header", "source", "flags"])
def test_library_path_changes_with_headers_sources_and_flags(
        csrc, edit, monkeypatch):
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    if edit == "header":
        (csrc / "mma_bf16.cuh").write_text("// v2\n")
    elif edit == "new header":
        (csrc / "other.cuh").write_text("// v1\n")
    elif edit == "source":
        (csrc / "flash_fwd.cu").write_text("// edited\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    changed = {n for n in before if before[n] != after[n]}
    # every header is hashed into every library; a source only into its own
    assert changed == ({"flash_fwd"} if edit == "source"
                       else set(_build.SOURCES))
