"""The port's kernel build (ops/_build.py) without nvcc: which files a
library's name hashes, and when a built library is reused."""
from pathlib import Path

import pytest

from ml_audio_restoration_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc/ of one source including a header that includes another,
    with the build directory beside it."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include <cuda_runtime.h>\n'
                              '#include "common.cuh"\nint k;\n')
    (src / "common.cuh").write_text('#pragma once\n#include "inner.cuh"\n'
                                    '#include "cuda_bf16.h"\n')
    (src / "inner.cuh").write_text('#pragma once\n#include "common.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_sources_follow_quoted_includes(csrc):
    """Quoted includes beside the file, recursively, each once (the cycle
    common -> inner -> common ends); system headers, quoted or not, are
    not followed."""
    assert _build.sources(csrc / "k.cu") == [
        csrc / "k.cu", csrc / "common.cuh", csrc / "inner.cuh"]


@pytest.mark.parametrize("edited", ["k.cu", "common.cuh", "inner.cuh"])
def test_library_name_changes_with_any_source(csrc, edited):
    before = _build.library_path("k")
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    after = _build.library_path("k")
    assert after != before and after.name.startswith("libk_")


def test_library_name_changes_with_flags(csrc, monkeypatch):
    before = _build.library_path("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-G"])
    assert _build.library_path("k") != before


def test_library_name_ignores_unrelated_files(csrc):
    before = _build.library_path("k")
    (csrc / "other.cuh").write_text("int other;\n")
    assert _build.library_path("k") == before


def test_build_reuses_a_library_of_the_same_sources(csrc, monkeypatch):
    """A library of these exact sources is returned without calling nvcc;
    after a header edit the build needs nvcc again."""
    lib = _build.library_path("k")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")

    def no_nvcc():
        raise RuntimeError("nvcc called")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert _build.build("k") == lib
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    with pytest.raises(RuntimeError, match="nvcc called"):
        _build.build("k")


@pytest.mark.parametrize("name", ["lstm_recurrence", "lstm_train"])
def test_package_sources_hash_their_shared_header(name):
    csrc = Path(_build.__file__).resolve().parent.parent / "csrc"
    assert _build.sources(csrc / f"{name}.cu") == [
        csrc / f"{name}.cu", csrc / "lstm_common.cuh"]
