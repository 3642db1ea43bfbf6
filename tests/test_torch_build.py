"""The kernel build's cache key and its failure without a compiler, on any machine.

A library lives under a hash of its source, the shared headers and the compiler flags, so
an edit to any of them builds anew and a stale library is never loaded.
"""

import pytest

from foley_tpu_torch.ops.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// kernel\n")
    (src / "common.cuh").write_text("// header\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    return src


@pytest.mark.parametrize("edit", ["source", "header", "flags"])
def test_library_path_changes_with_what_it_is_built_from(csrc, monkeypatch, edit):
    before = build.library_path("k")
    assert build.library_path("k") == before
    if edit == "source":
        (csrc / "k.cu").write_text("// kernel, edited\n")
    elif edit == "header":
        (csrc / "common.cuh").write_text("// header, edited\n")
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    after = build.library_path("k")
    assert after != before and after.name == before.name == "libk.so"


def test_missing_compiler_raises(csrc, tmp_path, monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library("k")
    assert not build.library_path("k").exists()
