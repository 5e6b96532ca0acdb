"""The port's CUDA build: a library is named by a hash of its sources, the
headers they include and the flags, so an edited header never reuses a
stale build. Runs without nvcc (the compiler is faked where a command
line is checked)."""

import importlib
import shutil
import subprocess

import pytest

from analytics_zoo_tpu_torch.ops import cuda_build

# the modules, not the functions the package re-exports under their names
flash_attention = importlib.import_module(
    "analytics_zoo_tpu_torch.ops.pallas.flash_attention")
quantized = importlib.import_module(
    "analytics_zoo_tpu_torch.ops.pallas.quantized")

LIBRARIES = {"flash_attention_fwd": flash_attention.LIBRARY,
             "flash_attention_bwd": flash_attention.LIBRARY_BWD,
             "quantized": quantized.LIBRARY}


def _copy(lib, tmp_path):
    """``lib`` over a copy of ``csrc/`` under ``tmp_path``."""
    src = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, src)
    return cuda_build.CudaLibrary(lib.name, [s.name for s in lib.sources],
                                  lambda _: None, src_dir=src), src


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_library_path_follows_the_shared_header(name, tmp_path):
    """K2, K3a/K3b and K6 include ``hopper.cuh``: editing a copy of it
    names a new library file, and the sources alone do not change."""
    lib, src = _copy(LIBRARIES[name], tmp_path)
    assert [h.name for h in cuda_build.included_headers(lib.sources, src)] \
        == ["hopper.cuh"]
    before = lib.path()
    assert before.name == LIBRARIES[name].path().name
    header = src / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert lib.path() != before
    assert lib.path().name.startswith(f"lib{name}-")


def test_library_path_ignores_headers_it_does_not_include(tmp_path):
    lib, src = _copy(LIBRARIES["quantized"], tmp_path)
    before = lib.path()
    (src / "unused.cuh").write_text("// not included by any source\n")
    assert lib.path() == before


def test_nested_includes_are_followed(tmp_path):
    (tmp_path / "a.cu").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text("#pragma once\n")
    lib = cuda_build.CudaLibrary("nested", ["a.cu"], lambda _: None,
                                 src_dir=tmp_path)
    assert [h.name for h in cuda_build.included_headers(lib.sources,
                                                        tmp_path)] == \
        ["b.cuh", "c.cuh"]
    before = lib.path()
    (tmp_path / "c.cuh").write_text("#pragma once\n// edited\n")
    assert lib.path() != before


def test_nvcc_gets_the_include_directory_not_the_header(tmp_path,
                                                         monkeypatch):
    """The header reaches nvcc through ``-I csrc/``; only the ``.cu``
    sources are compiled."""
    lib, src = _copy(LIBRARIES["flash_attention_fwd"], tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    seen = []

    def fake_run(cmd, **kwargs):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "no compiler here")

    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        lib.build()
    (cmd,) = seen
    assert cmd[cmd.index("-I") + 1] == str(src)
    assert [a for a in cmd if a.endswith((".cu", ".cuh"))] == \
        [str(src / "flash_attention_fwd.cu")]
