"""Builds the port's CUDA sources into shared libraries and loads them.

Each library is compiled by ``nvcc`` for ``sm_90a`` from the sources under
``analytics_zoo_tpu_torch/csrc/`` into ``build/`` at the repository root,
named by a hash of its sources, the headers they include (``#include
"..."``, resolved under ``csrc/``) and the flags, and loaded with
``ctypes``. The
build happens at the first launch of one of its kernels, never at import,
so the CPU tests (which have no ``nvcc``) import every module freely.
"""

from __future__ import annotations

import ctypes
import concurrent.futures
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: after the sources: the driver API (the toolkit's stub at build time, the
#: driver's ``libcuda.so.1`` at load), for ``cuTensorMapEncodeTiled``, which
#: builds the TMA tensor maps of the flash-attention backward
LINK_FLAGS = ("-lcuda",)

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def included_headers(sources: Sequence[Path],
                     include_dir: Path = CSRC_DIR) -> list:
    """Every header that ``sources`` include with ``#include "..."``,
    directly or through another header, resolved under ``include_dir``
    (where ``nvcc -I`` points), in first-seen order."""
    seen: list = []
    todo = list(sources)
    while todo:
        text = todo.pop(0).read_text()
        for name in _INCLUDE.findall(text):
            header = include_dir / name
            if header.exists() and header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


class CudaLibrary:
    """One shared library built from ``sources`` (file names under
    ``csrc/``). ``bind(lib)`` declares the C entry points' ``argtypes``
    and ``restype``. Thread-safe; builds at most once per process."""

    def __init__(self, name: str, sources: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None],
                 src_dir: Path = CSRC_DIR):
        self.name = name
        self.src_dir = Path(src_dir)
        self.sources = [self.src_dir / s for s in sources]
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_log = ""
        self.build_seconds: Optional[float] = None

    def path(self) -> Path:
        """The library's file: a header edit names a new one, so a stale
        build is never reused."""
        h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
        for src in self.sources + included_headers(self.sources,
                                                   self.src_dir):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile unless a library of these exact sources exists."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(self.src_dir), "-o", str(tmp),
             *[str(s) for s in self.sources], *LINK_FLAGS],
            capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {self.name}:\n"
                               f"{self.build_log}")
        os.replace(tmp, out)
        return out

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib


def build_all(libraries: Sequence[CudaLibrary]) -> None:
    """Build and load ``libraries`` with one ``nvcc`` each, all started
    together (each build is its own process, so threads overlap them)."""
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        for fut in [pool.submit(lib.get) for lib in libraries]:
            fut.result()
