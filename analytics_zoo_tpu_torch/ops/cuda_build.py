"""Builds the port's CUDA sources into shared libraries and loads them.

Each library is compiled by ``nvcc`` for ``sm_90a`` from the sources under
``analytics_zoo_tpu_torch/csrc/`` into ``build/`` at the repository root,
named by a hash of its sources, the headers they include (``#include
"..."``, resolved under ``csrc/``) and the flags, and loaded with
``ctypes``. The
build happens at the first launch of one of its kernels, never at import,
so the CPU tests (which have no ``nvcc``) import every module freely.

Every kernel wrapper launches through :func:`launch`, the lean path: the
entry point is resolved once (:meth:`CudaLibrary.entry`, no lock after
the first load), the stream's handle is read without building a
``torch.cuda.Stream`` (:func:`current_raw_stream`), and the current device
is switched only when the tensor lies on another (:func:`launch`); a
thread-local flag makes the device's context current once a thread.
At the NCF shapes a kernel's device work is a few microseconds, so these
host costs decide the wrapper's time.
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

import torch

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
        self._entries: dict = {}
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
        from ..observability.compile import record_compile
        record_compile(self.name, self.build_seconds, out.name)
        return out

    def get(self) -> ctypes.CDLL:
        """The loaded library, built on first use. Double-checked: the lock
        is taken only until the first load has finished."""
        lib = self._lib
        if lib is None:
            with self._lock:
                if self._lib is None:
                    lib = ctypes.CDLL(str(self.build()))
                    self._bind(lib)
                    self._lib = lib
                lib = self._lib
        return lib

    def entry(self, name: str):
        """The bound C entry point ``name``, resolved once and handed back
        from a dict afterwards (no lock, no attribute lookup on the
        library)."""
        fn = self._entries.get(name)
        if fn is None:
            fn = getattr(self.get(), name)
            self._entries[name] = fn
        return fn


def build_all(libraries: Sequence[CudaLibrary]) -> None:
    """Build and load ``libraries`` with one ``nvcc`` each, all started
    together (each build is its own process, so threads overlap them)."""
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        for fut in [pool.submit(lib.get) for lib in libraries]:
            fut.result()


def _no_cuda(*args):
    raise RuntimeError("this torch build has no CUDA")


#: ``current_device()``: the index of the current CUDA device, torch's raw
#: binding (no lazy-init check: a caller holds a CUDA tensor, so CUDA is
#: up)
current_device = getattr(torch._C, "_cuda_getDevice", _no_cuda)
#: ``current_raw_stream(index)``: the handle of device ``index``'s current
#: stream as an int, read without building a ``torch.cuda.Stream`` (what
#: ``torch.cuda.current_stream(index).cuda_stream`` returns)
current_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", _no_cuda)


#: per-thread state of :func:`launch`: ``bound`` once the thread has made
#: a device's context current
_THREAD = threading.local()
#: device index -> its retained primary context (driver handle)
_PRIMARY: dict = {}
_DRIVER: list = []


def _libcuda() -> ctypes.CDLL:
    """The driver API (``libcuda.so.1``), loaded once."""
    if not _DRIVER:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuDeviceGet.argtypes = [ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_int]
        lib.cuDevicePrimaryCtxRetain.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        lib.cuCtxSetCurrent.argtypes = [ctypes.c_void_p]
        for fn in (lib.cuDeviceGet, lib.cuDevicePrimaryCtxRetain,
                   lib.cuCtxSetCurrent):
            fn.restype = ctypes.c_int
        _DRIVER.append(lib)
    return _DRIVER[0]


def make_current(index: int) -> None:
    """Make device ``index``'s primary context (the one torch uses) current
    on the calling thread. A thread that has made no CUDA runtime call yet
    has no current context, and reads ``current_device()`` as 0 all the
    same: the kernels' first driver-API call there (the TMA tensor maps'
    ``cuTensorMapEncodeTiled``) then fails. :func:`launch` calls this once
    a thread."""
    cu = _libcuda()
    ctx = _PRIMARY.get(index)
    if ctx is None:
        dev = ctypes.c_int()
        handle = ctypes.c_void_p()
        for code in (cu.cuDeviceGet(ctypes.byref(dev), index),
                     cu.cuDevicePrimaryCtxRetain(ctypes.byref(handle),
                                                 dev)):
            if code:
                raise RuntimeError(f"CUDA driver error {code} retaining "
                                   f"device {index}'s primary context")
        ctx = _PRIMARY.setdefault(index, handle)
    code = cu.cuCtxSetCurrent(ctx)
    if code:
        raise RuntimeError(f"CUDA driver error {code} making device "
                           f"{index}'s context current")


def launch(entry, tensor: torch.Tensor, *args) -> int:
    """Calls the C entry point ``entry(*args, stream)`` with ``stream`` the
    current stream of ``tensor``'s CUDA device, that device current for
    the call (``torch.cuda.device`` switches to it only when another one
    is); returns the entry point's error code. A thread's first launch
    makes the device's context current first (:func:`make_current`).
    Only CUDA tensors come here: each wrapper runs its plain version for
    CPU tensors before it."""
    index = tensor.get_device()
    if not getattr(_THREAD, "bound", False):
        make_current(index)
        _THREAD.bound = True
    if current_device() == index:
        return entry(*args, current_raw_stream(index))
    with torch.cuda.device(index):
        return entry(*args, current_raw_stream(index))
