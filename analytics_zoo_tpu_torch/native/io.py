"""ctypes binding of the native IO library (``native/zoo_io.cc``), the
host-side C++ of the disk data tier — the port's copy of
``analytics_zoo_tpu/native/io.py``. The library is compiled at first use
with ``g++`` into ``build/native/`` (``_loader.py``); where that cannot
happen, :class:`NativeArrayFile` reads through ``numpy.memmap`` instead:
the same records, without the native gather loop and the background page
prefetch. ``NativeArrayFile.io_path`` says which path serves a file.

File format: ``.npy`` (v1/v2). The header (dtype, shape, data offset) is
parsed here; the native side sees flat bytes only.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional, Tuple

import numpy as np

from ._loader import build_and_load

log = logging.getLogger("analytics_zoo_tpu_torch.native")

_lib = None
_lib_lock = threading.Lock()


def _configure(lib):
    lib.zoo_open.restype = ctypes.c_void_p
    lib.zoo_open.argtypes = [ctypes.c_char_p]
    lib.zoo_size.restype = ctypes.c_long
    lib.zoo_size.argtypes = [ctypes.c_void_p]
    lib.zoo_data.restype = ctypes.c_void_p
    lib.zoo_data.argtypes = [ctypes.c_void_p]
    lib.zoo_gather.restype = ctypes.c_int
    lib.zoo_gather.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                               ctypes.POINTER(ctypes.c_long), ctypes.c_long,
                               ctypes.c_void_p]
    lib.zoo_prefetch.restype = ctypes.c_int
    lib.zoo_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                 ctypes.c_long]
    lib.zoo_prefetch_wait.restype = None
    lib.zoo_prefetch_wait.argtypes = [ctypes.c_void_p]
    lib.zoo_close.restype = None
    lib.zoo_close.argtypes = [ctypes.c_void_p]
    return lib


def load_native_io() -> Optional[ctypes.CDLL]:
    """The IO library, built and loaded once a process; None when it is
    unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        lib = build_and_load("zoo_io", "zoo_io.cc")
        try:
            _lib = _configure(lib) if lib is not None else False
        except AttributeError as e:   # a library without the entry points
            log.warning("native IO unavailable (%s); numpy.memmap in use", e)
            _lib = False
        return _lib or None


def native_io_available() -> bool:
    return load_native_io() is not None


def _read_npy_header(path: str) -> Tuple[np.dtype, Tuple[int, ...], int]:
    """(dtype, shape, data_offset) of a .npy file, C order required (read
    through numpy's public header readers: format versions 1.0 and 2.0,
    what ``np.save`` writes for every dtype with a latin-1 description)."""
    fmt = np.lib.format
    with open(path, "rb") as f:
        version = fmt.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = fmt.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = fmt.read_array_header_2_0(f)
        else:
            raise ValueError(f"{path}: .npy format {version} not supported")
        if fortran:
            raise ValueError(f"{path}: Fortran-order arrays not supported")
        return np.dtype(dtype), tuple(shape), f.tell()


class NativeArrayFile:
    """Random access to one ``.npy`` file: ``gather(indices)`` copies the
    selected records into a fresh array; ``prefetch(lo, hi)`` streams a
    record range's pages in on the library's thread. ``io_path`` is
    ``"native"`` or ``"memmap"``."""

    def __init__(self, path: str):
        self.path = path
        self.dtype, self.shape, self.offset = _read_npy_header(path)
        if not self.shape:
            raise ValueError(f"{path}: scalar arrays have no records")
        self.n = int(self.shape[0])
        self.record_shape = tuple(self.shape[1:])
        self.record_bytes = int(np.prod(self.record_shape, dtype=np.int64)
                                * self.dtype.itemsize) or self.dtype.itemsize
        self._lib = load_native_io()
        if self._lib is not None:
            self.io_path = "native"
            self._h = self._lib.zoo_open(path.encode())
            if not self._h:
                raise OSError(f"zoo_open failed for {path}")
            expected = self.offset + self.n * self.record_bytes
            if self._lib.zoo_size(self._h) < expected:
                self._lib.zoo_close(self._h)
                self._h = None
                raise ValueError(f"{path}: file shorter than header claims")
        else:
            self.io_path = "memmap"
            self._h = None
            self._mm = np.memmap(path, dtype=self.dtype, mode="r",
                                 offset=self.offset, shape=self.shape)

    def gather(self, indices: np.ndarray) -> np.ndarray:
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(idx),) + self.record_shape, self.dtype)
        if self._h is not None:
            rc = self._lib.zoo_gather(
                self._h, self.offset, self.record_bytes,
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), len(idx),
                out.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise IndexError(f"{self.path}: gather index out of range")
            return out
        if len(idx) and (idx.min() < 0 or idx.max() >= self.n):
            raise IndexError(f"{self.path}: gather index out of range")
        out[...] = self._mm[idx]
        return out

    def prefetch(self, lo: int, hi: int) -> None:
        """Pages of records ``[lo, hi)`` read in the background; nothing on
        the memmap path."""
        if self._h is None:
            return
        lo, hi = max(int(lo), 0), min(int(hi), self.n)
        if hi <= lo:
            return
        self._lib.zoo_prefetch(self._h, self.offset + lo * self.record_bytes,
                               (hi - lo) * self.record_bytes)

    def prefetch_wait(self) -> None:
        if self._h is not None:
            self._lib.zoo_prefetch_wait(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None) is not None:
            self._lib.zoo_close(self._h)
            self._h = None
        if hasattr(self, "_mm"):
            del self._mm

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        # an exception out of __del__ would surface mid-collection
        except Exception:  # noqa: BLE001  # zoolint: disable=ZL007
            pass
