"""ctypes binding of the native image-ops library (``native/zoo_image.cc``),
the host-side C++ of the image pipeline — the port's copy of
``analytics_zoo_tpu/native/image.py`` (the reference's
equivalent layer is OpenCV through BigDL's JNI:
``feature/image/OpenCVMethod.scala``, per-transformer use in
``feature/image/*.scala``).

Two batched ops back the hot transformers:

* :func:`resize_bilinear` — separable triangle-filter resampling, threaded
  over the batch (replaces a per-image Python/PIL loop);
* :func:`normalize` — fused dtype-convert + per-channel ``(x - mean) / std``
  in one pass.

Compiled on first use with ``g++`` (plain C ABI — no pybind11) into
``build/native/`` (``_loader.py``); when no compiler is available every
caller falls back to its numpy/PIL path — same results, minus the speed.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional, Sequence

import numpy as np

from ._loader import build_and_load

log = logging.getLogger("analytics_zoo_tpu_torch.native")

_lib = None
_lib_lock = threading.Lock()


def _configure(lib):
    lib.zoo_image_resize.restype = ctypes.c_int
    lib.zoo_image_resize.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_long, ctypes.c_int]
    lib.zoo_image_normalize.restype = ctypes.c_int
    lib.zoo_image_normalize.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int]
    return lib


def load_native_image() -> Optional[ctypes.CDLL]:
    """Load (building if needed) libzoo_image.so; None when unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        lib = build_and_load("zoo_image", "zoo_image.cc")
        try:
            _lib = _configure(lib) if lib is not None else False
        except AttributeError as e:   # stale/mismatched binary
            log.info("native image ops unavailable (%s); using numpy/PIL "
                     "fallbacks", e)
            _lib = False
        return _lib or None


def available() -> bool:
    return load_native_image() is not None


def _as_batch(arr: np.ndarray):
    """(H, W, C)/(N, H, W, C) -> contiguous (N, H, W, C) + had_batch flag."""
    if arr.ndim == 3:
        return np.ascontiguousarray(arr[None]), False
    if arr.ndim == 4:
        return np.ascontiguousarray(arr), True
    raise ValueError(f"expected (H, W, C) or (N, H, W, C), got {arr.shape}")


def resize_bilinear(arr: np.ndarray, out_h: int, out_w: int,
                    nthreads: int = 0) -> Optional[np.ndarray]:
    """Batched triangle-filter resize; None when the native lib or dtype
    path is unavailable (caller falls back to PIL)."""
    lib = load_native_image()
    if lib is None:
        return None
    if arr.dtype == np.uint8:
        is_f32 = 0
    elif arr.dtype == np.float32:
        is_f32 = 1
    else:
        return None
    batch, had_batch = _as_batch(arr)
    n, h, w, c = batch.shape
    out = np.empty((n, int(out_h), int(out_w), c), batch.dtype)
    rc = lib.zoo_image_resize(
        batch.ctypes.data_as(ctypes.c_void_p), is_f32, n, h, w, c,
        out.ctypes.data_as(ctypes.c_void_p), int(out_h), int(out_w),
        int(nthreads))
    if rc != 0:
        return None
    return out if had_batch else out[0]


def normalize(arr: np.ndarray, mean: Sequence[float], std: Sequence[float],
              nthreads: int = 0) -> Optional[np.ndarray]:
    """Fused convert + per-channel normalize to float32; None when
    unavailable (caller falls back to numpy)."""
    lib = load_native_image()
    if lib is None:
        return None
    if arr.dtype == np.uint8:
        is_f32 = 0
    elif arr.dtype == np.float32:
        is_f32 = 1
    else:
        return None
    batch, had_batch = _as_batch(arr)
    n, h, w, c = batch.shape
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (c,) or std.shape != (c,) or np.any(std == 0):
        return None
    inv = np.ascontiguousarray(1.0 / std, np.float32)
    out = np.empty(batch.shape, np.float32)
    fptr = ctypes.POINTER(ctypes.c_float)
    rc = lib.zoo_image_normalize(
        batch.ctypes.data_as(ctypes.c_void_p), is_f32, n, h * w, c,
        mean.ctypes.data_as(fptr), inv.ctypes.data_as(fptr),
        out.ctypes.data_as(fptr), int(nthreads))
    if rc != 0:
        return None
    return out if had_batch else out[0]
