"""3D image (volume) preprocessing — a copy of ``analytics_zoo_tpu/
feature/image3d/transforms.py`` (``Cropper.scala``: Crop3D, CenterCrop3D,
RandomCrop3D; ``Affine.scala``: AffineTransform3D; ``Rotation.scala``:
Rotate3D; ``Warp.scala``: the flow warp), vectorised numpy host ops that
compose with the ``>>`` ``Preprocessing`` combinator of ``feature/
common.py``.

The geometry is the reference's: 1-based voxel coordinates, the centre at
``(n+1)/2``, the source position ``centre - mat·(centre - idx) -
translation``, trilinear interpolation with the corners clamped. As in the
JAX package, ``"padding"`` pads with ``pad_val`` (the reference's
``WarpTransformer`` compares its mode string with an int and clamps
instead, ``Warp.scala:67``). Volumes are channels-last ``(D, H, W, C)``,
any C.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from ..common import Preprocessing

__all__ = ["ImageProcessing3D", "Crop3D", "CenterCrop3D", "RandomCrop3D",
           "AffineTransform3D", "Rotate3D", "Warp3D"]


class ImageProcessing3D(Preprocessing):
    """Base: applies per-volume (D, H, W, C) or batched (N, D, H, W, C)
    (``ImageProcessing3D.scala``)."""

    def apply(self, data):
        if isinstance(data, (list, tuple)):
            # recurse so per-item ndim normalization (3D → C=1) applies
            return [self.apply(np.asarray(v)) for v in data]
        data = np.asarray(data)
        if data.ndim == 5:
            return np.stack([self.apply_one(v) for v in data])
        if data.ndim == 3:  # channel-less volume → add C=1
            return self.apply_one(data[..., None])[..., 0]
        return self.apply_one(data)

    def apply_one(self, vol: np.ndarray) -> np.ndarray:
        raise NotImplementedError(type(self).__name__)


class Crop3D(ImageProcessing3D):
    """``Crop3D(start, patchSize)`` (``Cropper.scala:49``) — start is
    0-based (z, y, x)."""

    def __init__(self, start: Sequence[int], patch_size: Sequence[int]):
        self.start = tuple(int(s) for s in start)
        self.patch = tuple(int(p) for p in patch_size)

    def apply_one(self, vol):
        (z, y, x), (d, h, w) = self.start, self.patch
        if min(z, y, x) < 0 or z + d > vol.shape[0] \
                or y + h > vol.shape[1] or x + w > vol.shape[2]:
            raise ValueError(f"crop {self.start}+{self.patch} exceeds "
                             f"volume {vol.shape[:3]}")
        return vol[z:z + d, y:y + h, x:x + w]


class CenterCrop3D(ImageProcessing3D):
    """``CenterCrop3D(cropDepth, cropHeight, cropWidth)``."""

    def __init__(self, depth: int, height: int, width: int):
        self.patch = (int(depth), int(height), int(width))

    def apply_one(self, vol):
        start = [(s - p) // 2 for s, p in zip(vol.shape[:3], self.patch)]
        return Crop3D(start, self.patch).apply_one(vol)


class RandomCrop3D(ImageProcessing3D):
    """``RandomCrop3D(cropDepth, cropHeight, cropWidth)``."""

    def __init__(self, depth: int, height: int, width: int,
                 seed: Optional[int] = None):
        self.patch = (int(depth), int(height), int(width))
        self._rng = np.random.default_rng(seed)

    def apply_one(self, vol):
        start = [int(self._rng.integers(0, s - p + 1))
                 for s, p in zip(vol.shape[:3], self.patch)]
        return Crop3D(start, self.patch).apply_one(vol)


def _check_clamp_mode(clamp_mode: str) -> str:
    if clamp_mode not in ("clamp", "padding"):
        raise ValueError(f"clamp_mode must be 'clamp' or 'padding', got "
                         f"{clamp_mode!r}")
    return clamp_mode


def _trilinear_warp(src: np.ndarray, iz, iy, ix, clamp_mode: str,
                    pad_val: float) -> np.ndarray:
    """Sample ``src`` (D, H, W, C) at 1-based fractional positions
    (iz, iy, ix), the vectorized ``Warp.scala`` kernel."""
    d, h, w = src.shape[:3]
    off = ((iz < 1) | (iz > d) | (iy < 1) | (iy > h)
           | (ix < 1) | (ix > w))
    iz = np.clip(iz, 1, d)
    iy = np.clip(iy, 1, h)
    ix = np.clip(ix, 1, w)
    iz0 = np.floor(iz).astype(np.int64)
    iy0 = np.floor(iy).astype(np.int64)
    ix0 = np.floor(ix).astype(np.int64)
    iz1 = np.minimum(iz0 + 1, d)
    iy1 = np.minimum(iy0 + 1, h)
    ix1 = np.minimum(ix0 + 1, w)
    wz = (iz - iz0)[..., None]
    wy = (iy - iy0)[..., None]
    wx = (ix - ix0)[..., None]

    def at(zi, yi, xi):
        return src[zi - 1, yi - 1, xi - 1]  # 1-based → 0-based gather

    val = ((1 - wy) * (1 - wx) * (1 - wz) * at(iz0, iy0, ix0)
           + (1 - wy) * (1 - wx) * wz * at(iz1, iy0, ix0)
           + (1 - wy) * wx * (1 - wz) * at(iz0, iy0, ix1)
           + (1 - wy) * wx * wz * at(iz1, iy0, ix1)
           + wy * (1 - wx) * (1 - wz) * at(iz0, iy1, ix0)
           + wy * (1 - wx) * wz * at(iz1, iy1, ix0)
           + wy * wx * (1 - wz) * at(iz0, iy1, ix1)
           + wy * wx * wz * at(iz1, iy1, ix1))
    if clamp_mode == "padding":
        val = np.where(off[..., None], pad_val, val)
    if np.issubdtype(src.dtype, np.integer):
        info = np.iinfo(src.dtype)
        val = np.clip(np.rint(val), info.min, info.max)
    return val.astype(src.dtype)


class AffineTransform3D(ImageProcessing3D):
    """``AffineTransform3D(mat, translation, clampMode, padVal)``
    (``Affine.scala:44``): source position =
    ``center - mat · (center - idx) - translation`` in 1-based (z, y, x)
    coordinates with center ``(n+1)/2``."""

    def __init__(self, mat: np.ndarray,
                 translation: Sequence[float] = (0.0, 0.0, 0.0),
                 clamp_mode: str = "clamp", pad_val: float = 0.0):
        self.mat = np.asarray(mat, np.float64).reshape(3, 3)
        self.translation = np.asarray(translation, np.float64).reshape(3)
        self.clamp_mode = _check_clamp_mode(clamp_mode)
        self.pad_val = float(pad_val)

    def apply_one(self, vol):
        d, h, w = vol.shape[:3]
        cz, cy, cx = (d + 1) / 2.0, (h + 1) / 2.0, (w + 1) / 2.0
        zz, yy, xx = np.meshgrid(np.arange(1, d + 1, dtype=np.float64),
                                 np.arange(1, h + 1, dtype=np.float64),
                                 np.arange(1, w + 1, dtype=np.float64),
                                 indexing="ij")
        grid = np.stack([cz - zz, cy - yy, cx - xx])          # (3, D, H, W)
        src_pos = (grid - np.tensordot(self.mat, grid, axes=1)
                   - self.translation[:, None, None, None])
        # warp runs in offset mode: sample at idx + flow
        iz = zz + src_pos[0]
        iy = yy + src_pos[1]
        ix = xx + src_pos[2]
        return _trilinear_warp(vol, iz, iy, ix, self.clamp_mode,
                               self.pad_val)


class Rotate3D(AffineTransform3D):
    """``Rotate3D([yaw, pitch, roll])`` (``Rotation.scala:36``) — intrinsic
    z/y/x-axis rotations composed as yaw · pitch · roll."""

    def __init__(self, rotation_angles: Sequence[float],
                 clamp_mode: str = "clamp", pad_val: float = 0.0):
        yaw, pitch, roll = (float(a) for a in rotation_angles)
        roll_m = np.array([[1, 0, 0],
                           [0, math.cos(roll), -math.sin(roll)],
                           [0, math.sin(roll), math.cos(roll)]])
        pitch_m = np.array([[math.cos(pitch), 0, math.sin(pitch)],
                            [0, 1, 0],
                            [-math.sin(pitch), 0, math.cos(pitch)]])
        yaw_m = np.array([[math.cos(yaw), -math.sin(yaw), 0],
                          [math.sin(yaw), math.cos(yaw), 0],
                          [0, 0, 1]])
        super().__init__(yaw_m @ pitch_m @ roll_m,
                         clamp_mode=clamp_mode, pad_val=pad_val)
        self.rotation_angles = (yaw, pitch, roll)


class Warp3D(ImageProcessing3D):
    """Raw flow-field warp (``Warp.scala``): ``flow`` is (3, D, H, W);
    ``offset=True`` samples at ``idx + flow``, else at ``flow``."""

    def __init__(self, flow: np.ndarray, offset: bool = True,
                 clamp_mode: str = "clamp", pad_val: float = 0.0):
        self.flow = np.asarray(flow, np.float64)
        self.offset = bool(offset)
        self.clamp_mode = _check_clamp_mode(clamp_mode)
        self.pad_val = float(pad_val)

    def apply_one(self, vol):
        d, h, w = vol.shape[:3]
        if self.flow.shape != (3, d, h, w):
            raise ValueError(f"flow shape {self.flow.shape} vs volume "
                             f"{(3, d, h, w)}")
        if self.offset:
            zz, yy, xx = np.meshgrid(np.arange(1, d + 1),
                                     np.arange(1, h + 1),
                                     np.arange(1, w + 1), indexing="ij")
            iz, iy, ix = (zz + self.flow[0], yy + self.flow[1],
                          xx + self.flow[2])
        else:
            iz, iy, ix = self.flow
        return _trilinear_warp(vol, iz, iy, ix, self.clamp_mode,
                               self.pad_val)
