"""Image preprocessing transformers — the port's copy of
``analytics_zoo_tpu/feature/image/transforms.py`` (numpy on the host; the
resize and the normalize take the port's ``native/image.py``). Parity with
the reference's
``feature/image/*.scala`` OpenCV-JNI transformer files (Resize, CenterCrop,
RandomCrop, Flip, Brightness, ChannelNormalize, ChannelOrder, MatToTensor...),
re-designed host-side for the device:

* transforms are **vectorized numpy** wherever shapes allow (a batch
  ``(N, H, W, C)`` processes in one call — the role Spark's per-partition
  parallelism plays for the reference's per-record OpenCV ops), falling back
  to per-image application for ragged inputs;
* they compose with the same ``>>`` combinator as every other
  ``Preprocessing`` (``feature/common/Preprocessing.scala``);
* the output of a chain is a dense float32 NHWC batch ready for
  the device (channels-last, the layout the conv layers take; the
  reference's NCHW ``MatToTensor`` is an MKL layout choice).

Each class cites its reference counterpart file.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ..common import Preprocessing

__all__ = [
    "ImageProcessing", "Resize", "CenterCrop", "RandomCrop", "HFlip",
    "Brightness", "ChannelNormalize", "ChannelOrder", "PixelNormalizer",
    "MatToTensor", "ImageSetToSample",
    # augmentation family (ImageHue/Saturation/ColorJitter/Expand/... .scala)
    "Hue", "Saturation", "Contrast", "ColorJitter", "Expand", "Filler",
    "AspectScale", "RandomAspectScale", "ChannelScaledNormalizer", "Mirror",
    "FixedCrop", "RandomResize", "RandomPreprocessing", "BytesToMat",
    "PixelBytesToMat", "MatToFloats",
]


class ImageProcessing(Preprocessing):
    """Base: applies per-image (H, W, C) or batched (N, H, W, C).
    Counterpart of ``feature/image/ImageProcessing.scala``."""

    def apply(self, data):
        if isinstance(data, (list, tuple)):
            return [self.apply_one(np.asarray(im)) for im in data]
        data = np.asarray(data)
        if data.ndim == 4:
            return self.apply_batch(data)
        return self.apply_one(data)

    def apply_one(self, im: np.ndarray) -> np.ndarray:
        raise NotImplementedError(type(self).__name__)

    def apply_batch(self, batch: np.ndarray) -> np.ndarray:
        out = [self.apply_one(im) for im in batch]
        return np.stack(out) if out else batch


class Resize(ImageProcessing):
    """``Resize.scala`` — bilinear (triangle-filter) resize to
    (height, width). Fast path: the native batched C++ library
    (``native/zoo_image.cc``, the reference's OpenCV-JNI role); falls back
    to the per-image PIL loop when the library is unavailable."""

    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = int(resize_h), int(resize_w)

    def apply_batch(self, batch):
        from ...native import image as native_image
        out = native_image.resize_bilinear(batch, self.h, self.w)
        if out is not None:
            return out
        return super().apply_batch(batch)

    def apply_one(self, im):
        from ...native import image as native_image
        if im.ndim == 3 and im.shape[-1] in (1, 3, 4):
            out = native_image.resize_bilinear(im, self.h, self.w)
            if out is not None:
                return out
        from PIL import Image
        arr = im
        squeeze = arr.ndim == 3 and arr.shape[-1] == 1
        if squeeze:
            arr = arr[..., 0]
        dtype = arr.dtype
        if dtype != np.uint8:
            # PIL resizes float per-channel via mode F; round-trip per channel
            chans = [np.asarray(Image.fromarray(
                arr[..., c].astype(np.float32), mode="F").resize(
                    (self.w, self.h), Image.BILINEAR))
                for c in range(arr.shape[-1])] if arr.ndim == 3 else [
                np.asarray(Image.fromarray(arr.astype(np.float32), mode="F")
                           .resize((self.w, self.h), Image.BILINEAR))]
            out = np.stack(chans, axis=-1) if arr.ndim == 3 else chans[0]
            out = out.astype(dtype)
        else:
            out = np.asarray(Image.fromarray(arr).resize((self.w, self.h),
                                                         Image.BILINEAR))
        if squeeze:
            out = out[..., None]
        return out


class CenterCrop(ImageProcessing):
    """``CenterCrop.scala``."""

    def __init__(self, crop_h: int, crop_w: int):
        self.h, self.w = int(crop_h), int(crop_w)

    def _box(self, H, W):
        if H < self.h or W < self.w:
            raise ValueError(f"image {H}x{W} smaller than crop "
                             f"{self.h}x{self.w}")
        y = (H - self.h) // 2
        x = (W - self.w) // 2
        return y, x

    def apply_one(self, im):
        y, x = self._box(im.shape[0], im.shape[1])
        return im[y:y + self.h, x:x + self.w]

    def apply_batch(self, batch):
        y, x = self._box(batch.shape[1], batch.shape[2])
        return batch[:, y:y + self.h, x:x + self.w]


class RandomCrop(ImageProcessing):
    """``RandomCrop.scala`` — train-time augmentation."""

    def __init__(self, crop_h: int, crop_w: int, seed: Optional[int] = None):
        self.h, self.w = int(crop_h), int(crop_w)
        self._rng = np.random.default_rng(seed)

    def apply_one(self, im):
        H, W = im.shape[0], im.shape[1]
        if H < self.h or W < self.w:
            raise ValueError(f"image {H}x{W} smaller than crop "
                             f"{self.h}x{self.w}")
        y = int(self._rng.integers(0, H - self.h + 1))
        x = int(self._rng.integers(0, W - self.w + 1))
        return im[y:y + self.h, x:x + self.w]


class HFlip(ImageProcessing):
    """``Flip.scala`` (horizontal) with probability ``p``."""

    def __init__(self, p: float = 0.5, seed: Optional[int] = None):
        self.p = float(p)
        self._rng = np.random.default_rng(seed)

    def apply_one(self, im):
        return im[:, ::-1] if self._rng.random() < self.p else im

    def apply_batch(self, batch):
        flip = self._rng.random(batch.shape[0]) < self.p
        out = batch.copy()
        out[flip] = out[flip, :, ::-1]
        return out


class Brightness(ImageProcessing):
    """``Brightness.scala`` — add a uniform delta in [delta_low, delta_high]
    (operates in float; clips uint8 range)."""

    def __init__(self, delta_low: float = -32.0, delta_high: float = 32.0,
                 seed: Optional[int] = None):
        self.lo, self.hi = float(delta_low), float(delta_high)
        self._rng = np.random.default_rng(seed)

    def apply_one(self, im):
        delta = self._rng.uniform(self.lo, self.hi)
        out = im.astype(np.float32) + delta
        if im.dtype == np.uint8:
            return np.clip(out, 0, 255).astype(np.uint8)
        return out.astype(im.dtype)


class ChannelOrder(ImageProcessing):
    """``ChannelOrder.scala`` — swap RGB<->BGR."""

    def apply_one(self, im):
        return im[..., ::-1]

    def apply_batch(self, batch):
        return batch[..., ::-1]


class ChannelNormalize(ImageProcessing):
    """``ChannelNormalize.scala`` — per-channel (x - mean) / std, output
    float32. Batches take the fused native convert+normalize pass
    (``native/zoo_image.cc``) when available; numpy otherwise."""

    def __init__(self, mean: Sequence[float], std: Sequence[float] = (1., 1., 1.)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def apply_one(self, im):
        return (im.astype(np.float32) - self.mean) / self.std

    def apply_batch(self, batch):
        if (batch.ndim == 4 and self.mean.shape == (batch.shape[-1],)
                and self.std.shape == self.mean.shape):
            from ...native import image as native_image
            out = native_image.normalize(batch, self.mean, self.std)
            if out is not None:
                return out
        return (batch.astype(np.float32) - self.mean) / self.std


class PixelNormalizer(ImageProcessing):
    """``PixelNormalizer.scala`` — subtract a full per-pixel mean image."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def apply_one(self, im):
        return im.astype(np.float32) - self.means

    def apply_batch(self, batch):
        return batch.astype(np.float32) - self.means


class MatToTensor(ImageProcessing):
    """``MatToTensor.scala`` — finalize to float32. The reference emits NCHW
    for MKL; NHWC is kept (the conv layers take channels-last)."""

    def __init__(self, scale: float = 1.0):
        self.scale = float(scale)

    def apply_one(self, im):
        return im.astype(np.float32) * self.scale

    def apply_batch(self, batch):
        return batch.astype(np.float32) * self.scale


class ImageSetToSample(Preprocessing):
    """``ImageSetToSample.scala`` — stack a (possibly per-image) pipeline
    output into one dense NHWC float batch (all images must agree on shape
    by this point)."""

    def apply(self, data):
        if isinstance(data, np.ndarray) and data.ndim == 4:
            return data.astype(np.float32)
        ims = [np.asarray(im, np.float32) for im in data]
        shapes = {im.shape for im in ims}
        if len(shapes) != 1:
            raise ValueError(f"cannot stack ragged images {sorted(shapes)}; "
                             "Resize/Crop to a common size first")
        return np.stack(ims)


# ---------------------------------------------------------------------------
# color-space helpers (vectorized numpy HSV, matching colorsys per pixel)
# ---------------------------------------------------------------------------

def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float in [0,1] → HSV in [0,1] (colorsys convention)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.max(rgb, axis=-1)
    minc = np.min(rgb, axis=-1)
    v = maxc
    span = maxc - minc
    s = np.where(maxc > 0, span / np.where(maxc == 0, 1, maxc), 0.0)
    safe = np.where(span == 0, 1, span)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(span == 0, 0.0, (h / 6.0) % 1.0)
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


class _HSVTransform(ImageProcessing):
    """Base for HSV-space augmentations. Pixel-value convention follows the
    reference's OpenCV ops: uint8 OR float images both hold 0-255 values
    (``MatToFloats() >> Hue(...)`` works); rescale 0-1 float images to
    0-255 before color jitter."""

    def _hsv_op(self, hsv, delta):
        raise NotImplementedError

    def _delta(self):
        raise NotImplementedError

    def apply_one(self, im):
        delta = self._delta()
        if delta is None:      # no-op draw
            return im
        rgb = im.astype(np.float32) / 255.0
        out = _hsv_to_rgb(self._hsv_op(_rgb_to_hsv(rgb), delta))
        return (np.clip(out, 0.0, 1.0) * 255.0).astype(im.dtype)


class Hue(_HSVTransform):
    """``ImageHue.scala`` (BigDL ``augmentation.Hue``) — rotate the hue by a
    uniform delta in [delta_low, delta_high] DEGREES. (The reference's
    deltas are OpenCV H units = 2°; its conventional ``Hue(-18, 18)`` is
    ``Hue(-36, 36)`` here.)"""

    def __init__(self, delta_low: float = -36.0, delta_high: float = 36.0,
                 seed: Optional[int] = None):
        self.lo, self.hi = float(delta_low), float(delta_high)
        self._rng = np.random.default_rng(seed)

    def _delta(self):
        return self._rng.uniform(self.lo, self.hi)

    def _hsv_op(self, hsv, delta):
        hsv = hsv.copy()
        hsv[..., 0] = (hsv[..., 0] + delta / 360.0) % 1.0
        return hsv


class Saturation(_HSVTransform):
    """``ImageSaturation.scala`` — scale the saturation channel by a uniform
    factor in [delta_low, delta_high] (1.0 = unchanged)."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5,
                 seed: Optional[int] = None):
        self.lo, self.hi = float(delta_low), float(delta_high)
        self._rng = np.random.default_rng(seed)

    def _delta(self):
        d = self._rng.uniform(self.lo, self.hi)
        return None if d == 1.0 else d

    def _hsv_op(self, hsv, delta):
        hsv = hsv.copy()
        hsv[..., 1] = np.clip(hsv[..., 1] * delta, 0.0, 1.0)
        return hsv


class Contrast(ImageProcessing):
    """BigDL ``augmentation.Contrast`` (the zoo wraps it inside
    ``ImageColorJitter.scala``) — scale pixel values by a uniform factor in
    [delta_low, delta_high]."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5,
                 seed: Optional[int] = None):
        self.lo, self.hi = float(delta_low), float(delta_high)
        self._rng = np.random.default_rng(seed)

    def apply_one(self, im):
        delta = self._rng.uniform(self.lo, self.hi)
        out = im.astype(np.float32) * delta
        if im.dtype == np.uint8:
            return np.clip(out, 0, 255).astype(np.uint8)
        return out.astype(im.dtype)


class ColorJitter(ImageProcessing):
    """``ImageColorJitter.scala`` (BigDL ``augmentation.ColorJitter``) —
    randomly-ordered brightness/contrast/saturation/hue jitter, each applied
    with its own probability; the SSD training recipe's augmentation."""

    def __init__(self, brightness_prob: float = 0.5,
                 brightness_delta: float = 32.0,
                 contrast_prob: float = 0.5, contrast_lower: float = 0.5,
                 contrast_upper: float = 1.5,
                 hue_prob: float = 0.5, hue_delta: float = 36.0,
                 saturation_prob: float = 0.5,
                 saturation_lower: float = 0.5,
                 saturation_upper: float = 1.5,
                 random_order_prob: float = 0.0,
                 seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)
        self.random_order_prob = float(random_order_prob)
        self.probs = dict(brightness=float(brightness_prob),
                          contrast=float(contrast_prob),
                          hue=float(hue_prob),
                          saturation=float(saturation_prob))
        self.ops = dict(
            brightness=Brightness(-brightness_delta, brightness_delta,
                                  seed=self._rng.integers(1 << 31)),
            contrast=Contrast(contrast_lower, contrast_upper,
                              seed=self._rng.integers(1 << 31)),
            hue=Hue(-hue_delta, hue_delta, seed=self._rng.integers(1 << 31)),
            saturation=Saturation(saturation_lower, saturation_upper,
                                  seed=self._rng.integers(1 << 31)),
        )

    def apply_one(self, im):
        order = list(self.ops)
        if self._rng.random() < self.random_order_prob:
            self._rng.shuffle(order)
        for name in order:
            if self._rng.random() < self.probs[name]:
                im = self.ops[name].apply_one(im)
        return im


class Expand(ImageProcessing):
    """``ImageExpand.scala`` — place the image at a random position inside a
    larger mean-filled canvas (ratio drawn from [min_expand_ratio,
    max_expand_ratio]); the SSD zoom-out augmentation."""

    def __init__(self, means_r: float = 123.0, means_g: float = 117.0,
                 means_b: float = 104.0, min_expand_ratio: float = 1.0,
                 max_expand_ratio: float = 4.0, seed: Optional[int] = None):
        self.means = (float(means_r), float(means_g), float(means_b))
        self.lo, self.hi = float(min_expand_ratio), float(max_expand_ratio)
        self._rng = np.random.default_rng(seed)

    def apply_one(self, im):
        ratio = self._rng.uniform(self.lo, self.hi)
        H, W = im.shape[0], im.shape[1]
        nh, nw = int(H * ratio), int(W * ratio)
        y = int(self._rng.uniform(0, nh - H + 1))
        x = int(self._rng.uniform(0, nw - W + 1))
        fill = np.asarray(self.means[:im.shape[-1]] if im.ndim == 3 else
                          [self.means[0]], np.float32)
        canvas = np.broadcast_to(fill, (nh, nw) + fill.shape).astype(
            np.float32)
        canvas = canvas.copy()
        canvas[y:y + H, x:x + W] = im.astype(np.float32).reshape(
            H, W, -1)
        canvas = canvas if im.ndim == 3 else canvas[..., 0]
        if im.dtype == np.uint8:
            return np.clip(canvas, 0, 255).astype(np.uint8)
        return canvas.astype(im.dtype)

    def apply_batch(self, batch):
        # per-image random canvas sizes are ragged — return a list
        return [self.apply_one(im) for im in batch]


class Filler(ImageProcessing):
    """``ImageFiller.scala`` — fill a normalized-coordinate rectangle
    [start_x, end_x) x [start_y, end_y) with ``value`` (random-erasing
    style occlusion)."""

    def __init__(self, start_x: float, start_y: float, end_x: float,
                 end_y: float, value: float = 255.0):
        for v in (start_x, start_y, end_x, end_y):
            if not 0.0 <= v <= 1.0:
                raise ValueError("Filler coordinates are normalized to "
                                 "[0, 1]")
        if end_x <= start_x or end_y <= start_y:
            raise ValueError("Filler box must have positive area")
        self.box = (float(start_x), float(start_y), float(end_x),
                    float(end_y))
        self.value = value

    def apply_one(self, im):
        H, W = im.shape[0], im.shape[1]
        x1, y1, x2, y2 = self.box
        out = im.copy()
        out[int(y1 * H):int(y2 * H), int(x1 * W):int(x2 * W)] = self.value
        return out


class AspectScale(ImageProcessing):
    """``ImageAspectScale.scala`` — resize so the SHORT side is
    ``min_size`` keeping aspect ratio, long side capped at ``max_size``,
    both dims rounded down to a multiple of ``scale_multiple_of`` (the
    Faster-RCNN input convention)."""

    def __init__(self, min_size: int, scale_multiple_of: int = 1,
                 max_size: int = 1000):
        self.min_size = int(min_size)
        self.multiple = int(scale_multiple_of)
        self.max_size = int(max_size)

    def _target(self, H, W, min_size=None):
        short, long = min(H, W), max(H, W)
        scale = (min_size or self.min_size) / short
        if scale * long > self.max_size:
            scale = self.max_size / long
        nh, nw = int(round(H * scale)), int(round(W * scale))
        if self.multiple > 1:
            nh = max(self.multiple, nh // self.multiple * self.multiple)
            nw = max(self.multiple, nw // self.multiple * self.multiple)
        return nh, nw

    def apply_one(self, im):
        nh, nw = self._target(im.shape[0], im.shape[1])
        return Resize(nh, nw).apply_one(im)


class RandomAspectScale(AspectScale):
    """``ImageRandomAspectScale.scala`` — AspectScale with the short-side
    target drawn uniformly from ``scales`` (drawn per image, passed by
    value — the instance stays stateless/reentrant)."""

    def __init__(self, scales: Sequence[int], scale_multiple_of: int = 1,
                 max_size: int = 1000, seed: Optional[int] = None):
        super().__init__(int(scales[0]), scale_multiple_of, max_size)
        self.scales = [int(s) for s in scales]
        self._rng = np.random.default_rng(seed)

    def apply_one(self, im):
        draw = int(self._rng.choice(self.scales))
        nh, nw = self._target(im.shape[0], im.shape[1], draw)
        return Resize(nh, nw).apply_one(im)

    def apply_batch(self, batch):
        # per-image random sizes are ragged — return a list, not a stack
        return [self.apply_one(im) for im in batch]


class ChannelScaledNormalizer(ImageProcessing):
    """``ImageChannelScaledNormalizer.scala`` — (x - per-channel mean) *
    scale, output float32."""

    def __init__(self, mean_r: float, mean_g: float, mean_b: float,
                 scale: float = 1.0):
        self.mean = np.asarray([mean_r, mean_g, mean_b], np.float32)
        self.scale = float(scale)

    def apply_one(self, im):
        mean = self.mean[:im.shape[-1]] if im.ndim == 3 else self.mean[0]
        return (im.astype(np.float32) - mean) * self.scale

    apply_batch = apply_one


class Mirror(ImageProcessing):
    """``ImageMirror.scala`` — DETERMINISTIC horizontal flip (``HFlip`` is
    the probabilistic train-time variant)."""

    def apply_one(self, im):
        return im[:, ::-1]

    def apply_batch(self, batch):
        return batch[:, :, ::-1]


class FixedCrop(ImageProcessing):
    """``ImageFixedCrop.scala`` — crop a fixed box; coordinates are
    normalized to [0, 1] when ``normalized=True`` (the reference's wire
    form) else pixels."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 normalized: bool = True):
        if x2 <= x1 or y2 <= y1:
            raise ValueError("FixedCrop box must have positive area")
        self.box = (x1, y1, x2, y2)
        self.normalized = bool(normalized)

    def apply_one(self, im):
        H, W = im.shape[0], im.shape[1]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = x1 * W, x2 * W
            y1, y2 = y1 * H, y2 * H
        xi1, yi1 = max(0, int(x1)), max(0, int(y1))
        xi2, yi2 = min(W, int(round(x2))), min(H, int(round(y2)))
        return im[yi1:yi2, xi1:xi2]


class RandomResize(ImageProcessing):
    """``ImageRandomResize.scala`` — square resize to a side drawn
    uniformly from [min_size, max_size]."""

    def __init__(self, min_size: int, max_size: int,
                 seed: Optional[int] = None):
        self.lo, self.hi = int(min_size), int(max_size)
        self._rng = np.random.default_rng(seed)

    def apply_one(self, im):
        size = int(self._rng.integers(self.lo, self.hi + 1))
        return Resize(size, size).apply_one(im)

    def apply_batch(self, batch):
        # per-image random sizes are ragged — return a list
        return [self.apply_one(im) for im in batch]


class RandomPreprocessing(ImageProcessing):
    """``ImageRandomPreprocessing.scala`` — apply the wrapped transform
    with probability ``prob``, pass through otherwise."""

    def __init__(self, transform: ImageProcessing, prob: float,
                 seed: Optional[int] = None):
        self.transform = transform
        self.prob = float(prob)
        self._rng = np.random.default_rng(seed)

    def apply_one(self, im):
        if self._rng.random() < self.prob:
            return self.transform.apply_one(im)
        return im


class BytesToMat(ImageProcessing):
    """``ImageBytesToMat.scala`` — decode encoded image bytes (JPEG/PNG)
    to an (H, W, C) uint8 array (PIL replaces the OpenCV imdecode JNI)."""

    def apply(self, data):
        if isinstance(data, (bytes, bytearray)):
            return self._decode(bytes(data))
        if isinstance(data, (list, tuple)):
            return [self.apply(d) for d in data]
        return super().apply(data)

    def apply_one(self, im):
        return im  # already decoded

    @staticmethod
    def _decode(raw: bytes) -> np.ndarray:
        import io

        from PIL import Image
        with Image.open(io.BytesIO(raw)) as img:
            return np.asarray(img.convert("RGB"))


class PixelBytesToMat(ImageProcessing):
    """``ImagePixelBytesToMat.scala`` — reinterpret RAW pixel bytes as an
    (H, W, C) uint8 array (the reference reads the shape from the
    ImageFeature; here it is explicit)."""

    def __init__(self, height: int, width: int, channels: int = 3):
        self.shape = (int(height), int(width), int(channels))

    def apply(self, data):
        if isinstance(data, (bytes, bytearray)):
            return np.frombuffer(bytes(data), np.uint8).reshape(self.shape)
        if isinstance(data, (list, tuple)):
            return [self.apply(d) for d in data]
        return super().apply(data)

    def apply_one(self, im):
        return np.asarray(im, np.uint8).reshape(self.shape)


class MatToFloats(ImageProcessing):
    """``ImageMatToFloats.scala`` — to float32, keeping HWC layout (the
    host-side form ``MatToTensor`` finalizes for the device)."""

    def apply_one(self, im):
        return im.astype(np.float32)

    apply_batch = apply_one
