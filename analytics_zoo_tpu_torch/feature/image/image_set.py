"""ImageSet — the port's copy of ``analytics_zoo_tpu/feature/image/
image_set.py``; parity with ``feature/image/ImageSet.scala:46-260``
(Local/Distributed image collections + ``ImageSet.read``), a host-side
numpy collection feeding the device.

The reference's ``DistributedImageSet`` is an RDD of ``ImageFeature``; here
one process holds its shard of images (multi-host: each host reads its own
file shard), and ``to_feature_set`` hands a dense batch to the training
``FeatureSet`` pipeline with its background prefetch.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..common import Preprocessing
from ..feature_set import FeatureSet
from .transforms import ImageSetToSample

__all__ = ["ImageSet", "LocalImageSet"]

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")


class ImageSet:
    """A collection of images (ragged list of HWC uint8 arrays or one dense
    NHWC array) with optional integer labels."""

    def __init__(self, images: Union[np.ndarray, List[np.ndarray]],
                 labels: Optional[np.ndarray] = None,
                 label_map: Optional[Dict[str, int]] = None,
                 paths: Optional[List[str]] = None):
        self.images = images
        self.labels = None if labels is None else np.asarray(labels)
        self.label_map = label_map
        self.paths = paths  # origin files, kept for NNImageReader tables

    # ---- factories (ImageSet.scala:236 read) ------------------------------
    @staticmethod
    def read(path: str, with_label: bool = False,
             resize_h: Optional[int] = None, resize_w: Optional[int] = None,
             ) -> "ImageSet":
        """Read a file, a directory of images, or (``with_label=True``) a
        directory of per-class subdirectories — the reference's folder
        convention for classification datasets. Labels are assigned by
        sorted class-name order. Decoding needs PIL, imported here (a
        clear error when it is missing)."""
        try:
            from PIL import Image
        except ImportError as e:  # pragma: no cover - env without PIL
            raise ImportError(
                "ImageSet.read needs PIL (pillow) to decode image files; "
                "without it, build the set from decoded arrays with "
                "ImageSet.from_arrays") from e

        def load(p):
            im = Image.open(p).convert("RGB")
            if resize_h is not None and resize_w is not None:
                im = im.resize((resize_w, resize_h), Image.BILINEAR)
            return np.asarray(im, np.uint8)

        if os.path.isfile(path):
            if with_label:
                raise ValueError(
                    f"{path} is a single file; with_label=True needs a "
                    "directory of per-class subdirectories")
            return ImageSet([load(path)], paths=[path])
        if not os.path.isdir(path):
            raise FileNotFoundError(path)
        if with_label:
            classes = sorted(d for d in os.listdir(path)
                             if os.path.isdir(os.path.join(path, d)))
            if not classes:
                raise ValueError(f"{path}: with_label=True needs per-class "
                                 "subdirectories")
            label_map = {c: i for i, c in enumerate(classes)}
            images, labels, paths = [], [], []
            for c in classes:
                for f in sorted(os.listdir(os.path.join(path, c))):
                    if f.lower().endswith(_EXTS):
                        p = os.path.join(path, c, f)
                        images.append(load(p))
                        labels.append(label_map[c])
                        paths.append(p)
            if not images:
                raise ValueError(
                    f"no images under {path} (recognized extensions: "
                    f"{', '.join(_EXTS)})")
            return ImageSet(images, np.asarray(labels, np.int32), label_map,
                            paths=paths)
        files = [os.path.join(path, f) for f in sorted(os.listdir(path))
                 if f.lower().endswith(_EXTS)]
        images = [load(f) for f in files]
        if not images:
            raise ValueError(f"no images under {path}")
        return ImageSet(images, paths=files)

    @staticmethod
    def from_arrays(images, labels=None) -> "ImageSet":
        return ImageSet(images, labels)

    # ---- protocol ---------------------------------------------------------
    def __len__(self) -> int:
        return (self.images.shape[0] if isinstance(self.images, np.ndarray)
                else len(self.images))

    def transform(self, preprocessing: Preprocessing) -> "ImageSet":
        """Apply an image-transform chain (``ImageSet.transform``); labels
        ride along unchanged."""
        return ImageSet(preprocessing(self.images), self.labels,
                        self.label_map, paths=self.paths)

    def to_feature_set(self, shuffle: bool = True, seed: int = 0) -> FeatureSet:
        """Finalize into the training/inference ``FeatureSet``: stacks to a
        dense float NHWC batch (``ImageSetToSample`` role)."""
        x = ImageSetToSample()(self.images)
        return FeatureSet.array(x, self.labels, shuffle=shuffle, seed=seed)

    def to_array(self) -> np.ndarray:
        return ImageSetToSample()(self.images)


#: The reference distinguishes LocalImageSet/DistributedImageSet
#: (``ImageSet.scala:46,98``); one process = one host shard here.
LocalImageSet = ImageSet
