"""NNImageReader — port of ``analytics_zoo_tpu/pipeline/nnframes/
nn_image_reader.py`` (``pipeline/nnframes/NNImageReader.scala`` of the
reference): image files into the NNFrames columnar table
``{"image": NHWC uint8, "path": origin files[, "label": int32]}``, decoded
on the host by ``ImageSet.read`` and resized to one common shape so the
column stacks dense.
"""

from __future__ import annotations

import numpy as np

from ...feature.image import ImageSet
from .nn_estimator import Table

__all__ = ["NNImageReader"]


class NNImageReader:
    """``NNImageReader.readImages(path, ...)``."""

    @staticmethod
    def read_images(path: str, resize_h: int, resize_w: int,
                    with_label: bool = False) -> Table:
        """Read a file, a directory or a per-class directory tree into a
        table. The common ``(resize_h, resize_w)`` is required: the image
        column is one dense NHWC array."""
        iset = ImageSet.read(path, with_label=with_label,
                             resize_h=resize_h, resize_w=resize_w)
        images = (iset.images if isinstance(iset.images, np.ndarray)
                  else np.stack(iset.images))
        table: Table = {"image": images,
                        "path": np.asarray(iset.paths or [""] * len(iset))}
        if iset.labels is not None:
            table["label"] = iset.labels.astype(np.int32)
        return table
