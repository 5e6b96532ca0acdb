"""ImageModel base — port of ``analytics_zoo_tpu/models/image/common/
image_model.py``; parity with ``models/image/common/ImageModel.scala:116``:
a ZooModel that carries an attached preprocessing chain and predicts straight
from an ``ImageSet``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ....feature.common import Preprocessing
from ....feature.image import ImageSet
from ...common.zoo_model import ZooModel

__all__ = ["ImageModel"]


class ImageModel(ZooModel):
    """Base for vision zoo models. ``config`` attaches the preprocessing the
    published topology expects (``ImageConfig``/``ImageClassificationConfig``
    role, ``ImageClassificationConfig.scala:34-51``)."""

    def __init__(self, name: Optional[str] = None, device=None):
        super().__init__(name=name, device=device)
        self.preprocessing: Optional[Preprocessing] = None

    def set_preprocessing(self, preprocessing: Preprocessing) -> "ImageModel":
        self.preprocessing = preprocessing
        return self

    def predict_image_set(self, image_set: ImageSet, batch_size: int = 32
                          ) -> np.ndarray:
        """``predictImageSet`` (``ImageModel.scala:40-70``): apply the
        attached preprocessing, then the batched predict."""
        if self.preprocessing is not None:
            image_set = image_set.transform(self.preprocessing)
        return self.predict(image_set.to_array(), batch_size=batch_size)

    def predict_classes_image_set(self, image_set: ImageSet,
                                  batch_size: int = 32) -> np.ndarray:
        from ....utils.prediction import probs_to_classes
        return probs_to_classes(
            self.predict_image_set(image_set, batch_size=batch_size))
