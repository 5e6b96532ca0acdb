"""3D image (volume) preprocessing — port of ``analytics_zoo_tpu/feature/
image3d`` (``feature/image3d`` of the reference)."""

from .transforms import (AffineTransform3D, CenterCrop3D, Crop3D,  # noqa: F401
                         ImageProcessing3D, RandomCrop3D, Rotate3D, Warp3D)
