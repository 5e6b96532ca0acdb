"""Image pipeline — port of ``analytics_zoo_tpu/feature/image``
(``feature/image`` of the reference)."""

from .image_set import ImageSet, LocalImageSet
from .transforms import (AspectScale, Brightness, BytesToMat, CenterCrop,
                         ChannelNormalize, ChannelOrder,
                         ChannelScaledNormalizer, ColorJitter, Contrast,
                         Expand, Filler, FixedCrop, HFlip, Hue,
                         ImageProcessing, ImageSetToSample, MatToFloats,
                         MatToTensor, Mirror, PixelBytesToMat,
                         PixelNormalizer, RandomAspectScale, RandomCrop,
                         RandomPreprocessing, RandomResize, Resize,
                         Saturation)

__all__ = [
    "ImageSet", "LocalImageSet", "ImageProcessing", "Resize", "CenterCrop",
    "RandomCrop", "HFlip", "Brightness", "ChannelNormalize", "ChannelOrder",
    "PixelNormalizer", "MatToTensor", "ImageSetToSample",
    "Hue", "Saturation", "Contrast", "ColorJitter", "Expand", "Filler",
    "AspectScale", "RandomAspectScale", "ChannelScaledNormalizer", "Mirror",
    "FixedCrop", "RandomResize", "RandomPreprocessing", "BytesToMat",
    "PixelBytesToMat", "MatToFloats",
]
