from .image_model import ImageModel

__all__ = ["ImageModel"]
