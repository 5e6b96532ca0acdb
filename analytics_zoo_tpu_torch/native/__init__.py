"""The port's bindings of the host-side C++ libraries under the
repository's ``native/`` (built into ``build/``, never next to their
sources): the disk tier's IO (``zoo_io.cc``) and the image ops
(``zoo_image.cc``, :mod:`.image`)."""

from .io import NativeArrayFile, load_native_io, native_io_available

__all__ = ["NativeArrayFile", "load_native_io", "native_io_available"]
