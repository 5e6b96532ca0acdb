"""Host task runtime — port of ``analytics_zoo_tpu/ray``."""

from .raycontext import (ActorHandle, ObjectRef, RayContext,  # noqa: F401
                         RayTaskError)
