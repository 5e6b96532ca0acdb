"""Multi-GPU parallelism — port of ``analytics_zoo_tpu/parallel``: the
device mesh (``mesh.py``), the collectives the port issues explicitly
where the JAX package lets XLA insert them (``collectives.py``), ring and
Ulysses attention (``ring_attention.py``), the GPipe schedule
(``pipeline.py``) and the rank launcher (``launch.py``)."""

from .mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, EXPERT_AXIS,  # noqa: F401
                   PIPE_AXIS, create_mesh, global_mesh, set_global_mesh,
                   reset_global_mesh, batch_sharding, replicated_sharding,
                   data_parallel_size)
from .pipeline import gpipe_apply, sequential_apply  # noqa: F401
