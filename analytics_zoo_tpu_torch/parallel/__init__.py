"""Multi-GPU parallelism — port of ``analytics_zoo_tpu/parallel``: the
device mesh (``mesh.py``), the collectives the port issues explicitly
where the JAX package lets XLA insert them (``collectives.py``), ring and
Ulysses attention (``ring_attention.py``), the GPipe schedule
(``pipeline.py``) and the rank launcher (``launch.py``)."""
