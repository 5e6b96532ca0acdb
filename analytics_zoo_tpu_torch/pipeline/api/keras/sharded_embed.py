"""Sharded-embedding resolution — port of ``analytics_zoo_tpu/pipeline/api/
keras/sharded_embed.py``.

In the JAX package ``resolve_sharded_embeddings(model)`` upgrades a
model's plain ``Embedding`` layers to the row-partitioned dedup'd lookup
at step-build time when the mesh has a ``model`` axis larger than 1
(``zoo.embed.sharded``: auto | true | false), and declines otherwise. The
training loop resolves it once per loop. The port drives one device, so it
always declines there too; a user who wants the dedup'd engine on one
device builds the graph with ``ShardedEmbedding``, as in the JAX package.
"""

from __future__ import annotations

from typing import List


def find_embeddings(model) -> List[object]:
    """The container-dispatched plain ``Embedding`` layers of ``model``
    (exactly ``Embedding``: ``ShardedEmbedding`` routes through the engine
    itself), seen through a ``ZooModel`` facade."""
    from .engine import Model, Sequential
    from .layers.embeddings import Embedding

    if isinstance(model, Sequential):
        layers = list(model.layers)
    elif isinstance(model, Model):
        layers = [n.layer for n in model._topo]
    else:
        inner = getattr(model, "model", None)
        if inner is not None and inner is not model:
            return find_embeddings(inner)
        layers = []
    out, seen = [], set()
    for layer in layers:
        if type(layer) is Embedding and id(layer) not in seen:
            seen.add(id(layer))
            out.append(layer)
    return out


def resolve_sharded_embeddings(model) -> None:
    """The layer-call hook that routes ``model``'s plain embeddings through
    the row-sharded lookup, or None. The JAX package engages it only on a
    mesh whose ``model`` axis is larger than 1; the port drives one device
    (``ops.sharded_embedding.model_row_shard_count()`` is 1), so it
    declines for every model and every ``zoo.embed.sharded`` value, which
    is still checked for its spelling."""
    from ....common.context import tri_state_conf
    tri_state_conf("zoo.embed.sharded")
    return None
