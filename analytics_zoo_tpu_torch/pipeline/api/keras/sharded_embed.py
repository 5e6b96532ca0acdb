"""Sharded-embedding resolution — port of ``analytics_zoo_tpu/pipeline/api/
keras/sharded_embed.py``.

``resolve_sharded_embeddings(model)`` upgrades a model's plain
``Embedding`` layers to the row-partitioned dedup'd lookup when the global
mesh has a ``model`` axis larger than 1 (``zoo.embed.sharded``: auto |
true | false), and declines otherwise. The training loop resolves it once
per loop, before it places the parameters on the mesh, so an engaged
table is placed row-sharded. A user who wants the dedup'd engine on one
device builds the graph with ``ShardedEmbedding``, as in the JAX package.
"""

from __future__ import annotations

import logging
from typing import List, Optional

log = logging.getLogger("analytics_zoo_tpu_torch.training")


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


def resolve_sharded_embeddings(model) -> Optional[List[object]]:
    """Routes ``model``'s plain embeddings through the row-sharded lookup
    when the global mesh's ``model`` axis is larger than 1, as the JAX
    package's resolution does (``zoo.embed.sharded``): ``auto`` engages
    the tables whose rows divide the axis, ``true`` every table (one whose
    rows do not divide stays whole and the lookup splits it), ``false``
    none. Engaged layers look up on the engine (``_lookup_sharded``) and,
    where their rows divide, keep only their row block
    (``_row_shard``). Returns the engaged layers (their count is the
    ``zoo_embed_sharded_tables`` gauge), or None where it declines, as
    the JAX resolution returns its hook or None."""
    from ....common.context import tri_state_conf
    from ....ops.sharded_embedding import model_row_shard_count
    flag = tri_state_conf("zoo.embed.sharded")
    if flag is False:
        return None
    candidates = find_embeddings(model)
    n_model = model_row_shard_count()
    if not candidates or n_model <= 1:
        return None
    engaged = [layer for layer in candidates
               if flag is True or layer.input_dim % n_model == 0]
    for layer in engaged:
        layer._lookup_sharded = True
        layer._row_shard = layer.input_dim % n_model == 0
    if engaged:
        log.info("sharded embedding engine engaged for %d table(s) over "
                 "model=%d", len(engaged), n_model)
        from ....observability import default_registry
        default_registry().gauge(
            "zoo_embed_sharded_tables",
            "embedding tables routed through the row-partitioned sharded "
            "lookup in the live training loop").set(len(engaged))
    return engaged or None
