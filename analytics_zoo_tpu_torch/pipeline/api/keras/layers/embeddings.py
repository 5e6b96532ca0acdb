"""Embedding layers — port of ``analytics_zoo_tpu/pipeline/api/keras/
layers/embeddings.py``: ``Embedding``, ``ShardedEmbedding`` and the gather
BERT uses (:func:`take_rows`).

The two layers keep their JAX counterparts' different rules for an id
outside ``[0, V)``. ``Embedding`` gathers with ``jnp.take(table, ids,
axis=0)``, whose default out-of-bounds mode is "fill": an id in ``[-V, 0)``
wraps once (as numpy indexing does) and any other id reads a row of NaN.
``F.embedding`` and plain indexing raise instead, so :func:`take_rows`
reproduces the JAX rule explicitly. ``ShardedEmbedding`` runs the dedup'd
engine (``ops/sharded_embedding.py``), which clamps ids into ``[0, V)``.
``WordEmbedding`` gathers as ``Embedding`` does, from a table it keeps as
constant model state (frozen, the default) or as a trained weight.
``SparseEmbedding`` multiplies a multi-hot row by its table.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .....parallel.collectives import gather_from
from .....parallel.mesh import MODEL_AXIS, sharded_over
from ..engine import Layer, get_initializer, param_dtype


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with ``jnp.take``'s fill semantics (see module doc).
    No host synchronisation: the validity mask is applied on the device."""
    v = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + v, ids)
    valid = (ids >= 0) & (ids < v)
    rows = table[ids.clamp(0, v - 1)]
    return torch.where(valid.unsqueeze(-1), rows,
                       torch.full((), float("nan"), dtype=table.dtype,
                                  device=table.device))


class Embedding(Layer):
    """``Embedding(input_dim, output_dim, init, input_length)``: int ids
    ``(B, ...)`` to rows ``(B, ..., output_dim)`` of the ``embeddings``
    table, in its dtype, by :func:`take_rows`. Ids are 0-based."""

    def __init__(self, input_dim: int, output_dim: int, init: str = "uniform",
                 input_length: Optional[int] = None, **kwargs):
        if input_length is not None and "input_shape" not in kwargs:
            kwargs["input_shape"] = (input_length,)
        super().__init__(**kwargs)
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.init = init

    def build(self, input_shape, *, generator):
        self.add_weight("embeddings", get_initializer(self.init)(
            generator, (self.input_dim, self.output_dim), param_dtype()))

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)

    #: the lookup runs on the row-sharded dedup'd engine
    #: (``ShardedEmbedding``, or a plain ``Embedding`` the
    #: ``zoo.embed.sharded`` resolution engaged, ``keras/sharded_embed.py``)
    _lookup_sharded = False
    #: and the table's rows split over ``model`` (an engaged table whose
    #: rows do not divide the axis stays whole; the lookup splits it)
    _row_shard = False

    def param_sharding(self, mesh=None):
        """The embedding (column) dimension over ``model``, each rank
        gathering its columns of the rows (JAX ``Embedding.
        param_sharding``); rows instead on the row-sharded engine."""
        if self._row_shard:
            return {"embeddings": (MODEL_AXIS, None)}
        if self._lookup_sharded:
            return {}
        return {"embeddings": (None, MODEL_AXIS)}

    def call(self, x, *, training=False, generator=None):
        if self._lookup_sharded:
            from .....ops.sharded_embedding import sharded_embedding_lookup
            return sharded_embedding_lookup(self.embeddings, x)
        ax = sharded_over(self.embeddings, MODEL_AXIS)
        if ax is not None:
            return gather_from(take_rows(self.embeddings, x), ax, -1)
        return take_rows(self.embeddings, x)


class ShardedEmbedding(Embedding):
    """Drop-in ``Embedding`` on the dedup'd engine
    (``ops.sharded_embedding.sharded_embedding_lookup``): each step gathers
    the distinct ids' rows once and expands them to the id stream (K1 on
    the card), and the backward sums the row cotangents per distinct id
    in a fixed order (the SA kernel) before one scatter onto the table.
    Ids clamp into ``[0, V)``. On a mesh with a ``model`` axis the table's
    rows split over it and each rank looks up its own rows (the
    row-sharded engine)."""

    _lookup_sharded = _row_shard = True


class SparseEmbedding(Layer):
    """``keras/layers/SparseEmbedding.scala``: a multi-hot (or weighted)
    row over the vocabulary times the ``embeddings`` table, accumulated in
    f32, combined by ``sum``, ``mean`` (over the row's sum, at least 1) or
    ``sqrtn`` (over the root of its sum of squares, at least 1), then
    rounded to the table's dtype."""

    def __init__(self, input_dim: int, output_dim: int, init: str = "uniform",
                 combiner: str = "sum", **kwargs):
        super().__init__(**kwargs)
        self.input_dim, self.output_dim = input_dim, output_dim
        self.init = init
        self.combiner = combiner

    def build(self, input_shape, *, generator):
        self.add_weight("embeddings", get_initializer(self.init)(
            generator, (self.input_dim, self.output_dim), param_dtype()))

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)

    def call(self, x, *, training=False, generator=None):
        table = self.embeddings
        # the operands rounded to the table's dtype, the products and the
        # sum in f32 (jnp.matmul with preferred_element_type=float32)
        y = torch.matmul(x.to(table.dtype).float(), table.float())
        if self.combiner == "mean":
            y = y / torch.clamp_min(x.sum(dim=-1, keepdim=True).float(), 1.0)
        elif self.combiner == "sqrtn":
            y = y / torch.sqrt(torch.clamp_min(
                (x * x).sum(dim=-1, keepdim=True).float(), 1.0))
        return y.to(table.dtype)


class WordEmbedding(Layer):
    """``keras/layers/WordEmbedding.scala``: an embedding initialised from
    pretrained vectors ``weights`` (GloVe in the reference). Frozen by
    default: the table is constant model state (the JAX ``net_state``),
    never trained; ``trainable=True`` makes it a weight. Ids gather with
    :func:`take_rows`' fill rule."""

    def __init__(self, weights: np.ndarray, trainable: bool = False,
                 **kwargs):
        super().__init__(**kwargs)
        self.weights = np.asarray(weights)
        self.trainable = trainable

    def build(self, input_shape, *, generator):
        table = torch.tensor(self.weights, dtype=param_dtype())
        if self.trainable:
            self.add_weight("embeddings", table)
        else:
            self.add_state("embeddings", table)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.weights.shape[1],)

    def call(self, x, *, training=False, generator=None):
        return take_rows(self.embeddings, x)
