"""The dedup'd embedding engine — port of the single-shard part of
``analytics_zoo_tpu/ops/sharded_embedding.py``.

Each lookup deduplicates its ids with a fixed-capacity unique
(:func:`dedup_capacity` buckets the capacity to powers of two, so nearby
batch sizes share shapes), gathers each distinct row once into a
``(capacity, D)`` block and expands the block back to the id stream with
kernel K1 (``ops/pallas/embedding.py``, ``zoo.pallas.embed_gather``). The
backward never forms a dense cotangent per id: the row cotangents are
summed per distinct id onto the unique block in f32 (kernel SA, a fixed
order, so the same bits on every run; it reads the forward's sort, so it
is one launch), then scattered onto the table through the dump-row
trick. Out-of-range ids clamp into ``[0, V)``.

The port drives one device: a mesh with a ``model`` axis larger than 1
(the row-partitioned lookup), ``OutOfCoreEmbeddingCache`` and the host
cold tier are not ported yet.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from ..common.context import get_zoo_context
from .pallas.embedding import (dedup_scatter_add, embed_expand,
                               embed_expand_reference,
                               pallas_embed_gather_enabled)

__all__ = ["dedup_capacity", "dedup_embedding_lookup",
           "model_row_shard_count", "sharded_embedding_lookup"]


def round_up(x: int, mult: int) -> int:
    return (x + mult - 1) // mult * mult


def model_row_shard_count(mesh: Optional[Mapping[str, int]] = None) -> int:
    """Size of the ``model`` axis of ``mesh`` (a mapping of axis sizes):
    the row shard count of the lookup. The port has no device mesh, so
    with none given it is 1."""
    return 1 if mesh is None else int(mesh.get("model", 1))


def dedup_capacity(n_ids: int, vocab: int) -> int:
    """The static unique-id capacity for ``n_ids`` ids over a ``vocab``-row
    table: the safe ceiling ``min(n_ids, vocab)`` bucketed up to a power
    of two (never below the worst-case unique count), capped at the id
    count rounded up to 8, and at least 8."""
    need = max(min(int(n_ids), int(vocab)), 1)
    cap = 1 << (need - 1).bit_length()
    return max(min(cap, round_up(int(n_ids), 8)), 8)


def _dedup_sort(ids: torch.Tensor, capacity: int, fill: int
                ) -> Tuple[torch.Tensor, ...]:
    """``(uniq, inv, order, slot)``: :func:`_unique_ids`' two and what its
    stable sort leaves on the way, ``order`` (int64) the positions sorted
    stably by id and ``slot`` (int64, ascending) the slot of each sorted
    position — the sort of the positions by slot that SA reads (the slots
    rise with the id)."""
    n = ids.shape[0]
    srt, order = torch.sort(ids, stable=True)
    new = torch.ones(n, dtype=torch.bool, device=ids.device)
    new[1:] = srt[1:] != srt[:-1]
    slot = torch.cumsum(new, 0) - 1
    inv = torch.empty(n, dtype=torch.int32, device=ids.device)
    inv.scatter_(0, order, slot.to(torch.int32))
    # every id of a slot writes the same value; slots past the capacity
    # land on an extra entry that is sliced off
    uniq = torch.full((capacity + 1,), fill, dtype=ids.dtype,
                      device=ids.device)
    uniq.scatter_(0, slot.clamp(max=capacity), srt)
    return uniq[:capacity], inv, order, slot


def _unique_ids(ids: torch.Tensor, capacity: int,
                fill: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.unique(ids, size=capacity, fill_value=fill,
    return_inverse=True)``: ``uniq`` the sorted distinct ids padded with
    ``fill`` (truncated past ``capacity``), ``inv`` (int32) each id's
    index in it. Built from a sort, boundary marks and a cumulative sum:
    fixed shapes, no host synchronisation."""
    return _dedup_sort(ids, capacity, fill)[:2]


class _DedupTake(torch.autograd.Function):
    """``table[ids]`` for clamped int32 ``ids (N,)`` through the unique
    block, with the sparse scatter-add backward (``_dedup_take`` of the
    JAX package)."""

    @staticmethod
    def forward(ctx, table, ids, capacity: int, use_kernel: bool):
        v = table.shape[0]
        uniq, inv, order, slot = _dedup_sort(ids, capacity, fill=v)
        rows = table.index_select(0, uniq.clamp(0, v - 1).long())
        expand = embed_expand if use_kernel else embed_expand_reference
        # the backward's SA reads the forward's sort as it lies
        ctx.save_for_backward(uniq, inv, order, slot)
        ctx.capacity = capacity
        ctx.table_shape = table.shape
        ctx.table_dtype = table.dtype
        return expand(rows, inv)

    @staticmethod
    def backward(ctx, g):
        uniq, inv, order, slot = ctx.saved_tensors
        v, d = ctx.table_shape
        d_rows = dedup_scatter_add(g.contiguous(), inv, ctx.capacity,
                                   order=order, sorted_slot=slot)
        # dump-row trick: fill slots (uniq == v) land on the sliced-off row;
        # every other target is distinct, so the atomics of index_add_ add
        # each row once onto 0 and the bits are the same on every run
        dw = torch.zeros(v + 1, d, dtype=torch.float32, device=g.device)
        dw.index_add_(0, uniq.clamp(0, v).long(), d_rows)
        return dw[:v].to(ctx.table_dtype), None, None, None


def dedup_embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                           capacity: Optional[int] = None,
                           use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Single-shard dedup'd gather with the sparse scatter-add backward:
    ``table[clamp(ids, 0, V - 1)]`` of shape ``ids.shape + (D,)``, the
    forward bit for bit. ``use_kernel`` routes the expansion through K1
    (default: ``zoo.pallas.embed_gather`` for the table's device)."""
    v, d = table.shape
    orig = ids.shape
    flat = ids.reshape(-1).to(torch.int32).clamp(0, v - 1)
    if capacity is None:
        capacity = dedup_capacity(flat.shape[0], v)
    if use_kernel is None:
        use_kernel = pallas_embed_gather_enabled(table.device)
    out = _DedupTake.apply(table, flat, int(capacity), bool(use_kernel))
    return out.reshape(*orig, d)


def sharded_embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                             mesh: Optional[Mapping[str, int]] = None, *,
                             capacity: Optional[int] = None,
                             dedup: Optional[bool] = None,
                             use_kernel: Optional[bool] = None
                             ) -> torch.Tensor:
    """The lookup of ``ShardedEmbedding``: ``table[ids]`` with ids clamped
    into ``[0, V)``. With ``model == 1`` (always, without a mesh) this is
    the unsharded dedup'd lookup; ``dedup=False`` (``zoo.embed.dedup``)
    keeps the path but sizes the capacity at the id count rounded up to
    8. A row-sharded mesh raises: that form is not ported yet."""
    n_model = model_row_shard_count(mesh)
    if n_model > 1:
        raise NotImplementedError(
            f"the row-sharded embedding lookup (model={n_model}) is not "
            f"ported yet")
    n = ids.numel()
    if dedup is None:
        dedup = bool(get_zoo_context().get("zoo.embed.dedup", True))
    cap = capacity or (dedup_capacity(n, table.shape[0]) if dedup
                       else round_up(n, 8))
    return dedup_embedding_lookup(table, ids, cap, use_kernel)
