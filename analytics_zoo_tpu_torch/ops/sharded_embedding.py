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

The host-RAM cold tier: :class:`OutOfCoreEmbeddingCache` keeps the
table's head on the device (sized by ``zoo.embed.hot_rows_budget_mb``)
and the rest in pinned host memory; :meth:`~OutOfCoreEmbeddingCache.plan`
resolves one batch on the host (np.unique's dedup, the staged LRU of cold
rows, one fetch of the missing ones) into an :class:`EmbeddingFetchPlan`,
:meth:`~OutOfCoreEmbeddingCache.stream` stages the plans on a prefetch
thread, and :func:`oocore_gather` reads the virtual ``[hot; cold]`` table
(plain torch, as the JAX package leaves it to XLA). Its gradient per
distinct id is taken by SA in position order, from the plan's sort, so
it has the same bits on every run.

On a mesh whose ``model`` axis is larger than 1 the lookup is
row-partitioned (:func:`sharded_embedding_lookup`): each rank gathers the
distinct ids' rows it owns, one all-reduce over ``model`` completes the
block, K1 expands it on every rank, and the backward's SA runs on the
rank's ids and scatters onto its own rows.
"""

from __future__ import annotations

import collections
import threading
from typing import Iterable, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..common.context import get_zoo_context
from ..parallel.collectives import all_reduce
from .pallas.embedding import (dedup_scatter_add, embed_expand,
                               embed_expand_reference,
                               pallas_embed_gather_enabled)

__all__ = ["EmbeddingFetchPlan", "OutOfCoreEmbeddingCache",
           "dedup_capacity", "dedup_embedding_lookup",
           "model_row_shard_count", "oocore_gather",
           "sharded_embedding_lookup"]


def round_up(x: int, mult: int) -> int:
    return (x + mult - 1) // mult * mult


def model_row_shard_count(mesh=None) -> int:
    """Size of the ``model`` axis of ``mesh`` (a mesh, or a mapping of
    axis sizes; default the global mesh): the row shard count of the
    lookup."""
    if mesh is None:
        from ..parallel.mesh import global_mesh
        mesh = global_mesh()
    sizes = getattr(mesh, "shape", mesh)
    return int(sizes.get("model", 1))


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


class _RowShardedTake(torch.autograd.Function):
    """The row-sharded lookup's rank-local half (JAX
    ``_sharded_fwd_local``/``_sharded_bwd_local``): ``table`` is the rank's
    ``(V/n, D)`` row block, ``ids (N,)`` the clamped ids (alike on every
    rank of the ``model`` axis). Forward: the fixed-capacity unique, the
    owned unique rows gathered (the others exact zeros, in f32), one sum
    over ``model`` (each distinct row crosses once: the JAX ``psum``),
    then K1 expands the block to the id stream. Backward: SA sums the row
    cotangents per distinct id in position order, and the owned slots
    scatter onto the rank's rows (the others onto a dump row)."""

    @staticmethod
    def forward(ctx, table, ids, capacity: int, use_kernel: bool, ax):
        vs = table.shape[0]
        uniq, inv, order, slot = _dedup_sort(ids, capacity,
                                             fill=vs * ax.size)
        loc = uniq.long() - ax.index * vs
        own = (loc >= 0) & (loc < vs)
        rows_local = torch.where(
            own[:, None],
            table.index_select(0, loc.clamp(0, vs - 1)).float(),
            torch.zeros((), dtype=torch.float32, device=table.device))
        rows = all_reduce(rows_local, ax).to(table.dtype)
        expand = embed_expand if use_kernel else embed_expand_reference
        ctx.save_for_backward(loc, own, inv, order, slot)
        ctx.capacity, ctx.vs, ctx.dtype = capacity, vs, table.dtype
        return expand(rows, inv)

    @staticmethod
    def backward(ctx, g):
        loc, own, inv, order, slot = ctx.saved_tensors
        vs = ctx.vs
        d_rows = dedup_scatter_add(g.contiguous(), inv, ctx.capacity,
                                   order=order, sorted_slot=slot)
        safe = torch.where(own, loc.clamp(0, vs - 1),
                           torch.full_like(loc, vs))
        dw = torch.zeros(vs + 1, g.shape[1], dtype=torch.float32,
                         device=g.device)
        dw.index_add_(0, safe, d_rows)
        return dw[:vs].to(ctx.dtype), None, None, None, None


def _model_group(table: torch.Tensor, mesh):
    """The ``model`` axis the lookup shards over: ``mesh``'s (a mesh, or a
    mapping of axis sizes, which names no process group), else the mesh
    the table was placed on (``parallel.mesh.place_params``), else the
    global mesh's."""
    from ..parallel.mesh import MODEL_AXIS, Mesh, global_mesh
    if mesh is None:
        mesh = getattr(table, "_zoo_mesh", None) or global_mesh()
    if isinstance(mesh, Mesh):
        return mesh.group(MODEL_AXIS)
    if int(mesh.get(MODEL_AXIS, 1)) > 1:
        raise ValueError(
            f"the row-sharded lookup (model={mesh[MODEL_AXIS]}) needs a "
            f"parallel.mesh.Mesh, whose model axis has its process group; "
            f"axis sizes alone name no ranks")
    return None


def sharded_embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                             mesh=None, *,
                             capacity: Optional[int] = None,
                             dedup: Optional[bool] = None,
                             use_kernel: Optional[bool] = None
                             ) -> torch.Tensor:
    """The lookup of ``ShardedEmbedding``: ``table[ids]`` with ids clamped
    into ``[0, V)``. ``mesh`` defaults to the one the table was placed on,
    else the global mesh. On a ``model`` axis of one rank (always, in one
    process) this is the unsharded dedup'd lookup. On a larger one the
    table's rows split over it (JAX ``sharded_embedding_lookup``): a table
    placed row-sharded is this rank's block already; a whole table (its
    rows do not divide the axis) is padded and this rank's block taken
    here, its gradient gathered whole again. ``dedup=False``
    (``zoo.embed.dedup``) keeps the path but sizes the capacity at the id
    count rounded up to 8."""
    from ..parallel.collectives import split_to
    from ..parallel.mesh import MODEL_AXIS, sharded_over
    ax = _model_group(table, mesh)
    n = ids.numel()
    if dedup is None:
        dedup = bool(get_zoo_context().get("zoo.embed.dedup", True))
    if ax is None or ax.size == 1:
        cap = capacity or (dedup_capacity(n, table.shape[0]) if dedup
                           else round_up(n, 8))
        return dedup_embedding_lookup(table, ids, cap, use_kernel)
    if sharded_over(table, MODEL_AXIS) is not None:
        local, v = table, table.shape[0] * ax.size
    else:
        v = table.shape[0]
        vp = round_up(v, ax.size)
        padded = (table if vp == v else torch.cat(
            [table, table.new_zeros(vp - v, table.shape[1])]))
        local = split_to(padded, ax, 0)
    d = local.shape[1]
    orig = ids.shape
    flat = ids.reshape(-1).to(torch.int32).clamp(0, v - 1)
    cap = capacity or (dedup_capacity(n, v) if dedup else round_up(n, 8))
    if cap < min(n, v):
        raise ValueError(
            f"dedup capacity {cap} cannot hold the worst-case {min(n, v)} "
            f"unique ids per shard — the unique would silently truncate; "
            f"raise capacity or leave it unset")
    if use_kernel is None:
        use_kernel = pallas_embed_gather_enabled(table.device)
    out = _RowShardedTake.apply(local, flat, int(cap), bool(use_kernel), ax)
    return out.reshape(*orig, d)


# ---------------------------------------------------------------------------
# the host-RAM cold tier
# ---------------------------------------------------------------------------

def _conf(key: str, default):
    """``key`` from the zoo context when one is constructible, else
    ``default`` (the op stays usable standalone)."""
    try:
        return get_zoo_context().get(key, default)
    except Exception:  # zoolint: disable=ZL007 no context constructible
        return default


def oocore_gather(hot: torch.Tensor, cold: torch.Tensor,
                  remap: torch.Tensor) -> torch.Tensor:
    """The two-tier gather: ``remap`` indexes the virtual table ``[hot;
    cold]``, ``hot`` the device-resident head, ``cold`` the staged
    ``(capacity, D)`` rows the host plan uploaded. Plain torch
    (``index_select`` and ``torch.where``), differentiable in both tiers
    through torch's own backward; :meth:`OutOfCoreEmbeddingCache.rows`
    takes the gradient through SA instead."""
    hr, d = hot.shape[0], cold.shape[1]
    flat = remap.reshape(-1).long()
    cold_part = cold.index_select(
        0, (flat - hr).clamp(0, cold.shape[0] - 1)).reshape(
            *remap.shape, d)
    if hr == 0:
        return cold_part
    hot_part = hot.index_select(0, flat.clamp(0, hr - 1)).reshape(
        *remap.shape, d)
    return torch.where((remap < hr)[..., None], hot_part, cold_part)


class _OocoreRows(torch.autograd.Function):
    """:func:`oocore_gather` forward; backward: the row cotangents summed
    per distinct id by SA, each id's rows in position order (the plan's
    stable sort of ``inv``), then each sum copied to its id's row of the
    hot tier or its slot of the cold block (distinct targets, so no float
    atomics: the same bits on every run)."""

    @staticmethod
    def forward(ctx, hot, cold, remap, inv, order, sorted_slot, uniq_slot):
        ctx.save_for_backward(inv, order, sorted_slot, uniq_slot)
        ctx.hot_rows, ctx.cap = hot.shape[0], cold.shape[0]
        ctx.dtypes = (hot.dtype, cold.dtype)
        return oocore_gather(hot, cold, remap)

    @staticmethod
    def backward(ctx, g):
        inv, order, sorted_slot, uniq_slot = ctx.saved_tensors
        hr = ctx.hot_rows
        d = g.shape[-1]
        sums = dedup_scatter_add(g.reshape(-1, d).contiguous(), inv,
                                 uniq_slot.shape[0], order=order,
                                 sorted_slot=sorted_slot)
        virt = torch.zeros(hr + ctx.cap, d, dtype=torch.float32,
                           device=g.device)
        virt.index_copy_(0, uniq_slot, sums)
        return (virt[:hr].to(ctx.dtypes[0]), virt[hr:].to(ctx.dtypes[1]),
                None, None, None, None, None)


class EmbeddingFetchPlan:
    """One batch's host plan: the ``cold`` row block (its shape bucketed
    by :func:`dedup_capacity`), the ``remap`` into the virtual ``[hot;
    cold]`` table, and what the gradient needs: ``inv`` (each position's
    distinct id), its stable sort (``order``, ``sorted_slot``) and each
    distinct id's virtual row (``uniq_slot``). The arrays are numpy views
    of the host tensors the upload reads (pinned for a CUDA cache)."""

    __slots__ = ("ids", "remap", "cold", "cold_ids", "hot_rows",
                 "table_shape", "inv", "order", "sorted_slot", "uniq_slot",
                 "host")

    def __init__(self, ids, remap, cold, cold_ids, hot_rows, table_shape,
                 inv, order, sorted_slot, uniq_slot, pin: bool = False):
        self.ids = ids
        self.cold_ids = cold_ids
        self.hot_rows = int(hot_rows)
        self.table_shape = tuple(table_shape)
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in
                (cold, remap, inv, order, sorted_slot, uniq_slot)]
        #: (cold, remap, inv, order, sorted_slot, uniq_slot) as host tensors
        self.host = tuple(t.pin_memory() for t in host) if pin \
            else tuple(host)
        (self.cold, self.remap, self.inv, self.order, self.sorted_slot,
         self.uniq_slot) = (t.numpy() for t in self.host)

    def scatter_grad(self, d_hot, d_cold) -> np.ndarray:
        """The dense ``(V, D)`` f32 gradient from the tier cotangents (the
        host-side scatter-add an optimizer, or a parity test, applies to
        the master table)."""
        v, d = self.table_shape
        dw = np.zeros((v, d), np.float32)
        if self.hot_rows:
            dw[:self.hot_rows] += _numpy_f32(d_hot)
        dc = _numpy_f32(d_cold)
        np.add.at(dw, self.cold_ids, dc[:self.cold_ids.size])
        return dw


def _numpy_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


class OutOfCoreEmbeddingCache:
    """A two-tier table: the hot head on ``device`` (its rows from the
    ``zoo.embed.hot_rows_budget_mb`` budget) and the cold tail in host
    memory (pinned for a CUDA device). :meth:`plan` resolves one batch's
    missing rows (dedup'd: each distinct cold row fetched and uploaded
    once); :meth:`stream` overlaps that with the device's work on a
    prefetch thread and degrades to a fetch on the consumer's thread when
    a prefetch fails (the ``embed.prefetch`` fault site): a step can
    stall, never wedge. Fetches from host memory pass the
    ``embed.host_fetch`` site; a ledger charges blocked time to
    ``data_wait``. The counters and gauges are the JAX package's."""

    def __init__(self, table, *, hot_rows: Optional[int] = None,
                 prefetch_depth: Optional[int] = None,
                 staged_rows: int = 8192, registry=None, ledger=None,
                 device="cuda"):
        from ..observability import default_registry
        self.device = torch.device(device)
        self._pin = self.device.type == "cuda"
        self._table = np.ascontiguousarray(np.asarray(table, np.float32))
        v, d = self._table.shape
        if hot_rows is None:
            budget_mb = float(_conf("zoo.embed.hot_rows_budget_mb", 64))
            hot_rows = int((budget_mb * 1024 * 1024) // max(d * 4, 1))
        self.hot_rows = max(0, min(int(hot_rows), v))
        self._hot = torch.from_numpy(
            self._table[:self.hot_rows].copy()).to(self.device)
        cold = torch.from_numpy(self._table[self.hot_rows:].copy())
        # the cold tier stays in host memory, contiguous for fast slicing
        self._cold_host = cold.pin_memory() if self._pin else cold
        self._cold = self._cold_host.numpy()
        if prefetch_depth is None:
            prefetch_depth = int(_conf("zoo.embed.prefetch_depth", 2))
        self.prefetch_depth = max(1, int(prefetch_depth))
        self._staged_max = max(int(staged_rows), 1)
        self._staged: "collections.OrderedDict[int, np.ndarray]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._ledger = ledger
        reg = registry if registry is not None else default_registry()
        self._c_hits = reg.counter(
            "zoo_embed_cache_hits_total",
            "unique ids served without a host fetch (device-resident hot "
            "tier or already-staged cold rows)")
        self._c_misses = reg.counter(
            "zoo_embed_cache_misses_total",
            "unique cold-tier ids that required a host-RAM row fetch")
        self._c_prefetch = reg.counter(
            "zoo_embed_prefetch_rows_total",
            "cold rows staged ahead of the consuming step by the "
            "prefetch thread")
        self._c_dedup = reg.counter(
            "zoo_embed_dedup_saved_rows_total",
            "gathered rows saved by per-batch id dedup (ids seen minus "
            "unique ids)")
        self._c_prefetch_err = reg.counter(
            "zoo_embed_prefetch_errors_total",
            "prefetch attempts that failed and degraded to a "
            "synchronous fetch on the consumer thread")
        self._g_ids = reg.counter(
            "zoo_embed_ids_total",
            "ids resolved through the cache (dedup ratio denominator)")
        reg.gauge("zoo_embed_prefetch_depth",
                  "plan buffer depth of the cold-tier prefetch thread"
                  ).set(self.prefetch_depth)
        reg.gauge("zoo_embed_hot_rows",
                  "rows of the embedding table resident on device (the "
                  "hot tier; the rest live in host RAM)"
                  ).set(self.hot_rows)

    @property
    def hot(self) -> torch.Tensor:
        """The device-resident hot tier."""
        return self._hot

    @property
    def table(self) -> np.ndarray:
        """The host master copy."""
        return self._table

    def plan(self, ids) -> EmbeddingFetchPlan:
        """One batch resolved on the host: the ids clamped and dedup'd,
        hot and staged rows served from the cache, the missing cold rows
        fetched from host memory (``embed.host_fetch``), and the ``(cold,
        remap)`` pair with the gradient's sort, in (pinned) host
        tensors."""
        v, d = self._table.shape
        ids_np = np.asarray(ids)
        flat = np.clip(ids_np.reshape(-1).astype(np.int64), 0,
                       max(v - 1, 0))
        uniq, inv = np.unique(flat, return_inverse=True)
        inv = inv.reshape(-1)
        self._g_ids.inc(int(flat.size))
        self._c_dedup.inc(int(flat.size - uniq.size))
        hot_mask = uniq < self.hot_rows
        self._c_hits.inc(int(hot_mask.sum()))
        cold_ids = uniq[~hot_mask]
        rows = self._cold_rows(cold_ids)
        cap = dedup_capacity(max(int(cold_ids.size), 1), max(v, 1))
        cold = np.zeros((cap, d), np.float32)
        cold[:cold_ids.size] = rows
        slot = np.empty(uniq.size, np.int64)
        slot[hot_mask] = uniq[hot_mask]
        slot[~hot_mask] = self.hot_rows + np.arange(cold_ids.size)
        remap = slot[inv].astype(np.int32).reshape(ids_np.shape)
        order = np.argsort(inv, kind="stable")
        return EmbeddingFetchPlan(ids_np, remap, cold, cold_ids,
                                  self.hot_rows, (v, d), inv=inv,
                                  order=order, sorted_slot=inv[order],
                                  uniq_slot=slot, pin=self._pin)

    def _cold_rows(self, cold_ids: np.ndarray) -> np.ndarray:
        """Rows of the (distinct) cold ids: staged LRU hits first, then one
        batched host fetch for the misses."""
        d = self._table.shape[1]
        out = np.empty((cold_ids.size, d), np.float32)
        miss_pos, miss_ids = [], []
        with self._lock:
            for j, i in enumerate(cold_ids.tolist()):
                row = self._staged.get(i)
                if row is not None:
                    self._staged.move_to_end(i)
                    out[j] = row
                else:
                    miss_pos.append(j)
                    miss_ids.append(i)
        self._c_hits.inc(cold_ids.size - len(miss_ids))
        if miss_ids:
            self._c_misses.inc(len(miss_ids))
            fetched = self._host_fetch(np.asarray(miss_ids, np.int64))
            out[np.asarray(miss_pos)] = fetched
            with self._lock:
                for i, row in zip(miss_ids, fetched):
                    self._staged[i] = row
                while len(self._staged) > self._staged_max:
                    self._staged.popitem(last=False)
        return out

    def _host_fetch(self, miss_ids: np.ndarray) -> np.ndarray:
        from ..common import faults
        faults.inject("embed.host_fetch")
        return self._cold[miss_ids - self.hot_rows]

    def rows(self, plan: EmbeddingFetchPlan,
             hot: Optional[torch.Tensor] = None,
             cold: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The rows of a planned batch on the device, ``ids.shape + (D,)``:
        the plan's host tensors uploaded once (from pinned memory, without
        a host sync), then the two-tier gather. ``hot`` (default the cache's
        tier) and ``cold`` (default the plan's block) may be tensors that
        take the gradient, which flows back through SA."""
        hot = self._hot if hot is None else hot
        dev = hot.device
        host = plan.host
        up = [t.to(dev, non_blocking=True) for t in host]
        if cold is not None:
            up[0] = cold
        return _OocoreRows.apply(hot, *up)

    def stream(self, batches: Iterable, *, ledger=None
               ) -> Iterator[Tuple[np.ndarray, EmbeddingFetchPlan]]:
        """``(ids, plan)`` for each batch, the upcoming plans staged by a
        background thread (``feature_set._ThreadedIterator``, the machinery
        of ``prefetch_to_device``). A failed prefetch (``embed.prefetch``)
        is counted and its plan rebuilt on the consumer's thread. Blocked
        pulls and such rebuilds are ``data_wait`` on the ledger, the
        consumer's work ``device_step``."""
        from ..common import faults
        from ..feature.feature_set import _ThreadedIterator
        ledger = ledger if ledger is not None else self._ledger

        def note(category):
            if ledger is not None:
                ledger.note(category)

        def staged():
            for ids in batches:
                try:
                    faults.inject("embed.prefetch")
                    p = self.plan(ids)
                    self._c_prefetch.inc(int(p.cold_ids.size))
                    yield ids, p
                # degrade, never wedge: the consumer refetches in line
                except Exception:  # zoolint: disable=ZL007
                    self._c_prefetch_err.inc()
                    yield ids, None
        src = _ThreadedIterator(staged(), buffer_size=self.prefetch_depth)
        note("idle")
        try:
            for ids, p in src:
                if p is None:
                    p = self.plan(ids)    # the degraded fetch, in line
                note("data_wait")
                yield ids, p
                note("device_step")
        finally:
            note("data_wait")
            src.close()
