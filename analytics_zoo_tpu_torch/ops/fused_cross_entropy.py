"""Fused blockwise LM-head cross-entropy — port of the unsharded half of
``analytics_zoo_tpu/ops/fused_cross_entropy.py``: the replacement for the
full-logits ``sparse_categorical_crossentropy_from_logits`` training
objective that never forms the ``(N, V)`` logits tensor.

* forward: per row, ``logsumexp(h @ W + b)`` and the label's logit, from
  K4 (``ops/pallas/cross_entropy.fused_ce_forward``) or the row-chunked
  plain route;
* backward (:class:`_FusedRows`, the counterpart of the JAX custom VJP):
  ``dlogits = (softmax - onehot) * g`` re-formed from the saved row lse,
  folded into ``dh`` and ``dW``/``db`` by K5a and K5b, or by the chunked
  plain route.

``zoo.pallas.cross_entropy`` picks the route: ``auto`` takes the kernels
on a CUDA tensor, ``true`` takes them everywhere (a CPU tensor then runs
their plain versions), ``false`` takes the chunked plain route on any
device (the JAX package's XLA scan route) — a user's choice, never a
fallback. Labels < 0 are masked out of the loss and every gradient;
labels >= V poison their row (loss and gradient) to NaN, as loudly as the
full-logits objective's gather.

The vocab-sharded form (:func:`sharded_fused_cross_entropy_rows`, JAX
``fused_cross_entropy.py:342-602``) splits the head's ``(H, V)`` weight
column-wise over the ``model`` mesh axis: each rank runs K4 on its own
``(chunk, V/n)`` tiles, and one all-reduce max and one sum merge the
per-rank ``(m, l)`` carries and the label logit, as JAX's one ``pmax`` and
one ``psum`` do. The backward runs K5a and K5b on the rank's slice with
the merged lse; ``dh`` is summed over ``model`` (in f32, rounded once) and
``dW``/``db`` stay on the rank's columns.
"""

from __future__ import annotations

from typing import Optional

import torch

from .pallas.cross_entropy import (DEFAULT_CHUNK, fused_ce_backward,
                                   fused_ce_backward_reference,
                                   fused_ce_forward,
                                   fused_ce_forward_reference)

__all__ = ["fused_cross_entropy_rows", "fused_sparse_cross_entropy",
           "sharded_fused_cross_entropy_rows",
           "sharded_fused_sparse_cross_entropy", "vocab_shard_count",
           "pallas_ce_enabled", "DEFAULT_CHUNK", "AUTO_MIN_VOCAB"]

#: ``zoo.train.fused_ce=auto`` engages the fused loss at or above this head
#: width: below it the full-logits tensor is small
AUTO_MIN_VOCAB = 1024


def pallas_ce_enabled(device) -> bool:
    """``zoo.pallas.cross_entropy``: auto (the kernels on a CUDA tensor) |
    true | false. Covers K4 and the K5a/K5b pair together."""
    from ..common.context import tri_state_conf
    flag = tri_state_conf("zoo.pallas.cross_entropy")
    if flag == "auto":
        return torch.device(device).type == "cuda"
    return flag


def _fwd(h, w, b, labels, chunk: int, use_kernels: bool):
    # a CPU tensor takes the plain route either way, in ``chunk`` rows
    if use_kernels and h.device.type != "cpu":
        return fused_ce_forward(h, w, b, labels)
    return fused_ce_forward_reference(h, w, b, labels, chunk=chunk)


def _bwd(h, w, b, labels, lse, scale, chunk: int, use_kernels: bool,
         dh_dtype=None):
    if use_kernels and h.device.type != "cpu":
        return fused_ce_backward(h, w, b, labels, lse, scale, dh_dtype)
    return fused_ce_backward_reference(h, w, b, labels, lse, scale,
                                       dh_dtype=dh_dtype, chunk=chunk)


def _grad_scale(labels: torch.Tensor, g: torch.Tensor, v: int):
    """The per-row dlogits multiplier: the incoming cotangent on valid
    rows, exactly 0 on masked (label < 0) rows, NaN on over-range
    (label >= v) rows — the poison the forward applied, spread across
    dh/dW by the products as the full-logits backward would."""
    scale = torch.where(labels >= 0, g.float(),
                        torch.zeros((), device=g.device))
    return torch.where(labels >= v, torch.full((), float("nan"),
                                               device=g.device), scale)


def _poison_over_range(rows: torch.Tensor, labels: torch.Tensor, v: int):
    """Labels >= V poison their row to NaN, as the full-logits oracle's
    gather does."""
    return torch.where(labels >= v, torch.full((), float("nan"),
                                               device=rows.device), rows)


class _FusedRows(torch.autograd.Function):
    """The JAX ``_fused_rows`` custom VJP: the forward casts ``w`` to
    ``h``'s dtype and runs K4 (or the chunked route) and saves ``(h, w,
    b, labels, lse)``; the backward builds the grad scale and runs K5a +
    K5b, returning ``dh`` in ``h``'s dtype, ``dW`` in ``w``'s and ``db``
    in ``b``'s."""

    @staticmethod
    def forward(ctx, h, w, b, labels, chunk, use_kernels):
        v = w.shape[1]
        lse, ll = _fwd(h, w.to(h.dtype), b, labels, chunk, use_kernels)
        rows = torch.where(labels >= 0, lse - ll,
                           torch.zeros((), device=lse.device))
        ctx.save_for_backward(h, w, b, labels, lse)
        ctx.chunk, ctx.use_kernels = chunk, use_kernels
        return _poison_over_range(rows, labels, v)

    @staticmethod
    def backward(ctx, g):
        h, w, b, labels, lse = ctx.saved_tensors
        scale = _grad_scale(labels, g, w.shape[1])
        dh, dw, db = _bwd(h, w.to(h.dtype), b, labels, lse, scale,
                          ctx.chunk, ctx.use_kernels)
        return (dh.to(h.dtype), dw.to(w.dtype),
                None if b is None else db.to(b.dtype), None, None, None)


def _resolve_chunk(n: int, chunk: Optional[int]) -> int:
    if chunk is None:
        from ..common.context import get_zoo_context
        chunk = int(get_zoo_context().get("zoo.train.fused_ce_chunk",
                                          DEFAULT_CHUNK) or DEFAULT_CHUNK)
    if chunk <= 0:
        raise ValueError(f"fused-CE chunk must be positive, got {chunk}")
    return max(1, min(chunk, max(n, 1)))


def fused_cross_entropy_rows(hidden: torch.Tensor, w: torch.Tensor,
                             b: Optional[torch.Tensor], labels,
                             chunk: Optional[int] = None,
                             use_pallas: Optional[bool] = None
                             ) -> torch.Tensor:
    """Per-row cross-entropy of ``softmax(hidden @ w [+ b])`` against int
    ``labels`` — f32 ``(N,)``; label < 0 rows give 0 loss and 0 gradient,
    label >= V rows NaN. Differentiable in ``hidden``/``w``/``b``; the
    ``(N, V)`` logits tensor is never formed. ``hidden``, ``w`` and ``b``
    may be strided views. ``use_pallas`` None reads
    ``zoo.pallas.cross_entropy``."""
    n = hidden.shape[0]
    labels = torch.as_tensor(labels, device=hidden.device).reshape(-1).to(
        torch.int32)
    if labels.shape[0] != n:
        raise ValueError(f"fused CE: {n} hidden rows vs {labels.shape[0]} "
                         f"labels")
    chunk = _resolve_chunk(n, chunk)
    if use_pallas is None:
        use_pallas = pallas_ce_enabled(hidden.device)
    # the kernels take dense operands: a view (a tied head's ``emb.T``, a
    # column slice of ``hidden``) is copied here, and autograd hands each
    # gradient back through the copy in the caller's layout
    return _FusedRows.apply(hidden.contiguous(), w.contiguous(),
                            None if b is None else b.contiguous(), labels,
                            chunk, bool(use_pallas))


def fused_sparse_cross_entropy(y_true, hidden: torch.Tensor,
                               w: torch.Tensor,
                               b: Optional[torch.Tensor] = None, *,
                               chunk: Optional[int] = None,
                               use_pallas: Optional[bool] = None
                               ) -> torch.Tensor:
    """Scalar mean fused CE — the drop-in for
    ``sparse_categorical_crossentropy_from_logits(y, hidden @ w + b)``.
    ``hidden`` may be (..., H); labels reshape to the leading dims. The
    mean runs over valid (label >= 0) rows."""
    h2 = hidden.reshape(-1, hidden.shape[-1])
    l2 = torch.as_tensor(y_true, device=hidden.device).reshape(-1).to(
        torch.int32)
    rows = fused_cross_entropy_rows(h2, w, b, l2, chunk=chunk,
                                    use_pallas=use_pallas)
    count = torch.clamp((l2 >= 0).sum().float(), min=1.0)
    return rows.sum() / count


# ---------------------------------------------------------------------------
# the vocab-sharded form
# ---------------------------------------------------------------------------

#: the bias of a pad column: exactly inert in every logsumexp
_NEG_PAD = -1e30


def vocab_shard_count(mesh=None) -> int:
    """Size of the ``model`` mesh axis — the vocab shard count the sharded
    form splits the head over (1: the unsharded op applies)."""
    from ..parallel import mesh as mesh_lib
    mesh = mesh or mesh_lib.global_mesh()
    return int(mesh.shape[mesh_lib.MODEL_AXIS])


def _localize_labels(labels: torch.Tensor, off: int, vs: int):
    """Global labels on this rank's columns: the local column where the
    label lies in ``[off, off + vs)``, else -1 (masked rows, other ranks'
    labels, over-range labels: none of them has a label logit or a onehot
    here; the over-range poison rides the grad scale and the row NaN,
    both keyed on the global label)."""
    loc = labels - off
    mine = (labels >= 0) & (loc >= 0) & (loc < vs)
    return torch.where(mine, loc, torch.full_like(loc, -1))


class _ShardedRows(torch.autograd.Function):
    """The JAX ``_sharded_rows`` custom VJP on the rank's ``(H, V/n)``
    columns ``w`` (and ``b``) of the head."""

    @staticmethod
    def forward(ctx, h, w, b, labels, ax, chunk, v_total, use_kernels):
        from ..parallel.collectives import all_reduce
        vs = w.shape[1]
        lab_loc = _localize_labels(labels, ax.index * vs, vs)
        # a finished local lse is the (m, l) carry (lse_i, 1): the merge
        # reduces to the logsumexp of the ranks' lse's
        lse_i, ll_i = _fwd(h, w.to(h.dtype), b, lab_loc, chunk, use_kernels)
        zero = torch.zeros((), device=h.device)
        m = all_reduce(lse_i, ax, op="max")
        m_safe = torch.where(torch.isneginf(m), zero, m)
        scaled = torch.where(torch.isneginf(lse_i), zero,
                             torch.exp(lse_i - m_safe))
        l = all_reduce(scaled, ax)
        ll = all_reduce(ll_i, ax)
        lse = m_safe + torch.log(torch.where(l == 0.0,
                                             torch.ones((), device=h.device),
                                             l))
        ctx.save_for_backward(h, w, b, labels, lab_loc, lse)
        ctx.ax, ctx.chunk, ctx.v_total = ax, chunk, v_total
        ctx.use_kernels = use_kernels
        rows = torch.where(labels >= 0, lse - ll, zero)
        return _poison_over_range(rows, labels, v_total)

    @staticmethod
    def backward(ctx, g):
        from ..parallel.collectives import all_reduce
        h, w, b, labels, lab_loc, lse = ctx.saved_tensors
        # the grad scale keys on the global label: rows whose label lies
        # on another rank keep the softmax pull (no local onehot)
        scale = _grad_scale(labels, g, ctx.v_total)
        dh, dw, db = _bwd(h, w.to(h.dtype), b, lab_loc, lse, scale,
                          ctx.chunk, ctx.use_kernels,
                          dh_dtype=torch.float32)
        dh = all_reduce(dh, ctx.ax).to(h.dtype)
        return (dh, dw.to(w.dtype), None if b is None else db.to(b.dtype),
                None, None, None, None, None)


def sharded_fused_cross_entropy_rows(hidden: torch.Tensor, w: torch.Tensor,
                                     b: Optional[torch.Tensor], labels,
                                     mesh=None, chunk: Optional[int] = None,
                                     use_pallas: Optional[bool] = None
                                     ) -> torch.Tensor:
    """Vocab-sharded :func:`fused_cross_entropy_rows`: the head's columns
    split over the ``model`` axis, each rank forming only ``(chunk,
    V/n)`` tiles; semantics the unsharded op's (label < 0 rows 0, label
    >= V rows NaN). ``w`` (and ``b``) placed model-sharded on the mesh
    (``parallel.mesh.place_params``) are the rank's columns already; a
    whole weight is padded to the shard count (pad columns inert under a
    ``-1e30`` bias) and the rank's columns taken here, their gradients
    gathered whole again. On a ``model`` axis of 1 this is the unsharded
    op."""
    from ..parallel import mesh as mesh_lib
    from ..parallel.collectives import split_to
    mesh = mesh or mesh_lib.global_mesh()
    ax = mesh.group(mesh_lib.MODEL_AXIS)
    if ax.size <= 1:
        return fused_cross_entropy_rows(hidden, w, b, labels, chunk=chunk,
                                        use_pallas=use_pallas)
    n = hidden.shape[0]
    labels = torch.as_tensor(labels, device=hidden.device).reshape(-1).to(
        torch.int32)
    if labels.shape[0] != n:
        raise ValueError(f"sharded fused CE: {n} hidden rows vs "
                         f"{labels.shape[0]} labels")
    if mesh_lib.sharded_over(w, mesh_lib.MODEL_AXIS) is not None:
        v = w.shape[1] * ax.size
    else:
        v = w.shape[1]
        vp = -(-v // ax.size) * ax.size
        if vp != v:
            w = torch.cat([w, w.new_zeros(w.shape[0], vp - v)], 1)
            bias = b if b is not None else torch.zeros(
                v, dtype=torch.float32, device=w.device)
            b = torch.cat([bias, bias.new_full((vp - v,), _NEG_PAD)])
        w = split_to(w, ax, 1)
        b = None if b is None else split_to(b, ax, 0)
    if use_pallas is None:
        use_pallas = pallas_ce_enabled(hidden.device)
    return _ShardedRows.apply(
        hidden.contiguous(), w.contiguous(),
        None if b is None else b.contiguous(), labels, ax,
        _resolve_chunk(n, chunk), v, bool(use_pallas))


def sharded_fused_sparse_cross_entropy(y_true, hidden: torch.Tensor,
                                       w: torch.Tensor,
                                       b: Optional[torch.Tensor] = None, *,
                                       mesh=None, chunk: Optional[int] = None,
                                       use_pallas: Optional[bool] = None
                                       ) -> torch.Tensor:
    """Scalar mean vocab-sharded fused CE — the model-parallel drop-in for
    :func:`fused_sparse_cross_entropy` (the mean over label >= 0 rows)."""
    h2 = hidden.reshape(-1, hidden.shape[-1])
    l2 = torch.as_tensor(y_true, device=hidden.device).reshape(-1).to(
        torch.int32)
    rows = sharded_fused_cross_entropy_rows(h2, w, b, l2, mesh=mesh,
                                            chunk=chunk,
                                            use_pallas=use_pallas)
    count = torch.clamp((l2 >= 0).sum().float(), min=1.0)
    return rows.sum() / count
