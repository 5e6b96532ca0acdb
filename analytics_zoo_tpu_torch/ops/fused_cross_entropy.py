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
full-logits objective's gather. The vocab-sharded forms wait for
multi-GPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from .pallas.cross_entropy import (DEFAULT_CHUNK, fused_ce_backward,
                                   fused_ce_backward_reference,
                                   fused_ce_forward,
                                   fused_ce_forward_reference)

__all__ = ["fused_cross_entropy_rows", "fused_sparse_cross_entropy",
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


def _bwd(h, w, b, labels, lse, scale, chunk: int, use_kernels: bool):
    if use_kernels and h.device.type != "cpu":
        return fused_ce_backward(h, w, b, labels, lse, scale)
    return fused_ce_backward_reference(h, w, b, labels, lse, scale,
                                       chunk=chunk)


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
    ``(N, V)`` logits tensor is never formed. ``use_pallas`` None reads
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
    return _FusedRows.apply(hidden, w, b, labels, chunk, bool(use_pallas))


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
    h2 = hidden.reshape(-1, hidden.shape[-1]).contiguous()
    l2 = torch.as_tensor(y_true, device=hidden.device).reshape(-1).to(
        torch.int32)
    rows = fused_cross_entropy_rows(h2, w, b, l2, chunk=chunk,
                                    use_pallas=use_pallas)
    count = torch.clamp((l2 >= 0).sum().float(), min=1.0)
    return rows.sum() / count
