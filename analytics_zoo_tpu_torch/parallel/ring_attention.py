"""Ring and Ulysses attention — port of ``analytics_zoo_tpu/parallel/
ring_attention.py``: sequence parallelism over the ``seq`` mesh axis.

* **Ring** (:func:`ring_attention`, :func:`ring_self_attention`): each
  rank holds its ``T/n`` block of the queries, keys and values; the key
  and value blocks (and their key-padding mask slices) rotate around the
  axis by :func:`parallel.collectives.ring_shift_grad` while a streaming
  softmax accumulates the output in f32 torch ops, as the JAX package's
  does in ``jnp`` (so it owes no kernel): for each block ``s = q·kᵀ/√d``,
  ``m' = max(m, max allowed s)``, ``o = o·e^{m-m'} + e^{s-m'}·v``,
  ``l`` likewise, and at the end ``o / l``. A fully masked block leaves
  ``(o, m, l)`` as they were. ``causal`` masks by global positions.
* **Ulysses** (:func:`ulysses_self_attention`): an all-to-all turns the
  sequence split into a head split (``H/n`` heads, the whole sequence a
  rank), one local attention runs — ``ops/attention.py``'s, or the flash
  kernels K2/K3a/K3b where ``zoo.pallas.attention`` routes there — and a
  second all-to-all restores the sequence split. ``n_head`` must divide
  by the axis.

The ``*_self_attention`` entry points take the whole ``(B, H, T, D)``
arrays, which every rank of the ``seq`` axis holds alike (the port keeps
activations whole outside attention), take the rank's sequence block,
attend, and gather the output blocks whole again; their backward sums
each block's gradient where it belongs.

Dropout: the attention probabilities are dropped with a keep mask per
(query block, key block) pair; every rank draws all the pairs' masks from
the step's generator in one global order and keeps its own, so the
pattern is a function of global position and the generators of the ranks
stay alike. ``l`` sums the probabilities before the drop and ``o`` after
it, so ``o / l`` is dropout applied to the normalised weights.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..common.noise import noise_generator
from . import mesh as mesh_lib
from .collectives import (AxisGroup, all_to_all_grad, gather_from,
                          ring_shift_grad, split_to)

__all__ = ["ring_attention", "ring_self_attention", "ulysses_self_attention"]


def _block_masks(shape, n: int, my: int, rate: float, generator,
                 device) -> list:
    """The keep masks of query block ``my`` against each key block: all
    ``n x n`` pairs drawn in order, the rank's row kept."""
    gen = noise_generator(generator, device)
    out = []
    for qi in range(n):
        for _kj in range(n):
            keep = torch.rand(shape, generator=gen, device=device) >= rate
            if qi == my:
                out.append(keep)
    return out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   ax: Optional[AxisGroup], causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None,
                   dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Blockwise ring attention on this rank's blocks ``(B, H, T_local,
    D)`` of the sequence split over ``ax``; ``kv_mask`` this rank's
    ``(B, T_local)`` key-padding slice (true = attend), which rotates with
    the keys. Returns the rank's output block."""
    n = 1 if ax is None else ax.size
    my = 0 if ax is None else ax.index
    b, h, t_local, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    dev = q.device
    q_pos = my * t_local + torch.arange(t_local, device=dev)
    keeps = (_block_masks((b, h, t_local, t_local), n, my, dropout_rate,
                          generator, dev)
             if dropout_rate > 0.0 and generator is not None else None)
    o = torch.zeros(b, h, t_local, d, dtype=torch.float32, device=dev)
    m = torch.full((b, h, t_local, 1), float("-inf"), device=dev)
    l = torch.zeros(b, h, t_local, 1, dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    mask_blk = None if kv_mask is None else kv_mask.bool()
    zero = torch.zeros((), device=dev)
    for i in range(n):
        src = (my - i) % n
        s = torch.matmul(qf, k_blk.float().transpose(-1, -2)) * scale
        allowed = torch.ones(1, 1, t_local, t_local, dtype=torch.bool,
                             device=dev)
        if causal:
            k_pos = src * t_local + torch.arange(t_local, device=dev)
            allowed = (q_pos[:, None] >= k_pos[None, :])[None, None]
        if mask_blk is not None:
            allowed = allowed & mask_blk[:, None, None, :]
        s_masked = torch.where(allowed, s, torch.full((), float("-inf"),
                                                      device=dev))
        m_new = torch.maximum(m, s_masked.amax(-1, keepdim=True))
        m_safe = torch.where(torch.isneginf(m_new), zero, m_new)
        p = torch.where(allowed, torch.exp(s - m_safe), zero)
        corr = torch.where(torch.isneginf(m), zero, torch.exp(m - m_safe))
        l = l * corr + p.sum(-1, keepdim=True)
        if keeps is not None:
            p = torch.where(keeps[src], p / (1.0 - dropout_rate), zero)
        o = o * corr + torch.matmul(p, v_blk.float())
        m = m_new
        if i < n - 1:
            # the last block is folded in without a final rotation
            k_blk = ring_shift_grad(k_blk, ax)
            v_blk = ring_shift_grad(v_blk, ax)
            if mask_blk is not None:
                mask_blk = ring_shift_grad(mask_blk, ax)
    out = o / torch.where(l == 0.0, torch.ones((), device=dev), l)
    return out.to(q.dtype)


def _checks(q, ax, dropout_rate, generator):
    n = 1 if ax is None else ax.size
    t = q.shape[2]
    if t % n != 0:
        raise ValueError(f"sequence length {t} not divisible by seq axis "
                         f"size {n}")
    if dropout_rate > 0.0 and generator is None:
        raise ValueError("dropout_rate > 0 needs a generator (the JAX "
                         "package's dropout_rng)")


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh: Optional[mesh_lib.Mesh] = None,
                        causal: bool = False,
                        mask: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """The ring on whole ``(B, H, T, D)`` arrays (alike on every rank of
    the ``seq`` axis): each rank attends with its ``T/n`` query block,
    the output blocks are gathered whole. ``mask`` a ``(B, T)``
    key-padding mask (1 = attend). ``T`` must divide by the axis."""
    mesh = mesh or mesh_lib.global_mesh()
    ax = mesh.group(mesh_lib.SEQ_AXIS)
    _checks(q, ax, dropout_rate, generator)
    qb, kb, vb = (split_to(a, ax, 2) for a in (q, k, v))
    mb = None if mask is None else split_to(mask, ax, 1)
    out = ring_attention(qb, kb, vb, ax, causal=causal, kv_mask=mb,
                         dropout_rate=dropout_rate, generator=generator)
    return gather_from(out, ax, 2)


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           mesh: Optional[mesh_lib.Mesh] = None,
                           causal: bool = False,
                           mask: Optional[torch.Tensor] = None,
                           dropout_rate: float = 0.0,
                           generator: Optional[torch.Generator] = None,
                           flash: bool = False) -> torch.Tensor:
    """Ulysses sequence parallelism on whole ``(B, H, T, D)`` arrays:
    each rank's sequence block goes through one all-to-all to a head
    block over the whole sequence, attends locally (``flash``: the
    kernels K2/K3a/K3b, which take no dropout; else the oracle op), and a
    second all-to-all brings the rank's sequence block of every head
    back; the blocks are gathered whole. ``n_head`` must divide by the
    axis."""
    from ..ops.attention import dot_product_attention
    mesh = mesh or mesh_lib.global_mesh()
    ax = mesh.group(mesh_lib.SEQ_AXIS)
    _checks(q, ax, dropout_rate, generator)
    n, h = ax.size, q.shape[1]
    if h % n != 0:
        raise ValueError(f"n_head {h} not divisible by seq axis size {n} "
                         f"— use ring attention instead")
    # (B, H, T/n, D) -> (B, H/n, T, D): scatter heads, gather the sequence
    qg, kg, vg = (all_to_all_grad(split_to(a, ax, 2), ax, 1, 2)
                  for a in (q, k, v))
    if flash:
        from ..ops.pallas import flash_attention
        og = flash_attention(qg.contiguous(), kg.contiguous(),
                             vg.contiguous(), mask=mask, causal=causal)
    else:
        full_mask = None if mask is None else mask[:, None, None, :]
        if dropout_rate > 0.0:
            # every rank draws every head block's mask in rank order and
            # keeps its own, so the generators stay alike
            gen = noise_generator(generator, q.device)
            shape = (qg.shape[0], qg.shape[1], qg.shape[2], kg.shape[2])
            for j in range(ax.index):
                torch.rand(shape, generator=gen, device=q.device)
            og = dot_product_attention(qg, kg, vg, mask=full_mask,
                                       causal=causal,
                                       dropout_rate=dropout_rate,
                                       generator=gen)
            for j in range(ax.index + 1, n):
                torch.rand(shape, generator=gen, device=q.device)
        else:
            og = dot_product_attention(qg, kg, vg, mask=full_mask,
                                       causal=causal)
    # (B, H/n, T, D) -> (B, H, T/n, D): scatter the sequence, gather heads
    out = all_to_all_grad(og, ax, 2, 1)
    return gather_from(out, ax, 2)
