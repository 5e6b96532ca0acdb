"""Attention core ops — port of ``analytics_zoo_tpu/ops/attention.py``: the
oracle ``dot_product_attention`` (the JAX package's XLA path) plus the
head split/merge. Layout ``(B, H, T, D)``."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..common.noise import noise_generator

NEG_INF = -1e9


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          causal: bool = False, dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Multi-head scaled dot-product attention. ``mask`` broadcasts to
    ``(B, H, Tq, Tk)``, 1.0 = attend. Logits and softmax run in f32; the
    weights are cast to ``v.dtype`` before the second product. A row that
    sees no key gets uniform weights (the additive ``-1e9`` mask), unlike
    the flash kernel, which returns zeros there."""
    d_head = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits / math.sqrt(d_head)
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(tq, tk, dtype=torch.bool,
                        device=q.device).tril(diagonal=tk - tq)
        logits = torch.where(cm, logits, torch.full((), NEG_INF,
                                                    device=q.device))
    if mask is not None:
        logits = logits + (1.0 - mask.float()) * NEG_INF
    weights = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.rand(weights.shape,
                          generator=noise_generator(generator, q.device),
                          device=q.device) < 1.0 - dropout_rate
        weights = torch.where(keep, weights / (1.0 - dropout_rate),
                              torch.zeros((), device=q.device))
    out = torch.matmul(weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, H) → (B, n_head, T, H/n_head)."""
    b, t, h = x.shape
    return x.reshape(b, t, n_head, h // n_head).permute(0, 2, 1, 3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, n_head, T, d) → (B, T, n_head*d)."""
    b, nh, t, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, nh * d)
