"""Padding helper — the part of ``analytics_zoo_tpu/ops/pallas/common.py``
the port needs (``pad_to_multiple``). The TPU tile constants, ``round_up``
and the VMEM estimators do not carry over: each CUDA kernel states its own
tiles and shared-memory budget in its source."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_to_multiple(x: torch.Tensor, axis: int, mult: int,
                    value: float = 0.0) -> torch.Tensor:
    """Pad ``axis`` with ``value`` up to the next multiple of ``mult``
    (no-op when already aligned)."""
    rem = (-x.shape[axis]) % mult
    if rem == 0:
        return x
    axis = axis % x.dim()
    # F.pad lists (before, after) pairs from the last axis backwards
    pads = [0, 0] * (x.dim() - 1 - axis) + [0, rem]
    return F.pad(x, pads, value=value)
