"""Shared kernel/stride tuple normalizers for the layer modules — a copy
of ``analytics_zoo_tpu/pipeline/api/keras/layers/_shapes.py``."""

from __future__ import annotations

from typing import Tuple


def pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        if len(v) != 2:
            raise ValueError(f"expected 2 values, got {v!r}")
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def triple(v) -> Tuple[int, int, int]:
    if isinstance(v, (tuple, list)):
        if len(v) != 3:
            raise ValueError(f"expected 3 values, got {v!r}")
        return tuple(int(a) for a in v)
    return (int(v),) * 3
