"""Minimal protobuf wire-format codec — a copy of ``analytics_zoo_tpu/
utils/proto.py`` (no torch, no jax), shared by the TensorBoard event
writer/reader and the importers (no protobuf-runtime dependency; the wire
format is 4 primitives: varint, 64-bit, length-delimited, 32-bit)."""

from __future__ import annotations

import struct
from typing import Iterator, Tuple

__all__ = ["varint", "field_bytes", "field_varint", "field_double",
           "field_float", "parse_varint", "parse_fields"]


def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field_bytes(num: int, payload: bytes) -> bytes:
    return varint((num << 3) | 2) + varint(len(payload)) + payload


def field_varint(num: int, value: int) -> bytes:
    return varint(num << 3) + varint(value & 0xFFFFFFFFFFFFFFFF)


def field_double(num: int, value: float) -> bytes:
    return varint((num << 3) | 1) + struct.pack("<d", value)


def field_float(num: int, value: float) -> bytes:
    return varint((num << 3) | 5) + struct.pack("<f", value)


def parse_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def parse_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_num, wire_type, payload) — varints re-encoded so callers
    can parse them uniformly."""
    i = 0
    while i < len(buf):
        key, i = parse_varint(buf, i)
        num, wt = key >> 3, key & 7
        if wt == 0:
            v, i = parse_varint(buf, i)
            yield num, wt, varint(v)
        elif wt == 1:
            yield num, wt, buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = parse_varint(buf, i)
            yield num, wt, buf[i:i + ln]
            i += ln
        elif wt == 5:
            yield num, wt, buf[i:i + 4]
            i += 4
        else:
            raise IOError(f"unsupported wire type {wt}")
