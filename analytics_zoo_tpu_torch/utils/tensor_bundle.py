"""TensorFlow tensor-bundle (checkpoint) reader — a copy of
``analytics_zoo_tpu/utils/tensor_bundle.py`` (numpy only); the variables
half of SavedModel import (reference role: ``TFNetForInference.scala:412`` loads
SavedModels *with* their variables via a TF session; here the bundle is
parsed directly with the in-repo codecs, no TF runtime).

A bundle is ``prefix.index`` + ``prefix.data-NNNNN-of-MMMMM`` shards. The
index is a leveldb-format table file: prefix-compressed key blocks, a
block-handle index block, and a fixed 48-byte footer ending in the table
magic. Values are protos: the empty key maps to BundleHeaderProto
(num_shards/endianness/version), every other key is a tensor name mapping
to BundleEntryProto (dtype, shape, shard, offset, size, crc32c)
(``tensorflow/core/protobuf/tensor_bundle.proto``). Tensor bytes are raw
little-endian at [offset, offset+size) of the named shard.

Only what checkpoints actually contain is implemented: uncompressed index
blocks (the bundle writer never compresses them), full tensors (no
partitioned-variable slices), little-endian hosts.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from .proto import parse_fields, parse_varint


def _vint(payload) -> int:
    """parse_fields re-encodes varints as bytes; decode to int."""
    if isinstance(payload, int):
        return payload
    v, _ = parse_varint(payload, 0)
    return v

__all__ = ["read_tensor_bundle", "bundle_tensor_entries"]

_TABLE_MAGIC = 0xdb4775248b80fb57

# tensorflow DataType enum → numpy (the subset bundles carry)
_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
           5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
           14: np.uint16,  # DT_BFLOAT16: raw bits, widened by the caller
           19: np.float16, 22: np.uint32, 23: np.uint64}


def _parse_handle(buf: bytes, i: int) -> Tuple[Tuple[int, int], int]:
    off, i = parse_varint(buf, i)
    size, i = parse_varint(buf, i)
    return (off, size), i


def _read_block(raw: bytes, handle: Tuple[int, int]) -> List[Tuple[bytes, bytes]]:
    """One leveldb block → [(key, value)] via prefix-decompression."""
    off, size = handle
    block = raw[off:off + size]
    ctype = raw[off + size]  # 1-byte compression tag after the block
    if ctype != 0:
        raise NotImplementedError(
            f"compressed index block (type {ctype}); bundle index blocks "
            f"are written uncompressed")
    n_restarts = struct.unpack("<I", block[-4:])[0]
    data_end = len(block) - 4 * (n_restarts + 1)
    entries: List[Tuple[bytes, bytes]] = []
    i, key = 0, b""
    while i < data_end:
        shared, i = parse_varint(block, i)
        unshared, i = parse_varint(block, i)
        vlen, i = parse_varint(block, i)
        key = key[:shared] + block[i:i + unshared]
        i += unshared
        entries.append((key, block[i:i + vlen]))
        i += vlen
    return entries


def _decode_shape(payload: bytes) -> Tuple[int, ...]:
    dims = []
    for f, wt, p in parse_fields(payload):
        if f == 2:  # Dim
            size = 0
            for ff, _, pp in parse_fields(p):
                if ff == 1:
                    size = _vint(pp)
            dims.append(size)
    return tuple(dims)


def bundle_tensor_entries(prefix: str) -> Dict[str, Dict]:
    """Parse ``prefix.index`` → {tensor_name: {dtype, shape, shard, offset,
    size}} plus the header's shard count under the ``""`` key."""
    index_path = prefix + ".index"
    with open(index_path, "rb") as f:
        raw = f.read()
    if len(raw) < 48:
        raise ValueError(f"{index_path}: too short to be a bundle index")
    footer = raw[-48:]
    magic = struct.unpack("<Q", footer[-8:])[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{index_path}: bad table magic "
                         f"{magic:#x} (not a tensor-bundle index)")
    i = 0
    _meta, i = _parse_handle(footer, i)
    index_handle, i = _parse_handle(footer, i)

    entries: Dict[str, Dict] = {}
    num_shards = 1
    for _ikey, ival in _read_block(raw, index_handle):
        data_handle, _ = _parse_handle(ival, 0)
        for key, val in _read_block(raw, data_handle):
            if key == b"":
                for f, wt, p in parse_fields(val):
                    if f == 1:
                        num_shards = _vint(p)
                continue
            ent = {"dtype": 1, "shape": (), "shard": 0, "offset": 0,
                   "size": 0}
            for f, wt, p in parse_fields(val):
                if f == 1:
                    ent["dtype"] = _vint(p)
                elif f == 2 and isinstance(p, (bytes, bytearray)):
                    ent["shape"] = _decode_shape(p)
                elif f == 3:
                    ent["shard"] = _vint(p)
                elif f == 4:
                    ent["offset"] = _vint(p)
                elif f == 5:
                    ent["size"] = _vint(p)
                elif f == 7:
                    raise NotImplementedError(
                        f"tensor {key.decode()!r} is a partitioned-variable "
                        f"slice; merge the checkpoint first")
            entries[key.decode("utf-8")] = ent
    entries[""] = {"num_shards": num_shards}
    return entries


def read_tensor_bundle(prefix: str) -> Dict[str, np.ndarray]:
    """Read every tensor of the bundle at ``prefix`` (e.g.
    ``.../variables/variables``). DT_BFLOAT16 widens to float32."""
    entries = bundle_tensor_entries(prefix)
    header = entries.pop("")
    num_shards = header["num_shards"]
    shard_bytes: Dict[int, bytes] = {}
    out: Dict[str, np.ndarray] = {}
    for name, ent in entries.items():
        shard = ent["shard"]
        if shard not in shard_bytes:
            path = f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"
            if not os.path.exists(path):
                raise FileNotFoundError(f"bundle shard missing: {path}")
            with open(path, "rb") as f:
                shard_bytes[shard] = f.read()
        code = ent["dtype"]
        if code not in _DTYPES:
            raise NotImplementedError(
                f"tensor {name!r}: unsupported dtype enum {code}")
        dt = np.dtype(_DTYPES[code]).newbyteorder("<")
        buf = shard_bytes[shard][ent["offset"]:ent["offset"] + ent["size"]]
        arr = np.frombuffer(buf, dtype=dt).reshape(ent["shape"])
        if code == 14:  # bf16 bits → f32
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = np.ascontiguousarray(arr)
    return out
