"""TFNet — a frozen TensorFlow ``GraphDef`` (.pb) run as a ``Layer`` of
torch ops — port of ``analytics_zoo_tpu/pipeline/api/tfnet.py``
(``TFNet.scala:53-56``; ``Net.loadTF``).

No TF runtime: the GraphDef is decoded with the in-repo wire codec
(``utils/proto.py``; the decoder below is a numpy-only copy of the JAX
package's) and each node maps to torch ops, so an imported graph serves
and fine-tunes under the port's training step like any other layer.

Values follow the JAX package's rules:

* Float Const tensors of rank >= 1 become trainable parameters, unless
  ``trainable=False`` or the Const is structural (a Reshape shape, an
  axis, a pad table ...); ``FusedBatchNorm``'s mean and variance never
  train. A parameter is registered under a stand-in name (``c0``, ``c1``
  ... in the sorted order of the node names), since a TF node name may
  hold a ``.``, which ``register_parameter`` refuses; ``Layer._tree_keys``
  maps each back, so ``load_jax_params``, checkpoints, the ``.npz`` and
  ``install_imported_weights`` see the JAX tree's keys (the node names),
  in its order.
* Every other Const stays a host value. Structural inputs must be host
  values: a computed tensor reaching one raises ``NotImplementedError``
  (the JAX ``_static``). ``Shape`` and ``Rank`` give host int32 arrays.
  The Consts read as tensors are copied to the layer's device at load
  (and again when the layer is moved) and kept there.
* Device: the weights and those copies sit on ``device`` (``cuda``
  unless the caller passes another). An input is not moved: a tensor on
  another device raises; a numpy input is made on the layer's device.
* Dtypes: float64 computes as float32 (the JAX package runs with x64
  off); ``Cast`` to int64 and ``ArgMax`` give int64 (torch's index
  dtype), where the JAX package gives int32: the values are the same.
* ``SAME`` padding is XLA's, the smaller half low, padded explicitly
  (``-inf`` for MaxPool); AvgPool divides by the cells of each window
  inside the input. ``Gather`` follows ``jnp.take``'s fill rule (an index
  in ``[-n, 0)`` wraps once, any other outside ``[0, n)`` reads NaN or the
  most negative integer), as the port's ``Embedding`` does.
"""

from __future__ import annotations

import heapq
import struct
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.proto import parse_fields, parse_varint
from .keras.engine import Layer, probe_output_shape, squeeze_dim
from .keras.layers.convolution import conv_nhwc, window_pads
from .keras.layers.pooling import _avg, _pool

__all__ = ["TFNet", "load_tf"]

# tensorflow DataType enum → numpy (DT_BFLOAT16=14 widens to f32 on the
# host via an explicit bit-pattern conversion in _decode_tensor)
_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
           5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
           14: np.float32, 19: np.float16}

#: the torch dtype a value of each numpy dtype computes in (float64 as
#: float32, as the JAX package does with x64 off)
_TORCH = {np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float32,
          np.dtype(np.float16): torch.float16,
          np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
          np.dtype(np.int16): torch.int16, np.dtype(np.int8): torch.int8,
          np.dtype(np.uint8): torch.uint8, np.dtype(np.bool_): torch.bool}


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _as_int(payload: bytes) -> int:
    v, _ = parse_varint(payload, 0)
    return v


def _packed_ints(payload: bytes, wt: int) -> List[int]:
    if wt == 2:
        out, i = [], 0
        while i < len(payload):
            v, i = parse_varint(payload, i)
            out.append(_signed(v))
        return out
    return [_signed(_as_int(payload))]


# ---------------------------------------------------------------------------
# GraphDef decoding (tensorflow/core/framework/{graph,node_def,attr_value,
# tensor,tensor_shape}.proto subset)
# ---------------------------------------------------------------------------

def _decode_shape(buf: bytes) -> List[int]:
    dims: List[int] = []
    for num, wt, payload in parse_fields(buf):
        if num == 2:  # Dim
            size = -1
            for n2, _, p2 in parse_fields(payload):
                if n2 == 1:
                    size = _signed(_as_int(p2))
            dims.append(size)
    return dims


def _bits_to_float(vals: List[int], code: int) -> np.ndarray:
    """half_val holds raw bit patterns for DT_HALF and DT_BFLOAT16."""
    u16 = np.asarray(vals, np.uint16)
    if code == 14:  # bfloat16: bits are the top half of a float32
        return (u16.astype(np.uint32) << 16).view(np.float32)
    return u16.view(np.float16).astype(np.float32)


def _decode_tensor(buf: bytes) -> np.ndarray:
    # field numbers per tensorflow/core/framework/tensor.proto:
    # dtype=1 shape=2 tensor_content=4 half_val=13 float_val=5
    # double_val=6 int_val=7 string_val=8 int64_val=10 bool_val=11
    code = 1
    shape: List[int] = []
    content: Optional[bytes] = None
    floats: List[float] = []
    ints: List[int] = []
    doubles: List[float] = []
    bools: List[bool] = []
    halves: List[int] = []
    strings: List[bytes] = []
    for num, wt, payload in parse_fields(buf):
        if num == 1:
            code = _as_int(payload)
            # DT_STRING (7) decodes to an object array so Saver-machinery
            # consts (file patterns, slice names) survive GRAPH DECODE;
            # executing one still fails at the consuming op
            if code != 7 and code not in _DTYPES:
                raise NotImplementedError(f"TensorProto dtype {code}")
        elif num == 2:
            shape = _decode_shape(payload)
        elif num == 8:               # string_val
            strings.append(bytes(payload))
        elif num == 4:
            content = payload
        elif num == 5:               # float_val
            if wt == 2:
                floats.extend(struct.unpack(f"<{len(payload) // 4}f",
                                            payload))
            else:
                floats.append(struct.unpack("<f", payload)[0])
        elif num == 6:               # double_val
            if wt == 2:
                doubles.extend(struct.unpack(f"<{len(payload) // 8}d",
                                             payload))
            else:
                doubles.append(struct.unpack("<d", payload)[0])
        elif num in (7, 10):         # int_val / int64_val
            ints.extend(_packed_ints(payload, wt))
        elif num == 11:              # bool_val
            bools.extend(bool(v) for v in _packed_ints(payload, wt))
        elif num == 13:              # half_val (f16/bf16 bit patterns)
            halves.extend(_packed_ints(payload, wt))
    if code == 7:
        return np.asarray(strings, dtype=object).reshape(
            shape if shape else (len(strings),) if len(strings) != 1 else ())
    dtype = _DTYPES[code]
    n = int(np.prod(shape)) if shape else 1
    if content is not None:
        if code == 14:
            u16 = np.frombuffer(content, dtype=np.uint16)
            arr = (u16.astype(np.uint32) << 16).view(np.float32).copy()
        else:
            arr = np.frombuffer(content, dtype=dtype).copy()
    elif halves:
        arr = _bits_to_float(halves, code).astype(dtype)
    elif floats:
        arr = np.asarray(floats, dtype)
    elif doubles:
        arr = np.asarray(doubles, dtype)
    elif ints:
        arr = np.asarray(ints, dtype)
    elif bools:
        arr = np.asarray(bools, dtype)
    else:
        arr = np.zeros(0, dtype)
    if arr.size == 1 and n > 1:      # TF scalar-splat encoding
        arr = np.full(n, arr.reshape(-1)[0], dtype)
    return arr.reshape(shape)


def _decode_attr(buf: bytes) -> Any:
    """AttrValue → python value (s/i/f/b/type/shape/tensor/list)."""
    for num, wt, payload in parse_fields(buf):
        if num == 2:
            return payload.decode("utf-8", "replace")
        if num == 3:
            return _signed(_as_int(payload))
        if num == 4:
            return struct.unpack("<f", payload[:4])[0]
        if num == 5:
            return bool(_as_int(payload))
        if num == 6:
            return ("dtype", _as_int(payload))
        if num == 7:
            return _decode_shape(payload)
        if num == 8:
            return _decode_tensor(payload)
        if num == 1:  # ListValue
            ints: List[int] = []
            strs: List[str] = []
            floats: List[float] = []
            for n2, wt2, p2 in parse_fields(payload):
                if n2 == 2:
                    strs.append(p2.decode("utf-8", "replace"))
                elif n2 in (3, 6):
                    ints.extend(_packed_ints(p2, wt2))
                elif n2 == 4:
                    if wt2 == 2:
                        floats.extend(
                            struct.unpack(f"<{len(p2) // 4}f", p2))
                    else:
                        floats.append(struct.unpack("<f", p2)[0])
            return strs or floats or ints
    return None


def _decode_node(buf: bytes) -> Dict[str, Any]:
    node = {"name": "", "op": "", "inputs": [], "attrs": {}}
    for num, wt, payload in parse_fields(buf):
        if num == 1:
            node["name"] = payload.decode("utf-8")
        elif num == 2:
            node["op"] = payload.decode("utf-8")
        elif num == 3:
            node["inputs"].append(payload.decode("utf-8"))
        elif num == 5:  # attr map entry
            key, val = "", None
            for n2, _, p2 in parse_fields(payload):
                if n2 == 1:
                    key = p2.decode("utf-8")
                elif n2 == 2:
                    val = _decode_attr(p2)
            node["attrs"][key] = val
    return node


def _decode_graph(buf: bytes) -> List[Dict[str, Any]]:
    nodes = []
    for num, wt, payload in parse_fields(buf):
        if num == 1:
            nodes.append(_decode_node(payload))
    return nodes


# ---------------------------------------------------------------------------
# host values and tensors
# ---------------------------------------------------------------------------

class _HostConst:
    """A Const's host array, with one device copy for each device it is
    read on as a tensor (made outside a captured step: the capture's
    warm-up step runs first)."""

    def __init__(self, arr: np.ndarray):
        self.arr = arr
        self.tensors: Dict[Any, torch.Tensor] = {}

    def on(self, device) -> torch.Tensor:
        t = self.tensors.get(device)
        if t is None:
            t = _host_tensor(self.arr, device)
            self.tensors[device] = t
        return t


def _host_tensor(arr, device) -> torch.Tensor:
    """``arr`` as a tensor of its computing dtype on ``device``; never a
    view of a read-only buffer (a decoded or bundle array may be one)."""
    arr = np.asarray(arr)
    t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return t.to(device=device, dtype=_TORCH[arr.dtype])


def _static(v, what) -> np.ndarray:
    """A structural input's host value; a computed tensor is refused."""
    if isinstance(v, torch.Tensor):
        raise NotImplementedError(
            f"{what} must be a graph constant, found a computed tensor")
    return np.asarray(v.arr if isinstance(v, _HostConst) else v)


def _static_scalar(v, what) -> int:
    return int(_static(v, what).reshape(-1)[0])


# ---------------------------------------------------------------------------
# op semantics
# ---------------------------------------------------------------------------

def _conv2d(x, w, attrs, *, depthwise=False):
    sh, sw = attrs.get("strides", [1, 1, 1, 1])[1:3]
    dil = attrs.get("dilations", [1, 1, 1, 1])[1:3]
    if attrs.get("data_format", "NHWC") != "NHWC":
        raise NotImplementedError("only NHWC Conv2D is supported")
    pads = window_pads(x.shape[1:3], w.shape[:2], (sh, sw),
                       attrs.get("padding", "SAME"), dil)
    groups = w.shape[2] if depthwise else 1
    if depthwise:
        # HWCM → HW1(C*M) with C groups: output channel c*M + m
        w = w.reshape(w.shape[0], w.shape[1], 1, -1)
    return conv_nhwc(x, w, (sh, sw), pads, tuple(dil), groups)


def _pool2d(x, attrs, op):
    if attrs.get("data_format", "NHWC") != "NHWC":
        raise NotImplementedError(f"only NHWC {op} is supported")
    window = tuple(attrs.get("ksize", [1, 2, 2, 1])[1:3])
    strides = tuple(attrs.get("strides", [1, 2, 2, 1])[1:3])
    padding = attrs.get("padding", "VALID")
    if op == "MaxPool":
        return _pool(x, window, strides, padding, "max")
    return _avg(x, window, strides, padding)


def _fused_bn(xs, attrs):
    if attrs.get("data_format", "NHWC") != "NHWC":
        raise NotImplementedError("only NHWC FusedBatchNorm is supported")
    x, scale, offset, mean, var = xs
    eps = attrs.get("epsilon", 1e-3) or 1e-3
    if attrs.get("is_training", False):
        raise NotImplementedError(
            "FusedBatchNorm with is_training=True (frozen graphs only)")
    inv = torch.rsqrt(var + eps) * scale
    return x * inv + (offset - mean * inv)


def _reduce_dims(fn):
    """``fn`` over each of ``axes`` in turn (torch's ``prod``/``all``/
    ``any`` take one dim)."""
    def run(x, dim, keepdim):
        for d in sorted((d % x.dim() for d in dim), reverse=True):
            x = fn(x, dim=d, keepdim=keepdim)
        return x
    return run


def _mean(x, dim, keepdim):
    if not x.is_floating_point():
        x = x.float()
    return torch.mean(x, dim=dim, keepdim=keepdim)


_ELEMENTWISE = {
    "Add": torch.add, "AddV2": torch.add, "Sub": torch.sub,
    "Mul": torch.mul, "RealDiv": torch.div, "Div": torch.div,
    "Maximum": torch.maximum, "Minimum": torch.minimum, "Pow": torch.pow,
    "SquaredDifference": lambda a, b: torch.square(a - b),
    "FloorDiv": torch.floor_divide, "Mod": torch.remainder,
    "FloorMod": torch.remainder,
    "Greater": torch.gt, "GreaterEqual": torch.ge,
    "Less": torch.lt, "LessEqual": torch.le, "Equal": torch.eq,
    "LogicalAnd": torch.logical_and, "LogicalOr": torch.logical_or,
}

_UNARY = {
    "Relu": torch.relu, "Relu6": F.relu6, "Elu": F.elu,
    "Selu": F.selu, "Softplus": F.softplus,
    "Softsign": F.softsign, "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh, "Exp": torch.exp, "Log": torch.log,
    "Neg": torch.neg, "Abs": torch.abs, "Square": torch.square,
    "Sqrt": torch.sqrt, "Rsqrt": torch.rsqrt, "Erf": torch.erf,
    "Floor": torch.floor, "Ceil": torch.ceil,
    "Round": torch.round,                 # half to even, as jnp.round
    "StopGradient": torch.Tensor.detach,
    "Reciprocal": torch.reciprocal, "LogicalNot": torch.logical_not,
}

#: ops that hand their input on unchanged, a host value as a host value
#: (the SavedModel importer turns VarHandleOp into a Const carrying the
#: restored value, so a resource-variable read is one)
_PASS = {"Identity", "ReadVariableOp"}

_REDUCE = {"Mean": _mean, "Sum": torch.sum, "Max": torch.amax,
           "Min": torch.amin, "Prod": _reduce_dims(torch.prod),
           "All": _reduce_dims(torch.all), "Any": _reduce_dims(torch.any)}

# (op, input position) pairs whose values must stay host constants
_STRUCTURAL = {("Reshape", 1), ("ConcatV2", -1), ("Transpose", 1),
               ("Pad", 1), ("PadV2", 1), ("ExpandDims", 1), ("Mean", 1),
               ("Sum", 1), ("Max", 1), ("Min", 1), ("Prod", 1), ("All", 1),
               ("Any", 1), ("ArgMax", 1), ("GatherV2", 2),
               ("Tile", 1), ("Fill", 0), ("StridedSlice", 1),
               ("StridedSlice", 2), ("StridedSlice", 3)}

# (op, input position) pairs pinned NON-trainable even under trainable=True:
# FusedBatchNorm's moving mean/variance (positions 3, 4) are inference-mode
# STATISTICS — updating them by gradient descent silently diverges from
# frozen-BN fine-tune semantics (scale/offset at 1, 2 stay trainable, as in
# a standard BN fine-tune)
_FROZEN_STATS = {("FusedBatchNorm", 3), ("FusedBatchNorm", 4),
                 ("FusedBatchNormV2", 3), ("FusedBatchNormV2", 4),
                 ("FusedBatchNormV3", 3), ("FusedBatchNormV3", 4)}

# every op _run_node dispatches on; the load-time coverage check uses this
_SUPPORTED_OPS = (set(_UNARY) | _PASS | set(_ELEMENTWISE) | set(_REDUCE) | {
    "AddN", "LeakyRelu", "Softmax", "LogSoftmax", "MatMul", "BatchMatMul",
    "BatchMatMulV2", "BiasAdd", "Conv2D", "DepthwiseConv2dNative",
    "MaxPool", "AvgPool", "FusedBatchNorm", "FusedBatchNormV2",
    "FusedBatchNormV3", "Reshape", "Squeeze", "ExpandDims", "ConcatV2",
    "Pack", "Transpose", "Pad", "PadV2", "GatherV2", "Gather", "Tile",
    "Cast", "ArgMax", "Shape", "Rank", "StridedSlice", "Fill"})


def _take(x, ids, axis: int):
    """``jnp.take(x, ids, axis=axis)`` with its default fill rule."""
    x0 = x.movedim(axis, 0)
    v = x0.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + v, ids)
    valid = (ids >= 0) & (ids < v)
    rows = x0[ids.clamp(0, v - 1)]
    if x.is_floating_point():
        fill = float("nan")
    elif x.dtype == torch.bool:
        fill = False
    else:
        fill = torch.iinfo(x.dtype).min
    rows = torch.where(valid.reshape(valid.shape + (1,) * (x0.dim() - 1)),
                       rows, torch.full((), fill, dtype=x.dtype,
                                        device=x.device))
    k = ids.dim()
    return rows.movedim(tuple(range(k)), tuple(range(axis, axis + k)))


def _strided_slice(xs, attrs, t):
    x = xs[0]
    begin = _static(xs[1], "StridedSlice begin").astype(int)
    end = _static(xs[2], "StridedSlice end").astype(int)
    strides = (_static(xs[3], "StridedSlice strides").astype(int)
               if len(xs) > 3 else np.ones_like(begin))
    bm = attrs.get("begin_mask", 0)
    em = attrs.get("end_mask", 0)
    sm = attrs.get("shrink_axis_mask", 0)
    if attrs.get("new_axis_mask", 0) or attrs.get("ellipsis_mask", 0):
        raise NotImplementedError("StridedSlice new_axis/ellipsis masks")
    idx = []
    for i in range(len(begin)):
        if sm & (1 << i):
            idx.append(int(begin[i]))
            continue
        b = None if bm & (1 << i) else int(begin[i])
        e = None if em & (1 << i) else int(end[i])
        idx.append(slice(b, e, int(strides[i])))
    if not isinstance(x, torch.Tensor):          # a host value stays one
        return np.asarray(x.arr if isinstance(x, _HostConst) else x)[
            tuple(idx)]
    x = t(x)
    # torch slices only forwards: a negative step gathers its indices;
    # the dims go last to first, so a dropped dim moves no earlier one
    for d in reversed(range(len(idx))):
        sp = idx[d]
        if isinstance(sp, int):
            x = x.select(d, sp)
        elif sp.step > 0:
            x = x[(slice(None),) * d + (sp,)]
        else:
            x = x.index_select(d, torch.arange(
                *sp.indices(x.shape[d]), device=x.device))
    return x


def _run_node(node, vals, device):
    op = node["op"]
    attrs = node["attrs"]
    names = [n for n in node["inputs"] if not n.startswith("^")]
    xs = [vals[n] for n in names]  # producers register both name and name:0

    def t(v):
        """``v`` as a tensor on the graph's device."""
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(v, _HostConst):
            return v.on(device)
        return _host_tensor(v, device)

    if op in _PASS:
        out = xs[0]
    elif op in _UNARY:
        out = _UNARY[op](t(xs[0]))
    elif op in _ELEMENTWISE:
        out = _ELEMENTWISE[op](t(xs[0]), t(xs[1]))
    elif op == "AddN":
        out = t(xs[0])
        for a in xs[1:]:
            out = out + t(a)
    elif op == "LeakyRelu":
        out = F.leaky_relu(t(xs[0]), attrs.get("alpha", 0.2))
    elif op == "Softmax":
        out = torch.softmax(t(xs[0]), dim=-1)
    elif op == "LogSoftmax":
        out = torch.log_softmax(t(xs[0]), dim=-1)
    elif op == "MatMul":
        a, b = t(xs[0]), t(xs[1])
        a = a.T if attrs.get("transpose_a") else a
        b = b.T if attrs.get("transpose_b") else b
        # f32 accumulation, the result in the input's dtype
        out = (torch.matmul(a, b) if a.dtype == torch.float32
               else torch.matmul(a.float(), b.float()).to(a.dtype))
    elif op == "BatchMatMulV2" or op == "BatchMatMul":
        a, b = t(xs[0]), t(xs[1])
        a = a.transpose(-1, -2) if attrs.get("adj_x") else a
        b = b.transpose(-1, -2) if attrs.get("adj_y") else b
        out = torch.matmul(a, b)
    elif op == "BiasAdd":
        x, b = t(xs[0]), t(xs[1])
        if attrs.get("data_format", "NHWC") == "NCHW" and x.dim() == 4:
            out = x + b.reshape(1, -1, 1, 1)
        else:
            out = x + b
    elif op == "Conv2D":
        out = _conv2d(t(xs[0]), t(xs[1]), attrs)
    elif op == "DepthwiseConv2dNative":
        out = _conv2d(t(xs[0]), t(xs[1]), attrs, depthwise=True)
    elif op in ("MaxPool", "AvgPool"):
        out = _pool2d(t(xs[0]), attrs, op)
    elif op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
        out = _fused_bn([t(v) for v in xs], attrs)
    elif op in _REDUCE:
        x = t(xs[0])
        axes = tuple(int(a) for a in
                     np.atleast_1d(_static(xs[1], f"{op} axes")))
        out = _REDUCE[op](x, dim=axes or tuple(range(x.dim())),
                          keepdim=bool(attrs.get("keep_dims", False)))
    elif op == "Reshape":
        out = t(xs[0]).reshape(
            tuple(int(d) for d in _static(xs[1], "Reshape shape")))
    elif op == "Squeeze":
        x = t(xs[0])
        dims = attrs.get("squeeze_dims") or None
        if dims:
            for d in sorted((d % x.dim() for d in dims), reverse=True):
                x = squeeze_dim(x, d)
            out = x
        else:
            out = x.squeeze()
    elif op == "ExpandDims":
        out = t(xs[0]).unsqueeze(_static_scalar(xs[1], "ExpandDims axis"))
    elif op == "ConcatV2":
        axis = _static_scalar(xs[-1], "ConcatV2 axis")
        out = torch.cat([t(v) for v in xs[:-1]], dim=axis)
    elif op == "Pack":
        out = torch.stack([t(v) for v in xs], dim=attrs.get("axis", 0))
    elif op == "Transpose":
        out = t(xs[0]).permute(
            *(int(p) for p in _static(xs[1], "Transpose perm")))
    elif op in ("Pad", "PadV2"):
        pads = [tuple(int(v) for v in row)
                for row in _static(xs[1], "Pad paddings")]
        cv = (float(_static(xs[2], "PadV2 constant").reshape(-1)[0])
              if len(xs) > 2 else 0.0)
        out = F.pad(t(xs[0]), [p for row in reversed(pads) for p in row],
                    value=cv)
    elif op == "GatherV2" or op == "Gather":
        axis = (_static_scalar(xs[2], "Gather axis")
                if len(xs) > 2 else 0)
        x = t(xs[0])
        out = _take(x, t(xs[1]), axis % x.dim())
    elif op == "Tile":
        x = t(xs[0])
        reps = tuple(int(v) for v in _static(xs[1], "Tile multiples"))
        out = x.repeat(*((1,) * (x.dim() - len(reps)) + reps))
    elif op == "Cast":
        code = attrs.get("DstT")
        code = code[1] if isinstance(code, tuple) else code
        out = t(xs[0]).to(_TORCH[np.dtype(_DTYPES[code])])
    elif op == "ArgMax":
        out = torch.argmax(t(xs[0]),
                           dim=_static_scalar(xs[1], "ArgMax axis"))
    elif op == "Shape":
        x = xs[0]
        out = np.asarray(x.arr.shape if isinstance(x, _HostConst)
                         else np.shape(x) if not isinstance(x, torch.Tensor)
                         else tuple(x.shape), np.int32)
    elif op == "Rank":
        x = xs[0]
        out = np.asarray(len(x.shape) if isinstance(x, torch.Tensor)
                         else np.ndim(x.arr if isinstance(x, _HostConst)
                                      else x), np.int32)
    elif op == "StridedSlice":
        out = _strided_slice(xs, attrs, t)
    elif op == "Fill":
        dims = tuple(int(d) for d in _static(xs[0], "Fill dims"))
        out = t(xs[1]).reshape(()).expand(dims).clone()
    else:
        raise NotImplementedError(f"TF op {op!r} (node {node['name']!r})")
    vals[node["name"]] = out
    vals[node["name"] + ":0"] = out


# ---------------------------------------------------------------------------
# the Layer
# ---------------------------------------------------------------------------

class TFNet(Layer):
    """A frozen TF graph as a Layer (the JAX ``TFNet``).

    Float Const tensors of rank >= 1 become trainable parameters (pass
    ``trainable=False`` to pin them as host constants, the frozen
    semantics of the reference's TFNet); everything else (shapes, axes,
    perms, scalars) stays a host constant. The parameters exist from
    construction (``build`` adds none); :meth:`param` reads one by its
    node name. Its output shape comes from a forward on the meta device
    (:func:`probe_output_shape`), since only the graph can tell it.
    ``device``: where the weights live, ``cuda`` unless given."""

    def __init__(self, nodes: List[Dict[str, Any]],
                 inputs: Optional[List[str]] = None,
                 outputs: Optional[List[str]] = None,
                 trainable: bool = True, device=None, **kwargs):
        from ...common.context import resolve_device
        super().__init__(**kwargs)
        self.device = resolve_device(device)
        known = {n["name"] for n in nodes}
        for node in nodes:
            for raw in node["inputs"]:
                base, _, port = raw.lstrip("^").partition(":")
                if base not in known:
                    raise ValueError(
                        f"node {node['name']!r} consumes unknown tensor "
                        f"{raw!r}")
                if port not in ("", "0"):
                    raise NotImplementedError(
                        f"node {node['name']!r} consumes secondary output "
                        f"{raw!r}; only :0 outputs are computed")
        self.nodes = [n for n in nodes if n["op"] not in ("NoOp",)]
        placeholders = [n["name"] for n in self.nodes
                        if n["op"] == "Placeholder"]
        # PlaceholderWithDefault: only a feed when explicitly requested;
        # otherwise its input (the graph-supplied default) binds it at call.
        # A graph with NO pure Placeholder still needs somewhere to put the
        # caller's data — then the with-default nodes become the feeds.
        self._defaults = {n["name"]: n["inputs"][0].split(":")[0]
                          for n in self.nodes
                          if n["op"] == "PlaceholderWithDefault"
                          and n["inputs"]}
        self.feed_names = inputs or placeholders or list(self._defaults)
        if outputs:
            self.output_names = outputs
        else:
            consumed = set()
            for n in self.nodes:
                consumed.update(i.lstrip("^").split(":")[0]
                                for i in n["inputs"])
            self.output_names = [n["name"] for n in self.nodes
                                 if n["name"] not in consumed
                                 and n["op"] != "Const"] or \
                [self.nodes[-1]["name"]]

        structural = set()
        for n in self.nodes:
            names = [i for i in n["inputs"] if not i.startswith("^")]
            for pos, raw in enumerate(names):
                key = (n["op"], pos)
                last = (n["op"], -1)
                if (key in _STRUCTURAL or key in _FROZEN_STATS
                        or (last in _STRUCTURAL
                            and pos == len(names) - 1)):
                    structural.add(raw.split(":")[0])

        self.consts: Dict[str, np.ndarray] = {}
        weights: Dict[str, np.ndarray] = {}
        for n in self.nodes:
            if n["op"] != "Const":
                continue
            arr = n["attrs"].get("value")
            if arr is None:
                raise ValueError(f"Const node {n['name']!r} has no value")
            arr = np.asarray(arr)
            if (trainable and arr.ndim >= 1 and n["name"] not in structural
                    and np.issubdtype(arr.dtype, np.floating)):
                weights[n["name"]] = arr
            else:
                self.consts[n["name"]] = arr
        self._host = {name: _HostConst(arr)
                      for name, arr in self.consts.items()}
        self._placed = [self._host[name] for name in self.consts
                        if name not in structural]
        self._place_consts()
        # stand-in attribute names in the sorted order of the node names,
        # so the port's tree order is the JAX tree's
        keys = sorted(weights)
        width = len(str(max(len(keys) - 1, 0)))
        self._tree_keys = {f"c{i:0{width}d}": key
                           for i, key in enumerate(keys)}
        for attr, key in self._tree_keys.items():
            self.add_weight(attr, _host_tensor(weights[key], self.device))
        exec_nodes = [n for n in self.nodes
                      if n["op"] not in ("Const", "Placeholder",
                                         "PlaceholderWithDefault")]
        self._exec_nodes = self._topo_sort(exec_nodes)
        # fail at load, not mid-run: check op coverage against the SAME
        # set _run_node dispatches on (no second hand-kept list)
        for n in self._exec_nodes:
            if n["op"] not in _SUPPORTED_OPS:
                raise NotImplementedError(
                    f"TF op {n['op']!r} (node {n['name']!r})")

    @staticmethod
    def _topo_sort(nodes):
        """GraphDef does NOT guarantee topological node order: Kahn-sort
        (O(N+E), indegree counters + a by-file-order heap) so ``call``
        never reads a value before its producer ran, with deterministic
        ordering among ready nodes."""
        index = {n["name"]: i for i, n in enumerate(nodes)}
        indeg = {n["name"]: 0 for n in nodes}
        consumers: Dict[str, List[str]] = {n["name"]: [] for n in nodes}
        for n in nodes:
            deps = {raw.lstrip("^").split(":")[0] for raw in n["inputs"]}
            for d in deps:
                if d in indeg:
                    indeg[n["name"]] += 1
                    consumers[d].append(n["name"])
        ready = [index[name] for name, d in indeg.items() if d == 0]
        heapq.heapify(ready)
        ordered = []
        while ready:
            n = nodes[heapq.heappop(ready)]
            ordered.append(n)
            for c in consumers[n["name"]]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    heapq.heappush(ready, index[c])
        if len(ordered) != len(nodes):
            cyc = sorted(name for name, d in indeg.items() if d > 0)[:5]
            raise ValueError(f"GraphDef has a dependency cycle near {cyc}")
        return ordered

    @property
    def device(self) -> torch.device:
        """Where the weights and the constants' copies sit."""
        return self._device

    @device.setter
    def device(self, device) -> None:
        # with its index, as a tensor's device reads
        self._device = torch.empty(0, device=device).device

    def _place_consts(self) -> None:
        """Copy the Consts read as tensors to ``self.device``, once."""
        for c in self._placed:
            c.tensors = {self.device: c.on(self.device)}

    def _apply(self, fn, *args, **kwargs):
        """``.to``/``.cuda``/``.cpu``: the parameters move, and the
        layer's device and its constants' copies follow them."""
        out = super()._apply(fn, *args, **kwargs)
        self.device = fn(torch.empty(0, device=self.device)).device
        self._place_consts()
        return out

    def param(self, key: str) -> torch.nn.Parameter:
        """The trainable parameter of Const node ``key``."""
        for attr, k in self._tree_keys.items():
            if k == key:
                return getattr(self, attr)
        raise KeyError(f"{self.name}: no trainable Const {key!r}")

    def build(self, input_shape=None, *, generator=None):
        """Nothing to create: the parameters are the graph's Consts."""

    def compute_output_shape(self, input_shape):
        return probe_output_shape(self.call, input_shape)

    def call(self, x, *, training=False, generator=None):
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        if len(xs) != len(self.feed_names):
            raise ValueError(f"expected {len(self.feed_names)} inputs "
                             f"({self.feed_names}), got {len(xs)}")
        xs = [v if isinstance(v, torch.Tensor)
              else torch.as_tensor(v, device=self.device) for v in xs]
        device = xs[0].device
        probe = device.type == "meta"    # a shape probe: shapes only
        if not probe and device != self.device:
            raise ValueError(
                f"{self.name}: input on {device}, weights on {self.device}; "
                f"move the input or the layer (.to)")
        vals: Dict[str, Any] = {}
        for name, c in self._host.items():
            vals[name] = vals[name + ":0"] = c
        for attr, key in self._tree_keys.items():
            p = getattr(self, attr)
            vals[key] = vals[key + ":0"] = p.to(device) if probe else p
        for name, arr in zip(self.feed_names, xs):
            vals[name] = vals[name + ":0"] = arr
        for name, src in self._defaults.items():
            if name in vals:
                continue  # explicitly fed
            if src not in vals:
                raise ValueError(
                    f"PlaceholderWithDefault {name!r}: default {src!r} is "
                    f"not a constant; feed it explicitly via inputs=[...]")
            vals[name] = vals[name + ":0"] = vals[src]
        for node in self._exec_nodes:
            _run_node(node, vals, device)
        outs = [vals[n] for n in self.output_names]
        outs = [o.on(device) if isinstance(o, _HostConst)
                else o if isinstance(o, torch.Tensor)
                else _host_tensor(o, device) for o in outs]
        return outs[0] if len(outs) == 1 else outs


def load_tf(path: str, inputs: Optional[List[str]] = None,
            outputs: Optional[List[str]] = None,
            trainable: bool = True, device=None) -> TFNet:
    """Load a frozen GraphDef ``.pb`` — ``Net.loadTF`` /
    ``TFNet(path)`` parity (``pipeline/api/Net.scala:123-171``) — with
    its weights on ``device`` (``cuda`` unless given)."""
    with open(path, "rb") as f:
        nodes = _decode_graph(f.read())
    if not nodes:
        raise ValueError(f"{path}: no nodes decoded — not a GraphDef?")
    return TFNet(nodes, inputs=inputs, outputs=outputs, trainable=trainable,
                 device=device)
