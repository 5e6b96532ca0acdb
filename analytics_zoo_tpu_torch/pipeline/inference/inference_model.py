"""InferenceModel — port of ``analytics_zoo_tpu/pipeline/inference/
inference_model.py`` for one device: the replica-permit queue, the
precision paths of ``from_keras`` (fp32, bf16, int8 weight-only and
calibrated static int8), ``load`` of a ZooModel ``.npz``,
``load_checkpoint`` of a training run's newest snapshot that verifies
(``utils/checkpoint.py``, either package's), and
``predict``/``predict_async`` with power-of-two chunk padding and a bounded
number of in-flight chunks.

``predict_async`` enqueues the device work and returns a ``collect``
callable; ``collect`` is where the port synchronises with the device (the
outputs' ``.cpu()``).

int8 weight-only (``quantize="int8"``): :func:`quantize_int8` splits every
float leaf of at least ``_QUANT_MIN_SIZE`` entries into int8 values and
per-last-axis f32 scales, bit for bit as the JAX package does. The ``W``
of every ``Dense``/``DenseParams`` stays an int8 buffer on the device with
its f32 ``w_scale`` beside it, and each product runs K6 (``ops/pallas/
quantized.py``), which applies the scale after the f32 reduction. Every
other quantized leaf (embedding tables, LayerNorm scales, biases of 512 or
more entries) is dequantized once, at load, with the JAX formula
``q.to(dtype) * s.to(dtype)``: the same bits the JAX package's predict
recomputes inside every call. Leaves stay int8 only where a kernel reads
them as int8; the JAX package dequantizes all of them in its jitted
program and leaves the fusion to XLA.

Static int8 (``quantize="int8", calibrate=batch``): one eager forward
records each quantizable layer's input range (``_calibrate``), the
calibrated layers' weights become int8 with their activation scale
(``_rewrite_quantized``), and predict routes those layers to
``quantized_call``. A ``Dense`` runs kernel Q8 up to 32 rows
(``ops/pallas/quantized.py`` ``static_int8_dense``: the quantize, the int8
x int8 -> int32 product, the rescale, bias and ReLU in one kernel), above
that the same ops in torch with the product on ``torch._int_mm``; a
``Convolution2D`` (and ``AtrousConvolution2D``, which keeps its ``call``)
runs kernel C8 (``static_int8_conv2d``), the conv counterpart of Q8; where
C8's wgmma routes read the weight K-major, the rewrite repacks it once
(``W_kmajor``, a non-persistent buffer: no checkpoint, ``.npz`` or param
tree carries it).

Model state (BatchNorm's moving statistics) is not a parameter: it stays
f32 in every mode and moves to the device as it is, as the JAX runtime
keeps ``net_state`` apart from the params it casts or quantizes.

The weights are put on the device once, at load, never per predict.
"""

from __future__ import annotations

import copy
import queue
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...common.context import resolve_device
from ...common.reliability import RetryPolicy
from ...observability import default_registry
from ...ops.pallas.quantized import conv_takes_kmajor, repack_conv_weight
from ..api.keras.engine import (KerasNet, as_list, as_torch_dtype,
                                intercept_layer_calls, written_state)
from ..api.keras.layers.convolution import Convolution2D
from ..api.keras.layers.core import Dense
from ..api.keras.layers.self_attention import DenseParams

__all__ = ["InferenceModel"]

#: chunked predicts keep at most this many chunk outputs resident on the
#: device: chunk i-1 is read back while chunk i runs / i+1 dispatches
_MAX_INFLIGHT_CHUNKS = 2


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# int8 quantization (numpy, bit for bit the JAX package's)
# ---------------------------------------------------------------------------

_QUANT_MIN_SIZE = 512  # leaves smaller than this stay float (biases, scalars)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts (the param-tree layout)."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _quantize_leaf(a) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    a = np.asarray(a)
    if a.dtype.kind != "f" or a.size < _QUANT_MIN_SIZE or a.ndim < 1:
        return a, None
    axes = tuple(range(a.ndim - 1)) if a.ndim > 1 else (0,)
    amax = np.max(np.abs(a), axis=axes, keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    scale = np.where(scale == 0, 1.0, scale)
    qa = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    return qa, np.squeeze(scale, axis=axes) if a.ndim > 1 else scale


def quantize_int8(params) -> Tuple[Any, Any]:
    """Split a float param tree (nested dicts of arrays) into (int8-or-float
    tree, scale-or-None tree): per-channel symmetric quantization over the
    last axis, so a Dense kernel ``(in, out)`` gets one scale per output
    column; a 1-D leaf gets one scale, shaped ``(1,)``. Leaves under
    ``_QUANT_MIN_SIZE`` entries stay float."""
    if not isinstance(params, dict):
        return _quantize_leaf(params)
    qs, ss = {}, {}
    for k, v in params.items():
        qs[k], ss[k] = quantize_int8(v)
    return qs, ss


def _quantize_layer_entry(sub, act_scale: float):
    """Per-layer static-int8 params: int8 weight + per-out-channel scale +
    the calibrated activation scale (what ``quantized_call`` consumes)."""
    W = np.asarray(sub["W"])
    axes = tuple(range(W.ndim - 1))
    amax = np.max(np.abs(W), axis=axes)
    w_scale = np.where(amax == 0, 1.0, amax / 127.0).astype(np.float32)
    entry = {"W": np.clip(np.round(W / w_scale), -127, 127).astype(np.int8),
             "w_scale": w_scale, "x_scale": np.float32(act_scale)}
    for k, v in sub.items():
        if k != "W":
            entry[k] = np.asarray(v)
    return entry


def dequantize_int8(q_tree, scale_tree, dtype=torch.float32):
    """Inverse of :func:`quantize_int8` as tensors: ``q.to(dtype) *
    s.to(dtype)``, and float leaves without a scale cast to ``dtype``."""

    def dq(q, s):
        q = torch.as_tensor(q)
        if s is None:
            return q.to(dtype) if q.is_floating_point() else q
        return q.to(dtype) * torch.as_tensor(s).to(dtype)

    return _tree_map(dq, q_tree, scale_tree)


def _hollow_copy(model: nn.Module):
    """A deep copy of ``model`` whose parameters are empty placeholders (no
    weight is copied on the way), and ``{path: original parameter}``."""
    originals = dict(model.named_parameters())
    memo = {id(p): nn.Parameter(torch.empty(0), requires_grad=False)
            for p in originals.values()}
    return copy.deepcopy(model, memo), originals


def _owner(net: nn.Module, path: str) -> Tuple[nn.Module, str]:
    mod, _, key = path.rpartition(".")
    return net.get_submodule(mod), key


def _set_param(mod: nn.Module, key: str, value: torch.Tensor) -> None:
    mod._parameters[key] = nn.Parameter(value, requires_grad=False)


class InferenceModel:
    """Replica-permit batched inference runtime.

    >>> im = InferenceModel(concurrent_num=2).from_keras(model,
    ...                                                   dtype="bfloat16")
    >>> probs = im.predict(x)                       # thread-safe
    """

    def __init__(self, concurrent_num: int = 1, *, device=None,
                 max_batch_size: int = 4096, registry=None,
                 readback_retry: Optional[RetryPolicy] = None):
        if concurrent_num < 1:
            raise ValueError("concurrent_num must be >= 1")
        self.device = resolve_device(device)
        self.concurrent_num = int(concurrent_num)
        self.max_batch_size = int(max_batch_size)
        self._readback_retry = readback_retry if readback_retry \
            is not None else RetryPolicy(
                max_attempts=3, base_delay=0.05, max_delay=0.5,
                retryable=(ConnectionError, OSError))
        self.metrics = registry if registry is not None else default_registry()
        self._m_permit_wait = self.metrics.histogram(
            "zoo_inference_permit_wait_seconds",
            "wait for a replica permit per predict dispatch")
        self._m_batch_time = self.metrics.histogram(
            "zoo_inference_batch_seconds",
            "predict dispatch to readback completion per batch "
            "(device time + transfer; overlapped callers hide it)")
        self._m_batches = self.metrics.counter(
            "zoo_inference_batches_total", "predict batches collected")
        self._m_records = self.metrics.counter(
            "zoo_inference_records_total", "records predicted")
        # exactly concurrent_num permits ever exist, so every return is
        # put_nowait and can never block
        self._permits: "queue.Queue[int]" = queue.Queue(
            maxsize=self.concurrent_num)
        for i in range(self.concurrent_num):
            self._permits.put_nowait(i)
        self._model: Optional[KerasNet] = None
        self._dtype = torch.float32
        self._quantize: Optional[str] = None
        #: static int8 only: ``{layer name: (x_scale, W shape)}``
        self._act_scales: Optional[Dict[str, Tuple[float, tuple]]] = None

    # ---- loaders ----------------------------------------------------------
    def load(self, path: str, *, dtype: str = "float32",
             quantize: Optional[str] = None,
             calibrate=None) -> "InferenceModel":
        """Load a ZooModel one-file ``.npz`` (``doLoadBigDL`` role) —
        written by this package or by the JAX package — onto this
        runtime's device."""
        from ...models.common.zoo_model import load_model
        return self.from_keras(load_model(path, device=self.device),
                               dtype=dtype, quantize=quantize,
                               calibrate=calibrate)

    def load_checkpoint(self, model: KerasNet, ckpt_dir: str, *,
                        dtype: str = "float32",
                        quantize: Optional[str] = None,
                        calibrate=None) -> "InferenceModel":
        """Load the newest training snapshot from ``ckpt_dir`` (this
        package's or the JAX package's, ``utils/checkpoint.py``) into
        ``model``'s architecture (``doLoadTF(checkpoint)`` role), then
        serve it as :meth:`from_keras` does. A verified restore with
        fallback, READ-ONLY (``quarantine=False``): this process does not
        own the directory, and what looks uncommitted may be a live
        training run's save in flight."""
        from ...pipeline.api.keras.engine import (load_param_tree,
                                                  named_state)
        from ...pipeline.api.keras.training import (_param_tree, _shape_of,
                                                    tree_module)
        from ...utils.checkpoint import CheckpointManager
        if getattr(model, "built", True) is False:
            model.init_weights()
        net = tree_module(model)
        mgr = CheckpointManager(ckpt_dir, registry=self.metrics)
        out = mgr.restore_latest(
            {"params": _param_tree({n: _shape_of(p)
                                    for n, p in net.named_parameters()}),
             "net_state": _param_tree({n: _shape_of(t) for n, t
                                       in named_state(net).items()})},
            quarantine=False)
        if out is None:
            raise FileNotFoundError(f"no valid snapshot in {ckpt_dir}")
        load_param_tree(net, out[1]["params"], out[1]["net_state"])
        return self.from_keras(model, dtype=dtype, quantize=quantize,
                               calibrate=calibrate)

    def from_keras(self, model: KerasNet, *, dtype: str = "float32",
                   quantize: Optional[str] = None,
                   calibrate=None) -> "InferenceModel":
        """Serve an in-memory model (weights already present).

        ``dtype="bfloat16"`` makes a bf16 copy of the weights on this
        runtime's device and casts float inputs to bf16, as the JAX package
        casts its param tree; outputs come back as float32.
        ``quantize="int8"`` alone is weight-only int8 (int8 weights on the
        device, float compute through K6); adding ``calibrate=batch`` runs
        one eager calibration pass and executes the calibrated Dense layers
        as int8 x int8 -> int32 products with one rescale. The caller's
        model is never modified."""
        self._dtype = as_torch_dtype(dtype)
        if getattr(model, "built", True) is False:
            model.init_weights()
        if calibrate is not None and quantize != "int8":
            raise ValueError(
                "calibrate= requires quantize='int8' (a calibration batch "
                "without a quantized mode would be silently ignored)")
        self._act_scales = None
        if quantize is None:
            params = list(model.parameters())
            if self._dtype != torch.float32 or any(
                    p.device != self.device for p in params):
                model = copy.deepcopy(model)
                if hasattr(model, "device"):
                    model.device = self.device
                model.to(device=self.device)
                if self._dtype != torch.float32:
                    kept = {n: t.clone()
                            for n, t in written_state(model).items()}
                    model.to(dtype=self._dtype)
                    for n, t in kept.items():   # the state stays f32
                        mod, key = _owner(model, n)
                        mod._buffers[key] = t
        elif quantize == "int8":
            if calibrate is not None:
                self._act_scales = self._calibrate(model, calibrate)
                model = self._rewrite_quantized(model, self._act_scales,
                                                self.device)
            else:
                model = self._weight_only(model, self.device, self._dtype)
            if hasattr(model, "device"):
                model.device = self.device
        else:
            raise ValueError(f"unknown quantize mode {quantize!r}; "
                             "use None or 'int8'")
        self._quantize = quantize
        self._model = model.eval()
        return self

    @staticmethod
    def _weight_only(model: nn.Module, device, dtype) -> nn.Module:
        """A copy of ``model`` on ``device`` with :func:`quantize_int8`'s
        leaves: each Dense/DenseParams ``W`` it quantizes as an int8 buffer
        beside its f32 ``w_scale`` (K6 reads both), every other quantized
        leaf dequantized once to ``dtype``, the other float leaves cast to
        ``dtype``."""
        net, originals = _hollow_copy(model)
        for path, p in originals.items():
            mod, key = _owner(net, path)
            t = p.detach()
            q, s = ((t, None) if t.dtype == torch.bfloat16
                    else _quantize_leaf(t.cpu().numpy()))
            if s is not None and key == "W" \
                    and isinstance(mod, (Dense, DenseParams)):
                del mod._parameters[key]
                mod.register_buffer("W", torch.from_numpy(q).to(device))
                mod.register_buffer("w_scale", torch.from_numpy(s).to(device))
            else:
                _set_param(mod, key, dequantize_int8(q, s, dtype).to(device))
        return net.to(device)     # the model state, as it is

    @staticmethod
    def _quantizable(layer) -> bool:
        """True when the class that provides the layer's effective ``call``
        also provides a matching ``quantized_call`` — a subclass that
        overrides ``call`` must not inherit a quantized path with different
        semantics."""
        for cls in type(layer).__mro__:
            if "call" in cls.__dict__:
                return "quantized_call" in cls.__dict__
        return False

    @staticmethod
    def _calibrate(model: nn.Module, calibrate
                   ) -> Dict[str, Tuple[float, tuple]]:
        """One eager forward over the calibration batch, recording per
        quantizable container-dispatched layer the activation scale and
        the kernel shape — ``{name: (x_scale, W_shape)}`` — so the rewrite
        can refuse name-colliding layers elsewhere. The max of colliding
        ranges is taken (conservative)."""
        records: Dict[str, float] = {}
        shapes: Dict[str, tuple] = {}

        def rec(layer, x, training, generator):
            w = layer._parameters.get("W")
            if (InferenceModel._quantizable(layer) and w is not None
                    and not isinstance(x, (list, tuple))):
                amax = float(x.abs().max())
                records[layer.name] = max(records.get(layer.name, 0.0), amax)
                shapes[layer.name] = tuple(w.shape)
            return None

        dev = getattr(model, "device", None)
        if dev is None:
            dev = next(model.parameters()).device
        xs = []
        for a in as_list(calibrate):
            a = np.asarray(a)
            # the JAX package reads the batch through jnp.asarray (32-bit)
            xs.append(torch.from_numpy(np.ascontiguousarray(
                a.astype(np.float32) if a.dtype == np.float64 else a)
            ).to(dev))
        with torch.no_grad(), intercept_layer_calls(rec):
            model.apply(xs if len(xs) > 1 else xs[0], training=False)
        if not records:
            raise ValueError("calibration found no quantizable layer "
                             "(Dense/Convolution2D) in the model")
        return {name: (max(amax, 1e-8) / 127.0, shapes[name])
                for name, amax in records.items()}

    @staticmethod
    def _rewrite_quantized(model: nn.Module, act_scales, device
                           ) -> nn.Module:
        """A copy of ``model`` on ``device`` in which each calibrated
        layer's ``W`` is int8 beside its ``w_scale`` and ``x_scale``
        buffers (:func:`_quantize_layer_entry`), recursing through nested
        containers by attribute name — the JAX param tree's keys. A layer
        is rewritten only when both its name and its kernel shape match
        the calibration record. Every other leaf moves as it is."""
        net, originals = _hollow_copy(model)
        done = set()

        def rewrite(prefix: str, module: nn.Module):
            for k, child in module.named_children():
                path = f"{prefix}{k}"
                entry = act_scales.get(k)
                w = originals.get(f"{path}.W")
                if (entry is not None and w is not None
                        and tuple(w.shape) == entry[1]):
                    sub = {key: p.detach().cpu().numpy()
                           for key, p in originals.items()
                           if key.rpartition(".")[0] == path}
                    e = _quantize_layer_entry(
                        {key.rpartition(".")[2]: v for key, v in sub.items()},
                        entry[0])
                    for key, v in e.items():
                        # contiguous: a conv kernel's float original is
                        # O-major in memory, and C8 reads the HWIO order
                        t = torch.as_tensor(np.ascontiguousarray(v)).to(
                            device)
                        if key in ("W", "w_scale", "x_scale"):
                            child._parameters.pop(key, None)
                            child.register_buffer(key, t)
                        else:
                            _set_param(child, key, t)
                    if isinstance(child, Convolution2D) and \
                            conv_takes_kmajor(child.W.shape[2]):
                        # C8's wgmma routes read W as (F, K), K contiguous:
                        # repacked once here, never saved
                        child.register_buffer(
                            "W_kmajor", repack_conv_weight(child.W),
                            persistent=False)
                    done.update(sub)
                else:
                    rewrite(path + ".", child)

        rewrite("", net)
        for path, p in originals.items():
            if path not in done:
                mod, key = _owner(net, path)
                _set_param(mod, key, p.detach().to(device))
        return net.to(device)     # the model state, as it is

    def _run(self, xs: List[np.ndarray]):
        """One chunk through the model; returns device outputs."""
        return self._forward([torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True) for a in xs])

    def _forward(self, ts: List[torch.Tensor]):
        """The predict program on device tensors: float inputs cast to the
        runtime dtype, the model (with the static-int8 hook), bf16 outputs
        upcast. Launches only device work, so it can be captured in a CUDA
        graph."""
        dtype = self._dtype
        ts = [t.to(dtype) if t.is_floating_point() and dtype != torch.float32
              else t for t in ts]
        act_scales = self._act_scales

        def qhook(layer, x, training, generator):
            if (layer.name in act_scales
                    and getattr(layer, "x_scale", None) is not None
                    and not isinstance(x, (list, tuple))):
                return layer.quantized_call(x)
            return None

        with torch.no_grad(), intercept_layer_calls(
                qhook if act_scales else None):
            y = self._model.apply(ts if len(ts) > 1 else ts[0],
                                  training=False)
        return y.float() if y.dtype == torch.bfloat16 else y

    def predict(self, x, batch_size: Optional[int] = None):
        """Batched predict; blocks while all replica permits are busy.
        Thread-safe."""
        return self.predict_async(x, batch_size)()

    def predict_classes(self, x, zero_based: bool = True):
        """Class ids of :meth:`predict`'s probabilities (argmax, or a 0.5
        threshold for one column)."""
        from ...utils.prediction import probs_to_classes
        return probs_to_classes(self.predict(x), zero_based=zero_based)

    def predict_async(self, x, batch_size: Optional[int] = None,
                      block: bool = True):
        """Dispatch a predict without waiting for the device. Returns a
        zero-argument ``collect`` that synchronises, reads the result back
        and returns it as numpy; the replica permit is held until
        ``collect`` runs, so call it exactly once. Inputs longer than
        ``max_batch_size`` go in chunks (each padded to a power of two by
        repeating its last row), with at most ``_MAX_INFLIGHT_CHUNKS``
        chunk outputs on the device at once. With ``block=False`` the call
        returns None instead of waiting for a permit — a single-threaded
        pipeline must use it for its second in-flight dispatch."""
        if self._model is None:
            raise RuntimeError("no model loaded; call load()/from_keras() "
                               "first")
        xs = [np.asarray(a) for a in as_list(x)]
        n = xs[0].shape[0]
        if n == 0:
            raise ValueError("predict called with an empty batch")
        cap = _next_pow2(self.max_batch_size + 1) // 2
        cap = min(cap, _next_pow2(n))
        if block:
            t_wait = time.perf_counter()
            permit = self._permits.get()
            self._m_permit_wait.observe(time.perf_counter() - t_wait)
        else:
            try:
                permit = self._permits.get_nowait()
            except queue.Empty:
                return None
            self._m_permit_wait.observe(0.0)
        t_dispatch = time.perf_counter()
        deferred = []
        outs = []

        def readback_oldest():
            yp, m = deferred.pop(0)
            host = self._readback_retry.call(
                lambda: yp.cpu().numpy(), op="inference.readback",
                registry=self.metrics)
            outs.append(host[:m])

        try:
            for i in range(0, n, cap):
                if len(deferred) >= _MAX_INFLIGHT_CHUNKS:
                    readback_oldest()
                chunk = [a[i:i + cap] for a in xs]
                m = chunk[0].shape[0]
                padded = _next_pow2(m)
                if m != padded:
                    chunk = [np.concatenate(
                        [a, np.repeat(a[-1:], padded - m, axis=0)], axis=0)
                        for a in chunk]
                deferred.append((self._run(chunk), m))
        except BaseException:
            self._permits.put_nowait(permit)
            raise

        done = [False]

        def collect():
            if done[0]:
                raise RuntimeError("predict_async result already collected")
            done[0] = True
            try:
                while deferred:
                    readback_oldest()
                self._m_batch_time.observe(time.perf_counter() - t_dispatch)
                self._m_batches.inc()
                self._m_records.inc(n)
                return np.concatenate(outs, axis=0)
            finally:
                self._permits.put_nowait(permit)

        return collect

    # ---- introspection ----------------------------------------------------
    def memory_bytes(self) -> int:
        """Weight footprint on the device (parameters and buffers) — shows
        the int8 reduction."""
        if self._model is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in (*self._model.parameters(),
                             *self._model.buffers()))
