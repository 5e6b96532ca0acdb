"""Layer engine — port of ``analytics_zoo_tpu/pipeline/api/keras/engine.py``
(the dtype policy, initializers, layer-call interception, ``Layer`` and
``KerasNet.apply``).

A ``Layer`` is an ``nn.Module`` built in two phases, as in the JAX package:
the constructor takes the configuration, ``build(input_shape, generator=)``
creates the parameters (on the CPU, from an explicit ``torch.Generator``)
once shapes are known. Parameter attribute names are the JAX param-tree
keys (``W``, ``b``, ``gamma``, ``block0`` ...), so ``named_parameters``
spells the same paths as the JAX tree and weights move across name for
name. A Dense ``W`` stays ``(d_in, d_out)``.

``Sequential`` stacks layers in order; ``Model`` runs a graph built with
the functional API (``Input``, then layers called on ``Variable``s), in
the JAX package's toposort order and with its positional auto-names.
``Lambda`` wraps a torch function as a graph node, and ``Variable``'s
operators (``+ - * / **``, unary ``-``, slicing, ``index_select``,
``squeeze``) each add one, under the JAX package's name prefixes. A
``Lambda``'s output shape comes from running its function on tensors on
``torch.device("meta")`` (:func:`probe_output_shape`, the counterpart of
``jax.eval_shape``): nothing is computed.

Model state (the JAX package's ``net_state`` tree) is kept as buffers
registered with :meth:`Layer.add_state` under the JAX state tree's keys
(:func:`named_state`); the optimizer never sees them. Some of it is
constant (a frozen ``WordEmbedding`` table); some the training step writes
(BatchNorm's moving statistics, ``add_state(..., written=True)``). A
training forward never writes such a buffer itself: it hands the new value
to :func:`emit_state`, and the step that ran it (:func:`collect_state`)
commits what was handed once, after its update (:func:`commit_state`), as
the JAX step takes ``new_state`` from ``apply``. Outside a collecting step
(a plain call, the recompute of ``zoo.train.remat``) the values are
dropped.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import contextvars
import math
import operator
import types
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

# --------------------------------------------------------------------------
# dtype policy
# --------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_compute_dtype = torch.float32
_param_dtype = torch.float32
#: who last set the policy: "default" | "direct" | "context" — the
#: context only overrides a policy it owns (see init_zoo_context)
_policy_owner = "default"


def as_torch_dtype(dtype: Any) -> torch.dtype:
    """``torch.float32``/``torch.bfloat16`` from a name or dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _DTYPES.values():
            raise ValueError(f"unsupported dtype {dtype}")
        return dtype
    from ....common.context import dtype_name
    return _DTYPES[dtype_name(dtype)]


def set_policy(compute_dtype: Any = torch.float32,
               param_dtype: Any = torch.float32) -> None:
    """Set the global mixed-precision policy: layers compute in
    ``compute_dtype``; parameters are created in ``param_dtype``. A direct
    call takes ownership of the policy: later context inits that do not
    name ``zoo.compute.dtype`` leave it alone."""
    global _compute_dtype, _param_dtype, _policy_owner
    _compute_dtype = as_torch_dtype(compute_dtype)
    _param_dtype = as_torch_dtype(param_dtype)
    _policy_owner = "direct"


def policy_owner() -> str:
    return _policy_owner


def _set_policy_from_context(compute_dtype: Any) -> None:
    """Context-owned policy write (init_zoo_context only)."""
    global _policy_owner
    set_policy(compute_dtype=compute_dtype)
    _policy_owner = "context"


def _reset_policy() -> None:
    """Back to the float32 default (reset_zoo_context only)."""
    global _policy_owner
    set_policy()
    _policy_owner = "default"


def compute_dtype() -> torch.dtype:
    return _compute_dtype


def param_dtype() -> torch.dtype:
    return _param_dtype


# --------------------------------------------------------------------------
# naming
# --------------------------------------------------------------------------

_uid_counters: Dict[str, int] = collections.defaultdict(int)


#: True while a shape probe (:func:`probe_output_shape`) runs: probes use
#: placeholder batch dims on the meta device, so batch-dependent decisions
#: must not warn or raise off them
_in_shape_probe = False


def in_shape_probe() -> bool:
    return _in_shape_probe


def unique_name(prefix: str) -> str:
    _uid_counters[prefix] += 1
    return f"{prefix}{_uid_counters[prefix]}"


def reset_uids() -> None:
    _uid_counters.clear()


# --------------------------------------------------------------------------
# initializers (Keras-1 ``init=`` strings), jax.nn.initializers semantics
# --------------------------------------------------------------------------

#: stddev of a unit normal truncated to [-2, 2] — jax's variance_scaling
#: divides by it so the truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def _fans(shape):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _variance_scaling(scale: float, mode: str, distribution: str):
    def init(generator, shape, dtype):
        fan_in, fan_out = _fans(shape)
        denom = {"fan_in": fan_in, "fan_out": fan_out,
                 "fan_avg": (fan_in + fan_out) / 2.0}[mode]
        var = scale / max(denom, 1.0)
        out = torch.empty(shape, dtype=torch.float32)
        if distribution == "uniform":
            lim = math.sqrt(3.0 * var)
            out.uniform_(-lim, lim, generator=generator)
        elif distribution == "normal":
            out.normal_(0.0, math.sqrt(var), generator=generator)
        else:  # truncated_normal
            std = math.sqrt(var) / _TRUNC_STD
            nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
        return out.to(dtype)
    return init


def _uniform(scale):
    def init(generator, shape, dtype):
        return torch.empty(shape).uniform_(-scale, scale,
                                           generator=generator).to(dtype)
    return init


def _normal(stddev):
    def init(generator, shape, dtype):
        return torch.empty(shape).normal_(0.0, stddev,
                                          generator=generator).to(dtype)
    return init


def _orthogonal(generator, shape, dtype):
    rows, cols = math.prod(shape[:-1]), shape[-1]
    a = torch.empty(max(rows, cols), min(rows, cols)).normal_(
        generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return q.reshape(shape).to(dtype)


def _const(value):
    def init(generator, shape, dtype):
        return torch.full(shape, value, dtype=dtype)
    return init


_INITIALIZERS: Dict[str, Callable] = {
    "glorot_uniform": _variance_scaling(1.0, "fan_avg", "uniform"),
    "glorot_normal": _variance_scaling(1.0, "fan_avg", "truncated_normal"),
    "xavier": _variance_scaling(1.0, "fan_avg", "uniform"),
    "he_normal": _variance_scaling(2.0, "fan_in", "truncated_normal"),
    "he_uniform": _variance_scaling(2.0, "fan_in", "uniform"),
    "lecun_uniform": _variance_scaling(1.0, "fan_in", "uniform"),
    "lecun_normal": _variance_scaling(1.0, "fan_in", "truncated_normal"),
    "uniform": _uniform(0.05),
    "normal": _normal(0.05),
    "zero": _const(0.0),
    "zeros": _const(0.0),
    "one": _const(1.0),
    "ones": _const(1.0),
    "orthogonal": _orthogonal,
}


def get_initializer(name: Union[str, Callable]) -> Callable:
    """Map a Keras-1 init name to ``init(generator, shape, dtype) ->
    tensor`` (a CPU tensor drawn from ``generator``)."""
    if callable(name):
        return name
    if name not in _INITIALIZERS:
        raise ValueError(f"unknown initializer: {name}")
    return _INITIALIZERS[name]


# --------------------------------------------------------------------------
# layer-call interception
# --------------------------------------------------------------------------

_LAYER_HOOK = contextvars.ContextVar("zoo_layer_hook", default=None)


@contextlib.contextmanager
def intercept_layer_calls(hook):
    """Scope a hook over every container-dispatched layer call.

    ``hook(layer, x, training, generator)`` returns the output to
    substitute the call, or ``None`` to run the layer normally. Nested
    scopes chain: the innermost hook is consulted first and a ``None``
    falls through to the enclosing one. ``hook=None`` disables
    interception for the scope."""
    prev = _LAYER_HOOK.get()
    if prev is not None and hook is not None:
        inner = hook

        def hook(layer, x, training, generator):
            out = inner(layer, x, training, generator)
            if out is not None:
                return out
            return prev(layer, x, training, generator)
    token = _LAYER_HOOK.set(hook)
    try:
        yield
    finally:
        _LAYER_HOOK.reset(token)


def dispatch_layer(layer: "Layer", x, *, training: bool = False,
                   generator: Optional[torch.Generator] = None):
    """Call ``layer`` through the active interception hook, if any."""
    hook = _LAYER_HOOK.get()
    if hook is not None:
        out = hook(layer, x, training, generator)
        if out is not None:
            return out
    return layer(x, training=training, generator=generator)


# --------------------------------------------------------------------------
# state the training step writes
# --------------------------------------------------------------------------

_STATE_SINK = contextvars.ContextVar("zoo_state_sink", default=None)


@contextlib.contextmanager
def collect_state():
    """Scope over a training step's forward: every :func:`emit_state`
    inside it lands in the yielded dict (``{id(buffer): (buffer,
    value)}``; a layer called twice keeps its last value, as the JAX
    containers keep a shared layer's last ``new_state``), which the step
    hands to :func:`commit_state` after its update."""
    sink: Dict[int, tuple] = {}
    token = _STATE_SINK.set(sink)
    try:
        yield sink
    finally:
        _STATE_SINK.reset(token)


@contextlib.contextmanager
def discard_state():
    """Scope whose :func:`emit_state` calls are dropped: the recompute of
    a rematerialised forward, which must not write the state twice."""
    token = _STATE_SINK.set(None)
    try:
        yield
    finally:
        _STATE_SINK.reset(token)


def emit_state(layer: "Layer", key: str, value: torch.Tensor) -> None:
    """A training forward's new value of ``layer``'s written state
    ``key``, handed to the collecting step (dropped outside one)."""
    sink = _STATE_SINK.get()
    if sink is not None:
        buf = getattr(layer, key)
        sink[id(buf)] = (buf, value.detach())


_AUX_SINK = contextvars.ContextVar("zoo_aux_sink", default=None)


@contextlib.contextmanager
def collect_aux_losses():
    """Scope over a training step's forward: every :func:`emit_aux_loss`
    inside it lands in the yielded list, which the step adds to the loss
    it differentiates (JAX ``training.py`` ``_aux_loss_sum``: the
    ``aux_loss`` state leaves)."""
    sink: list = []
    token = _AUX_SINK.set(sink)
    try:
        yield sink
    finally:
        _AUX_SINK.reset(token)


def emit_aux_loss(value: torch.Tensor) -> None:
    """A layer's auxiliary loss (``SparseMoE``'s load balance), added to
    the training step's loss; dropped outside a training step."""
    sink = _AUX_SINK.get()
    if sink is not None:
        sink.append(value)


def commit_state(sink: Optional[Dict[int, tuple]]) -> None:
    """Write each collected value into its buffer, in place (a captured
    step keeps reading the same buffers)."""
    if sink:
        bufs, values = zip(*sink.values())
        with torch.no_grad():
            torch._foreach_copy_(list(bufs), list(values))


def written_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s state that the training step writes, by dotted
    path."""
    out: Dict[str, torch.Tensor] = {}
    for prefix, m in module.named_modules():
        for key in getattr(m, "_written_keys", ()):
            out[f"{prefix}.{key}" if prefix else key] = getattr(m, key)
    return out


# --------------------------------------------------------------------------
# Layer base
# --------------------------------------------------------------------------

class Layer(nn.Module):
    """Base layer. Subclasses implement ``build(input_shape, generator=)``
    (register parameters, shapes include a leading ``None`` batch dim)
    and ``call(x, training=False, generator=None)``. ``generator`` is the
    explicit random state of training-time noise (dropout)."""

    def __init__(self, name: Optional[str] = None,
                 input_shape: Optional[Sequence[int]] = None):
        super().__init__()
        # an auto name is renamed by position when the layer joins a
        # Sequential, so param keys never depend on process-global counters
        self._auto_name = name is None
        self.name = name or unique_name(type(self).__name__.lower() + "_")
        # Keras-1 convention: input_shape excludes the batch dim
        self._declared_input_shape = (
            (None,) + tuple(input_shape) if input_shape is not None else None)

    def build(self, input_shape, *, generator: torch.Generator) -> None:
        """Create this layer's parameters (none by default)."""

    def compute_output_shape(self, input_shape):
        """The output shape for ``input_shape`` (leading ``None`` batch
        dim). The JAX package infers it with ``jax.eval_shape``; a real
        forward at full width is too dear here, so each layer that a
        ``Sequential`` or a graph ``Model`` holds states its rule."""
        raise NotImplementedError(
            f"{type(self).__name__} has no output-shape rule, so it cannot "
            f"be stacked in a Sequential or a graph Model yet; a layer "
            f"whose shape only a forward can tell can return "
            f"probe_output_shape(self.call, input_shape)")

    def add_weight(self, key: str, value: torch.Tensor) -> None:
        """Register ``value`` as parameter ``key`` (the JAX tree key)."""
        self.register_parameter(key, nn.Parameter(value))

    #: ``{attribute: key}`` for the parameters registered under a stand-in
    #: name, because their JAX tree key is no attribute name (a TF node
    #: name may hold a ``.``); :func:`tree_key` reads it
    _tree_keys: Mapping[str, str] = types.MappingProxyType({})

    #: the buffers that are model state (:meth:`add_state`), and those of
    #: them that the training step writes
    _state_keys: tuple = ()
    _written_keys: tuple = ()

    def add_state(self, key: str, value: torch.Tensor,
                  written: bool = False) -> None:
        """Register ``value`` as model state ``key`` (the JAX
        ``net_state`` tree's key): a buffer, moved with the module and
        written to checkpoints and ``.npz`` files, never given to the
        optimizer. ``written``: the training step writes it (the layer's
        training forward hands the new value to :func:`emit_state`);
        else it is constant."""
        self.register_buffer(key, value)
        if key not in self._state_keys:
            self._state_keys = self._state_keys + (key,)
        if written and key not in self._written_keys:
            self._written_keys = self._written_keys + (key,)

    def call(self, x, *, training: bool = False,
             generator: Optional[torch.Generator] = None):
        raise NotImplementedError(type(self).__name__)

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        return self.call(x, training=training, generator=generator)

    def __call__(self, x, *args, **kwargs):
        """On graph ``Variable``s (one or a list): connect this layer into
        the graph (the functional API). On tensors: run it."""
        if isinstance(x, Variable) or (
                isinstance(x, (list, tuple)) and x
                and all(isinstance(v, Variable) for v in x)):
            return Variable(Node(self, [v.node for v in as_list(x)]))
        return super().__call__(x, *args, **kwargs)

    def extra_repr(self) -> str:
        return self.name


# --------------------------------------------------------------------------
# graph nodes and Variables
# --------------------------------------------------------------------------

class Node:
    """One call of a layer in a graph, on its parents' outputs."""

    __slots__ = ("layer", "parents", "name")

    def __init__(self, layer: Layer, parents: Sequence["Node"]):
        self.layer = layer
        self.parents = list(parents)
        self.name = layer.name


class InputLayer(Layer):
    """A graph input of ``shape`` (without the batch dim)."""

    def __init__(self, shape: Sequence[int], name: Optional[str] = None):
        super().__init__(name=name or unique_name("input_"))
        self.shape = (None,) + tuple(shape)

    def compute_output_shape(self, input_shape):
        return input_shape

    def call(self, x, *, training=False, generator=None):
        return x


def _concrete(shape):
    return tuple(1 if d is None else d for d in shape)


def _meta(shape) -> torch.Tensor:
    return torch.empty(_concrete(shape), dtype=_compute_dtype,
                       device="meta")


def _out_shape(out):
    if isinstance(out, (list, tuple)):
        return [_out_shape(o) for o in out]
    return (None,) + tuple(out.shape[1:])


def probe_output_shape(fn: Callable, input_shape):
    """The output shape(s) of ``fn`` on inputs of ``input_shape`` (a shape
    or a list of shapes, leading ``None`` batch dims): ``fn`` runs on
    tensors of the compute dtype on the meta device, so only shapes are
    worked out, as ``jax.eval_shape`` does in the JAX package."""
    global _in_shape_probe
    spec = ([_meta(s) for s in input_shape]
            if isinstance(input_shape, list) else _meta(input_shape))
    prev = _in_shape_probe
    _in_shape_probe = True
    try:
        with torch.no_grad():
            out = fn(spec)
    finally:
        _in_shape_probe = prev
    return _out_shape(out)


class Lambda(Layer):
    """A torch-function layer — ``autograd.Lambda`` of the reference
    (``Lambda.scala``). ``fn`` takes the input tensor (a list input as
    ``*x``) and returns a tensor; its output shape is probed on the meta
    device. ``fn`` runs inside the training step, so it must not read a
    tensor back to the host (a captured step cannot) and should make its
    constants on its input's device."""

    def __init__(self, fn: Callable, name: Optional[str] = None):
        super().__init__(name=name or unique_name("lambda_"))
        self.fn = fn

    def compute_output_shape(self, input_shape):
        return probe_output_shape(self.call, input_shape)

    def call(self, x, *, training=False, generator=None):
        if isinstance(x, (list, tuple)):
            return self.fn(*x)
        return self.fn(x)


class _Constant:
    """A non-``Variable`` operand of a graph op: a Python number as it is;
    an array made a tensor once, then kept on each device it is used on
    (made outside a captured step: the capture's warm-up step runs
    first)."""

    def __init__(self, value):
        self.value = value
        self.tensors: Dict[Any, torch.Tensor] = {}

    def on(self, like: torch.Tensor):
        if isinstance(self.value, (bool, int, float)):
            return self.value
        key = like.device
        t = self.tensors.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(self.value)).to(like.device)
            if t.is_floating_point() and like.is_floating_point():
                t = t.to(like.dtype)
            self.tensors[key] = t
        return t


def graph_op(a, b, fn: Callable, name: str) -> "Variable":
    """``fn(a, b)`` as a ``Lambda`` node named ``unique_name(name + "_")``:
    two ``Variable``s become a two-input node; a constant on either side
    is closed over (``_Constant``)."""
    if isinstance(a, Variable) and isinstance(b, Variable):
        return Lambda(fn, name=unique_name(name + "_"))([a, b])
    if isinstance(a, Variable):
        c = _Constant(b)
        return Lambda(lambda x: fn(x, c.on(x)),
                      name=unique_name(name + "_"))(a)
    c = _Constant(a)
    return Lambda(lambda x: fn(c.on(x), x), name=unique_name(name + "_"))(b)


def take_index(a: torch.Tensor, index: int, dim: int) -> torch.Tensor:
    """``jnp.take(a, index, axis=dim)`` for one integer index: an index in
    ``[-n, 0)`` wraps once, any other outside ``[0, n)`` reads the fill
    value (NaN, or the most negative integer), as ``jnp.take``'s default
    "fill" mode does."""
    n = a.shape[dim]
    if -n <= index < 0:
        index += n
    if 0 <= index < n:
        return a.select(dim, index)
    shape = list(a.shape)
    del shape[dim]
    fill = (float("nan") if a.is_floating_point()
            else torch.iinfo(a.dtype).min)
    return torch.full(shape, fill, dtype=a.dtype, device=a.device)


def squeeze_dim(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.squeeze(a, axis=dim)``: raises unless that dim is 1."""
    if a.shape[dim] != 1:
        raise ValueError(f"cannot squeeze axis {dim} of size "
                         f"{a.shape[dim]} (shape {tuple(a.shape)})")
    return a.squeeze(dim)


class Variable:
    """A graph-node handle with operator overloading —
    ``autograd.Variable`` (``autograd/math.scala:365-640``). Each operator
    adds a ``Lambda`` node named by the JAX package's prefix (``add_``,
    ``sub_``, ``mul_``, ``div_``, ``pow_``, ``neg_``, ``slice_``,
    ``indexselect_``, ``squeeze_``)."""

    def __init__(self, node: Node):
        self.node = node

    @property
    def name(self) -> str:
        return self.node.name

    # -- binary ops ---------------------------------------------------------
    def _binop(self, other, fn, opname):
        return graph_op(self, other, fn, opname)

    def _rbinop(self, other, fn, opname):
        return graph_op(other, self, fn, opname)

    def __add__(self, o): return self._binop(o, operator.add, "add")
    def __radd__(self, o): return self._rbinop(o, operator.add, "add")
    def __sub__(self, o): return self._binop(o, operator.sub, "sub")
    def __rsub__(self, o): return self._rbinop(o, operator.sub, "sub")
    def __mul__(self, o): return self._binop(o, operator.mul, "mul")
    def __rmul__(self, o): return self._rbinop(o, operator.mul, "mul")
    def __truediv__(self, o): return self._binop(o, operator.truediv, "div")
    def __rtruediv__(self, o): return self._rbinop(o, operator.truediv, "div")
    def __pow__(self, o): return self._binop(o, operator.pow, "pow")

    def __neg__(self):
        return Lambda(torch.negative, name=unique_name("neg_"))(self)

    # -- keras-style slicing (Variable.slice / indexSelect in math.scala) ---
    def __getitem__(self, idx):
        return Lambda(lambda a: a[idx], name=unique_name("slice_"))(self)

    def slice(self, dim: int, start: int, length: int) -> "Variable":
        def f(a):
            sl = [slice(None)] * a.dim()
            sl[dim] = slice(start, start + length)
            return a[tuple(sl)]
        return Lambda(f, name=unique_name("slice_"))(self)

    def index_select(self, dim: int, index: int) -> "Variable":
        return Lambda(lambda a: take_index(a, index, dim),
                      name=unique_name("indexselect_"))(self)

    def squeeze(self, dim: int) -> "Variable":
        return Lambda(lambda a: squeeze_dim(a, dim),
                      name=unique_name("squeeze_"))(self)


def Input(shape: Sequence[int], name: Optional[str] = None) -> Variable:
    """A graph input — keras ``Input`` / ``autograd.Variable(inputShape)``
    in the reference."""
    return Variable(Node(InputLayer(shape, name=name), []))


class KerasNet(Layer):
    """Base of the model containers — ``KerasNet.apply`` runs the forward
    pass, and ``compile``/``fit``/``evaluate``/``predict``/
    ``predict_classes`` are the Keras facade over ``training.
    TrainingLoop`` with the JAX package's argument conventions
    (``training.py:2197-2330``). ``apply`` returns the output alone: the
    JAX package threads a ``state`` tree beside it, which the port keeps
    as buffers (:meth:`Layer.add_state`); the new state of a training
    forward goes to the step that collects it (:func:`collect_state`)."""

    #: training progress and optimizer state, kept across fit calls
    opt_state = None
    finished_epochs = 0
    finished_iterations = 0
    _loop = None
    #: ``set_checkpoint``'s ``{"path", "trigger", "keep"}``
    _checkpoint = None
    #: ``set_tensorboard``'s summaries, ``set_profile``'s directory and the
    #: compiled learning rate (a value or a schedule) the summaries read
    _train_summary = None
    _val_summary = None
    _profile_dir = None
    _lr = None

    def apply(self, x, *, training: bool = False,
              generator: Optional[torch.Generator] = None):
        return self(x, training=training, generator=generator)

    def init_weights(self, generator: Optional[torch.Generator] = None,
                     input_shape=None, sample_input=None) -> "KerasNet":
        """Create every parameter from ``generator`` (default: seeded from
        ``zoo.seed``) on the CPU, then move it to ``self.device``. The
        input shape comes from (in order) ``input_shape``, a
        ``sample_input`` batch, or the declared layer shapes, as in the
        JAX package."""
        from ....common.context import get_zoo_context
        if generator is None:
            generator = get_zoo_context().generator()
        shape = input_shape
        if shape is None and sample_input is not None:
            shapes = [(None,) + tuple(np.shape(a)[1:])
                      for a in as_list(sample_input)]
            shape = shapes if len(shapes) > 1 else shapes[0]
        self.build(shape, generator=generator)
        self.to(self.device)
        self.built = True
        return self

    def load_jax_params(self, tree: Dict[str, Any],
                        state: Optional[Dict[str, Any]] = None
                        ) -> "KerasNet":
        """Fill the weights from the JAX network's param tree (nested dicts
        of arrays) name for name, and the model state from its
        ``net_state`` tree when given; builds first if needed."""
        if not self.built:
            self.init_weights()
        load_param_tree(self, tree, state)
        return self

    def __getstate__(self):
        """Copies (``copy.deepcopy``, pickling) carry the network and its
        weights; the training loop and the optimizer state stay with the
        original, as a served copy needs neither."""
        state = dict(self.__dict__)
        for key in ("_loop", "opt_state", "_opt_state_owner"):
            state.pop(key, None)
        return state

    def compile(self, optimizer="adam", loss="mse", metrics=None,
                clip_norm: Optional[float] = None,
                clip_value: Optional[float] = None, **opt_kwargs):
        """``KerasNet.compile`` (``Topology.scala:135``): ``optimizer`` is
        a name (``opt_kwargs`` such as ``lr`` go to its constructor) or a
        ``GradientTransformation``; ``loss`` a name or callable;
        ``metrics`` names."""
        from . import metrics as metrics_lib
        from . import objectives, optimizers
        from .training import TrainingLoop
        opt = optimizers.with_clipping(
            optimizers.get_optimizer(optimizer, **opt_kwargs),
            clip_norm=clip_norm, clip_value=clip_value)
        self._loop = TrainingLoop(
            self, opt, objectives.get_loss(loss),
            [metrics_lib.get_metric(m) for m in (metrics or [])])
        self._loop.global_clip = clip_norm is not None
        # the effective lr (constant or schedule) for the LearningRate
        # summary
        self._lr = optimizers.resolve_lr(optimizer, **opt_kwargs)
        return self

    def _compiled_loop(self, what: str):
        if self._loop is None:
            raise RuntimeError(f"call compile() before {what}()")
        return self._loop

    def set_checkpoint(self, path: str, trigger=None,
                       keep: Optional[int] = None) -> "KerasNet":
        """``KerasNet.setCheckpoint`` (``Topology.scala:245-255``):
        snapshot params + optimizer state + net state into ``path``
        whenever ``trigger`` fires (default: every epoch); ``keep``
        snapshots are kept (default ``zoo.checkpoint.keep``; 0 keeps
        every one). ``fit`` resumes from the newest snapshot there that
        verifies."""
        self._checkpoint = {"path": path, "trigger": trigger, "keep": keep}
        return self

    def set_tensorboard(self, log_dir: str, app_name: str,
                        parameters_every_epochs: Optional[int] = None
                        ) -> "KerasNet":
        """``setTensorBoard(logDir, appName)`` (``Topology.scala:204-216``):
        ``fit`` writes the train scalars (Loss a step, Throughput and
        LearningRate an epoch) to ``<log_dir>/<app_name>/train`` and the
        validation metrics to ``.../validation`` as TensorBoard event
        files; ``parameters_every_epochs=N`` adds per-layer weight
        histograms every N epochs (under fused-epoch dispatch, at each
        block's last epoch)."""
        from ....utils.tensorboard import TrainSummary, ValidationSummary
        for attr in ("_train_summary", "_val_summary"):
            old = getattr(self, attr, None)
            if old is not None:   # redirecting: release the previous file
                old.close()
        self._train_summary = TrainSummary(log_dir, app_name)
        if parameters_every_epochs is not None:
            self._train_summary.set_summary_trigger("Parameters",
                                                    parameters_every_epochs)
        self._val_summary = ValidationSummary(log_dir, app_name)
        return self

    def set_profile(self, log_dir: str) -> "KerasNet":
        """Trace the NEXT ``fit`` call (one-shot) with ``torch.profiler``
        into ``log_dir``, for TensorBoard's profile plugin."""
        self._profile_dir = log_dir
        return self

    def get_train_summary(self, tag: str = "Loss"):
        """``getTrainSummary(tag)`` (``Topology.scala:222-229``): ``(n, 3)``
        rows of ``[iteration, value, wall_time]``."""
        if self._train_summary is None:
            raise RuntimeError("call set_tensorboard() before reading "
                               "summaries")
        return self._train_summary.read_scalar(tag)

    def get_validation_summary(self, tag: str):
        """``getValidationSummary(tag)`` (``Topology.scala:231-236``)."""
        if self._val_summary is None:
            raise RuntimeError("call set_tensorboard() before reading "
                               "summaries")
        return self._val_summary.read_scalar(tag)

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None, shuffle: bool = True, callbacks=(),
            end_trigger=None):
        """``KerasNet.fit`` (``Topology.scala:418``): ``x`` an array, a
        list of arrays or a ``FeatureSet`` (then ``y=None``). ``nb_epoch``
        more epochs, ``end_trigger`` (``common/triggers.py``) stopping
        earlier; returns ``{"loss": [...], "val_*": [...]}``."""
        from ....feature.feature_set import FeatureSet
        loop = self._compiled_loop("fit")
        if isinstance(x, FeatureSet):
            return loop.fit_feature_set(x, batch_size=batch_size,
                                        nb_epoch=nb_epoch,
                                        validation_data=validation_data,
                                        callbacks=callbacks,
                                        end_trigger=end_trigger)
        return loop.fit(x, y, batch_size=batch_size, nb_epoch=nb_epoch,
                        validation_data=validation_data, shuffle=shuffle,
                        callbacks=callbacks, end_trigger=end_trigger)

    def evaluate(self, x, y=None, batch_size: int = 32):
        """``KerasNet.evaluate`` (``Topology.scala:496``): the loss and
        every compiled metric over ``x``, padded tail rows masked out."""
        return self._compiled_loop("evaluate").evaluate(
            x, y, batch_size=batch_size)

    def predict(self, x, batch_size: int = 32):
        """``KerasNet.predict``: outputs as a float32 numpy array."""
        loop = self._loop
        if loop is None:
            from . import objectives, optimizers
            from .training import TrainingLoop
            loop = TrainingLoop(self, optimizers.identity(),
                                objectives.get_loss("mse"))
        return loop.predict(x, batch_size=batch_size)

    def predict_classes(self, x, batch_size: int = 32,
                        zero_based: bool = True):
        """``predictClass`` (``Predictor.scala:210``)."""
        from ....utils.prediction import probs_to_classes
        return probs_to_classes(self.predict(x, batch_size=batch_size),
                                zero_based=zero_based)


class Sequential(KerasNet):
    """Linear stack — ``Sequential`` (``Topology.scala:825-959``). Layers
    that join with an automatic name are renamed ``f"{type}_{position}"``
    and registered under that name, so the parameter paths are the JAX
    param tree's (``transformerlayer_0/wte``, ``dense_1/W``) and weights
    move across with :meth:`load_jax_params`. ``device`` is where the
    weights live: ``cuda`` unless given (raises without a GPU). Each layer
    is called through :func:`dispatch_layer`, so the fused loss can
    intercept the head."""

    def __init__(self, layers: Optional[Sequence[Layer]] = None,
                 name: Optional[str] = None, device=None):
        from ....common.context import resolve_device
        super().__init__(name=name or unique_name("sequential_"))
        self.device = resolve_device(device)
        self.layers = []
        self.built = False
        for layer in layers or []:
            self.add(layer)

    def add(self, layer: Layer) -> "Sequential":
        if self.built:
            raise RuntimeError(f"{self.name}: add layers before the weights "
                               f"are built")
        taken = {l.name for l in self.layers}
        if layer._auto_name:
            cand = f"{type(layer).__name__.lower()}_{len(self.layers)}"
            while cand in taken:        # dodge user-chosen names
                cand += "_"
            layer.name = cand
            layer._auto_name = False     # one name if the layer is reused
        if layer.name in taken:
            raise ValueError(f"{self.name}: duplicate layer name "
                             f"{layer.name!r}; give the layers distinct "
                             f"name=...")
        self.add_module(layer.name, layer)
        self.layers.append(layer)
        return self

    @property
    def input_shape(self):
        for layer in self.layers:
            if layer._declared_input_shape is not None:
                return layer._declared_input_shape
        return None

    def compute_output_shape(self, input_shape):
        shape = input_shape
        for layer in self.layers:
            shape = layer.compute_output_shape(shape)
        return shape

    def build(self, input_shape=None, *, generator: torch.Generator):
        shape = input_shape or self.input_shape
        if shape is None:
            raise ValueError(f"{self.name}: the first layer needs "
                             f"input_shape=...")
        for layer in self.layers:
            layer.build(shape, generator=generator)
            shape = layer.compute_output_shape(shape)

    def call(self, x, *, training=False, generator=None):
        if not self.built:
            raise RuntimeError("no weights; call init_weights() first")
        from ....common.noise import split_generators
        gens = split_generators(generator, len(self.layers))
        h = x
        for layer, g in zip(self.layers, gens):
            h = dispatch_layer(layer, h, training=training, generator=g)
        return h


class Model(KerasNet):
    """Graph container — ``Model`` (``Topology.scala:602``):
    ``Model(input=[vars], output=var)``. Nodes run in the JAX package's
    toposort (depth first from the outputs, parents in order); a layer
    that joins with an automatic name is renamed ``f"{type}_{position}"``
    by its place in that order and registered under it, so the parameter
    paths are the JAX param tree's (``embedding_2/embeddings``,
    ``dense_13/W``). A layer called in two nodes shares its weights.
    ``device`` is where the weights live: ``cuda`` unless given (raises
    without a GPU). Each node is called through :func:`dispatch_layer`."""

    def __init__(self, input, output, name: Optional[str] = None,
                 device=None):
        from ....common.context import resolve_device
        super().__init__(name=name or unique_name("model_"))
        self.device = resolve_device(device)
        self.inputs = as_list(input)
        self.outputs = as_list(output)
        self._multi_output = isinstance(output, (list, tuple))
        self._topo = self._toposort()
        taken = {n.layer.name for n in self._topo if not n.layer._auto_name}
        for i, node in enumerate(self._topo):
            if node.layer._auto_name:
                cand = f"{type(node.layer).__name__.lower()}_{i}"
                while cand in taken:        # dodge user-chosen names
                    cand += "_"
                node.layer.name = cand
                taken.add(cand)
                node.layer._auto_name = False  # shared layers keep one name
            node.name = node.layer.name
        for node in self._topo:
            if not node.parents:
                continue
            known = self._modules.get(node.name)
            if known is None:
                self.add_module(node.name, node.layer)
            elif known is not node.layer:
                raise ValueError(f"{self.name}: two different layers named "
                                 f"{node.name!r}; give them distinct "
                                 f"name=...")
        self.built = False

    def _toposort(self):
        seen, order = set(), []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for p in node.parents:
                visit(p)
            order.append(node)

        for v in self.outputs:
            visit(v.node)
        return order

    @property
    def input_shape(self):
        shapes = [v.node.layer.shape for v in self.inputs]
        return shapes if len(shapes) > 1 else shapes[0]

    def _propagate(self, input_shape, generator=None):
        """Walk the graph's shapes from ``input_shape``; with a
        ``generator``, build each layer on its input shape on the way (a
        shared layer once). Returns the output shape(s)."""
        shapes = input_shape or self.input_shape
        shape_of = {id(v.node): s for v, s in zip(
            self.inputs, shapes if isinstance(shapes, list) else [shapes])}
        built = set()
        for node in self._topo:
            if not node.parents:
                shape_of.setdefault(id(node), node.layer.shape)
                continue
            args = [shape_of[id(p)] for p in node.parents]
            in_shape = args if len(args) > 1 else args[0]
            if generator is not None and id(node.layer) not in built:
                node.layer.build(in_shape, generator=generator)
                built.add(id(node.layer))
            shape_of[id(node)] = node.layer.compute_output_shape(in_shape)
        outs = [shape_of[id(v.node)] for v in self.outputs]
        return outs if self._multi_output else outs[0]

    def compute_output_shape(self, input_shape):
        return self._propagate(input_shape)

    def build(self, input_shape=None, *, generator: torch.Generator):
        self._propagate(input_shape, generator)

    def __deepcopy__(self, memo):
        """A deep copy with the graph's nodes copied parents first, so that
        no node's copy recurses into its parents' (the default recursion
        follows the chain of parents and runs out of stack on a deep
        graph, ResNet-50's 175 nodes)."""
        for node in self._topo:
            copy.deepcopy(node, memo)
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        new.__dict__.update(copy.deepcopy(self.__getstate__(), memo))
        return new

    def new_graph(self, outputs: Sequence[str]) -> "Model":
        """Sub-graph surgery (``GraphNet.newGraph``, ``NetUtils.scala``;
        JAX ``engine.py:634-639``): a ``Model`` from this one's inputs to
        the nodes named ``outputs``, on the same layers, so it shares
        their weights and state; built when this one is."""
        by_name = {n.name: n for n in self._topo}
        outs = [Variable(by_name[o]) for o in outputs]
        sub = Model(self.inputs, outs if len(outs) > 1 else outs[0],
                    device=self.device)
        sub.built = self.built
        return sub

    def call(self, x, *, training=False, generator=None):
        if not self.built:
            raise RuntimeError("no weights; call init_weights() first")
        from ....common.noise import split_generators
        xs = as_list(x)
        if len(xs) != len(self.inputs):
            raise ValueError(f"{self.name} expects {len(self.inputs)} "
                             f"inputs, got {len(xs)}")
        gens = split_generators(generator, len(self._topo))
        value_of = {id(v.node): a for v, a in zip(self.inputs, xs)}
        for node, g in zip(self._topo, gens):
            if not node.parents:
                continue
            args = [value_of[id(p)] for p in node.parents]
            value_of[id(node)] = dispatch_layer(
                node.layer, args if len(args) > 1 else args[0],
                training=training, generator=g)
        outs = [value_of[id(v.node)] for v in self.outputs]
        return outs if self._multi_output else outs[0]


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"a": {"b": x}}`` → ``{"a/b": x}``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, path + "/"))
        else:
            out[path] = v
    return out


def named_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s model state (:meth:`Layer.add_state`), constant and
    written, by dotted path — the JAX ``net_state`` tree's paths."""
    out: Dict[str, torch.Tensor] = {}
    for prefix, m in module.named_modules():
        for key in getattr(m, "_state_keys", ()):
            out[f"{prefix}.{key}" if prefix else key] = getattr(m, key)
    return out


def tree_key(module: Optional[nn.Module], name: str) -> tuple:
    """The JAX tree's key path of ``module``'s parameter or state ``name``
    (a dotted path): its components, with the owning layer's stand-in
    attribute name (``Layer._tree_keys``) given back as its JAX key.
    Without ``module``, the components of ``name``."""
    *path, leaf = name.split(".")
    if module is not None:
        owner = module
        for part in path:    # by ``_modules``: a child may be "forward"
            owner = owner._modules[part]
        leaf = getattr(owner, "_tree_keys", {}).get(leaf, leaf)
    return (*path, leaf)


def tree_order(named: Dict[str, Any]) -> list:
    """``named``'s ``(path, value)`` pairs in the JAX ``tree_flatten``
    order of the matching nested dict: sorted keys, depth first — the
    lexicographic order of the key paths."""
    return sorted(named.items(), key=lambda kv: kv[0].split("."))


def _load_tree(module: nn.Module, want: Dict[str, torch.Tensor],
               tree: Dict[str, Any], what: str) -> None:
    want = {"/".join(tree_key(module, name)): t for name, t in want.items()}
    got = flatten_tree(tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"{what} tree mismatch: missing {missing}, "
                       f"extra {extra}")
    src = {key: torch.tensor(np.asarray(got[key])) for key in want}
    for key, t in want.items():
        spec = getattr(t, "_zoo_spec", None)
        if spec is not None:
            # a parameter placed on a device mesh keeps this rank's slice
            from ....parallel.mesh import local_slice
            src[key] = local_slice(src[key], spec, t._zoo_mesh)
    for key, t in want.items():
        if tuple(src[key].shape) != tuple(t.shape):
            raise ValueError(f"{key}: shape {tuple(src[key].shape)} does "
                             f"not match the port's {tuple(t.shape)}")
    with torch.no_grad():
        for key, t in want.items():
            t.copy_(src[key].to(t.dtype))


def load_param_tree(module: nn.Module, tree: Dict[str, Any],
                    state: Optional[Dict[str, Any]] = None) -> None:
    """Fill ``module``'s parameters from a nested dict of arrays keyed as
    the JAX param tree, and, when ``state`` is given, its model state
    from the JAX ``net_state`` tree. Every key must match a tensor of the
    same shape (a parameter placed on a device mesh takes its rank's slice
    of the whole array, ``parallel.mesh.place_params``); a missing or an
    extra key raises."""
    _load_tree(module, dict(module.named_parameters()), tree, "param")
    if state is not None:
        _load_tree(module, named_state(module), state, "state")


def _copy_in(dst: Dict[str, torch.Tensor], src: Dict[str, Any]) -> None:
    with torch.no_grad():
        for k, v in src.items():
            dst[k].copy_(torch.as_tensor(np.asarray(v)).to(dst[k].dtype))


def install_imported_weights(model: "KerasNet", weights: Dict[str, Any],
                             states: Optional[Dict[str, Any]] = None,
                             source: str = "imported") -> "KerasNet":
    """The model importers' shared installer (JAX ``engine.py:649-670``):
    init the graph, then overwrite named layers' parameters (shape-checked)
    and model state. ``weights``/``states`` map a layer name to a dict of
    arrays under the JAX tree's keys, in the JAX layouts (a Dense ``W``
    ``(in, out)``, a conv ``W`` HWIO); state goes into the layer's
    :meth:`Layer.add_state` buffers."""
    model.init_weights()
    layers = dict(model.named_children())

    def leaves(layer, named):
        return {"/".join(tree_key(layer, n)): t for n, t in named.items()}

    for lname, w in weights.items():
        if lname not in layers:
            raise ValueError(f"{source} weights for unknown layer {lname!r}")
        tmpl = leaves(layers[lname], dict(layers[lname].named_parameters()))
        for k, v in w.items():
            if k not in tmpl:
                raise ValueError(f"{lname}: {source} provides param {k!r}; "
                                 f"layer has {sorted(tmpl)}")
            if tuple(tmpl[k].shape) != np.shape(v):
                raise ValueError(f"{lname}.{k}: {source} weight shape "
                                 f"{np.shape(v)} vs graph "
                                 f"{tuple(tmpl[k].shape)}")
        _copy_in(tmpl, w)
    for lname, st in (states or {}).items():
        if lname not in layers:
            raise ValueError(f"{source} state for unknown layer {lname!r}")
        tmpl = leaves(layers[lname], named_state(layers[lname]))
        missing = sorted(set(st) - set(tmpl))
        if missing:
            raise ValueError(f"{lname}: {source} provides state {missing}; "
                             f"layer has {sorted(tmpl)}")
        _copy_in(tmpl, st)
    return model


def as_list(x) -> Sequence:
    return list(x) if isinstance(x, (list, tuple)) else [x]
