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
``Lambda`` and ``Variable`` arithmetic are not ported yet.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import math
from typing import Any, Callable, Dict, Optional, Sequence, Union

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
        forward at full width is too dear here, so each layer a
        ``Sequential`` stacks states its rule."""
        raise NotImplementedError(
            f"{type(self).__name__} has no output-shape rule, so it cannot "
            f"be stacked in a Sequential yet")

    def add_weight(self, key: str, value: torch.Tensor) -> None:
        """Register ``value`` as parameter ``key`` (the JAX tree key)."""
        self.register_parameter(key, nn.Parameter(value))

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


class Variable:
    """A graph-node handle — ``autograd.Variable`` of the reference. The
    operator overloads of the JAX package's ``Variable`` (arithmetic,
    slicing) are not ported yet."""

    def __init__(self, node: Node):
        self.node = node

    @property
    def name(self) -> str:
        return self.node.name


def Input(shape: Sequence[int], name: Optional[str] = None) -> Variable:
    """A graph input — keras ``Input`` / ``autograd.Variable(inputShape)``
    in the reference."""
    return Variable(Node(InputLayer(shape, name=name), []))


class KerasNet(Layer):
    """Base of the model containers — ``KerasNet.apply`` runs the forward
    pass, and ``compile``/``fit``/``evaluate``/``predict``/
    ``predict_classes`` are the Keras facade over ``training.
    TrainingLoop`` with the JAX package's argument conventions
    (``training.py:2197-2330``). The port's layers are stateless, so
    ``apply`` returns the output alone (the JAX package threads a ``state``
    tree beside it for BatchNorm, which is not ported yet)."""

    #: training progress and optimizer state, kept across fit calls
    opt_state = None
    finished_epochs = 0
    finished_iterations = 0
    _loop = None

    def apply(self, x, *, training: bool = False,
              generator: Optional[torch.Generator] = None):
        return self(x, training=training, generator=generator)

    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "KerasNet":
        """Create every parameter from ``generator`` (default: seeded from
        ``zoo.seed``) on the CPU, then move it to ``self.device``."""
        from ....common.context import get_zoo_context
        if generator is None:
            generator = get_zoo_context().generator()
        self.build(generator=generator)
        self.to(self.device)
        self.built = True
        return self

    def load_jax_params(self, tree: Dict[str, Any]) -> "KerasNet":
        """Fill the weights from the JAX network's param tree (nested dicts
        of arrays) name for name; builds first if needed."""
        if not self.built:
            self.init_weights()
        load_param_tree(self, tree)
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
        return self

    def _compiled_loop(self, what: str):
        if self._loop is None:
            raise RuntimeError(f"call compile() before {what}()")
        return self._loop

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None, shuffle: bool = True, callbacks=()):
        """``KerasNet.fit`` (``Topology.scala:418``): ``x`` an array, a
        list of arrays or a ``FeatureSet`` (then ``y=None``). ``nb_epoch``
        more epochs; returns ``{"loss": [...], "val_*": [...]}``."""
        from ....feature.feature_set import FeatureSet
        loop = self._compiled_loop("fit")
        if isinstance(x, FeatureSet):
            return loop.fit_feature_set(x, batch_size=batch_size,
                                        nb_epoch=nb_epoch,
                                        validation_data=validation_data,
                                        callbacks=callbacks)
        return loop.fit(x, y, batch_size=batch_size, nb_epoch=nb_epoch,
                        validation_data=validation_data, shuffle=shuffle,
                        callbacks=callbacks)

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
        from .training import probs_to_classes
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


def load_param_tree(module: nn.Module, tree: Dict[str, Any]) -> None:
    """Fill ``module``'s parameters from a nested dict of arrays keyed as
    the JAX param tree. Every key must match a parameter of the same
    shape; a missing or an extra key raises."""
    want = {name.replace(".", "/"): p
            for name, p in module.named_parameters()}
    got = flatten_tree(tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"param tree mismatch: missing {missing}, "
                       f"extra {extra}")
    src = {key: torch.tensor(np.asarray(got[key])) for key in want}
    for key, p in want.items():
        if tuple(src[key].shape) != tuple(p.shape):
            raise ValueError(f"{key}: shape {tuple(src[key].shape)} does "
                             f"not match the port's {tuple(p.shape)}")
    with torch.no_grad():
        for key, p in want.items():
            p.copy_(src[key].to(p.dtype))


def as_list(x) -> Sequence:
    return list(x) if isinstance(x, (list, tuple)) else [x]
