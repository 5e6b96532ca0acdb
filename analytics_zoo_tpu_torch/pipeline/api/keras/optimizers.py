"""Optimizers — port of ``analytics_zoo_tpu/pipeline/api/keras/
optimizers.py`` with optax's update rules, not ``torch.optim``'s.

A :class:`GradientTransformation` is a triple of plain functions over
``{name: tensor}`` dicts, as optax's pair is over pytrees: ``init(params)
-> state``, ``update(updates, state, params, scalars) -> (updates,
state)``, and ``scalars(count) -> [float]``, the per-step values that
update number ``count`` (counted from 0) reads: the learning rate of a
schedule, adam's and adamax's bias corrections. :func:`apply_updates`
adds the result to the parameters. Kept from optax:

* adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
  correction by ``1 - b^t`` with ``t`` counted from 1, in f32 as optax
  computes it (:func:`_bias_correction`), and ``eps`` outside the square
  root: ``mu_hat / (sqrt(nu_hat) + eps)``;
* adamw: the decoupled decay ``wd * p`` added to the adam direction of
  every parameter (no mask, as ``optax.adamw`` applies it) before the
  learning rate scales it;
* rmsprop: ``eps`` inside the square root, ``nu`` starting at 0;
  adagrad: the accumulator starting at 0.1, ``eps`` 1e-7; adadelta and
  adamax as ``optax.scale_by_adadelta``/``scale_by_adamax`` (fault e:
  each differs from ``torch.optim``'s);
* schedules are functions of the update count starting at 0, so a
  warmup schedule's first update is 0;
* sgd momentum is ``optax.trace``: ``t = g + m t``;
* ``multi_optimizer`` routes each parameter by its layer's name prefix.

The count is the caller's (the training loop keeps it beside the state):
the host computes a block of steps' scalars (:func:`step_scalars`) and
writes them into a device buffer, and each update reads its row. So an
update captured once in a CUDA graph and replayed reads the right step's
values, and the eager loop runs the same code on a row of its own.

Updates happen in place: each transform rewrites the gradient tensors it
is handed (they become the updates) and its own state, with
``torch._foreach_*`` kernels, so no second copy of the parameters'
size is held beyond the optimizer state and one temporary.

Each transform also names its state in optax's leaf order
(``GradientTransformation.slots``): ``"count"`` where optax keeps an
update count, a per-parameter list of tensors where it keeps a moment.
A slot over a subset of the parameters (a ``multi_optimizer`` group's)
is a ``{name: tensor}`` dict. Checkpoints write the optimizer state in
that order (:func:`optax_leaves`), so a snapshot of the JAX package
resumes here and back; a transform without an optax counterpart would
have no slots (``slots=None``).
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


def no_scalars(count: int) -> List[float]:
    return []


def no_slots(state) -> List[Any]:
    return []


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(updates, state, params=None,
    scalars=None) -> (updates, state)``, rewriting ``updates`` and
    ``state`` in place, with ``scalars`` the step's row of this
    transform's per-step values (a 1-D f32 tensor, None when
    ``scalars(0)`` is empty); ``scalars(count)`` lists those values for
    update number ``count``; ``slots(state)`` the state in optax's leaf
    order (``"count"`` or a per-parameter tensor list, each), None when
    the state has no optax counterpart."""
    init: Callable[[Params], Any]
    update: Callable[..., Any]
    scalars: Callable[[int], List[float]] = no_scalars
    slots: Optional[Callable[[Any], List[Any]]] = no_slots


def _values(d: Params) -> List[torch.Tensor]:
    return list(d.values())


def n_scalars(opt: GradientTransformation) -> int:
    """How many per-step values ``opt``'s update reads."""
    return len(opt.scalars(0))


def step_scalars(opt: GradientTransformation, count: int,
                 steps: int = 1) -> np.ndarray:
    """``(steps, n_scalars)`` f32: the rows of updates ``count``,
    ``count + 1``, ... — host values, computed without the device."""
    rows = [opt.scalars(count + j) for j in range(steps)]
    return np.asarray(rows, np.float32).reshape(steps, n_scalars(opt))


def scalar_rows(opt: GradientTransformation, count: int, steps: int,
                device) -> torch.Tensor:
    """:func:`step_scalars` on ``device``; a CUDA copy goes through pinned
    memory and does not block the host."""
    rows = torch.from_numpy(step_scalars(opt, count, steps))
    if torch.device(device).type == "cuda":
        return rows.pin_memory().to(device, non_blocking=True)
    return rows.to(device)


def _row_slice(scalars: Optional[torch.Tensor], at: int, n: int,
               ) -> Optional[torch.Tensor]:
    if n == 0:
        return None
    if scalars is None:
        raise ValueError("this optimizer reads per-step values: pass the "
                         "step's row of step_scalars()/scalar_rows()")
    return scalars[at:at + n]


def apply_updates(params: Params, updates: Params) -> None:
    """``p += u`` for every parameter, in place (optax.apply_updates)."""
    with torch.no_grad():
        torch._foreach_add_(_values(params), _values(updates))


def optax_order(names: List[str]) -> List[int]:
    """The positions of parameters ``names`` (dotted paths, the port's
    order) in the JAX param tree's flatten order (nested dicts, keys
    sorted at each level)."""
    return sorted(range(len(names)), key=lambda i: names[i].split("."))


def optax_leaves(opt: GradientTransformation, state, count: int,
                 names: List[str]) -> Optional[List[Any]]:
    """``state`` (with update count ``count``) as optax's leaves for the
    parameters ``names``: a count as an int32 scalar, each moment's
    tensors in the JAX tree's order. None when ``opt`` has no optax
    layout."""
    if opt.slots is None:
        return None
    order = optax_order(names)
    out: List[Any] = []
    for slot in opt.slots(state):
        if isinstance(slot, str):
            out.append(np.int32(count))
        elif isinstance(slot, dict):
            out.extend(t for _, t in _by_path(slot))
        else:
            out.extend(slot[i] for i in order)
    return out


def _by_path(slot: Dict[str, torch.Tensor]):
    """A subset slot's ``(name, tensor)`` pairs in the JAX tree order."""
    return sorted(slot.items(), key=lambda kv: kv[0].split("."))


def load_optax_leaves(opt: GradientTransformation, state, leaves,
                      names: List[str]) -> Optional[int]:
    """Copies optax-ordered ``leaves`` (host arrays) into ``state``'s
    tensors in place; returns the count they carry (None when none
    does)."""
    order = optax_order(names)
    it = iter(leaves)
    count = None
    with torch.no_grad():
        for slot in opt.slots(state):
            if isinstance(slot, str):
                count = int(np.asarray(next(it)))
                continue
            tensors = ([t for _, t in _by_path(slot)]
                       if isinstance(slot, dict) else
                       [slot[i] for i in order])
            for t in tensors:
                t.copy_(torch.as_tensor(np.asarray(next(it))))
    return count


def _chain_slots(transforms):
    if any(t.slots is None for t in transforms):
        return None

    def slots(state):
        return [x for t, s in zip(transforms, state) for x in t.slots(s)]
    return slots


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    sizes = [n_scalars(t) for t in transforms]

    def init(params):
        return [t.init(params) for t in transforms]

    def update(updates, state, params=None, scalars=None):
        at = 0
        for t, s, n in zip(transforms, state, sizes):
            updates, _ = t.update(updates, s, params,
                                  _row_slice(scalars, at, n))
            at += n
        return updates, state

    def values(count):
        return [v for t in transforms for v in t.scalars(count)]
    return GradientTransformation(init, update, values,
                                  _chain_slots(transforms))




# ---------------------------------------------------------------------------
# schedules (optax semantics on a host step count)
# ---------------------------------------------------------------------------

def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac ** power + end_value
    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps)


def join_schedules(schedules, boundaries) -> Schedule:
    def schedule(step):
        out = schedules[0](step)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = fn(step - boundary)
        return out
    return schedule


def poly_schedule(lr: float, max_iterations: int, power: float = 0.5):
    return polynomial_schedule(lr, 0.0, power, max_iterations)


def make_schedule(lr: Union[float, Callable], schedule: Optional[str] = None,
                  decay: float = 0.0, **kw) -> Union[float, Callable]:
    if callable(lr):
        return lr
    if schedule == "poly":
        return poly_schedule(lr, kw.get("max_iterations", 10000),
                             kw.get("power", 0.5))
    if schedule == "warmup_linear":
        warm = kw.get("warmup_steps", 0)
        total = kw.get("total_steps", 10000)
        return join_schedules([linear_schedule(0.0, lr, warm),
                               linear_schedule(lr, 0.0,
                                               max(total - warm, 1))],
                              [warm])
    if decay > 0:
        return lambda step: lr / (1.0 + decay * step)
    return lr


def _warmup_linear_decay(lr: float, warmup_portion: float, total: int):
    if total > 0 and warmup_portion >= 0:
        warm = max(int(total * warmup_portion), 1)
        return join_schedules([linear_schedule(0.0, lr, warm),
                               linear_schedule(lr, 0.0,
                                               max(total - warm, 1))],
                              [warm])
    return lr


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _stateless(fn) -> GradientTransformation:
    """A transform with no state and no per-step values: ``fn(updates,
    params)`` rewrites ``updates`` in place."""
    def update(updates, state, params=None, scalars=None):
        fn(updates, params)
        return updates, state
    return GradientTransformation(lambda params: None, update)


def identity() -> GradientTransformation:
    return _stateless(lambda updates, params: None)


def _zeros(params: Params, value: float = 0.0) -> List[torch.Tensor]:
    return [torch.full_like(p, value) for p in params.values()]


def scale_by_learning_rate(lr: Union[float, Schedule]
                           ) -> GradientTransformation:
    """``u = -lr * u``; a schedule reads the update count from 0, its
    value for each step a per-step scalar (``-lr(count)``)."""
    if not callable(lr):
        return _stateless(
            lambda updates, params: torch._foreach_mul_(_values(updates),
                                                        -lr))

    def update(updates, state, params=None, scalars=None):
        torch._foreach_mul_(_values(updates), _row_slice(scalars, 0, 1)[0])
        return updates, state
    # optax's ScaleByScheduleState holds the count
    return GradientTransformation(lambda params: None, update,
                                  lambda count: [-lr(count)],
                                  lambda state: ["count"])


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    def init(params):
        return {"trace": _zeros(params)}

    def update(updates, state, params=None, scalars=None):
        g, t = _values(updates), state["trace"]
        torch._foreach_mul_(t, decay)
        torch._foreach_add_(t, g)                 # t = g + decay * t
        if nesterov:
            torch._foreach_add_(g, t, alpha=decay)
        else:
            torch._foreach_copy_(g, t)
        return updates, state
    return GradientTransformation(init, update,
                                  slots=lambda state: [state["trace"]])


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` as optax computes it: in f32, the power by
    binary exponentiation (XLA's integer power). In f64, ``1 - 0.999``
    would differ from the f32 value by 1e-5 relative."""
    f = np.float32
    out, base, n = f(1), f(decay), count
    while n:
        if n & 1:
            out = f(out * base)
        base = f(base * base)
        n >>= 1
    return float(f(1) - out)


def _moment(m: List[torch.Tensor], g: List[torch.Tensor], decay: float,
            square: bool) -> None:
    """``m = (1 - decay) g^order + decay m`` in place (optax's
    ``update_moment``, order 2 when ``square``)."""
    torch._foreach_mul_(m, decay)
    if square:
        torch._foreach_addcmul_(m, g, g, value=1 - decay)
    else:
        torch._foreach_add_(m, g, alpha=1 - decay)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """Per-step values: the two bias corrections of update ``count + 1``."""
    def init(params):
        return {"mu": _zeros(params), "nu": _zeros(params)}

    def update(updates, state, params=None, scalars=None):
        bc1, bc2 = _row_slice(scalars, 0, 2)
        g, mu, nu = _values(updates), state["mu"], state["nu"]
        _moment(mu, g, b1, square=False)
        _moment(nu, g, b2, square=True)
        mu_hat = torch._foreach_div(mu, bc1)
        # the denominator is built in the gradient buffers
        torch._foreach_copy_(g, nu)
        torch._foreach_div_(g, bc2)
        torch._foreach_sqrt_(g)
        torch._foreach_add_(g, eps)
        torch._foreach_div_(mu_hat, g)
        torch._foreach_copy_(g, mu_hat)
        return updates, state
    return GradientTransformation(
        init, update, lambda count: [_bias_correction(b1, count + 1),
                                     _bias_correction(b2, count + 1)],
        lambda state: ["count", state["mu"], state["nu"]])


def scale_by_adamax(b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> GradientTransformation:
    """``u = (mu / (1 - b1^t)) / max(|g| + eps, b2 nu)``; the bias
    correction is the per-step value."""
    def init(params):
        return {"mu": _zeros(params), "nu": _zeros(params)}

    def update(updates, state, params=None, scalars=None):
        (bc1,) = _row_slice(scalars, 0, 1)
        g, mu, nu = _values(updates), state["mu"], state["nu"]
        _moment(mu, g, b1, square=False)
        torch._foreach_mul_(nu, b2)
        torch._foreach_maximum_(nu, torch._foreach_add(
            torch._foreach_abs(g), eps))
        torch._foreach_copy_(g, mu)
        torch._foreach_div_(g, bc1)
        torch._foreach_div_(g, nu)
        return updates, state
    # optax keeps adamax's moments in a ScaleByAdamState (count, mu, nu)
    return GradientTransformation(
        init, update, lambda count: [_bias_correction(b1, count + 1)],
        lambda state: ["count", state["mu"], state["nu"]])


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0) -> GradientTransformation:
    """``u = g * rsqrt(nu + eps)``, ``nu`` from ``initial_scale``."""
    def init(params):
        return {"nu": _zeros(params, initial_scale)}

    def update(updates, state, params=None, scalars=None):
        g, nu = _values(updates), state["nu"]
        _moment(nu, g, decay, square=True)
        scale = torch._foreach_add(nu, eps)
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(g, scale)
        return updates, state
    return GradientTransformation(init, update,
                                  slots=lambda state: [state["nu"]])


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> GradientTransformation:
    """``s += g^2``; ``u = g * rsqrt(s + eps)`` where ``s > 0``, else 0."""
    def init(params):
        return {"sum_of_squares": _zeros(params, initial_accumulator_value)}

    def update(updates, state, params=None, scalars=None):
        g, s = _values(updates), state["sum_of_squares"]
        torch._foreach_addcmul_(s, g, g)
        for gi, si in zip(g, s):
            gi.mul_(torch.where(si > 0, torch.rsqrt(si + eps),
                                torch.zeros((), dtype=si.dtype,
                                            device=si.device)))
        return updates, state
    return GradientTransformation(
        init, update, slots=lambda state: [state["sum_of_squares"]])


def scale_by_adadelta(rho: float = 0.9, eps: float = 1e-6
                      ) -> GradientTransformation:
    """``e_g`` updated first; ``u = sqrt(e_x + eps) / sqrt(e_g + eps) *
    g``; then ``e_x`` from ``u``."""
    def init(params):
        return {"e_g": _zeros(params), "e_x": _zeros(params)}

    def update(updates, state, params=None, scalars=None):
        g, e_g, e_x = _values(updates), state["e_g"], state["e_x"]
        _moment(e_g, g, rho, square=True)
        num = torch._foreach_add(e_x, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        torch._foreach_mul_(g, num)
        _moment(e_x, g, rho, square=True)
        return updates, state
    return GradientTransformation(
        init, update, slots=lambda state: [state["e_g"], state["e_x"]])


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    return _stateless(lambda updates, params: torch._foreach_add_(
        _values(updates), _values(params), alpha=weight_decay))


def clip(max_delta: float) -> GradientTransformation:
    def fn(updates, params):
        u = _values(updates)
        torch._foreach_clamp_min_(u, -max_delta)
        torch._foreach_clamp_max_(u, max_delta)
    return _stateless(fn)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, a device scalar."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's rule: unchanged below ``max_norm``, else ``(u / norm) *
    max_norm``; the choice is made on the device (no host sync)."""
    def fn(updates, params):
        u = _values(updates)
        norm = global_norm(u)
        keep = norm < max_norm
        for t in u:
            t.copy_(torch.where(keep, t, (t / norm) * max_norm))
    return _stateless(fn)


# ---------------------------------------------------------------------------
# constructors (Keras-1 argument conventions, as in the JAX package)
# ---------------------------------------------------------------------------

def sgd(lr: float = 0.01, momentum: float = 0.0, decay: float = 0.0,
        nesterov: bool = False, **kw) -> GradientTransformation:
    lr = make_schedule(lr, decay=decay, **kw)
    return chain(trace(momentum, nesterov) if momentum else identity(),
                 scale_by_learning_rate(lr))


def adam(lr: float = 0.001, beta_1: float = 0.9, beta_2: float = 0.999,
         epsilon: float = 1e-8, decay: float = 0.0,
         schedule: Optional[str] = None, **kw) -> GradientTransformation:
    lr = make_schedule(lr, schedule=schedule, decay=decay, **kw)
    return chain(scale_by_adam(beta_1, beta_2, epsilon),
                 scale_by_learning_rate(lr))


def adam_weight_decay(lr: float = 1e-4, warmup_portion: float = -1.0,
                      total: int = -1, schedule: str = "linear",
                      beta_1: float = 0.9, beta_2: float = 0.999,
                      epsilon: float = 1e-6, weight_decay: float = 0.01,
                      ) -> GradientTransformation:
    """BERT AdamW: linear warmup over ``warmup_portion * total`` steps then
    linear decay to 0 (a constant ``lr`` without ``total``)."""
    return chain(scale_by_adam(beta_1, beta_2, epsilon),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(
                     _warmup_linear_decay(lr, warmup_portion, total)))


def rmsprop(lr: float = 0.001, rho: float = 0.9, epsilon: float = 1e-8,
            **kw) -> GradientTransformation:
    """``optax.rmsprop(lr, decay=rho, eps=epsilon)``."""
    return chain(scale_by_rms(rho, epsilon), scale_by_learning_rate(lr))


def adagrad(lr: float = 0.01, **kw) -> GradientTransformation:
    """``optax.adagrad(lr)``: accumulator from 0.1, eps 1e-7."""
    return chain(scale_by_rss(0.1, 1e-7), scale_by_learning_rate(lr))


def adadelta(lr: float = 1.0, rho: float = 0.95, epsilon: float = 1e-8,
             **kw) -> GradientTransformation:
    """``optax.adadelta(lr, rho=rho, eps=epsilon)`` (no weight decay)."""
    return chain(scale_by_adadelta(rho, epsilon), scale_by_learning_rate(lr))


def adamax(lr: float = 0.002, beta_1: float = 0.9, beta_2: float = 0.999,
           epsilon: float = 1e-8, **kw) -> GradientTransformation:
    return chain(scale_by_adamax(beta_1, beta_2, epsilon),
                 scale_by_learning_rate(lr))


# Each constructor carries its lr_resolver: the EFFECTIVE lr (a constant
# or a step -> lr schedule) the constructor builds from the same kwargs.

def _signature_lr(fn, kwargs):
    p = inspect.signature(fn).parameters.get("lr")
    return kwargs.get("lr", p.default if p is not None else None)


def _schedule_resolver(fn):
    def resolve(**kw):
        extra = {k: v for k, v in kw.items()
                 if k not in ("lr", "schedule", "decay")}
        return make_schedule(_signature_lr(fn, kw),
                             schedule=kw.get("schedule"),
                             decay=kw.get("decay", 0.0), **extra)
    return resolve


def _constant_resolver(fn):
    return lambda **kw: _signature_lr(fn, kw)


sgd.lr_resolver = _schedule_resolver(sgd)
adam.lr_resolver = _schedule_resolver(adam)
adam_weight_decay.lr_resolver = lambda **kw: _warmup_linear_decay(
    _signature_lr(adam_weight_decay, kw),
    kw.get("warmup_portion", -1.0), kw.get("total", -1))
for _ctor in (rmsprop, adagrad, adadelta, adamax):
    _ctor.lr_resolver = _constant_resolver(_ctor)

OPTIMIZERS: Dict[str, Callable[..., GradientTransformation]] = {
    "sgd": sgd,
    "adam": adam,
    "adamw": adam_weight_decay,
    "adam_weight_decay": adam_weight_decay,
    "rmsprop": rmsprop,
    "adagrad": adagrad,
    "adadelta": adadelta,
    "adamax": adamax,
}


def get_optimizer(opt: Union[str, GradientTransformation],
                  **kwargs) -> GradientTransformation:
    if isinstance(opt, GradientTransformation):
        return opt
    if isinstance(opt, str):
        if opt not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {opt!r}")
        return OPTIMIZERS[opt](**kwargs)
    raise TypeError(f"bad optimizer spec: {opt!r}")


def resolve_lr(opt: Union[str, GradientTransformation], **kwargs):
    """The EFFECTIVE learning rate of a ``compile()`` spec — a float or a
    ``step -> lr`` schedule, from the ``lr_resolver`` registered beside
    each constructor; None for a built transformation."""
    if not isinstance(opt, str) or opt not in OPTIMIZERS:
        return None
    ctor = OPTIMIZERS[opt]
    resolver = getattr(ctor, "lr_resolver", None) or _constant_resolver(ctor)
    return resolver(**kwargs)


def multi_optimizer(rules: Dict[str, Union[str, GradientTransformation]],
                    default: Union[str, GradientTransformation] = "adam",
                    ) -> GradientTransformation:
    """Each parameter to the optimizer of the first rule whose key
    prefixes its layer's name (the first component of the parameter's
    name, the JAX param tree's top-level key), else to ``default`` (an
    explicit ``"__default__"`` rule wins over it), as
    ``optax.multi_transform`` routes them.

    The state keeps each group's state beside the names of the parameters
    it owns. Its slots are ``optax.multi_transform``'s leaves: the groups
    in sorted label order, each with its own transform's slots over only
    the parameters it owns (a masked parameter leaves no leaf)."""
    keys = list(rules)
    transforms = {k: get_optimizer(v) for k, v in rules.items()}
    transforms.setdefault("__default__", get_optimizer(default))
    sizes = {k: n_scalars(t) for k, t in transforms.items()}

    def label(name: str) -> str:
        layer = name.split(".", 1)[0]
        return next((k for k in keys if layer.startswith(k)), "__default__")

    def part(tree: Optional[Params], lab: str) -> Optional[Params]:
        return None if tree is None else {
            n: t for n, t in tree.items() if label(n) == lab}

    def init(params):
        return {"groups": {k: t.init(part(params, k))
                           for k, t in transforms.items()},
                "owned": {k: list(part(params, k)) for k in transforms}}

    def update(updates, state, params=None, scalars=None):
        at = 0
        for k, t in transforms.items():
            mine = part(updates, k)
            if mine:
                t.update(mine, state["groups"][k], part(params, k),
                         _row_slice(scalars, at, sizes[k]))
            at += sizes[k]
        return updates, state

    def values(count):
        return [v for t in transforms.values() for v in t.scalars(count)]

    slots = None
    if all(t.slots is not None for t in transforms.values()):
        def slots(state):
            out: List[Any] = []
            for k in sorted(transforms):
                names = state["owned"][k]
                for slot in transforms[k].slots(state["groups"][k]):
                    out.append(slot if isinstance(slot, str)
                               else dict(zip(names, slot)))
            return out
    return GradientTransformation(init, update, values, slots)


def with_clipping(opt: GradientTransformation,
                  clip_norm: Optional[float] = None,
                  clip_value: Optional[float] = None,
                  ) -> GradientTransformation:
    transforms = []
    if clip_value is not None:
        transforms.append(clip(clip_value))
    if clip_norm is not None:
        transforms.append(clip_by_global_norm(clip_norm))
    transforms.append(opt)
    return chain(*transforms) if len(transforms) > 1 else opt
