"""Optimizers — port of ``analytics_zoo_tpu/pipeline/api/keras/
optimizers.py`` with optax's update rules, not ``torch.optim``'s.

A :class:`GradientTransformation` is a pair of plain functions over
``{name: tensor}`` dicts, as optax's is over pytrees: ``init(params) ->
state`` and ``update(updates, state, params) -> (updates, state)``;
:func:`apply_updates` adds the result to the parameters. Kept from optax:

* adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
  correction by ``1 - b^t`` with ``t`` counted from 1, and ``eps``
  outside the square root: ``mu_hat / (sqrt(nu_hat) + eps)``;
* adamw: the decoupled decay ``wd * p`` added to the adam direction of
  every parameter (no mask, as ``optax.adamw`` applies it) before the
  learning rate scales it;
* schedules are functions of the update count starting at 0, so a
  warmup schedule's first update is 0;
* sgd momentum is ``optax.trace``: ``t = g + m t``.

Updates happen in place: each transform rewrites the gradient tensors it
is handed (they become the updates) and its own state, with
``torch._foreach_*`` kernels, so no second copy of the parameters'
size is held beyond the optimizer state and one adam temporary. The
update count and the schedules live on the host, so a step never waits
on the device.

``rmsprop``, ``adagrad``, ``adadelta``, ``adamax`` and
``multi_optimizer`` are not ported yet; their optax defaults differ from
``torch.optim``'s (eps placement, initial accumulators) and each needs a
parity test when it lands.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(updates, state, params) ->
    (updates, state)``, rewriting ``updates`` and ``state`` in place."""
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], Any]


def _values(d: Params) -> List[torch.Tensor]:
    return list(d.values())


def apply_updates(params: Params, updates: Params) -> None:
    """``p += u`` for every parameter, in place (optax.apply_updates)."""
    with torch.no_grad():
        torch._foreach_add_(_values(params), _values(updates))


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(updates, state, params=None):
        for t, s in zip(transforms, state):
            updates, _ = t.update(updates, s, params)
        return updates, state
    return GradientTransformation(init, update)


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: None,
                                  lambda u, s, p=None: (u, s))


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

def scale_by_learning_rate(lr: Union[float, Schedule]
                           ) -> GradientTransformation:
    """``u = -lr * u``; a schedule reads the update count from 0."""
    def init(params):
        return {"count": 0}

    def update(updates, state, params=None):
        step = lr(state["count"]) if callable(lr) else lr
        torch._foreach_mul_(_values(updates), -step)
        state["count"] += 1
        return updates, state
    return GradientTransformation(init, update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    def init(params):
        return {"trace": [torch.zeros_like(p) for p in params.values()]}

    def update(updates, state, params=None):
        g, t = _values(updates), state["trace"]
        torch._foreach_mul_(t, decay)
        torch._foreach_add_(t, g)                 # t = g + decay * t
        if nesterov:
            torch._foreach_add_(g, t, alpha=decay)
        else:
            torch._foreach_copy_(g, t)
        return updates, state
    return GradientTransformation(init, update)


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


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params.values()],
                "nu": [torch.zeros_like(p) for p in params.values()]}

    def update(updates, state, params=None):
        g, mu, nu = _values(updates), state["mu"], state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        state["count"] += 1
        t = state["count"]
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, t))
        # the denominator is built in the gradient buffers
        torch._foreach_copy_(g, nu)
        torch._foreach_div_(g, _bias_correction(b2, t))
        torch._foreach_sqrt_(g)
        torch._foreach_add_(g, eps)
        torch._foreach_div_(mu_hat, g)
        torch._foreach_copy_(g, mu_hat)
        return updates, state
    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params):
        torch._foreach_add_(_values(updates), _values(params),
                            alpha=weight_decay)
        return updates, state
    return GradientTransformation(lambda params: None, update)


def clip(max_delta: float) -> GradientTransformation:
    def update(updates, state, params=None):
        u = _values(updates)
        torch._foreach_clamp_min_(u, -max_delta)
        torch._foreach_clamp_max_(u, max_delta)
        return updates, state
    return GradientTransformation(lambda params: None, update)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, a device scalar."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's rule: unchanged below ``max_norm``, else ``(u / norm) *
    max_norm``; the choice is made on the device (no host sync)."""
    def update(updates, state, params=None):
        u = _values(updates)
        norm = global_norm(u)
        keep = norm < max_norm
        for t in u:
            t.copy_(torch.where(keep, t, (t / norm) * max_norm))
        return updates, state
    return GradientTransformation(lambda params: None, update)


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


def _not_ported(name: str):
    def ctor(*args, **kwargs):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (the port has sgd, adam "
            f"and adamw); its optax defaults differ from torch.optim's")
    ctor.__name__ = name
    return ctor


rmsprop = _not_ported("rmsprop")
adagrad = _not_ported("adagrad")
adadelta = _not_ported("adadelta")
adamax = _not_ported("adamax")
multi_optimizer = _not_ported("multi_optimizer")

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
