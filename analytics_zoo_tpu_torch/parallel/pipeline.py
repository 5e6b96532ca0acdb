"""Pipeline parallelism — port of ``analytics_zoo_tpu/parallel/
pipeline.py``: the GPipe microbatch schedule over the ``pipe`` mesh axis.

The batch is cut into ``n_micro`` microbatches; the schedule runs
``n_micro + P - 1`` ticks (``P`` the pipe axis size). At each tick every
pipe rank applies its stage(s) to its current microbatch — rank 0 takes
the next microbatch, the others what the rank before them handed over —
and the activations move one hop around the axis
(:func:`parallel.collectives.ring_shift`, a ``ppermute``). The last
rank keeps the finished microbatches; one sum over ``pipe`` (its blocks,
zeros elsewhere) hands the result to every rank, as the JAX schedule's
masked ``psum`` does. On a mesh without a ``pipe`` axis,
:func:`sequential_apply` runs the same stages one after another.

* :func:`gpipe_apply`: homogeneous stages, ``stage_fn(params_j, h,
  generator)`` on the ``j``-th row of every stacked parameter;
* :func:`hetero_gpipe_apply`: a distinct stage a rank over a common
  ``(B_micro, W)`` f32 wire format (the ``Pipeline`` layer).

The schedule is one autograd node (:class:`_Schedule`): its forward
runs the ticks, each rank's stage(s) under a graph of their own, and its
backward runs the ticks in reverse with the shifts the other way, taking
each tick's vector-Jacobian product from the graph its forward kept (as
the JAX schedule's ``scan`` keeps each tick's residuals). Every rank
issues the same collectives in the same order, which a graph of per-tick
nodes would not promise; and a stage's noise is drawn once, in the
forward, so the gradients are those of the masks the forward used, on any
generator.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..common.noise import split_generators, split_seeds
from . import mesh as mesh_lib
from .collectives import all_reduce, ring_shift

__all__ = ["gpipe_apply", "hetero_gpipe_apply", "sequential_apply"]


def _check(x: torch.Tensor, n_micro: int) -> None:
    if x.shape[0] % n_micro != 0:
        raise ValueError(f"per-shard batch {x.shape[0]} not divisible by "
                         f"n_micro={n_micro}")


class _Schedule(torch.autograd.Function):
    """The GPipe ticks as one autograd node, so every pipe rank runs the
    same collectives in the same order in both directions. Forward: the
    ticks, each rank's stage(s) on the tick's input under a graph that is
    kept. Backward: the ticks in reverse; each rank takes the kept
    graph's vector-Jacobian product with the gradient of its output — the
    last rank's share of the result's gradient where it retired a
    microbatch, else what the next rank handed back — and hands the
    input's gradient one hop back. The feed's gradient (rank 0's) is
    summed over the axis, so every rank holds the input's."""

    @staticmethod
    def forward(ctx, plan, x, *params):
        ax, n_micro, run = plan
        p, r = ax.size, ax.index
        mbs = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
        state = torch.zeros_like(mbs[0])
        leaves = [q.detach().requires_grad_() for q in params]
        ticks_ = []
        outs = [None] * n_micro
        ticks = n_micro + p - 1
        for t in range(ticks):
            inp = (mbs[min(t, n_micro - 1)] if r == 0 else state
                   ).detach().requires_grad_()
            with torch.enable_grad():
                y = run(inp, t, leaves)
            ticks_.append((inp, y))
            y = y.detach()
            if r == p - 1 and t >= p - 1:
                outs[t - (p - 1)] = y
            if t < ticks - 1:
                state = ring_shift(y, ax)
        out = (torch.cat(outs) if r == p - 1 else torch.zeros(
            (x.shape[0],) + tuple(y.shape[1:]), dtype=y.dtype,
            device=y.device))
        ctx.plan, ctx.ticks, ctx.leaves = plan, ticks_, leaves
        ctx.x_shape = x.shape
        # the last rank's result on every rank (its blocks plus zeros)
        return all_reduce(out, ax)

    @staticmethod
    def backward(ctx, g):
        ax, n_micro, _ = ctx.plan
        leaves = ctx.leaves
        p, r = ax.size, ax.index
        ticks = n_micro + p - 1
        g_mbs = g.reshape(n_micro, g.shape[0] // n_micro, *g.shape[1:])
        dx = torch.zeros(ctx.x_shape, dtype=g.dtype, device=g.device)
        dx_mbs = dx.view(n_micro, ctx.x_shape[0] // n_micro,
                         *ctx.x_shape[1:])
        dparams = [torch.zeros_like(q) for q in leaves]
        back = None
        for t in reversed(range(ticks)):
            inp, y = ctx.ticks[t]
            ctx.ticks[t] = None
            gy = torch.zeros_like(y)
            if r != p - 1 and back is not None:
                gy = back
            if r == p - 1 and t >= p - 1:
                gy = gy + g_mbs[t - (p - 1)]
            grads = (torch.autograd.grad(y, [inp] + leaves, gy,
                                         allow_unused=True)
                     if y.requires_grad else [None] * (1 + len(leaves)))
            g_inp = grads[0] if grads[0] is not None else torch.zeros_like(
                inp)
            for d, q in zip(dparams, grads[1:]):
                if q is not None:
                    d.add_(q)
            if r == 0:
                if t < n_micro:
                    dx_mbs[t].add_(g_inp)
                g_inp = torch.zeros_like(g_inp)
            if t > 0:
                # the input's gradient back to the rank that sent it
                back = ring_shift(g_inp, ax, -1)
        ctx.ticks = ctx.leaves = None
        return (None, all_reduce(dx, ax), *dparams)


def _schedule(run: Callable, x: torch.Tensor, ax, n_micro: int,
              params: Sequence[torch.Tensor]) -> torch.Tensor:
    """The GPipe ticks: ``run(h, t, params)`` is the rank's work at tick
    ``t``."""
    _check(x, n_micro)
    return _Schedule.apply((ax, n_micro, run), x, *params)


def gpipe_apply(stage_fn: Callable, stacked_params: Dict[str, torch.Tensor],
                x: torch.Tensor, *, mesh: mesh_lib.Mesh, n_micro: int,
                generator: Optional[torch.Generator] = None,
                stages_per_rank: int = 1) -> torch.Tensor:
    """``x`` through the stacked stages under the GPipe schedule.
    ``stacked_params`` holds this rank's ``stages_per_rank`` rows of every
    stacked parameter; stage ``j`` of the rank is ``stage_fn({k: v[j]},
    h, generator)``, applied back to back. Each (tick, rank, stage) draws
    from a generator of its own, split alike on every rank, where
    ``generator`` is a CPU one (seeds); a device generator is drawn from
    in program order."""
    ax = mesh.group(mesh_lib.PIPE_AXIS)
    ticks = n_micro + ax.size - 1
    seeds = _seeds(generator, ticks * ax.size * stages_per_rank)
    names = list(stacked_params)

    def run(h, t, params):
        for j in range(stages_per_rank):
            g = _generator(generator, seeds,
                           (t * ax.size + ax.index) * stages_per_rank + j)
            h = stage_fn({k: v[j] for k, v in zip(names, params)}, h, g)
        return h
    return _schedule(run, x, ax, n_micro,
                     [stacked_params[k] for k in names])


def hetero_gpipe_apply(stage_fns: Sequence[Callable], x_wire: torch.Tensor,
                       params: Sequence[torch.Tensor], *,
                       mesh: mesh_lib.Mesh, n_micro: int,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """The GPipe schedule over distinct stages, one a pipe rank:
    ``stage_fns[rank](params, h_wire, generator)`` maps the ``(B_micro,
    W)`` wire format to itself (the ``Pipeline`` layer packs and
    unpacks); ``params`` the rank's parameter tensors."""
    ax = mesh.group(mesh_lib.PIPE_AXIS)
    ticks = n_micro + ax.size - 1
    seeds = _seeds(generator, ticks)
    fn = stage_fns[ax.index]
    return _schedule(
        lambda h, t, ps: fn(ps, h, _generator(generator, seeds, t)),
        x_wire, ax, n_micro, list(params))


def _seeds(generator, n: int):
    if generator is None or generator.device.type != "cpu":
        return None
    return split_seeds(generator, n)


def _generator(generator, seeds, i: int):
    if seeds is None:
        return generator
    return torch.Generator().manual_seed(seeds[i])


def sequential_apply(stage_fn: Callable,
                     stacked_params: Dict[str, torch.Tensor],
                     x: torch.Tensor, n_stages: int,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """The stacked stages one after another (no ``pipe`` axis): the same
    arithmetic as the schedule's for deterministic stages."""
    gens = split_generators(generator, n_stages)
    for i in range(n_stages):
        x = stage_fn({k: v[i] for k, v in stacked_params.items()}, x,
                     gens[i])
    return x
