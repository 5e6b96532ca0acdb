"""GPipe and Pipeline — port of ``analytics_zoo_tpu/pipeline/api/keras/
layers/gpipe.py``: pipeline parallelism as a layer, over the ``pipe`` mesh
axis (``parallel/pipeline.py``'s schedule), sequential elsewhere.

* :class:`GPipe` stacks ``num_stages`` homogeneous, shape-preserving,
  stateless stages: each parameter of the stage is one ``(S, ...)``
  array under the stage's own parameter path (the JAX layer's stacked
  tree); on a ``pipe=P`` mesh each rank keeps its ``S/P`` consecutive
  stages' rows (``param_sharding``) and applies them back to back a tick.
* :class:`Pipeline` runs heterogeneous stages (a list of layers each):
  every stage's parameters are raveled into one row of a ``(S, L)``
  ``stack`` (the JAX layer's packed buffer, so weights move across), and
  activations cross stage boundaries in a common ``(B_micro, W)`` f32
  wire format; on a ``pipe`` mesh of exactly ``S`` ranks each rank keeps
  its row and runs its stage.

A batch the schedule cannot split (the microbatch count does not divide
the rank's batch) runs the stages one after another, with one warning.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, List, Optional

import torch
from torch.func import functional_call

from .....parallel import mesh as mesh_lib
from .....parallel.pipeline import (gpipe_apply, hetero_gpipe_apply,
                                    sequential_apply)
from ..engine import (Layer, compute_dtype, discard_state, param_dtype,
                      tree_order)

log = logging.getLogger("analytics_zoo_tpu_torch.gpipe")


def _remat(fn: Callable) -> Callable:
    """``fn(params, h, generator)`` rematerialised: the backward runs it
    again on the forward's noise, the generator's state taken where the
    forward starts (``noise.stash``/``noise.redraw``), its new state
    dropped. A stage's start inside a captured step has no twin to draw
    from (a twin replays the step from its seed), so that raises."""
    from torch.utils.checkpoint import checkpoint

    from .....common import noise

    def run(params, h, gen):
        stashed = noise.stash(gen)
        if isinstance(stashed, torch.Generator):
            raise RuntimeError(
                "a rematerialised pipeline stage inside a step captured in "
                "a CUDA graph cannot draw its noise again; set remat=False "
                "or run the step eagerly")
        forward = True

        def body(params, h):
            nonlocal forward
            if forward:
                forward = False
                return fn(params, h, gen)
            with noise.redraw(gen, stashed), discard_state():
                return fn(params, h, gen)
        return checkpoint(body, params, h, use_reentrant=False,
                          preserve_rng_state=False)
    return run


def _pipe_mesh():
    mesh = mesh_lib.global_mesh()
    return mesh, mesh.shape[mesh_lib.PIPE_AXIS]


class GPipe(Layer):
    """A stack of ``num_stages`` homogeneous layers over the ``pipe``
    axis. ``stage_factory()`` builds one stage (shape-preserving and
    stateless); each rank of a ``pipe=P`` mesh (``num_stages`` a multiple
    of ``P``) owns ``num_stages/P`` consecutive stages and microbatches
    flow through the GPipe schedule; without a pipe axis the stack runs
    sequentially (the same arithmetic for deterministic stages)."""

    def __init__(self, stage_factory: Callable, num_stages: int,
                 n_microbatches: Optional[int] = None, remat: bool = False,
                 **kwargs):
        super().__init__(**kwargs)
        if num_stages < 1:
            raise ValueError(f"num_stages={num_stages} < 1")
        self.stage_factory = stage_factory
        self.num_stages = num_stages
        self.n_microbatches = n_microbatches
        self.remat = remat
        # the template stage defines the arithmetic; it is kept outside
        # the module tree, whose parameters are the stacked ones
        self._stage = [stage_factory()]
        self._warned_fallback = False

    @property
    def stage(self) -> Layer:
        return self._stage[0]

    def compute_output_shape(self, input_shape):
        return input_shape

    def build(self, input_shape, *, generator):
        stages = [self.stage] + [self.stage_factory()
                                 for _ in range(self.num_stages - 1)]
        for st in stages:
            st.build(input_shape, generator=generator)
            if getattr(st, "_state_keys", ()):
                raise ValueError(f"{self.name}: pipeline stages must be "
                                 f"stateless")
            out = st.compute_output_shape(input_shape)
            if tuple(out[1:]) != tuple(input_shape[1:]):
                raise ValueError(
                    f"{self.name}: stage must preserve shape, got "
                    f"{tuple(input_shape[1:])} -> {tuple(out[1:])}")
        named = [dict(st.named_parameters()) for st in stages]
        # the stage's parameters become the stacked arrays, registered on
        # this layer under the stage's own paths (the JAX stacked tree)
        for path in named[0]:
            stacked = torch.nn.Parameter(torch.stack(
                [n[path].detach() for n in named]))
            owner = self.stage.get_submodule(path.rpartition(".")[0])
            setattr(owner, path.rpartition(".")[2], stacked)
        for key, child in self.stage.named_children():
            self.add_module(key, child)
        for key, p in self.stage.named_parameters(recurse=False):
            self.register_parameter(key, p)

    def param_sharding(self, mesh=None):
        """The stage dimension over ``pipe``; inner dimensions whole."""
        return {path: (mesh_lib.PIPE_AXIS,)
                for path, _ in self.stage.named_parameters()}

    def _stage_fn(self, training):
        stage = self.stage

        def fn(p_stage, h, gen):
            return functional_call(stage, p_stage, (h,),
                                   {"training": training, "generator": gen})
        return _remat(fn) if self.remat else fn

    def call(self, x, *, training=False, generator=None):
        mesh, pipe = _pipe_mesh()
        fn = self._stage_fn(training)
        x = x.to(compute_dtype())
        stacked = dict(self.stage.named_parameters())
        if pipe > 1:
            if self.num_stages % pipe:
                raise ValueError(
                    f"{self.name}: num_stages={self.num_stages} must be a "
                    f"multiple of the pipe axis size {pipe}")
            n_micro = self.n_microbatches or pipe
            if x.shape[0] % n_micro == 0:
                return gpipe_apply(fn, stacked, x, mesh=mesh,
                                   n_micro=n_micro, generator=generator,
                                   stages_per_rank=self.num_stages // pipe)
            if not self._warned_fallback:
                log.warning("%s: batch %d not divisible by n_microbatches="
                            "%d — running stages SEQUENTIALLY on the pipe=%d "
                            "mesh; pick a divisible batch size to pipeline",
                            self.name, x.shape[0], n_micro, pipe)
                self._warned_fallback = True
            if mesh_lib.sharded_over(next(iter(stacked.values())),
                                     mesh_lib.PIPE_AXIS) is not None:
                stacked = {k: mesh_lib.full_tensor_grad(v)
                           for k, v in stacked.items()}
        return sequential_apply(fn, stacked, x, self.num_stages, generator)


class Pipeline(Layer):
    """Heterogeneous pipeline parallelism: ``stages`` a list of stages,
    each a layer or a list of layers, with their own parameters and
    shapes. Every stage's parameters ravel into one row of ``stack``
    (``(S, L)``, padded to the longest stage; the JAX layer's packed
    buffer); activations cross boundaries flattened and padded to one f32
    width. On a ``pipe`` axis of exactly ``S`` ranks each rank keeps its
    row and runs its stage under the GPipe schedule; elsewhere the stages
    run in order. Stages must be stateless, and their parameters share one
    dtype."""

    def __init__(self, stages, n_microbatches: Optional[int] = None,
                 remat: bool = False, **kwargs):
        super().__init__(**kwargs)
        if not stages:
            raise ValueError("Pipeline needs at least one stage")
        self._stages = [list(s) if isinstance(s, (list, tuple)) else [s]
                        for s in stages]
        self.num_stages = len(self._stages)
        self.n_microbatches = n_microbatches
        self.remat = remat
        self._warned_fallback = False

    def build(self, input_shape, *, generator):
        shape = tuple(input_shape)
        self._meta = []
        rows = []
        for si, layers in enumerate(self._stages):
            in_shape = shape
            leaves = []
            for lyr in layers:
                lyr.build(shape, generator=generator)
                if getattr(lyr, "_state_keys", ()):
                    raise ValueError(
                        f"{self.name}: pipeline stages must be stateless "
                        f"({lyr.name} carries state)")
                shape = lyr.compute_output_shape(shape)
                leaves.append(tree_order(dict(lyr.named_parameters())))
            flat = [(li, name, t) for li, lv in enumerate(leaves)
                    for name, t in lv]
            for _, name, t in flat:
                if t.dtype != param_dtype():
                    raise ValueError(f"{self.name}: all stage params must "
                                     f"be {param_dtype()}, got {t.dtype}")
            self._meta.append({
                "leaves": [(li, name, tuple(t.shape)) for li, name, t
                           in flat],
                "in_feat": tuple(in_shape[1:]),
                "out_feat": tuple(shape[1:])})
            rows.append(torch.cat([t.detach().reshape(-1)
                                   for _, _, t in flat])
                        if flat else torch.zeros(0, dtype=param_dtype()))
        self._out_shape = shape
        self._wire = max([math.prod(m["in_feat"]) for m in self._meta]
                         + [math.prod(self._meta[-1]["out_feat"])])
        width = max(r.numel() for r in rows)
        self.add_weight("stack", torch.stack([
            torch.cat([r, r.new_zeros(width - r.numel())]) for r in rows]))

    def param_sharding(self, mesh=None):
        return {"stack": (mesh_lib.PIPE_AXIS, None)}

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + tuple(self._out_shape[1:])

    def _unpack(self, si, vec):
        """Stage ``si``'s parameters, by layer, out of its row."""
        params = [dict() for _ in self._stages[si]]
        off = 0
        for li, name, shape in self._meta[si]["leaves"]:
            size = math.prod(shape)
            params[li][name] = vec[off:off + size].reshape(shape)
            off += size
        return params

    def _to_wire(self, x):
        b = x.shape[0]
        in_sz = math.prod(self._meta[0]["in_feat"])
        xw = x.reshape(b, in_sz).to(torch.float32)
        return torch.nn.functional.pad(xw, (0, self._wire - in_sz))

    def _from_wire(self, out):
        feat = self._meta[-1]["out_feat"]
        size = math.prod(feat)
        return out[:, :size].reshape((out.shape[0],) + feat).to(
            compute_dtype())

    def _stage_fn(self, si, training):
        meta = self._meta[si]
        in_sz = math.prod(meta["in_feat"])
        out_sz = math.prod(meta["out_feat"])
        layers = self._stages[si]

        def fn(vec, h_wire, gen=None):
            params = self._unpack(si, vec)
            b = h_wire.shape[0]
            h = h_wire[:, :in_sz].reshape((b,) + meta["in_feat"])
            for lyr, p in zip(layers, params):
                h = functional_call(lyr, p, (h,), {"training": training,
                                                   "generator": gen})
            h = h.to(torch.float32).reshape(b, out_sz)
            return torch.nn.functional.pad(h, (0, self._wire - out_sz))

        return _remat(fn) if self.remat else fn

    def call(self, x, *, training=False, generator=None):
        mesh, pipe = _pipe_mesh()
        stack = self.stack
        if pipe > 1:
            if self.num_stages != pipe:
                raise ValueError(
                    f"{self.name}: {self.num_stages} stages on a pipe={pipe} "
                    f"mesh — heterogeneous stages need exactly one stage "
                    f"per pipe rank")
            n_micro = self.n_microbatches or pipe
            if x.shape[0] % n_micro == 0:
                ax = mesh.group(mesh_lib.PIPE_AXIS)
                fns = [None] * pipe
                fns[ax.index] = (lambda ps, h, gen, f=self._stage_fn(
                    ax.index, training): f(ps[0][0], h, gen))
                return self._from_wire(hetero_gpipe_apply(
                    fns, self._to_wire(x), [stack], mesh=mesh,
                    n_micro=n_micro, generator=generator))
            if not self._warned_fallback:
                log.warning("%s: batch %d not schedulable over pipe=%d "
                            "(n_micro=%d) — running stages SEQUENTIALLY",
                            self.name, x.shape[0], pipe, n_micro)
                self._warned_fallback = True
            if mesh_lib.sharded_over(stack, mesh_lib.PIPE_AXIS) is not None:
                stack = mesh_lib.full_tensor_grad(stack)
        h = self._to_wire(x)
        for si in range(self.num_stages):
            h = self._stage_fn(si, training)(stack[si], h, generator)
        return self._from_wire(h)
