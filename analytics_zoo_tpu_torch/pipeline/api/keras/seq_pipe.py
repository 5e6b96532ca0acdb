"""Sequence- and pipeline-parallel training-step integration — port of
``analytics_zoo_tpu/pipeline/api/keras/seq_pipe.py``: the training loop
routes attention over the ``seq`` axis and cuts a model's homogeneous
block run into GPipe stages over ``pipe`` without touching model code.

Two conf flags, both resolved once per training loop:

* ``zoo.train.seq_attention = off | ring | ulysses`` — ``off`` keeps the
  layers' own routing (``zoo.seq.mode`` on a seq mesh); ``ring`` or
  ``ulysses`` forces it for every attention layer of the step (the mode
  wins over ``zoo.seq.mode``), a mesh without a ``seq`` axis fails when
  the loop resolves it, and an attention call that cannot ride the mesh
  raises instead of falling back to full attention.
* ``zoo.train.pipe_stages = S`` — the Sequential's longest run of
  consecutive layers alike in type, configuration and parameter shapes
  (a ``TransformerBlock`` stack) is cut into ``S`` stages and run through
  ``parallel.pipeline.gpipe_apply`` over ``pipe``: the run's parameters
  are stacked into ``(S, ...)`` arrays each rank takes its stages of, the
  first run layer's dispatch is intercepted to the schedule, the rest
  become identities. Without a ``pipe`` axis the stack runs through
  ``sequential_apply``. ``zoo.train.pipe_microbatch`` sets the
  microbatch count (0 = the pipe axis size).

Inside a pipeline stage the attention layers run with seq routing off:
one of sequence or pipeline parallelism a layer run.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
from typing import List, Optional

import torch

log = logging.getLogger("analytics_zoo_tpu_torch.training")

#: the seq-attention override of the current step: None = unset (layer
#: routing), "off" = routing off (inside pipeline stages), "ring" or
#: "ulysses" = forced mode, strict
_FORCED_SEQ_MODE: contextvars.ContextVar = contextvars.ContextVar(
    "zoo_forced_seq_mode", default=None)


def forced_seq_mode() -> Optional[str]:
    """The training loop's seq-attention override for the current scope."""
    return _FORCED_SEQ_MODE.get()


@contextlib.contextmanager
def seq_attention_scope(mode: Optional[str]):
    """Scope the seq-attention override over a step; ``None`` is a no-op
    (the layers' routing stands)."""
    if mode is None:
        yield
        return
    token = _FORCED_SEQ_MODE.set(mode)
    try:
        yield
    finally:
        _FORCED_SEQ_MODE.reset(token)


def resolve_seq_attention() -> Optional[str]:
    """``zoo.train.seq_attention`` → None (off) or the forced mode, the
    mesh checked at once: forcing sequence parallelism without a ``seq``
    axis is a configuration error."""
    from ....common.context import FALSE_FLAG_SPELLINGS, get_zoo_context
    from ....parallel import mesh as mesh_lib

    mode = str(get_zoo_context().get("zoo.train.seq_attention",
                                     "off")).strip().lower()
    if mode in FALSE_FLAG_SPELLINGS or mode in ("none", "off"):
        return None
    if mode not in ("ring", "ulysses"):
        raise ValueError(f"zoo.train.seq_attention must be "
                         f"off|ring|ulysses, got {mode!r}")
    mesh = mesh_lib.global_mesh()
    n_seq = int(mesh.shape[mesh_lib.SEQ_AXIS])
    if n_seq <= 1:
        raise ValueError(
            f"zoo.train.seq_attention={mode} needs a seq mesh axis > 1 "
            f"(current mesh: {dict(mesh.shape)}); set zoo.mesh.seq")
    log.info("sequence-parallel attention forced for this training loop: "
             "%s over seq=%d (zoo.train.seq_attention)", mode, n_seq)
    return mode


class PipeStageSpec:
    """A resolved pipeline cut: the consecutive homogeneous layer run a
    Sequential's step intercepts into one GPipe schedule."""

    def __init__(self, layers: List, mesh, pipe_size: int,
                 stages_per_rank: int, n_micro: int):
        self.layers = list(layers)
        self.mesh = mesh
        self.pipe_size = int(pipe_size)
        self.stages_per_rank = int(stages_per_rank)
        self.n_micro = int(n_micro)

    def hook(self, training: bool):
        """The dispatch hook: the run's first layer runs the whole stacked
        pipeline; the other run layers pass their input through."""
        from torch.func import functional_call

        from ....parallel import mesh as mesh_lib
        from ....parallel import pipeline as pipe_lib
        from ....parallel.collectives import split_to

        first = self.layers[0]
        members = {id(l) for l in self.layers}
        spec = self

        def stage_fn(p_stage, h, gen):
            with seq_attention_scope("off"):
                return functional_call(first, p_stage, (h,),
                                       {"training": training,
                                        "generator": gen})

        def _hook(layer, x, training_, generator):
            if id(layer) not in members:
                return None
            if layer is not first:
                return x    # already computed inside the schedule
            if not isinstance(x, torch.Tensor):
                raise ValueError(
                    "zoo.train.pipe_stages: the pipelined block run must "
                    "take a single tensor input (multi-input runs — e.g. "
                    "masked BERT blocks — cannot stack)")
            per_layer = [dict(l.named_parameters()) for l in spec.layers]
            stacked = {k: torch.stack([p[k] for p in per_layer])
                       for k in per_layer[0]}
            if spec.pipe_size > 1:
                ax = spec.mesh.group(mesh_lib.PIPE_AXIS)
                # each rank its stages' rows; their gradients gathered
                # whole again in the backward
                stacked = {k: split_to(v, ax, 0) for k, v in stacked.items()}
                return pipe_lib.gpipe_apply(
                    stage_fn, stacked, x, mesh=spec.mesh,
                    n_micro=spec.n_micro, generator=generator,
                    stages_per_rank=spec.stages_per_rank)
            return pipe_lib.sequential_apply(stage_fn, stacked, x,
                                             len(spec.layers), generator)

        return _hook


def _config_sig(layer, depth: int = 2):
    """A layer's hyperparameter signature: every public, non-Layer,
    non-name attribute (and sub-layers' one level down). Stages must agree
    in configuration, not only in parameter shapes: the schedule applies
    the first layer's code to every stage."""
    from .engine import Layer

    out = {}
    for k, v in sorted(vars(layer).items()):
        if k.startswith("_") or k in ("name", "training"):
            continue
        if isinstance(v, Layer):
            out[k] = _config_sig(v, depth - 1) if depth > 0 else type(v)
        elif callable(v):
            out[k] = getattr(v, "__name__", repr(v))
        else:
            out[k] = repr(v)
    for k, child in layer.named_children():
        if isinstance(child, Layer):
            out[k] = (_config_sig(child, depth - 1) if depth > 0
                      else type(child))
    return (type(layer).__name__, tuple(sorted(out.items())))


def _stackable_run(model) -> List:
    """The longest run of consecutive Sequential layers alike in type,
    configuration and parameter shapes, with no model state; at least
    two."""
    layers = getattr(model, "layers", None)
    if not layers:
        return []

    def sig(layer):
        params = dict(layer.named_parameters())
        if not params or getattr(layer, "_state_keys", ()):
            return None
        return (_config_sig(layer), tuple(
            (k, tuple(p.shape)) for k, p in sorted(params.items())))

    best: List = []
    run: List = []
    prev = None
    for layer in layers:
        s = sig(layer)
        run = run + [layer] if s is not None and s == prev else (
            [layer] if s is not None else [])
        prev = s
        if len(run) > len(best):
            best = list(run)
    return best if len(best) >= 2 else []


def resolve_pipe_spec(model) -> Optional[PipeStageSpec]:
    """``zoo.train.pipe_stages`` → the resolved :class:`PipeStageSpec`
    (None when off). A pipeline the model cannot be cut into fails at
    once."""
    from ....common.context import get_zoo_context
    from ....parallel import mesh as mesh_lib
    from .engine import Sequential

    stages = int(get_zoo_context().get("zoo.train.pipe_stages", 0) or 0)
    if stages <= 0:
        return None
    if not isinstance(model, Sequential):
        raise ValueError(
            "zoo.train.pipe_stages needs a Sequential model (the stage "
            "cut stacks a consecutive layer run); got "
            f"{type(model).__name__}")
    run = _stackable_run(model)
    if len(run) != stages:
        raise ValueError(
            f"zoo.train.pipe_stages={stages} but the model's stackable "
            f"block run has {len(run)} layer(s) "
            f"({[l.name for l in run]}) — the stage count must equal "
            f"the homogeneous run length")
    mesh = mesh_lib.global_mesh()
    pipe_size = int(mesh.shape[mesh_lib.PIPE_AXIS])
    if pipe_size > 1 and stages % pipe_size != 0:
        raise ValueError(
            f"zoo.train.pipe_stages={stages} does not divide by the "
            f"pipe mesh axis ({pipe_size})")
    n_micro = int(get_zoo_context().get("zoo.train.pipe_microbatch", 0)
                  or 0)
    if n_micro <= 0:
        n_micro = max(pipe_size, 1)
    log.info("pipeline-parallel block run resolved: %d stage(s) over "
             "pipe=%d, %d microbatch(es) (zoo.train.pipe_stages; %s)",
             stages, pipe_size, n_micro,
             "GPipe schedule" if pipe_size > 1
             else "sequential fallback — no pipe mesh axis")
    return PipeStageSpec(run, mesh, pipe_size,
                         stages_per_rank=max(stages // max(pipe_size, 1),
                                             1),
                         n_micro=n_micro)


@contextlib.contextmanager
def pipe_intercept(spec: Optional[PipeStageSpec], training: bool):
    """Scope the pipeline intercept over a step; no-op for ``None``.
    Chains under any inner intercept (the fused-loss head hook)."""
    if spec is None:
        yield
        return
    from .engine import intercept_layer_calls
    with intercept_layer_calls(spec.hook(training)):
        yield
