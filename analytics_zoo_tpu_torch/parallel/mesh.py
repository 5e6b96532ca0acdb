"""The device mesh — port of ``analytics_zoo_tpu/parallel/mesh.py``.

The JAX package lays its devices out in a ``jax.sharding.Mesh`` with the
axes ``data``, ``pipe``, ``seq``, ``expert`` and ``model`` (in that order,
``model`` innermost) and lets XLA place every array by its sharding. The
port's mesh has the same axes in the same order over the ranks of the
``torch.distributed`` world (one process a rank; rank ``r``'s coordinates
are ``r``'s digits in the axis sizes, ``model`` fastest), and a process
group for each axis that holds its rank. A placement is a spec per array:
for each dimension ``None`` (whole) or the axis it is split over, or
``(axis, blocks)`` for a dimension read as ``blocks`` equal blocks each
split over the axis (the fused ``[q|k|v]`` projection, whose rank-local
block keeps whole heads). Each rank holds its slice (:func:`local_slice`);
:func:`gather_full` puts the whole array back together.

Without a process group (one process) every mesh has one rank, every axis
size 1, and nothing changes from the one-device port.
"""

from __future__ import annotations

import collections
import itertools
import logging
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .collectives import AxisGroup, all_gather

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"

ALL_AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, EXPERT_AXIS, PIPE_AXIS)
#: the mesh's axis order (JAX ``mesh.py:57-60``): model innermost, so its
#: collectives join neighbouring ranks
MESH_ORDER = (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, EXPERT_AXIS, MODEL_AXIS)

log = logging.getLogger("analytics_zoo_tpu_torch.mesh")

#: process groups made so far, by their ranks: ``new_group`` is collective,
#: and every rank makes the same meshes in the same order, so each group is
#: made once and shared by the meshes that need it
_GROUPS: Dict[Tuple[int, ...], object] = {}
_global_mesh: Optional["Mesh"] = None


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A mesh over ranks: ``shape`` (axis → size, in :data:`MESH_ORDER`),
    this rank's coordinates and the :class:`AxisGroup` of each axis."""

    def __init__(self, sizes: Dict[str, int], ranks: Sequence[int]):
        self.shape = collections.OrderedDict(
            (ax, int(sizes[ax])) for ax in MESH_ORDER)
        self.ranks = tuple(ranks)
        _, me = _world()
        grid = list(itertools.product(*(range(n) for n in
                                          self.shape.values())))
        self.coords = dict(zip(MESH_ORDER, grid[self.ranks.index(me)]))
        self.groups: Dict[str, AxisGroup] = {}
        for axis_pos, ax in enumerate(MESH_ORDER):
            members = []
            for other in grid:
                if all(other[i] == c for i, c in enumerate(grid[
                        self.ranks.index(me)]) if i != axis_pos):
                    members.append(self.ranks[grid.index(other)])
            group = None
            if self.shape[ax] > 1:
                # every group of this axis, made on every rank in one order
                for start in grid:
                    if start[axis_pos] != 0:
                        continue
                    ranks_ax = tuple(
                        self.ranks[grid.index(start[:axis_pos] + (i,)
                                              + start[axis_pos + 1:])]
                        for i in range(self.shape[ax]))
                    if ranks_ax not in _GROUPS:
                        _GROUPS[ranks_ax] = dist.new_group(list(ranks_ax))
                group = _GROUPS[tuple(members)]
            self.groups[ax] = AxisGroup(group, members, self.coords[ax])

    @property
    def size(self) -> int:
        return len(self.ranks)

    def group(self, axis: str) -> AxisGroup:
        return self.groups[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, ranks={self.ranks})"


def create_mesh(data: int = -1, model: int = 1, seq: int = 1,
                expert: int = 1, pipe: int = 1, *,
                ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over ``ranks`` (default: every rank of the world).
    ``data=-1`` absorbs the ranks the other axes leave (JAX
    ``create_mesh``); every rank of the world calls it alike."""
    if ranks is None:
        ranks = range(_world()[0])
    ranks = list(ranks)
    n = len(ranks)
    fixed = model * seq * expert * pipe
    if data == -1:
        if n % fixed != 0:
            raise ValueError(f"device count {n} not divisible by "
                             f"model*seq*expert*pipe={fixed}")
        data = n // fixed
    total = data * fixed
    if total != n:
        raise ValueError(f"mesh {data}x{pipe}x{seq}x{expert}x{model}="
                         f"{total} != device count {n}")
    return Mesh({DATA_AXIS: data, PIPE_AXIS: pipe, SEQ_AXIS: seq,
                 EXPERT_AXIS: expert, MODEL_AXIS: model}, ranks)


def set_global_mesh(mesh: Mesh) -> None:
    global _global_mesh
    _global_mesh = mesh


def global_mesh() -> Mesh:
    """The process-wide mesh: the context's (``zoo.mesh.*``) once
    ``init_zoo_context`` made one, else pure data parallelism over the
    world, made on first use."""
    global _global_mesh
    if _global_mesh is None:
        _global_mesh = create_mesh()
    return _global_mesh


def reset_global_mesh() -> None:
    global _global_mesh
    _global_mesh = None


def data_parallel_size(mesh: Optional[Mesh] = None) -> int:
    return (mesh or global_mesh()).shape[DATA_AXIS]


def mesh_metadata(mesh: Optional[Mesh] = None) -> dict:
    """The JSON topology block of a checkpoint manifest (JAX
    ``mesh_metadata``): the axis sizes and the device count."""
    mesh = mesh or global_mesh()
    return {"axes": {k: int(v) for k, v in mesh.shape.items()},
            "devices": int(mesh.size)}


def format_mesh(meta: Optional[dict]) -> str:
    """``{data:8}``: the axes above 1 of :func:`mesh_metadata` (``{}``
    when all are 1)."""
    axes = (meta or {}).get("axes", {}) or {}
    kept = {k: v for k, v in axes.items() if int(v) != 1}
    return "{" + ", ".join(f"{k}:{v}" for k, v in kept.items()) + "}"


def batch_sharding(mesh: Optional[Mesh] = None) -> Tuple:
    """A batch's spec: the leading dimension over ``data``."""
    return (DATA_AXIS,)


def replicated_sharding(mesh: Optional[Mesh] = None) -> Tuple:
    """The spec of an array every rank holds whole."""
    return ()


def stacked_batch_sharding(mesh: Optional[Mesh] = None) -> Tuple:
    """A ``(K, batch, ...)`` chunk's spec: the batch dimension over
    ``data``."""
    return (None, DATA_AXIS)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def _entry(e):
    """``(axis, blocks)`` of one spec entry (``None`` → ``(None, 1)``)."""
    if e is None:
        return None, 1
    if isinstance(e, tuple):
        return e[0], int(e[1])
    return e, 1


def spec_axes(spec) -> Tuple[str, ...]:
    return tuple(_entry(e)[0] for e in (spec or ()) if e is not None)


def local_slice(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the whole array ``t`` under ``spec``."""
    for dim, e in enumerate(spec or ()):
        ax, blocks = _entry(e)
        if ax is None or mesh.shape[ax] == 1:
            continue
        n, i = mesh.shape[ax], mesh.axis_index(ax)
        t = torch.cat([b.chunk(n, dim)[i] for b in t.chunk(blocks, dim)],
                      dim)
    return t.contiguous()


def gather_full(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole array from every rank's slice under ``spec`` (the
    inverse of :func:`local_slice`; collective over the spec's axes)."""
    for dim in reversed(range(len(spec or ()))):
        ax, blocks = _entry(spec[dim])
        if ax is None or mesh.shape[ax] == 1:
            continue
        parts = all_gather(t, mesh.group(ax), dim).chunk(mesh.shape[ax], dim)
        t = torch.cat([torch.cat([p.chunk(blocks, dim)[b] for p in parts],
                                 dim) for b in range(blocks)], dim)
    return t


def _divides(shape, spec, mesh: Mesh) -> bool:
    for dim, e in enumerate(spec):
        ax, blocks = _entry(e)
        if ax is None:
            continue
        if dim >= len(shape) or shape[dim] % (blocks * mesh.shape[ax]):
            return False
    return True


def declared_shardings(model, mesh: Optional[Mesh] = None
                       ) -> Dict[str, tuple]:
    """Every spec the layers of ``model`` declare on ``mesh``
    (``param_sharding(mesh)``: a layer's specs for parameters of its
    subtree, named relative to it), under the parameters' full names."""
    from ..pipeline.api.keras.training import tree_module
    root = tree_module(model)
    out: Dict[str, tuple] = {}
    for prefix, module in root.named_modules():
        declare = getattr(module, "param_sharding", None)
        if declare is None:
            continue
        for rel, spec in (declare(mesh) or {}).items():
            out.setdefault(f"{prefix}.{rel}" if prefix else rel, spec)
    return out


def param_shardings(model, params: Dict[str, torch.Tensor],
                    mesh: Optional[Mesh] = None) -> Dict[str, Optional[tuple]]:
    """Each parameter's spec (``None``: replicated) on ``mesh``: what the
    layers declare over ``model``/``expert``/``pipe``. On a mesh without
    those axes everything replicates. A dimension that does not divide by
    its axis makes its leaf replicate, and one warning line says how many
    and names the first (JAX ``param_shardings``)."""
    mesh = mesh or global_mesh()
    out = {name: None for name in params}
    if (mesh.shape[MODEL_AXIS] * mesh.shape[EXPERT_AXIS]
            * mesh.shape[PIPE_AXIS] == 1):
        return out
    declared = declared_shardings(model, mesh)
    fallbacks = []
    for name, t in params.items():
        spec = declared.get(name)
        if spec is None or not spec_axes(spec):
            continue
        if _divides(tuple(t.shape), spec, mesh):
            out[name] = tuple(spec)
        else:
            fallbacks.append((name, tuple(t.shape), spec))
    if fallbacks:
        first = fallbacks[0]
        log.warning("%d param leaf/leaves replicated instead of "
                    "model-sharded (dim not divisible by axis size); first "
                    "offender: %s shape=%s spec=%s", len(fallbacks), *first)
        if len(fallbacks) > 1:
            log.debug("all replicated-fallback leaves: %s", "; ".join(
                f"{p} shape={s} spec={sp}" for p, s, sp in fallbacks))
    return out


def zero_sharding_for(base, shape, mesh: Optional[Mesh] = None):
    """ZeRO-1's placement of an optimizer-state leaf shaped like a
    parameter of spec ``base``: the first dimension the spec leaves whole
    and the ``data`` axis divides goes over ``data``; without one the leaf
    keeps ``base`` (JAX ``zero_sharding_for``). ``shape`` is the whole
    leaf's."""
    mesh = mesh or global_mesh()
    dp = mesh.shape[DATA_AXIS]
    base = tuple(base or ())
    if dp <= 1:
        return base or None
    spec = list(base) + [None] * (len(shape) - len(base))
    for i, (e, dim) in enumerate(zip(spec, shape)):
        if e is None and dim % dp == 0:
            spec[i] = DATA_AXIS
            return tuple(spec)
    return base or None


def sharded_over(t: torch.Tensor, axis: str):
    """The :class:`AxisGroup` of ``axis`` when the placed parameter ``t``
    is split over it (:func:`place_params`), else ``None``."""
    spec = getattr(t, "_zoo_spec", None)
    mesh = getattr(t, "_zoo_mesh", None)
    if spec is None or mesh is None or mesh.shape[axis] == 1:
        return None
    return mesh.group(axis) if axis in spec_axes(spec) else None


def place_params(model, mesh: Mesh) -> Dict[str, Optional[tuple]]:
    """Puts ``model``'s parameters on ``mesh``: each sharded parameter
    keeps this rank's slice (:func:`local_slice`) of the whole array it
    holds now, and every parameter records its spec and the mesh (which
    the layers read to run their tensor-parallel forms). A model placed on
    another mesh is gathered whole first. Returns the specs by name."""
    from ..pipeline.api.keras.training import tree_module
    root = tree_module(model)
    if getattr(root, "_zoo_mesh", None) is mesh:
        return root._zoo_specs
    unplace_params(model)
    named = dict(root.named_parameters())
    specs = param_shardings(model, named, mesh)
    with torch.no_grad():
        for name, p in named.items():
            spec = specs[name]
            if spec is not None:
                p.data = local_slice(p.data, spec, mesh)
            p._zoo_spec, p._zoo_mesh = spec, mesh
    root._zoo_mesh, root._zoo_specs = mesh, specs
    return specs


def unplace_params(model) -> None:
    """Gathers a placed model's parameters whole again (collective on the
    mesh it was placed on); a model never placed is left as it is."""
    from ..pipeline.api.keras.training import tree_module
    root = tree_module(model)
    mesh = getattr(root, "_zoo_mesh", None)
    if mesh is None:
        return
    with torch.no_grad():
        for p in root.parameters():
            spec = getattr(p, "_zoo_spec", None)
            if spec is not None:
                p.data = gather_full(p.data, spec, mesh)
            p._zoo_spec = p._zoo_mesh = None
    root._zoo_mesh = root._zoo_specs = None


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole array of a placed parameter (collective), ``t`` itself
    when it is not split."""
    spec = getattr(t, "_zoo_spec", None)
    if spec is None:
        return t
    return gather_full(t.detach(), spec, t._zoo_mesh)


def full_tensor_grad(t: torch.Tensor) -> torch.Tensor:
    """:func:`full_tensor` with autograd: the whole array gathered over
    each split dimension, the gradient of each rank's slice its part of
    the whole one (blocked dimensions are not taken)."""
    from .collectives import gather_from
    spec, mesh = getattr(t, "_zoo_spec", None), getattr(t, "_zoo_mesh", None)
    for dim, e in enumerate(spec or ()):
        ax, blocks = _entry(e)
        if ax is None or mesh.shape[ax] == 1:
            continue
        if blocks != 1:
            raise ValueError("full_tensor_grad takes no blocked dimension")
        t = gather_from(t, mesh.group(ax), dim)
    return t
