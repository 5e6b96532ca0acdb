"""The training loop on a device mesh — the port of the mesh-aware parts
of ``analytics_zoo_tpu/pipeline/api/keras/training.py``: data
parallelism, ZeRO-1 and the placement of parameters, batches,
checkpoints and restores.

The JAX loop jits its step over sharded arrays and lets XLA insert the
collectives. The port's :class:`MeshStep` (one a loop, made when the
global mesh has more than one rank) issues them:

* **placement**: every parameter keeps its rank's slice under the specs
  its layers declare (``parallel.mesh.place_params``: Megatron TP over
  ``model``, experts over ``expert``, pipeline stages over ``pipe``);
* **data parallelism**: each rank of the ``data`` axis takes its rows of
  every global batch (:meth:`MeshStep.rows`); after the backward the loss
  and every gradient are averaged over ``data`` (one all-reduce a dtype,
  over the gradients laid end to end), *before* the guarded step's norm,
  flags and clip, so they see the global gradient, as the JAX step's do;
* **ZeRO-1** (``zoo.train.zero_sharding``): each optimizer moment keeps
  only its ``data`` rank's slice on the first dimension the spec leaves
  whole and the axis divides (``parallel.mesh.zero_sharding_for``); the
  update runs on the matching slices of the parameters and gradients, and
  the updated slices are gathered back over ``data``. The update is
  elementwise, so the parameters are plain DP's bit for bit;
* **checkpoints**: the whole arrays are gathered (collectives on every
  rank), rank 0 writes them in the JAX format with the live
  ``mesh_metadata``; a restore reads whole arrays and each rank keeps its
  slices (the elastic re-mesh restore: a snapshot of another mesh is
  reported and re-placed).

Captured steps (``zoo.train.scan_steps``, ``device_cache``) capture the
collectives under NCCL. Gloo cannot run inside a CUDA graph, so a
captured mode on CUDA tensors under gloo raises.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ....parallel import mesh as mesh_lib
from ....parallel.collectives import all_gather, all_reduce

log = logging.getLogger("analytics_zoo_tpu_torch.training")


def _full_shape(t: torch.Tensor) -> tuple:
    """The whole array's shape of a placed parameter."""
    spec = getattr(t, "_zoo_spec", None)
    mesh = getattr(t, "_zoo_mesh", None)
    shape = list(t.shape)
    for dim, e in enumerate(spec or ()):
        ax = mesh_lib._entry(e)[0]
        if ax is not None:
            shape[dim] *= mesh.shape[ax]
    return tuple(shape)


class MeshStep:
    """The mesh of one training loop (see the module doc)."""

    def __init__(self, loop, mesh: mesh_lib.Mesh):
        from ....common.context import _flag, get_zoo_context
        self.mesh = mesh
        self.data = mesh.group(mesh_lib.DATA_AXIS)
        self.dp = self.data.size
        self.rank0 = dist.get_rank() == mesh.ranks[0]
        loop._loss_application()   # engaged embeddings before placement
        mesh_lib.place_params(loop.model, mesh)
        params = loop._params()
        self.specs = {n: p._zoo_spec
                      for n, p in loop._tree_params().items()}
        self.axes = {n: mesh_lib.spec_axes(s) for n, s in self.specs.items()}
        self.zero_dims: Dict[str, int] = {}
        if _flag(get_zoo_context().get("zoo.train.zero_sharding", False),
                 "zoo.train.zero_sharding") and self.dp > 1:
            for n, p in params.items():
                spec = mesh_lib.zero_sharding_for(self.specs[n],
                                                  _full_shape(p), mesh)
                if spec and mesh_lib.DATA_AXIS in spec:
                    self.zero_dims[n] = spec.index(mesh_lib.DATA_AXIS)
        if getattr(loop, "global_clip", False) and (
                self.zero_dims or any(self.axes[n] for n in params)):
            raise NotImplementedError(
                "compile(clip_norm=...) on a mesh that splits parameters "
                "or optimizer state: the optimizer's global norm would see "
                "one rank's slices; use zoo.train.grad_clip (the guarded "
                "step's clip, which sums the norm over the mesh)")
        log.info("training on mesh %s (%s), %d parameter(s) split, ZeRO-1 "
                 "on %d", mesh_lib.format_mesh(mesh_lib.mesh_metadata(mesh)),
                 dist.get_backend(), sum(bool(a) for a in self.axes.values()),
                 len(self.zero_dims))

    def check_capturable(self, device: torch.device) -> None:
        """A captured step on CUDA tensors needs NCCL: gloo cannot run in
        a CUDA graph."""
        if device.type == "cuda" and dist.get_backend() == "gloo":
            raise RuntimeError(
                "zoo.train.scan_steps / zoo.train.device_cache capture the "
                "step in a CUDA graph, which gloo's collectives cannot "
                "join: run captured steps under NCCL (a card a rank) or "
                "train eagerly (scan_steps=1, device_cache=false)")

    # -- batches -----------------------------------------------------------
    def local_batch(self, batch_size: int) -> int:
        if batch_size % self.dp:
            raise ValueError(f"batch {batch_size} not divisible by the data "
                             f"axis size {self.dp}")
        return batch_size // self.dp

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        b = self.local_batch(n)
        return slice(self.data.index * b, (self.data.index + 1) * b)

    def take(self, batch, dim: int = 0):
        """This rank's rows (along ``dim``) of an array or a list of
        arrays (host or device)."""
        if isinstance(batch, (list, tuple)):
            return type(batch)(self.take(a, dim) for a in batch)
        if batch is None or self.dp == 1:
            return batch
        index = [slice(None)] * dim + [self.rows(batch.shape[dim])]
        return batch[tuple(index)]

    def host_batches(self, it):
        """A FeatureSet's ``(x, y)`` batches cut to this rank's rows."""
        for x, y in it:
            yield self.take(x), self.take(y)

    # -- the step ----------------------------------------------------------
    def sync(self, loss: torch.Tensor, grads: Dict[str, torch.Tensor]):
        """The loss and the gradients averaged over ``data`` (in place for
        the gradients; one all-reduce a dtype); returns the loss."""
        if self.dp == 1:
            return loss
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for g in grads.values():
            by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            flat = all_reduce(torch.cat([g.reshape(-1) for g in group]),
                              self.data)
            flat.div_(self.dp)
            torch._foreach_copy_(group, [f.view_as(g) for f, g in zip(
                flat.split([g.numel() for g in group]), group)])
        return all_reduce(loss.detach(), self.data) / self.dp

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global gradient norm over the mesh: each split gradient's
        squares summed over the axes it is split over, f32."""
        from ....common import anomaly
        if not any(self.axes[n] for n in grads):
            return anomaly.global_norm(list(grads.values()))
        total = torch.zeros((), dtype=torch.float32,
                            device=next(iter(grads.values())).device)
        groups: Dict[tuple, List[torch.Tensor]] = {}
        for n, g in grads.items():
            groups.setdefault(self.axes[n], []).append(g)
        for axes, gs in groups.items():
            sq = torch.stack(torch._foreach_norm(
                [g.float() for g in gs])).square().sum()
            for ax in axes:
                sq = all_reduce(sq, self.mesh.group(ax))
            total = total + sq
        return total.sqrt()

    def zero_views(self, tensors: Dict[str, torch.Tensor]):
        """ZeRO-1: each tensor's ``data`` rank slice where its moments are
        split, else the tensor."""
        out = {}
        for n, t in tensors.items():
            dim = self.zero_dims.get(n)
            out[n] = t if dim is None else t.narrow(
                dim, self.data.index * (t.shape[dim] // self.dp),
                t.shape[dim] // self.dp)
        return out

    def update(self, optimizer, grads, opt_state, params, row) -> None:
        """The optimizer update; under ZeRO-1 on the rank's slices, the
        updated slices then gathered whole over ``data``."""
        from .optimizers import apply_updates
        if not self.zero_dims:
            updates, _ = optimizer.update(grads, opt_state, params, row)
            apply_updates(params, updates)
            return
        views = self.zero_views(params)
        updates, _ = optimizer.update(self.zero_views(grads), opt_state,
                                      views, row)
        apply_updates(views, updates)
        with torch.no_grad():
            for n, dim in self.zero_dims.items():
                params[n].copy_(all_gather(views[n].contiguous(), self.data,
                                           dim))

    # -- checkpoints ---------------------------------------------------------
    def leaf_params(self, optimizer, opt_state, names) -> Dict[int, str]:
        """``id(tensor) -> parameter name`` of every moment leaf."""
        from .optimizers import optax_order
        out: Dict[int, str] = {}
        if optimizer.slots is None:
            return out
        order = optax_order(names)
        for slot in optimizer.slots(opt_state):
            if isinstance(slot, dict):
                out.update({id(t): n for n, t in slot.items()})
            elif not isinstance(slot, str):
                out.update({id(slot[i]): names[i] for i in order})
        return out

    def full(self, t: torch.Tensor, name: Optional[str] = None,
             moment: bool = False) -> torch.Tensor:
        """The whole array of a placed parameter ``t``, or with ``moment``
        of parameter ``name``'s optimizer moment ``t``."""
        if moment and name in self.zero_dims:
            t = all_gather(t.contiguous(), self.data, self.zero_dims[name])
        spec = (self.specs.get(name) if moment
                else getattr(t, "_zoo_spec", None))
        return (t.detach() if spec is None
                else mesh_lib.gather_full(t.detach(), spec, self.mesh))

    def local_moment(self, a: np.ndarray, name: str) -> torch.Tensor:
        """This rank's slice of the whole host array of parameter
        ``name``'s optimizer moment."""
        t = torch.as_tensor(np.asarray(a))
        spec = self.specs.get(name)
        if spec is not None:
            t = mesh_lib.local_slice(t, spec, self.mesh)
        if name in self.zero_dims:
            dim = self.zero_dims[name]
            k = t.shape[dim] // self.dp
            t = t.narrow(dim, self.data.index * k, k)
        return t
