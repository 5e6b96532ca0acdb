"""Every collective of the port, over one axis of a device mesh
(``parallel/mesh.py``), on ``torch.distributed``.

Where the JAX package annotates a sharding and XLA inserts the collective
(a ``psum``, an all-gather, an all-to-all, a ``ppermute``), the port calls
one of these functions explicitly. An axis of size 1 (or a process without
a process group) makes each of them the identity.

Backends: NCCL when each rank has its own card; gloo on the CPU, and for
ranks that share one card. Every collective has one native form, the
call NCCL runs (``all_gather_single``/``all_gather_into_tensor``,
``all_to_all_single``, ``batch_isend_irecv``), which gloo also runs on CPU
tensors, so the CPU tests run the code NCCL runs. Gloo takes CUDA tensors
for two collectives only, ``all_reduce`` and ``broadcast``
(:data:`GLOO_CUDA_NATIVE`); for a CUDA tensor under gloo (ranks sharing
one card) the others are built from ``all_reduce`` over a slotted buffer
— each rank writes its block into its own slot of a zeroed ``(n, ...)``
buffer and the sum hands every rank every block, exactly (each element
is one block's value plus zeros) — which moves ``n`` times the bytes of a
native all-gather: :data:`GLOO_CUDA_SLOTTED`. Nothing is copied through
host memory by this module.

Autograd: :func:`reduce_from` (the Megatron "g": sum forward, identity
backward), :func:`copy_to` ("f": identity forward, sum backward),
:func:`gather_from` (all-gather forward, the rank's slice backward),
:func:`split_to` (the rank's slice forward, all-gather backward),
:func:`all_to_all` and :func:`ring_shift` (the inverse exchange
backward). The backward rules assume what the mesh code keeps true: a
value gathered over an axis is consumed alike on every rank of it, so its
gradient is the same on every rank.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["AxisGroup", "all_reduce", "all_gather", "all_to_all",
           "ring_shift", "reduce_from", "copy_to",
           "gather_from", "split_to", "all_to_all_grad", "ring_shift_grad",
           "GLOO_CUDA_NATIVE",
           "GLOO_CUDA_SLOTTED"]

#: the collectives gloo runs on CUDA tensors itself
GLOO_CUDA_NATIVE = ("all_reduce", "broadcast")
#: the collectives this module builds from a slotted ``all_reduce`` for
#: CUDA tensors under gloo
GLOO_CUDA_SLOTTED = ("all_gather", "all_to_all", "ring_shift")


class AxisGroup:
    """The ranks of one mesh axis that hold this process: the process
    group over them (``None`` when the axis has size 1), the global ranks
    in axis order and this process's index among them."""

    def __init__(self, group, ranks: Sequence[int], index: int):
        self.group = group
        self.ranks = tuple(ranks)
        self.index = int(index)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self) -> str:
        return f"AxisGroup(ranks={self.ranks}, index={self.index})"


def _active(ax: Optional[AxisGroup]) -> bool:
    return ax is not None and ax.size > 1


def _slotted(t: torch.Tensor, ax: AxisGroup) -> bool:
    """True where ``t`` is a CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend(ax.group) == "gloo"


def all_reduce(t: torch.Tensor, ax: Optional[AxisGroup],
               op: str = "sum") -> torch.Tensor:
    """The sum (or ``"max"``) of ``t`` over the axis, on every rank (a new
    tensor; ``t`` is left as it is)."""
    out = t.clone()
    if _active(ax):
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=ax.group)
    return out


#: the native all-gather into one tensor (named ``all_gather_single`` in
#: newer torch releases)
_gather_into = (getattr(dist, "all_gather_single", None)
                or dist.all_gather_into_tensor)


def _blocks(t: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    """``(n, *t.shape)``: ``t`` of each axis rank, in axis order."""
    t = t.contiguous()
    if _slotted(t, ax):
        buf = torch.zeros((ax.size,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        buf[ax.index].copy_(t)
        dist.all_reduce(buf, group=ax.group)
        return buf
    buf = torch.empty((ax.size * t.numel(),), dtype=t.dtype,
                      device=t.device)
    _gather_into(buf, t.reshape(-1), group=ax.group)
    return buf.view((ax.size,) + tuple(t.shape))


def all_gather(t: torch.Tensor, ax: Optional[AxisGroup],
               dim: int = 0) -> torch.Tensor:
    """The axis's blocks concatenated along ``dim``, in axis order."""
    if not _active(ax):
        return t
    return torch.cat(list(_blocks(t, ax).unbind(0)), dim=dim)


def all_to_all(t: torch.Tensor, ax: Optional[AxisGroup], split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(tiled=True)``: ``t`` cut into the axis size's
    blocks along ``split_dim``; block ``j`` goes to axis rank ``j``; the
    blocks a rank receives are concatenated along ``concat_dim`` in the
    senders' order."""
    if not _active(ax):
        return t
    n = ax.size
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} "
                         f"does not divide by the axis size {n}")
    if _slotted(t, ax):
        mine = [b.chunk(n, dim=split_dim)[ax.index]
                for b in _blocks(t, ax).unbind(0)]
        return torch.cat(mine, dim=concat_dim)
    send = torch.stack(t.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ax.group)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)


def ring_shift(t: torch.Tensor, ax: Optional[AxisGroup],
               shift: int = 1) -> torch.Tensor:
    """``ppermute`` by ``shift`` around the axis: each rank gets the
    tensor of the rank ``shift`` places before it (``[(i, i + shift)]``)."""
    if not _active(ax):
        return t
    n = ax.size
    src = (ax.index - shift) % n
    if _slotted(t, ax):
        return _blocks(t, ax)[src]
    t = t.contiguous()
    out = torch.empty_like(t)
    dst = (ax.index + shift) % n
    if src == ax.index:         # a shift by a multiple of the axis size
        return out.copy_(t)
    ops = [dist.P2POp(dist.isend, t, ax.ranks[dst], group=ax.group),
           dist.P2POp(dist.irecv, out, ax.ranks[src], group=ax.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.ax.size, dim=ctx.dim)[ctx.ax.index], None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return x.chunk(ax.size, dim=dim)[ax.index].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.ax, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_dim, concat_dim):
        ctx.args = (ax, split_dim, concat_dim)
        return all_to_all(x, ax, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        ax, split_dim, concat_dim = ctx.args
        return all_to_all(g, ax, concat_dim, split_dim), None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, shift):
        ctx.ax, ctx.shift = ax, shift
        return ring_shift(x, ax, shift)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, ctx.ax, -ctx.shift), None, None


def reduce_from(x: torch.Tensor, ax: Optional[AxisGroup]) -> torch.Tensor:
    """Sum over the axis forward; the gradient passes as it is (after a
    row-parallel product)."""
    return _Reduce.apply(x, ax) if _active(ax) else x


def copy_to(x: torch.Tensor, ax: Optional[AxisGroup]) -> torch.Tensor:
    """Identity forward; the gradient summed over the axis (before a
    column-parallel product)."""
    return _Copy.apply(x, ax) if _active(ax) else x


def gather_from(x: torch.Tensor, ax: Optional[AxisGroup],
                dim: int) -> torch.Tensor:
    """All-gather along ``dim`` forward; the rank's slice of the gradient
    backward."""
    return _Gather.apply(x, ax, dim) if _active(ax) else x


def split_to(x: torch.Tensor, ax: Optional[AxisGroup],
             dim: int) -> torch.Tensor:
    """The rank's slice along ``dim`` forward; the gradient all-gathered
    backward."""
    return _Split.apply(x, ax, dim) if _active(ax) else x


def all_to_all_grad(x: torch.Tensor, ax: Optional[AxisGroup], split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    """:func:`all_to_all` with its inverse exchange as the backward."""
    return (_AllToAll.apply(x, ax, split_dim, concat_dim) if _active(ax)
            else x)


def ring_shift_grad(x: torch.Tensor, ax: Optional[AxisGroup],
                    shift: int = 1) -> torch.Tensor:
    """:func:`ring_shift` with the opposite shift as the backward."""
    return _Shift.apply(x, ax, shift) if _active(ax) else x
