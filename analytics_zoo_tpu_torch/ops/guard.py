"""The guarded training step's kernels, G1 and G2 (``csrc/guard.cu``).

Neither has a Pallas counterpart: in the JAX package XLA fuses the
guarded step's gradient norm, scalar chain and discard select into the
step. On the card, as torch ops, they were some 80 small kernels a step;
these are the two launches that take their place
(``pipeline/api/keras/training.py`` ``TrainingLoop.guarded_step``,
``dispatch.Guard``).

:func:`guard_check` (G2): from the step's gradients (any number, f32 or
bf16) — or, on a mesh, the global gradient norm — the global norm with
the bits of ``anomaly.tensor_norms`` (``torch._foreach_norm``) and
``anomaly.norm_of_norms`` (``torch.linalg.vector_norm``), the sentinel's
flag word and EWMA update (``common/anomaly.check``), the global-norm
clip's scale and engaged bit (``anomaly.clip_by_global_norm``), ``bad``
(recover mode: any anomaly bit), the step's row of per-step optimizer
values (the row of the device count, before it moves) and the count's
advance — one launch. The gradients' descriptors go to the kernel by
value, up to :func:`param_cap` of them; past it, in a device table.

:func:`guard_commit` (G1): where ``bad``, one set of tensors copied over
another; else nothing — one launch for every tensor, over a device table
of the tensors that :func:`commit_table` makes once per set of tensors.
The recover-mode step runs it twice (``dispatch.Guard``): after G2 has
decided ``bad`` and before the update, the state into its pre-step
copies (the keep), and after the update, the copies back over the state
(the discard). On the card a good step moves no state bytes at all.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version (:func:`guard_check_reference`,
:func:`guard_commit_reference`), the torch ops the kernels replace, whose
bits the kernels give.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..common import anomaly
from .cuda_build import CudaLibrary, launch
from .launch_count import LaunchCount

__all__ = ["guard_check", "guard_check_reference", "guard_commit",
           "guard_commit_reference", "commit_table",
           "CommitTable", "LIBRARY", "KERNEL_CHECK", "KERNEL_COMMIT"]

#: elements of one chunk of ``torch._foreach_norm`` (``NORM_CHUNK`` in
#: ``guard.cu``); G2 runs 16 warps a chunk
NORM_CHUNK = 65536
#: bytes a block of G1 copies at a time (``CHUNK`` in ``guard.cu``)
CHUNK = 32768
#: G1's grid: two blocks an SM of the H100, which a good step's launch
#: (every block returns after one read) keeps cheap and a bad step's copy
#: still spreads over the whole card
_COMMIT_BLOCKS = 264


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.guard_check.argtypes = [p, i, p, i, p, p, p, i, p, p, p, p, p, p,
                                i, i, p, p, p, p, i, f, f, i, p]
    lib.guard_param_cap.argtypes = []
    lib.guard_commit.argtypes = [p, i, ctypes.c_longlong, p, i, p]
    for fn in (lib.guard_check, lib.guard_commit, lib.guard_param_cap):
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("guard", ["guard.cu"], _bind)

KERNEL_CHECK = LaunchCount()    # G2
KERNEL_COMMIT = LaunchCount()   # G1


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# G2
# ---------------------------------------------------------------------------

def guard_check_reference(loss, gnorm, ewma, obs, count, base, table, *,
                          sentinel: bool, spike_factor: float,
                          grad_clip: float, recover: bool, grads=None):
    """Plain version of G2: the torch ops of ``anomaly.check``,
    ``anomaly.clip_by_global_norm``'s scale and the guarded step's row and
    count, in their order (with ``grads``, the step's gradients, and
    ``gnorm`` None: ``anomaly.tensor_norms`` and ``norm_of_norms`` first).
    Updates ``ewma``, ``obs`` and ``count`` in place; returns ``(flags,
    bad, row, scale)`` (``row`` None without a table, ``scale`` None
    without clipping)."""
    if gnorm is None:
        gnorm = anomaly.norm_of_norms(anomaly.tensor_norms(list(grads)),
                                      loss.device)
    if sentinel:
        flags, (new_ewma, new_obs) = anomaly.check(
            loss, gnorm, (ewma, obs), spike_factor)
        ewma.copy_(new_ewma)
        obs.copy_(new_obs)
    else:
        flags = torch.zeros((), dtype=torch.int32, device=loss.device)
    scale = None
    if grad_clip > 0:
        scale, engaged = anomaly.clip_scale(gnorm, grad_clip)
        flags = flags | engaged.to(torch.int32) * anomaly.GRAD_CLIPPED
    row = (None if table is None or table.shape[-1] == 0
           else table.index_select(0, (count - base).view(1))[0])
    if recover:
        bad = (flags & anomaly.ANOMALY_MASK) > 0
        count.add_((~bad).to(torch.int64))
    else:
        bad = torch.zeros((), dtype=torch.bool, device=loss.device)
        count.add_(1)
    return flags, bad, row, scale


def _scalar(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype or t.numel() != 1:
        raise ValueError(f"guard_check: {what} must be a one-element "
                         f"{dtype}; got {tuple(t.shape)} {t.dtype}")


def guard_check(loss, gnorm, ewma, obs, count, base, table, *,
                sentinel: bool, spike_factor: float, grad_clip: float,
                recover: bool, flags_out: Optional[torch.Tensor] = None,
                grads: Optional[Sequence[torch.Tensor]] = None,
                tickets: Optional[torch.Tensor] = None):
    """G2: the guarded step's flag word, EWMA update, clip scale, ``bad``,
    per-step row and count advance from the step's ``loss`` and ``gnorm``
    (f32 scalar) — or, with ``gnorm`` None, ``grads``, the step's
    gradients, whose global norm the kernel takes (written into a new
    ``gnorm``). ``ewma``/``obs`` (f32), ``count``/``base`` (int64) are the
    guard's device scalars (``ewma``, ``obs`` and ``count`` updated in
    place); ``table`` the block's ``(K, n)`` f32 per-step values or None.
    ``flags_out``, an int32 scalar, receives the flag word when given.
    ``tickets`` (on the card, with ``grads``): an int32 tensor of at
    least ``len(grads) + 1`` zeros on the loss's device, which the launch
    counts in and leaves at zero — the training loop's own
    (:meth:`dispatch.Guard.tickets`), so that no two loops' launches
    share one; without it a zeroed one is made for the call.
    Returns ``(flags, bad, row, scale)`` as :func:`guard_check_reference`
    does. CUDA tensors launch the kernel (or raise); CPU tensors run the
    plain version."""
    if not loss.is_cuda:
        out = guard_check_reference(
            loss, gnorm, ewma, obs, count, base, table, sentinel=sentinel,
            spike_factor=spike_factor, grad_clip=grad_clip, recover=recover,
            grads=grads)
        if flags_out is not None:
            flags_out.copy_(out[0])
        return out
    if loss.dtype not in (torch.float32, torch.bfloat16):
        loss = loss.float()
    if loss.numel() != 1:
        raise ValueError("guard_check: the loss must be a scalar")
    rows_c = grad_table = None
    n_grads, units, scratch = -1, 0, None
    if gnorm is None:
        grads, rows_c, units = _grad_rows(list(grads), loss.get_device())
        n_grads = len(grads)
        gnorm = torch.empty((), dtype=torch.float32, device=loss.device)
        scratch = torch.empty(units + n_grads, dtype=torch.float32,
                              device=loss.device)
        if n_grads > param_cap():
            grad_table = _grad_table(rows_c, loss.device)
        if tickets is None:
            tickets = torch.zeros(n_grads + 1, dtype=torch.int32,
                                  device=loss.device)
        elif (tickets.dtype != torch.int32 or not tickets.is_contiguous()
              or tickets.numel() < n_grads + 1 or not tickets.is_cuda
              or tickets.get_device() != loss.get_device()):
            raise ValueError("guard_check: tickets must be a contiguous "
                             f"int32 tensor of at least {n_grads + 1} "
                             "elements on the loss's device")
    for t, dtype, what in ((gnorm, torch.float32, "gnorm"),
                           (ewma, torch.float32, "ewma"),
                           (obs, torch.float32, "obs"),
                           (count, torch.int64, "count"),
                           (base, torch.int64, "base")):
        _scalar(t, dtype, what)
        if not t.is_cuda or t.get_device() != loss.get_device():
            raise ValueError(f"guard_check: {what} lies on another device")
    rows = n = 0
    row = None
    if table is not None and table.shape[-1] > 0:
        if (table.dim() != 2 or table.dtype != torch.float32
                or not table.is_contiguous() or not table.is_cuda):
            raise ValueError("guard_check: the table must be a contiguous "
                             "(K, n) float32 CUDA tensor")
        rows, n = table.shape
        row = torch.empty(n, dtype=torch.float32, device=loss.device)
    if flags_out is None:
        flags = torch.empty((), dtype=torch.int32, device=loss.device)
    else:
        _scalar(flags_out, torch.int32, "flags_out")
        flags = flags_out
    bad = torch.empty((), dtype=torch.bool, device=loss.device)
    scale = (torch.empty((), dtype=torch.float32, device=loss.device)
             if grad_clip > 0 else None)
    err = launch(
        LIBRARY.entry("guard_check"), loss,
        None if rows_c is None else ctypes.cast(rows_c, ctypes.c_void_p),
        n_grads, None if grad_table is None else grad_table.data_ptr(),
        units, None if scratch is None else tickets.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        loss.data_ptr(), int(loss.dtype == torch.bfloat16),
        gnorm.data_ptr(), ewma.data_ptr(), obs.data_ptr(),
        count.data_ptr(), base.data_ptr(),
        None if row is None else table.data_ptr(), rows, n,
        None if row is None else row.data_ptr(), flags.data_ptr(),
        bad.data_ptr(), None if scale is None else scale.data_ptr(),
        int(sentinel), float(spike_factor), float(grad_clip), int(recover))
    _raise_on(err, "guard_check")
    KERNEL_CHECK.launches += 1
    return flags, bad, row, scale


#: ``Grad`` flags in ``guard.cu``
_BF16, _ALIGNED, _VEC8 = 1, 2, 4
_PARAM_CAP: List[int] = []


def param_cap() -> int:
    """The most gradients whose descriptors G2 takes by value
    (``PARAM_CAP`` in ``guard.cu``: 1024)."""
    if not _PARAM_CAP:
        _PARAM_CAP.append(int(LIBRARY.entry("guard_param_cap")()))
    return _PARAM_CAP[0]


def _grad_flags(g: torch.Tensor) -> int:
    """``g``'s ``Grad`` flags: its dtype, and ``_foreach_norm``'s choice of
    path — vectorised for a 16-byte aligned f32 address and a length that
    is a multiple of 4 (a bf16 gradient's f32 copy is a fresh, aligned
    allocation, so only its length decides)."""
    n, ptr = g.numel(), g.data_ptr()
    if g.dtype == torch.bfloat16:
        return (_BF16 | (_VEC8 if ptr % 8 == 0 else 0)
                | (_ALIGNED if n % 4 == 0 else 0))
    return _ALIGNED if n % 4 == 0 and ptr % 16 == 0 else 0


def _grad_rows(grads: List[torch.Tensor], device: int):
    """The gradients as G2 reads them (bf16 and f32 as they are, any other
    dtype cast to f32 as ``anomaly.tensor_norms`` casts it), their
    descriptors as a C array of ``(address, elements, first chunk | flags
    << 32)`` int64 triples, and the kernel's warp units (16 a chunk; an
    empty gradient takes one chunk, whose warps sum nothing)."""
    out, flat, first = [], [], 0
    for g in grads:
        if g.get_device() != device:
            raise ValueError("guard_check: the gradients must lie on the "
                             "loss's device")
        if g.dtype not in (torch.float32, torch.bfloat16):
            g = g.float()
        if not _dense(g):
            raise ValueError("guard_check: every gradient must be dense")
        out.append(g)
        flat += [g.data_ptr(), g.numel(), first | _grad_flags(g) << 32]
        first += max(1, -(-g.numel() // NORM_CHUNK))
    return out, (ctypes.c_longlong * max(len(flat), 1))(*flat), 16 * first


_GRAD_TABLES: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _grad_table(rows_c, device: torch.device) -> torch.Tensor:
    """The descriptors' device copy past :func:`param_cap` gradients: made
    anew for an eager call; kept, with its pinned source, for a call being
    captured (the graph replays the copy from that source)."""
    host = torch.tensor(list(rows_c), dtype=torch.int64).pin_memory()
    if not torch.cuda.is_current_stream_capturing():
        return host.to(device, non_blocking=True)
    key = (device.index, tuple(rows_c))
    if key not in _GRAD_TABLES:
        _GRAD_TABLES[key] = (host, host.to(device, non_blocking=True))
    return _GRAD_TABLES[key][1]


# ---------------------------------------------------------------------------
# G1
# ---------------------------------------------------------------------------

class CommitTable:
    """The device table G1 reads: one ``(dst, src, bytes, first chunk)``
    int64 row a state tensor, and the key it was made for (the tensors'
    addresses and sizes)."""

    def __init__(self, state: Sequence[torch.Tensor],
                 prev: Sequence[torch.Tensor]):
        self.key = _key(state, prev)
        rows, first = [], 0
        for t, p in zip(state, prev):
            nbytes = t.numel() * t.element_size()
            if nbytes:
                rows.append([t.data_ptr(), p.data_ptr(), nbytes, first])
                first += -(-nbytes // CHUNK)
        self.n, self.chunks = len(rows), first
        host = torch.tensor(rows or [[0, 0, 0, 0]], dtype=torch.int64)
        # pinned and kept: the copy may be captured into a graph, which
        # reads the host buffer again at each replay
        self.host = host.pin_memory()
        device = state[0].device
        self.entries = self.host.to(device, non_blocking=True)
        self.blocks = max(1, min(self.chunks, _COMMIT_BLOCKS))


def _key(state, prev) -> Tuple:
    return tuple((t.data_ptr(), p.data_ptr(), t.numel() * t.element_size())
                 for t, p in zip(state, prev))


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill one span of memory from its data
    pointer without gaps or overlaps, in any dimension order (contiguous,
    or a permutation of it such as a ``channels_last`` weight)."""
    dims = sorted((st, n) for st, n in zip(t.stride(), t.shape) if n != 1)
    expect = 1
    for st, n in dims:
        if st != expect:
            return False
        expect *= n
    return True


def commit_table(state: Sequence[torch.Tensor], prev: Sequence[torch.Tensor],
                 table: Optional[CommitTable] = None) -> CommitTable:
    """``table`` when it was made for these tensors, else a new one. Each
    state tensor and its copy must be alike in shape, dtype and strides
    and fill their span of memory (the kernel copies the span's bytes)."""
    if table is not None and table.key == _key(state, prev):
        return table
    for t, p in zip(state, prev):
        if (t.shape != p.shape or t.dtype != p.dtype
                or t.stride() != p.stride() or not _dense(t)):
            raise ValueError("guard_commit: every state tensor and its copy "
                             "must be alike (shape, dtype, strides) and "
                             "dense")
    return CommitTable(state, prev)


def guard_commit_reference(state: Sequence[torch.Tensor],
                           prev: Sequence[torch.Tensor],
                           bad: torch.Tensor) -> None:
    """Plain version of G1: ``torch.where(bad, prev, t, out=t)`` a
    tensor."""
    for t, p in zip(state, prev):
        torch.where(bad, p, t, out=t)


def guard_commit(state: List[torch.Tensor], prev: List[torch.Tensor],
                 bad: torch.Tensor,
                 table: Optional[CommitTable] = None) -> Optional[CommitTable]:
    """G1: where ``bad`` (a bool scalar), every tensor of ``state`` gets
    its pre-step copy in ``prev`` back, bit for bit; else nothing changes.
    ``table`` is the :class:`CommitTable` of an earlier call, reused when
    it was made for these tensors; returns the table used (None on the
    CPU). CUDA tensors launch the kernel (or raise); CPU tensors run the
    plain version."""
    if len(state) != len(prev):
        raise ValueError("guard_commit: state and prev differ in length")
    if not state:
        return table
    if not bad.is_cuda:
        guard_commit_reference(state, prev, bad)
        return None
    if bad.dtype != torch.bool or bad.numel() != 1:
        raise ValueError("guard_commit: bad must be a bool scalar")
    dev = bad.get_device()
    if any(not t.is_cuda or t.get_device() != dev for t in state):
        raise ValueError("guard_commit: the state lies on another device")
    table = commit_table(state, prev, table)
    err = launch(LIBRARY.entry("guard_commit"), bad,
                 table.entries.data_ptr(), table.n, table.chunks,
                 bad.data_ptr(), table.blocks)
    _raise_on(err, "guard_commit")
    KERNEL_COMMIT.launches += 1
    return table
