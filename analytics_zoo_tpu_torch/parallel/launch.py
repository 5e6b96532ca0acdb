"""Runs a function on several ranks at once: one process a rank, started
with the ``spawn`` method, in one ``torch.distributed`` process group.

    results = run_ranks(fn, world=4, init_file=path, args=(...))

``fn(rank, world, *args)`` must be importable by name from a module (the
workers import it; keep that module free of ``jax``). Each worker sets up
the group from ``init_file`` (a ``file://`` store: no port is bound),
runs ``fn`` and hands back its return value; ``run_ranks`` returns them in
rank order and raises if a rank raised or died. ``backend`` is ``gloo``
(the CPU, or ranks sharing one card) or ``nccl`` (a card a rank);
``device`` ``"cuda"`` puts rank ``r`` on card ``r % device_count``.
"""

from __future__ import annotations

import os
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_ranks", "init_rank"]


def init_rank(rank: int, world: int, init_file: str, backend: str = "gloo",
              device: str = "cpu") -> None:
    """This process as rank ``rank`` of ``world`` (the store at
    ``init_file``); on ``device="cuda"`` its card is ``rank %
    device_count``."""
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank, **kwargs)


def _worker(rank, world, init_file, backend, device, fn, args, queue):
    try:
        # ranks share the host's cores (and, under gloo, often one card)
        torch.set_num_threads(1)
        init_rank(rank, world, init_file, backend, device)
        out = fn(rank, world, *args)
        queue.put((rank, True, out))
    except Exception:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, init_file: str,
              args: Sequence[Any] = (), backend: str = "gloo",
              device: str = "cpu", timeout: float = 600.0) -> List[Any]:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks; their return
    values in rank order. Raises with the rank's traceback if one raised,
    if one died without an answer, and if they did not all answer within
    ``timeout`` seconds (every process is stopped either way)."""
    if os.path.exists(init_file):
        os.remove(init_file)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(
        r, world, init_file, backend, device, fn, tuple(args), queue),
        daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    errors = []
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world and not errors:
            try:
                rank, ok, out = queue.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"rank {dead[0]} died (exit code "
                                  f"{procs[dead[0]].exitcode})")
                elif time.monotonic() > deadline:
                    errors.append(f"no answer within {timeout} s")
                continue
            if ok:
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.5)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return [results[r] for r in range(world)]
