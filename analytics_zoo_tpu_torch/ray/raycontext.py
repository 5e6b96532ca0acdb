"""Ray-equivalent task runtime — a copy of ``analytics_zoo_tpu/ray/
raycontext.py`` with the port's process start method; parity with
RayOnSpark, ``pyzoo/zoo/ray/util/raycontext.py``: ``RayContext(sc).init()``
boots ray workers next to the data; ``JVMGuard``/``ProcessMonitor``
(``ray/util/process.py``) kill them when the driver dies.

The runtime is a process pool on the host — stateless ``remote`` tasks
round-trip through a shared queue, stateful actors get a dedicated
process. Worker processes are daemonic and additionally self-terminate
when the parent pid disappears (the JVMGuard role). Multi-host placement
is not re-invented here: under a ``torch.distributed`` group every host
already runs the same program, so "run an actor on each host" is the
program itself.
"""

from __future__ import annotations

import atexit
import itertools
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

__all__ = ["RayContext", "ObjectRef", "ActorHandle", "RayTaskError"]


class RayTaskError(RuntimeError):
    """A task raised; carries the worker-side traceback."""


def _mp_context():
    """``spawn``: the driver is a torch process (threads, and a CUDA
    context once it has touched the card), which a forked child must not
    inherit. Payloads must therefore be picklable and task functions
    importable by name, ray's own contract."""
    return mp.get_context("spawn")


class ObjectRef:
    """Future handle (the ``ray.ObjectRef`` role)."""

    __slots__ = ("id",)

    def __init__(self, id_: int):
        self.id = id_

    def __repr__(self):
        return f"ObjectRef({self.id})"


def _parent_guard(parent_pid: int, poll_s: float = 1.0):
    """Worker-side thread: exit hard if the parent process disappears
    (ProcessMonitor/JVMGuard parity — orphaned workers must not linger)."""

    def watch():
        while True:
            try:
                os.kill(parent_pid, 0)
            except OSError:
                os._exit(1)
            time.sleep(poll_s)

    threading.Thread(target=watch, daemon=True).start()


def _put_result(result_q: mp.Queue, task_id: int, fn_call):
    """Run and reply; unpicklable RESULTS must become errors here — the
    queue's feeder thread would otherwise drop them silently and the
    driver's get() would hang."""
    try:
        result = fn_call()
        pickle.dumps(result)
        result_q.put((task_id, True, result))
    except BaseException:  # noqa: BLE001 — workers must not die on task errors
        result_q.put((task_id, False, traceback.format_exc()))


def _pool_worker(parent_pid: int, task_q: mp.Queue, result_q: mp.Queue):
    _parent_guard(parent_pid)
    while True:
        item = task_q.get()
        if item is None:
            return
        task_id, fn, args, kwargs = item
        _put_result(result_q, task_id, lambda: fn(*args, **kwargs))


def _actor_worker(parent_pid: int, cls, init_args, init_kwargs,
                  cmd_q: mp.Queue, result_q: mp.Queue, ack_id: int):
    _parent_guard(parent_pid)
    try:
        obj = cls(*init_args, **init_kwargs)
    except BaseException:
        result_q.put((ack_id, False, traceback.format_exc()))
        return
    result_q.put((ack_id, True, None))  # construction ack
    while True:
        item = cmd_q.get()
        if item is None:
            return
        task_id, method, args, kwargs = item
        _put_result(result_q, task_id,
                    lambda: getattr(obj, method)(*args, **kwargs))


class _ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs) -> ObjectRef:
        return self._handle._call(self._name, args, kwargs)


class ActorHandle:
    """``actor.method.remote(...)`` → ObjectRef (the ray actor surface)."""

    def __init__(self, ctx: "RayContext", cmd_q: mp.Queue,
                 proc: mp.Process):
        self._ctx = ctx
        self._cmd_q = cmd_q
        self._proc = proc

    def _call(self, method: str, args, kwargs) -> ObjectRef:
        RayContext._check_picklable((args, kwargs), f"{method}() arguments")
        ref = ObjectRef(next(self._ctx._ids))
        self._cmd_q.put((ref.id, method, args, kwargs))
        return ref

    def __getattr__(self, name: str) -> _ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return _ActorMethod(self, name)

    def terminate(self):
        self._cmd_q.put(None)
        self._proc.join(timeout=5)
        if self._proc.is_alive():
            self._proc.terminate()
        if self in self._ctx._actors:  # deliberate exit ≠ crashed worker
            self._ctx._actors.remove(self)


class RayContext:
    """``RayContext(num_workers).init()`` → ``remote``/``get``/``actor``.

    The surface mirrors the RayOnSpark bring-up (``raycontext.py:192``):
    ``init`` boots the workers, ``stop`` tears everything down, and workers
    cannot outlive the driver.
    """

    def __init__(self, num_workers: Optional[int] = None):
        self.num_workers = int(num_workers or (os.cpu_count() or 2))
        self._ids = itertools.count()
        self._mp_ctx = _mp_context()
        self._procs: List[mp.Process] = []
        self._actors: List[ActorHandle] = []
        self._task_q: Optional[mp.Queue] = None
        self._result_q: Optional[mp.Queue] = None
        self._results: Dict[int, Any] = {}
        self._initialized = False

    # ------------------------------------------------------------------
    def init(self) -> "RayContext":
        if self._initialized:
            return self
        ctx = self._mp_ctx
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        for _ in range(self.num_workers):
            p = ctx.Process(target=_pool_worker,
                            args=(os.getpid(), self._task_q, self._result_q),
                            daemon=True)
            p.start()
            self._procs.append(p)
        self._initialized = True
        atexit.register(self.stop)
        return self

    def _require_init(self):
        if not self._initialized:
            raise RuntimeError("RayContext not initialized — call init()")

    # ------------------------------------------------------------------
    @staticmethod
    def _check_picklable(payload, what: str):
        """Surface pickling failures at submission — mp.Queue serializes in
        a background feeder thread where they would vanish and hang get()."""
        try:
            pickle.dumps(payload)
        except Exception as e:
            raise RayTaskError(f"{what} is not picklable (payloads cross "
                               f"process boundaries by pickle): {e}") from e

    def remote(self, fn: Callable, *args, **kwargs) -> ObjectRef:
        """Submit ``fn(*args, **kwargs)`` to the worker pool."""
        self._require_init()
        self._check_picklable((fn, args, kwargs), "task")
        ref = ObjectRef(next(self._ids))
        self._task_q.put((ref.id, fn, args, kwargs))
        return ref

    def actor(self, cls, *args, **kwargs) -> ActorHandle:
        """Start a dedicated stateful worker running ``cls(*args)``."""
        self._require_init()
        self._check_picklable((cls, args, kwargs), "actor spec")
        ctx = self._mp_ctx
        cmd_q = ctx.Queue()
        # construction ack uses a UNIQUE id from the shared counter — a
        # fixed sentinel would hit the first actor's cached ack and mask a
        # later actor's failed __init__ (results are cached, never popped)
        ack_id = next(self._ids)
        p = ctx.Process(target=_actor_worker,
                        args=(os.getpid(), cls, args, kwargs, cmd_q,
                              self._result_q, ack_id),
                        daemon=True)
        p.start()
        # surface __init__ failures immediately; p is passed so a child
        # dying WITHOUT an ack (segfault, os._exit, unpicklable class in a
        # spawn context) raises instead of hanging the 0.2s poll forever
        try:
            ok, payload = self._wait_for(ack_id, extra_proc=p)
        except BaseException:
            p.join(timeout=1)  # reap — a no-ack death must not zombie
            raise
        if not ok:
            p.join(timeout=1)
            raise RayTaskError(f"actor construction failed:\n{payload}")
        h = ActorHandle(self, cmd_q, p)
        self._actors.append(h)
        return h

    # ------------------------------------------------------------------
    def _dead_workers(self) -> List[int]:
        return [p.pid for p in self._procs if not p.is_alive()] + \
            [h._proc.pid for h in self._actors if not h._proc.is_alive()]

    def _wait_for(self, task_id: int, deadline: Optional[float] = None,
                  extra_proc=None):
        # results are cached, not popped: get() on the same ref twice
        # returns the same value (ray.get semantics)
        extra_dead_at = None
        while task_id not in self._results:
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"ObjectRef({task_id}) not ready before "
                                   f"timeout")
            # liveness of the just-spawned (untracked) process is checked
            # EVERY iteration: a steady stream of unrelated pool results
            # would otherwise starve the Empty branch and re-open the hang
            if extra_proc is not None and not extra_proc.is_alive():
                # wall-clock grace (not iterations — a busy result queue
                # spins iterations in microseconds): the dead child's queue
                # feeder gets ~1s to flush a final (failure) ack
                now = time.monotonic()
                if extra_dead_at is None:
                    extra_dead_at = now
                elif now - extra_dead_at > 1.0:
                    raise RayTaskError(
                        f"actor process {extra_proc.pid} died before "
                        f"delivering its construction ack (segfault / "
                        f"os._exit in __init__?)")
            try:
                # bounded poll so crashed workers are detected even with no
                # deadline (a dead worker's result will never arrive)
                got_id, ok, payload = self._result_q.get(timeout=0.2)
                self._results[got_id] = (ok, payload)
            except queue_mod.Empty:
                dead = self._dead_workers()
                if dead:
                    raise RayTaskError(
                        f"worker process(es) {dead} died before delivering "
                        f"ObjectRef({task_id}) (crashed / OOM-killed?)")
        return self._results[task_id]

    def get(self, refs: Union[ObjectRef, Sequence[ObjectRef]],
            timeout: Optional[float] = None):
        """Block for result(s). Task errors raise :class:`RayTaskError`;
        expiry raises :class:`TimeoutError` (the timeout bounds the WHOLE
        call, also for a list of refs)."""
        self._require_init()
        deadline = None if timeout is None else time.monotonic() + timeout
        if isinstance(refs, ObjectRef):
            refs_list = [refs]
        else:
            refs_list = list(refs)
        out = []
        for r in refs_list:
            ok, payload = self._wait_for(r.id, deadline)
            if not ok:
                raise RayTaskError(f"task failed:\n{payload}")
            out.append(payload)
        return out[0] if isinstance(refs, ObjectRef) else out

    # ------------------------------------------------------------------
    def stop(self):
        if not self._initialized:
            return
        for h in self._actors:
            try:
                h.terminate()
            except Exception:  # noqa: BLE001 — best-effort teardown  # zoolint: disable=ZL007
                pass
        for _ in self._procs:
            try:
                self._task_q.put(None)
            except Exception:  # noqa: BLE001 — best-effort teardown  # zoolint: disable=ZL007
                pass
        for p in self._procs:
            p.join(timeout=2)
            if p.is_alive():
                p.terminate()
        self._procs.clear()
        self._actors.clear()
        self._initialized = False
