"""Durable checkpoint/resume — port of ``analytics_zoo_tpu/utils/
checkpoint.py``, in the JAX package's on-disk format, so a snapshot of
the one package resumes in the other.

Format: one directory per snapshot (``ckpt-<iteration>/``) holding one
``.npz`` per tree (params / opt_state / net_state — ``leaf_<i>`` arrays
in the deterministic :func:`tree_leaves` order, which is
``jax.tree_util``'s for nested dicts, lists and tuples: dict keys
sorted) plus a ``manifest.json`` carrying per-tree CRC32 checksums, leaf
counts/shapes/dtypes, the resume metadata, and (``mesh=``) the mesh the
snapshot was cut under. The manifest is written LAST (tmp file +
``os.replace``) and is the **commit marker**: a directory without one
was never committed — a process killed mid-write can never produce a
snapshot that a resume will trust.

Durability contract, as in the JAX package:

* **Async save.** :meth:`CheckpointManager.save` snapshots device
  tensors to host and returns; serialization, checksumming, the manifest
  commit, and pruning run on a background writer thread, off the
  training step path. The snapshot is one batched device-to-host copy
  into pinned host memory, then one wait. At most ONE save is in
  flight: the next ``save()`` (or ``close()``) joins it first. A
  background failure counts in ``zoo_ckpt_save_failures_total`` and
  surfaces as :class:`CheckpointSaveError` on that next call — never
  silently.
* **Verified restore with fallback.** :meth:`restore` verifies the
  manifest and checksums; :meth:`restore_latest` walks snapshots newest
  → oldest, **quarantines** a corrupt/uncommitted one to
  ``ckpt-<n>.corrupt`` (counted in ``zoo_ckpt_corrupt_total``, never
  silently deleted) and falls back to the newest snapshot that verifies.
  Legacy snapshots (pre-manifest: ``meta.json`` only) restore with a
  logged warning.
* **Chaos-provable.** The writer carries the named fault sites
  ``ckpt.write`` (per tree file), ``ckpt.manifest`` and ``ckpt.rename``
  (the commit) through ``common.faults``.

Single-writer discipline: one process owns a checkpoint directory at a
time. Quarantining is an OWNER action: a reader of someone else's live
directory (serving loading a training run's weights) must restore with
``restore_latest(..., quarantine=False)``, which skips bad snapshots
instead of renaming them.

Restored trees hold numpy arrays; the caller copies them where they go
(the training loop into its live parameter and optimizer tensors, in
place).
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import faults

log = logging.getLogger("analytics_zoo_tpu_torch.checkpoint")

__all__ = ["CheckpointManager", "CheckpointError", "CheckpointSaveError",
           "CheckpointCorruptError", "CheckpointArchitectureError",
           "tree_leaves", "tree_flatten", "tree_unflatten", "MESH_ONE_DEVICE"]

_CKPT_RE = re.compile(r"^ckpt-(\d+)$")
MANIFEST = "manifest.json"
_MANIFEST_VERSION = 1
_UNCOMMITTED = "no manifest.json — the save never committed"


class CheckpointError(RuntimeError):
    """Base class for checkpoint failures."""


class CheckpointSaveError(CheckpointError):
    """A background (async) save failed; raised on the NEXT checkpoint
    call so the failure is never silent. The original error is chained."""


class CheckpointCorruptError(CheckpointError):
    """A snapshot failed verification (bad checksum, torn write, missing
    commit marker). The snapshot has been quarantined to
    ``ckpt-<n>.corrupt``."""

    def __init__(self, step: int, reason: str):
        super().__init__(f"checkpoint ckpt-{step} is corrupt: {reason}")
        self.step = step
        self.reason = reason


class CheckpointArchitectureError(ValueError):
    """The snapshot does not match the restore template (leaf count or
    shape) — a configuration error, NOT corruption: it must never trigger
    quarantine or fallback (every snapshot of the run would be
    quarantined against a wrong template)."""


#: the mesh block the JAX package writes for one device
#: (``parallel.mesh.mesh_metadata`` of a one-device mesh)
MESH_ONE_DEVICE = {"axes": {"data": 1, "pipe": 1, "seq": 1, "expert": 1,
                            "model": 1}, "devices": 1}


# ---------------------------------------------------------------------------
# trees: nested dicts / lists / tuples, flattened as jax.tree_util does
# ---------------------------------------------------------------------------

def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``: dict values in sorted-key order, list and
    tuple items in order, ``None`` a node without leaves, anything else a
    leaf — ``jax.tree_util.tree_flatten``'s order for these nodes."""
    leaves: List[Any] = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", type(node), keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return ("seq", type(node), None, [walk(c) for c in node])
        leaves.append(node)
        return "*"
    return leaves, walk(tree)


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == "*":
            return next(it)
        kind, typ, keys, children = d
        built = [build(c) for c in children]
        if kind == "dict":
            return typ(zip(keys, built))
        return typ(built) if typ in (list, tuple) else typ(*built)
    return build(treedef)


# ---------------------------------------------------------------------------
# leaf-level helpers
# ---------------------------------------------------------------------------

_ALIGN = 64


def _snapshot_leaves(tree: Any) -> List[np.ndarray]:
    """Host-side copies of every leaf — the only work that stays on the
    caller's (step) path. Device tensors come back in ONE batched copy:
    each is copied, without a host wait, into its slice of one pinned
    host buffer, then one event is waited for; host leaves are copied so
    the background writer never races a caller mutating its own arrays.
    A bfloat16 tensor is written as float32 (numpy has no bfloat16)."""
    leaves = tree_leaves(tree)
    out: List[Optional[np.ndarray]] = [None] * len(leaves)
    dev = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            if t.is_cuda:
                dev.append((i, t))
            else:
                out[i] = t.contiguous().numpy().copy()
        else:
            out[i] = np.array(leaf, copy=True)
    if dev:
        offsets, total = [], 0
        for _, t in dev:
            offsets.append(total)
            total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
        buf = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
        for (i, t), off in zip(dev, offsets):
            n = t.numel() * t.element_size()
            dst = buf[off:off + n].view(t.dtype).view(t.shape)
            dst.copy_(t, non_blocking=True)
            out[i] = dst.numpy()
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return out  # type: ignore[return-value]


def _write_tree(path: str, leaves: List[np.ndarray]) -> Tuple[int, int]:
    """Serialize ``leaves`` to ``path`` (.npz), fsync, and return
    ``(crc32, bytes)`` of the file as written."""
    faults.inject("ckpt.write")
    np.savez(path, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    crc = 0
    size = 0
    with open(path, "rb+") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
        os.fsync(f.fileno())
    return crc & 0xFFFFFFFF, size


def _file_crc(path: str) -> Tuple[int, int]:
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc & 0xFFFFFFFF, size


def _rebuild_tree(template: Any, loaded: List[np.ndarray], path: str) -> Any:
    """Rebuild a tree from loaded leaves using ``template``'s structure
    (the template supplies the treedef — no pickled treedefs on disk).
    Preserves template leaf types for non-array scalar leaves (e.g. a
    count) and fails loudly on any shape mismatch — silently installing
    permuted leaves would train on scrambled weights."""
    leaves, treedef = tree_flatten(template)
    if len(loaded) != len(leaves):
        raise CheckpointArchitectureError(
            f"{path}: checkpoint has {len(loaded)} leaves, "
            f"template has {len(leaves)} — architecture mismatch")
    out = []
    for i, (tmpl, arr) in enumerate(zip(leaves, loaded)):
        if tuple(np.shape(tmpl)) != tuple(arr.shape):
            raise CheckpointArchitectureError(
                f"{path}: leaf {i} shape {arr.shape} != template "
                f"{tuple(np.shape(tmpl))} — architecture mismatch")
        if np.ndim(tmpl) == 0 and not isinstance(
                tmpl, (np.ndarray, torch.Tensor)):
            out.append(type(tmpl)(arr.item()))
        else:
            out.append(arr)
    return tree_unflatten(treedef, out)


def _load_leaves(path: str) -> List[np.ndarray]:
    with np.load(path) as data:
        return [data[f"leaf_{i}"] for i in range(len(data.files))]


class CheckpointManager:
    """Directory of snapshots with asynchronous verified save,
    checksum-verified restore with corruption fallback, and pruning."""

    def __init__(self, directory: str, keep: int = 3, registry=None,
                 ledger=None):
        if keep < 0:
            raise ValueError(
                f"keep must be >= 0 (0 = keep every snapshot), got {keep}")
        self.directory = directory
        self.keep = keep
        # goodput attribution: when the owning loop passes its
        # GoodputLedger, save() charges the SYNCHRONOUS window (join of
        # the previous in-flight write + host snapshot + any sync write)
        # to ckpt_stall; the async background write stays hidden — by
        # construction only the stall the step path actually felt counts
        self._ledger = ledger
        os.makedirs(directory, exist_ok=True)
        # -- async writer state (at most one save in flight) ---------------
        self._lock = threading.Lock()
        self._pending: Optional[Tuple[threading.Thread, dict]] = None
        # -- observability (docs/guides/OBSERVABILITY.md zoo_ckpt_*) -------
        if registry is None:
            from ..observability import default_registry
            registry = default_registry()
        self._registry = registry
        self._m_save_s = registry.histogram(
            "zoo_ckpt_save_seconds",
            "background checkpoint write wall time per committed save")
        self._m_bytes = registry.histogram(
            "zoo_ckpt_bytes", "bytes written per committed save")
        self._m_save_fail = registry.counter(
            "zoo_ckpt_save_failures_total",
            "checkpoint saves that failed (surfaced on the next "
            "checkpoint call)")
        self._m_corrupt = registry.counter(
            "zoo_ckpt_corrupt_total",
            "snapshots quarantined to ckpt-<n>.corrupt (bad checksum, "
            "torn write, or missing commit marker)")
        self._m_fallback = registry.counter(
            "zoo_ckpt_restore_fallback_total",
            "restores that could not use the newest snapshot and fell "
            "back past quarantined one(s)")

    # ---- paths ------------------------------------------------------------
    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}")

    # ---- async plumbing ---------------------------------------------------
    def save_in_flight(self) -> bool:
        """Whether a background save is currently writing."""
        with self._lock:
            return (self._pending is not None
                    and self._pending[0].is_alive())

    def join(self) -> None:
        """Wait for the in-flight save (if any); surface its failure as
        :class:`CheckpointSaveError` exactly once."""
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return
        thread, box = pending
        thread.join()
        err = box.get("error")
        if err is not None:
            raise CheckpointSaveError(
                f"background save of ckpt-{box['step']} failed: "
                f"{err}") from err

    def close(self, raise_pending: bool = True) -> None:
        """Join the in-flight save. ``raise_pending=False`` logs a
        pending failure instead of raising (exception-path cleanup — the
        failure was already counted when it happened)."""
        try:
            self.join()
        except CheckpointSaveError:
            if raise_pending:
                raise
            log.exception("in-flight checkpoint save failed during close")

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(raise_pending=exc_type is None)

    # ---- save -------------------------------------------------------------
    def save(self, step: int, trees: Dict[str, Any],
             meta: Optional[Dict[str, Any]] = None,
             sync: bool = False, mesh: Optional[Dict[str, Any]] = None,
             ) -> str:
        """Snapshot ``trees`` as ``ckpt-<step>``.

        Device tensors are fetched to host NOW (the step path pays one
        batched transfer); serialization + commit happen on a background
        writer unless ``sync=True``. Joins any previous in-flight save
        first — surfacing ITS failure — so at most one save is ever in
        flight and failures are never silent. ``mesh`` (the JAX
        package's ``mesh_metadata`` dict; :data:`MESH_ONE_DEVICE` for the
        port's one device) records the topology the snapshot was cut
        under.
        Returns the final snapshot path (committed only once the
        manifest lands)."""
        led = self._ledger
        if led is not None:
            # close the caller's interval first, then charge everything
            # this call blocks on (join/snapshot/sync write) to
            # ckpt_stall via the finally below
            led.note(led.good)
        try:
            return self._save_blocking(step, trees, meta, sync, mesh)
        finally:
            if led is not None:
                led.note("ckpt_stall")

    def _save_blocking(self, step, trees, meta, sync, mesh) -> str:
        self.join()
        # every tree's leaves in ONE batched device-to-host copy
        names = list(trees)
        per_tree = [tree_leaves(trees[name]) for name in names]
        fetched = iter(_snapshot_leaves([a for leaves in per_tree
                                         for a in leaves]))
        host = {name: [next(fetched) for _ in leaves]
                for name, leaves in zip(names, per_tree)}
        meta = {"step": step, **(meta or {})}
        final = self._dir(step)
        if sync:
            try:
                self._write(step, host, meta, final, mesh)
            except Exception as e:
                # Exception only: a KeyboardInterrupt/SystemExit mid-write
                # must stay a BaseException (wrapping it would feed the
                # user's Ctrl-C into the fit retry loop as a step failure)
                raise CheckpointSaveError(
                    f"save of ckpt-{step} failed: {e}") from e
            return final
        box: dict = {"step": step}
        thread = threading.Thread(
            target=self._write_guarded,
            args=(step, host, meta, final, mesh, box),
            name=f"ckpt-writer-{step}", daemon=True)
        with self._lock:
            self._pending = (thread, box)
        thread.start()
        return final

    def _write_guarded(self, step, host, meta, final, mesh, box) -> None:
        try:
            self._write(step, host, meta, final, mesh)
        except BaseException as e:   # surfaced via join(); never silent
            box["error"] = e

    def _write(self, step, host, meta, final, mesh=None) -> None:
        t0 = time.perf_counter()
        try:
            total = self._commit(step, host, meta, final, mesh)
        except BaseException as e:
            self._m_save_fail.inc()
            self._registry.emit("ckpt.save_failure", step=step,
                                error=f"{type(e).__name__}: {e}")
            log.error("checkpoint save of ckpt-%d failed: %s", step, e)
            raise
        dur = time.perf_counter() - t0
        self._m_save_s.observe(dur)
        self._m_bytes.observe(total)
        self._registry.emit("ckpt.save", step=step, bytes=total, dur_s=dur)
        self._prune()

    def _commit(self, step, host, meta, final, mesh=None) -> int:
        """Write tree files, then the manifest (the commit marker) LAST.
        A crash at any earlier point leaves an uncommitted directory no
        restore will trust."""
        if os.path.isdir(final):
            # leftovers of an uncommitted attempt at the same step (or an
            # explicit re-save): drop the commit marker FIRST so a crash
            # mid-overwrite cannot leave old-manifest/new-files mixtures
            marker = os.path.join(final, MANIFEST)
            if os.path.exists(marker):
                os.remove(marker)
            shutil.rmtree(final)
        os.makedirs(final)
        total = 0
        tree_entries: Dict[str, dict] = {}
        for name, leaves in host.items():
            fname = name + ".npz"
            crc, size = _write_tree(os.path.join(final, fname), leaves)
            total += size
            tree_entries[name] = {
                "file": fname, "crc32": crc, "bytes": size,
                "leaves": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                           for a in leaves]}
        manifest = {"version": _MANIFEST_VERSION, "step": step,
                    "meta": meta, "trees": tree_entries}
        if mesh is not None:
            manifest["mesh"] = mesh
        faults.inject("ckpt.manifest")
        tmp = os.path.join(final, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        faults.inject("ckpt.rename")
        os.replace(tmp, os.path.join(final, MANIFEST))
        return total

    def _prune(self) -> None:
        steps = self._scan()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # ---- lookup -----------------------------------------------------------
    def _scan(self) -> List[int]:
        """Committed-looking steps: a manifest (new format) or a
        ``meta.json`` (legacy, pre-manifest) marks a committed snapshot.
        No checksum verification here — that is :meth:`verify` /
        :meth:`restore_latest`'s job."""
        out = []
        for name in os.listdir(self.directory):
            m = _CKPT_RE.match(name)
            if not m:
                continue
            d = os.path.join(self.directory, name)
            if (os.path.exists(os.path.join(d, MANIFEST))
                    or os.path.exists(os.path.join(d, "meta.json"))):
                out.append(int(m.group(1)))
        return sorted(out)

    def _scan_all(self) -> List[int]:
        """Every ``ckpt-<n>`` directory, committed or not — the restore
        fallback walk must SEE uncommitted snapshots to quarantine them."""
        out = []
        for name in os.listdir(self.directory):
            m = _CKPT_RE.match(name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def steps(self) -> list:
        """Committed snapshot steps, ascending (joins an in-flight save
        first so a just-requested snapshot is visible once committed)."""
        self.join()
        return self._scan()

    def latest(self) -> Optional[int]:
        """Newest COMMITTED step (commit-marker check only; full checksum
        verification happens in :meth:`restore_latest`/:meth:`verify`)."""
        steps = self.steps()
        return steps[-1] if steps else None

    # ---- verification -----------------------------------------------------
    def _commit_status(self, step: int) -> str:
        """Cheap commit-marker classification, no checksums:
        ``committed`` / ``legacy`` / ``uncommitted`` / ``missing``."""
        d = self._dir(step)
        if not os.path.isdir(d):
            return "missing"
        if os.path.exists(os.path.join(d, MANIFEST)):
            return "committed"
        if os.path.exists(os.path.join(d, "meta.json")):
            return "legacy"
        return "uncommitted"

    def _read_manifest(self, step: int) -> dict:
        """Parse AND schema-check the manifest; raises
        :class:`CheckpointCorruptError` on anything unreadable or
        malformed — a manifest that parses as JSON but lost its schema
        (version skew, hand edit, torn rewrite) is corruption, not a
        crash."""
        try:
            with open(os.path.join(self._dir(step), MANIFEST)) as f:
                manifest = json.load(f)
            for name, entry in manifest["trees"].items():
                if (not isinstance(entry.get("file"), str)
                        or not isinstance(entry.get("bytes"), int)
                        or not isinstance(entry.get("crc32"), int)
                        or not isinstance(entry.get("leaves"), list)):
                    raise CheckpointCorruptError(
                        step, f"manifest entry for tree {name!r} is "
                              f"malformed")
            mesh = manifest.get("mesh")
            if mesh is not None:
                # elastic restore decides placement from this — torn or
                # hand-edited mesh metadata is corruption like any other
                # (it must never silently mis-shard a restore)
                if (not isinstance(mesh, dict)
                        or not isinstance(mesh.get("axes"), dict)
                        or not all(isinstance(v, int)
                                   for v in mesh["axes"].values())):
                    raise CheckpointCorruptError(
                        step, "manifest mesh metadata is malformed")
            manifest["meta"]
            return manifest
        except CheckpointCorruptError:
            raise
        except (OSError, ValueError, KeyError, AttributeError,
                TypeError) as e:
            raise CheckpointCorruptError(step, f"unreadable manifest: {e}")

    @staticmethod
    def _check_entry(step: int, entry: dict, crc: int, size: int) -> None:
        if size != entry["bytes"]:
            raise CheckpointCorruptError(
                step, f"{entry['file']}: {size} bytes on disk, manifest "
                      f"says {entry['bytes']} (truncated?)")
        if crc != entry["crc32"]:
            raise CheckpointCorruptError(
                step, f"{entry['file']}: CRC32 {crc:#010x} != manifest "
                      f"{entry['crc32']:#010x}")

    def verify(self, step: int) -> Tuple[str, Optional[str]]:
        """Classify snapshot ``step`` without touching it:
        ``("ok", None)`` — manifest present, every tree file matches its
        CRC32 and byte count; ``("legacy", None)`` — pre-manifest layout,
        nothing to verify against; ``("uncommitted", reason)`` — no
        commit marker; ``("corrupt", reason)`` — failed verification."""
        status = self._commit_status(step)
        if status == "missing":
            return "corrupt", "snapshot directory missing"
        if status == "legacy":
            return "legacy", None
        if status == "uncommitted":
            return "uncommitted", _UNCOMMITTED
        try:
            manifest = self._read_manifest(step)
            for entry in manifest["trees"].values():
                path = os.path.join(self._dir(step), entry["file"])
                if not os.path.exists(path):
                    raise CheckpointCorruptError(
                        step, f"tree file {entry['file']} missing")
                crc, size = _file_crc(path)
                self._check_entry(step, entry, crc, size)
        except CheckpointCorruptError as e:
            return "corrupt", e.reason
        return "ok", None

    def survey(self, verify: bool = False) -> List[dict]:
        """Operator inventory of the directory (``scripts/zoo-ckpt``):
        one dict per snapshot/quarantine directory with ``name``,
        ``step``, ``status`` (``committed``/``ok``/``corrupt``/
        ``legacy``/``uncommitted``/``quarantined``), ``reason``, and
        ``bytes``. ``verify=True`` upgrades the commit-marker check to a
        full checksum pass (``committed`` → ``ok``/``corrupt``)."""
        out = []
        for name in sorted(os.listdir(self.directory)):
            full = os.path.join(self.directory, name)
            if not os.path.isdir(full):
                continue
            m = _CKPT_RE.match(name)
            quarantined = re.match(r"^ckpt-(\d+)\.corrupt", name)
            if m:
                step: Optional[int] = int(m.group(1))
                if verify:
                    status, reason = self.verify(step)
                else:
                    # cheap pass: commit markers only, no checksums
                    status = self._commit_status(step)
                    reason = _UNCOMMITTED if status == "uncommitted" \
                        else None
            elif quarantined:
                step = int(quarantined.group(1))
                status, reason = "quarantined", None
            else:
                continue
            size = 0
            for f in os.listdir(full):
                try:
                    size += os.path.getsize(os.path.join(full, f))
                except OSError:
                    pass
            out.append({"name": name, "step": step, "status": status,
                        "reason": reason, "bytes": size})
        return out

    # ---- quarantine -------------------------------------------------------
    def _quarantine(self, step: int, reason: str) -> str:
        """Move a bad snapshot aside as ``ckpt-<n>.corrupt`` — out of the
        resume path but NEVER silently deleted (an operator may want the
        evidence; ``zoo-ckpt list`` shows it)."""
        src = self._dir(step)
        dst = src + ".corrupt"
        k = 1
        while os.path.exists(dst):
            dst = f"{src}.corrupt.{k}"
            k += 1
        os.rename(src, dst)
        self._m_corrupt.inc()
        self._registry.emit("ckpt.corrupt", step=step, reason=reason,
                            quarantined_to=os.path.basename(dst))
        log.error("checkpoint ckpt-%d failed verification (%s); "
                  "quarantined to %s", step, reason, os.path.basename(dst))
        return dst

    # ---- restore ----------------------------------------------------------
    def _load_verified(self, step: int, templates: Dict[str, Any],
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Verify-and-load in ONE read per file: requested trees are read
        into memory, CRC32-checked against the manifest, then parsed from
        the same buffer; non-requested trees are stream-checked — restore
        never pays the read-twice cost a separate verify pass would."""
        import io

        d = self._dir(step)
        manifest = self._read_manifest(step)
        for name in templates:
            if name not in manifest["trees"]:
                raise CheckpointArchitectureError(
                    f"{d}: manifest has no tree {name!r} — "
                    f"architecture mismatch")
        trees = {}
        for name, entry in manifest["trees"].items():
            path = os.path.join(d, entry["file"])
            try:
                if name in templates:
                    with open(path, "rb") as f:
                        data = f.read()
                    crc, size = zlib.crc32(data) & 0xFFFFFFFF, len(data)
                else:
                    data = None
                    crc, size = _file_crc(path)
            except OSError as e:
                raise CheckpointCorruptError(step, f"{entry['file']}: {e}")
            self._check_entry(step, entry, crc, size)
            if data is None:
                continue
            with np.load(io.BytesIO(data)) as z:
                loaded = [z[f"leaf_{i}"] for i in range(len(z.files))]
            if len(loaded) != len(entry["leaves"]):
                raise CheckpointCorruptError(
                    step, f"{entry['file']}: {len(loaded)} leaves on disk, "
                          f"manifest says {len(entry['leaves'])}")
            trees[name] = _rebuild_tree(templates[name], loaded, path)
        meta = dict(manifest["meta"])
        if "mesh" in manifest:
            # surfaced through restore meta so callers (the training
            # loop's elastic _try_resume) can compare against the live
            # mesh and report a topology change
            meta["mesh"] = manifest["mesh"]
        return trees, meta

    def _load_legacy(self, step: int, templates: Dict[str, Any],
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        d = self._dir(step)
        log.warning("snapshot ckpt-%d predates manifests; restoring "
                    "WITHOUT checksum verification", step)
        trees = {}
        for name, tmpl in templates.items():
            path = os.path.join(d, name + ".npz")
            trees[name] = _rebuild_tree(tmpl, _load_leaves(path), path)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return trees, meta

    def restore(self, step: int, templates: Dict[str, Any],
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Load snapshot ``step`` after verification; each named tree is
        rebuilt against the same-structure template (fresh
        ``optimizer.init`` output, fresh ``build`` params).

        A snapshot that fails verification is quarantined and raises
        :class:`CheckpointCorruptError`; a template that does not match
        raises :class:`CheckpointArchitectureError` (a ``ValueError`` —
        config bug, nothing is quarantined). Use :meth:`restore_latest`
        for the newest-valid-with-fallback semantics."""
        self.join()
        status = self._commit_status(step)
        if status == "missing":
            raise FileNotFoundError(f"no snapshot ckpt-{step} in "
                                    f"{self.directory}")
        if status == "legacy":
            return self._load_legacy(step, templates)
        if status == "uncommitted":
            self._quarantine(step, _UNCOMMITTED)
            raise CheckpointCorruptError(step, _UNCOMMITTED)
        try:
            return self._load_verified(step, templates)
        except CheckpointCorruptError as e:
            self._quarantine(step, e.reason)
            raise

    def _discard(self, step: int, reason: str, quarantine: bool) -> None:
        """A bad snapshot encountered during a fallback walk: the OWNING
        process quarantines it; a read-only observer (another process's
        directory — e.g. serving loading a live training dir) must only
        SKIP it, because what looks uncommitted from outside may be a
        concurrent writer's save in flight."""
        if quarantine:
            self._quarantine(step, reason)
        else:
            log.warning("skipping snapshot ckpt-%d (%s) — read-only "
                        "restore, not quarantining", step, reason)

    def restore_latest(self, templates: Dict[str, Any],
                       min_step: Optional[int] = None,
                       quarantine: bool = True,
                       ) -> Optional[Tuple[int, Dict[str, Any],
                                           Dict[str, Any]]]:
        """Restore the newest snapshot that VERIFIES, walking newest →
        oldest: a corrupt or uncommitted snapshot is quarantined (counted
        in ``zoo_ckpt_corrupt_total``) and the walk falls back to the
        next one (``zoo_ckpt_restore_fallback_total`` counts restores
        that could not use the newest snapshot). Returns ``(step, trees,
        meta)``, or ``None`` when no snapshot at or past ``min_step``
        verifies.

        ``quarantine=False`` makes the walk READ-ONLY (skip instead of
        rename): required for any process that does not own the
        directory — against a live training run, an "uncommitted"
        snapshot may simply be the writer's save in flight, and renaming
        it from outside would destroy a healthy save mid-commit."""
        self.join()
        skipped = 0
        result = None
        for step in reversed(self._scan_all()):
            status = self._commit_status(step)
            if status == "uncommitted":
                self._discard(step, _UNCOMMITTED, quarantine)
                skipped += 1
                continue
            if min_step is not None and step < min_step:
                break   # older than the caller's in-memory progress
            try:
                if status == "legacy":
                    trees, meta = self._load_legacy(step, templates)
                else:
                    trees, meta = self._load_verified(step, templates)
            except CheckpointArchitectureError:
                raise   # wrong template, not corruption — fail loudly
            except CheckpointCorruptError as e:
                self._discard(step, e.reason, quarantine)
                skipped += 1
                continue
            except (OSError, KeyError, ValueError, EOFError) as e:
                # a legacy (unverifiable) snapshot torn on disk, or an
                # unreadable file: discard and keep walking
                self._discard(step, f"{type(e).__name__}: {e}", quarantine)
                skipped += 1
                continue
            result = (step, trees, meta)
            break
        if skipped:
            self._m_fallback.inc()
            self._registry.emit(
                "ckpt.fallback", skipped=skipped,
                restored_step=result[0] if result else None)
        return result
