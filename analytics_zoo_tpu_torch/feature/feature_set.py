"""FeatureSet — port of ``analytics_zoo_tpu/feature/feature_set.py``: the
host-RAM (numpy) cached dataset, its disk tier and its bucketed form, and
the pipeline that feeds the device.

* :class:`FeatureSet`: ``x`` (an array or a list of arrays) and optional
  ``y``, with a per-epoch reshuffled order. The permutation is the JAX
  package's bit for bit: ``np.random.default_rng(seed +
  epoch).permutation(n)``, and the training loop passes ``epoch =
  zoo.seed + epoch`` as the JAX loop does, so both packages see the same
  batches in the same order. A ``torch.Tensor`` (on any device) stays as
  it is, as the JAX set keeps a ``jax.Array``; host slicing reads it back
  once (``_host_view``). ``transform`` applies a vectorized
  preprocessing to the cached arrays; ``infinite_batches`` loops passes.
* :func:`chunked` stacks K batches into one ``(K, batch, ...)`` chunk for
  the multi-step dispatch (``zoo.train.scan_steps``), the last chunk of an
  epoch shorter; a set whose batches can be gathered from a copy on the
  device says so with ``device_cacheable`` (``zoo.train.device_cache``).
* :func:`prefetch_to_device`: batches assembled (and pinned) on a
  background thread (:class:`_ThreadedIterator`), their host-to-device
  copies issued ``buffer_size`` batches ahead on a copy stream of their
  own, each yielded batch guarded by an event the compute stream waits on
  and ``record_stream`` on its tensors. The batches and their order are
  the source's; the goodput ledger gets the JAX pipeline's ``idle`` /
  ``data_wait`` / ``device_step`` notes.
* :class:`DiskFeatureSet` (``DISK_AND_DRAM(numSlice)``): ``.npy`` files
  read through the port's native IO (``native/io.py``), one random
  ``1/num_slices`` slice materialized a pass; :class:`BucketedFeatureSet`:
  ragged buckets interleaved per epoch.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import (Any, Callable, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from .common import Preprocessing


def _as_list(x) -> List[Any]:
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _keep(a):
    """A ``torch.Tensor`` stays where it lies (the JAX set keeps a
    ``jax.Array`` on its device); anything else becomes a numpy array.
    Host slicing converts once, in ``_host_view``, never per batch."""
    if isinstance(a, torch.Tensor):
        return a
    return np.asarray(a)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def stack_batches(items: List[Tuple[Any, Any]]) -> Tuple[Any, Any]:
    """K ``(x, y)`` batches stacked into one ``(K, batch, ...)`` chunk (an
    ``x`` list stacks feature by feature; None labels stay None)."""
    def stack(parts):
        if parts[0] is None:
            return None
        if isinstance(parts[0], (list, tuple)):
            return [np.stack(group) for group in zip(*parts)]
        return np.stack(parts)
    xs, ys = zip(*items)
    return stack(list(xs)), stack(list(ys))


def chunked(batches: Iterable[Tuple[Any, Any]], k: int
            ) -> Iterator[Tuple[Any, Any]]:
    """The batches in order, ``k`` to a chunk; the last chunk holds what
    is left (JAX ``training.py`` ``_chunked``)."""
    buf = []
    for item in batches:
        buf.append(item)
        if len(buf) == k:
            yield stack_batches(buf)
            buf = []
    if buf:
        yield stack_batches(buf)


class FeatureSet:
    """In-memory cached dataset (``CachedDistributedFeatureSet``'s role)."""

    #: its arrays can be copied to the device once and each epoch's
    #: batches gathered there (a bucketed set of ragged batches cannot)
    device_cacheable = True

    def __init__(self, x, y=None, shuffle: bool = True, seed: int = 0):
        self.xs = [_keep(a) for a in _as_list(x)]
        if not self.xs:
            raise ValueError("FeatureSet needs at least one feature array")
        n = self.xs[0].shape[0]
        for a in self.xs:
            if a.shape[0] != n:
                raise ValueError("feature arrays disagree on leading dim")
        self.y = None if y is None else _keep(y)
        if self.y is not None and self.y.shape[0] != n:
            raise ValueError("labels disagree with features on leading dim")
        self.shuffle = shuffle
        self.seed = seed

    @staticmethod
    def array(x, y=None, *, shuffle: bool = True,
              seed: int = 0) -> "FeatureSet":
        return FeatureSet(x, y, shuffle=shuffle, seed=seed)

    @staticmethod
    def from_iterable(records: Sequence[Tuple[Any, Any]], *,
                      shuffle: bool = True, seed: int = 0) -> "FeatureSet":
        """From ``(x, y)`` records (or bare ``x`` records), stacked into
        contiguous arrays once."""
        xs, ys = [], []
        for rec in records:
            if isinstance(rec, tuple) and len(rec) == 2:
                xs.append(rec[0])
                ys.append(rec[1])
            else:
                xs.append(rec)
        x = np.stack([np.asarray(a) for a in xs])
        y = np.stack([np.asarray(a) for a in ys]) if ys else None
        return FeatureSet(x, y, shuffle=shuffle, seed=seed)

    def __len__(self) -> int:
        return self.xs[0].shape[0]

    @property
    def x(self):
        return self.xs if len(self.xs) > 1 else self.xs[0]

    def transform(self, fn: Union[Preprocessing, Callable]) -> "FeatureSet":
        """A new set of ``fn((x, y))``'s arrays: a vectorized preprocessing
        over the cached arrays (cache after transform)."""
        xs, y = self._host_view()
        x2, y2 = fn((xs if len(xs) > 1 else xs[0], y))
        return FeatureSet(x2, y2, shuffle=self.shuffle, seed=self.seed)

    def _host_view(self):
        """The arrays as numpy: tensors read back once and kept, so that
        host slicing never reads the device per batch. ``xs`` and ``y``
        are read once (the disk tier makes them whole-file gathers)."""
        xs, y = self.xs, self.y
        if not any(isinstance(a, torch.Tensor)
                   for a in xs + ([y] if y is not None else [])):
            return xs, y
        if getattr(self, "_host_xs", None) is None:
            self._host_xs = [_host(a) for a in xs]
            self._host_y = None if y is None else _host(y)
        return self._host_xs, self._host_y

    def _order(self, epoch: int) -> np.ndarray:
        n = len(self)
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng(self.seed + epoch).permutation(n)

    def _slice(self, idx) -> Tuple[Any, Any]:
        xs, y = self._host_view()
        bx = [a[idx] for a in xs]
        bx = bx if len(bx) > 1 else bx[0]
        return bx, None if y is None else y[idx]

    def iter_batches(self, batch_size: int, *, epoch: int = 0,
                     drop_last: bool = True) -> Iterator[Tuple[Any, Any]]:
        """One pass (one epoch), reshuffled by ``epoch`` number."""
        order = self._order(epoch)
        n = len(self)
        end = n - (n % batch_size) if drop_last else n
        for i in range(0, end, batch_size):
            yield self._slice(order[i:i + batch_size])

    def infinite_batches(self, batch_size: int, *, start_epoch: int = 0
                         ) -> Iterator[Tuple[Any, Any]]:
        """Passes forever, reshuffled every pass (the infinite looped
        iterator of ``CachedDistributedFeatureSet``)."""
        epoch = start_epoch
        while True:
            yield from self.iter_batches(batch_size, epoch=epoch,
                                         drop_last=True)
            epoch += 1

    def steps_per_epoch(self, batch_size: int,
                        drop_last: bool = True) -> int:
        n = len(self)
        return (n // batch_size if drop_last
                else (n + batch_size - 1) // batch_size)

    def sample(self, n: int):
        """The first ``n`` records, without reading more than them."""
        bx = [_host(a[:n]) for a in self.xs]
        return bx if len(bx) > 1 else bx[0]


# ---------------------------------------------------------------------------
# host prefetch on a thread, device copies ahead on a stream of their own
# ---------------------------------------------------------------------------

class _ThreadedIterator:
    """A host iterator run on a background thread into a bounded queue, so
    batch assembly overlaps the device's work."""

    _END = object()

    def __init__(self, it: Iterator, buffer_size: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def run():
            try:
                for item in it:
                    if not self._put(item):
                        return
            except BaseException as e:  # handed to the consumer
                self._err = e
            finally:
                # the end sentinel always lands: a consumer blocked in
                # __next__ must see it (StopIteration or the error). While
                # live it waits for room like any item; after close() the
                # stream is abandoned, so an unread item is dropped to make
                # room, which guarantees the thread ends
                while True:
                    try:
                        self._q.put(self._END, timeout=0.1)
                        return
                    except queue.Full:
                        if self._stop.is_set():
                            try:
                                self._q.get_nowait()
                            except queue.Empty:
                                pass

        self._t = threading.Thread(target=run, daemon=True,
                                   name="zoo-prefetch")
        self._t.start()

    def _put(self, item) -> bool:
        """A bounded put that looks at the stop flag between timed
        attempts, so a producer blocked on a full queue is released by
        close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        # drain, so that the producer sees the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def _tree_map(fn: Callable, item):
    """``fn`` on every array or tensor leaf of ``item`` (tuples, lists and
    dicts kept; None and other values, such as a row count, as they are)."""
    if isinstance(item, (np.ndarray, np.generic, torch.Tensor)):
        return fn(item)
    if isinstance(item, tuple):
        return tuple(_tree_map(fn, a) for a in item)
    if isinstance(item, list):
        return [_tree_map(fn, a) for a in item]
    if isinstance(item, dict):
        return {k: _tree_map(fn, v) for k, v in item.items()}
    return item


def _leaves(item) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _tree_map(out.append, item)
    return out


def prefetch_to_device(it: Iterator, device, *, buffer_size: int = 2,
                       threaded: bool = True, ledger=None) -> Iterator:
    """The batches of ``it`` on ``device``, in order, with ``buffer_size``
    of them already copied (or in flight) while the consumer works on the
    current one.

    Each item is a batch or a tuple/list/dict of them (numpy arrays or
    tensors; None and scalars pass through). On the background thread
    (``threaded``) the source assembles each batch and stages it in pinned
    host memory; on the consumer's thread its host-to-device copies are
    issued on a copy stream of this pipeline's own and an event recorded
    after them. A batch is handed out only after the consumer's current
    stream waits on that event, and each of its tensors is marked used by
    that stream (``record_stream``), so the allocator never reuses its
    memory under a running kernel. On the CPU the batches are tensors
    sharing the host arrays' memory.

    ``ledger`` (a :class:`~..observability.goodput.GoodputLedger`): time in
    here, the blocking pull and the copies' issue, is ``data_wait``; the
    consumer's time between a yielded batch and its next ``next()`` is
    ``device_step``; spin-up before the first yield is ``idle``. The notes
    run on the consumer's thread, the thread the ledger accounts."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None

    def stage(item):
        """Host side: tensors over the batch's arrays, pinned for a copy
        to the card."""
        def one(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))
            return t.pin_memory() if cuda and t.device.type == "cpu" else t
        return _tree_map(one, item)

    def put(item):
        if not cuda:
            return _tree_map(lambda t: t.to(device), item), None
        with torch.cuda.stream(copy_stream):
            out = _tree_map(lambda t: t.to(device, non_blocking=True), item)
        done = torch.cuda.Event()
        done.record(copy_stream)
        return out, done

    def hand_out(entry):
        out, done = entry
        if done is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(done)
            for t in _leaves(out):
                t.record_stream(current)
        return out

    def note(category):
        if ledger is not None:
            ledger.note(category)

    staged = (stage(item) for item in it)
    src = _ThreadedIterator(staged, buffer_size=buffer_size + 2) \
        if threaded else staged
    buf: collections.deque = collections.deque()
    note("idle")                    # the body first runs at the first next()
    try:
        for item in src:
            buf.append(put(item))
            if len(buf) > buffer_size:
                note("data_wait")
                yield hand_out(buf.popleft())
                note("device_step")
        while buf:
            note("data_wait")
            yield hand_out(buf.popleft())
            note("device_step")
    finally:
        note("data_wait")           # the pipeline's own tail
        if threaded:
            src.close()


# ---------------------------------------------------------------------------
# the disk tier (DiskFeatureSet, FeatureSet.scala:332-409)
# ---------------------------------------------------------------------------

class DiskFeatureSet(FeatureSet):
    """``DISK_AND_DRAM(numSlice)``: the dataset lives on disk (``.npy``
    files, read through :class:`~..native.io.NativeArrayFile`); each
    training pass materializes a random ``1/num_slices`` slice in host RAM,
    and in rotation mode (``shuffle=False``) the next pass's pages stream
    in on the native library's thread while the current slice trains. The
    training loop counts ``nb_epoch`` and ``EveryEpoch``/``MaxEpoch`` in
    full passes (``num_slices`` slice passes). ``num_slices == 0`` is an
    evaluation-only set (readable whole, no training slices)."""

    def __init__(self, x_paths, y_path: Optional[str] = None,
                 num_slices: int = 2, shuffle: bool = True, seed: int = 0):
        from ..native import NativeArrayFile
        if num_slices == 1 or num_slices < 0:
            raise ValueError(
                "num_slices must be 0 (eval-only) or >= 2; for everything "
                "in DRAM use FeatureSet.array (the reference's DRAM type)")
        paths = ([x_paths] if isinstance(x_paths, (str, bytes))
                 else list(x_paths))
        self.files_x = [NativeArrayFile(p) for p in paths]
        self.file_y = NativeArrayFile(y_path) if y_path is not None else None
        self.total = self.files_x[0].n
        for f in self.files_x:
            if f.n != self.total:
                raise ValueError("feature files disagree on record count")
        if self.file_y is not None and self.file_y.n != self.total:
            raise ValueError("label file disagrees with features on count")
        self.num_slices = int(num_slices)
        self.shuffle = shuffle
        self.seed = seed
        self.slice_size = (self.total // self.num_slices
                           if self.num_slices else self.total)
        self._cur: Optional[Tuple[int, List[np.ndarray], Any]] = None

    @staticmethod
    def disk(x_paths, y_path=None, *, num_slices: int = 2,
             shuffle: bool = True, seed: int = 0) -> "DiskFeatureSet":
        return DiskFeatureSet(x_paths, y_path, num_slices, shuffle, seed)

    @property
    def num_of_slice(self) -> int:
        return self.num_slices

    @property
    def io_path(self) -> str:
        """Which reader serves the files: ``"native"`` (the port's
        ``libzoo_io``) or ``"memmap"`` (numpy, where it is unavailable)."""
        return self.files_x[0].io_path

    def __len__(self) -> int:
        return self.slice_size

    def _slice_indices(self, pass_idx: int) -> np.ndarray:
        """Record indices of slice ``pass_idx``, sorted for sequential
        reads (``_order`` reshuffles within the slice)."""
        if self.shuffle:
            rng = np.random.default_rng(self.seed + 7919 * pass_idx)
            idx = rng.choice(self.total, size=self.slice_size, replace=False)
            idx.sort()
            return idx
        # rotation modulo the total, so that a total num_slices does not
        # divide still reaches every record over the passes
        lo = (pass_idx * self.slice_size) % self.total
        return np.arange(lo, lo + self.slice_size) % self.total

    def _materialize(self, pass_idx: int) -> None:
        if self._cur is not None and self._cur[0] == pass_idx:
            return
        idx = self._slice_indices(pass_idx)
        xs = [f.gather(idx) for f in self.files_x]
        y = self.file_y.gather(idx) if self.file_y is not None else None
        self._cur = (pass_idx, xs, y)
        # the next slice's pages stream in while this one trains, in
        # rotation mode only: there it is a dense range, where a shuffled
        # slice's sorted sample spans about the whole file
        if not self.shuffle:
            nxt = self._slice_indices(pass_idx + 1)
            lo, hi = int(nxt.min()), int(nxt.max()) + 1
            for f in self.files_x + ([self.file_y] if self.file_y else []):
                f.prefetch(lo, hi)

    def iter_batches(self, batch_size: int, *, epoch: int = 0,
                     drop_last: bool = True):
        if self.num_slices == 0:
            raise ValueError("num_slices=0 is an evaluation-only "
                             "DiskFeatureSet — it cannot train "
                             "(FeatureSet.scala:369-375)")
        self._materialize(epoch)
        _, xs, y = self._cur
        order = self._order(epoch)
        n = self.slice_size
        end = n - (n % batch_size) if drop_last else n
        for i in range(0, end, batch_size):
            sel = order[i:i + batch_size]
            bx = [a[sel] for a in xs]
            yield (bx if len(bx) > 1 else bx[0],
                   None if y is None else y[sel])

    def sample(self, n: int):
        """The first ``n`` records straight from disk."""
        idx = np.arange(min(n, self.total))
        bx = [f.gather(idx) for f in self.files_x]
        return bx if len(bx) > 1 else bx[0]

    # whole-set views (the reference's data(train=false) path)
    @property
    def xs(self):  # type: ignore[override]
        all_idx = np.arange(self.total)
        return [f.gather(all_idx) for f in self.files_x]

    @property
    def x(self):
        xs = self.xs
        return xs if len(xs) > 1 else xs[0]

    @property
    def y(self):
        if self.file_y is None:
            return None
        return self.file_y.gather(np.arange(self.total))

    def close(self):
        for f in self.files_x + ([self.file_y] if self.file_y else []):
            f.close()


class BucketedFeatureSet(FeatureSet):
    """Length-bucketed dataset of ragged sequences: batches never mix
    buckets, and the batch order interleaves the buckets, reshuffled each
    epoch (``seed + 31 * epoch``). Its batches stack into no one array, so
    it is not device-cacheable and a multi-step dispatch cannot chunk it;
    ``evaluate``/``predict`` need a dense set (``ragged``)."""

    device_cacheable = False
    ragged = True

    def __init__(self, buckets: Sequence[FeatureSet], shuffle: bool = True,
                 seed: int = 0):
        buckets = [b for b in buckets if len(b) > 0]
        if not buckets:
            raise ValueError("BucketedFeatureSet needs non-empty buckets")
        self.buckets = list(buckets)
        self.shuffle = shuffle
        self.seed = seed

    def __len__(self) -> int:
        return sum(len(b) for b in self.buckets)

    def steps_per_epoch(self, batch_size: int,
                        drop_last: bool = True) -> int:
        return sum(b.steps_per_epoch(batch_size, drop_last)
                   for b in self.buckets)

    def iter_batches(self, batch_size: int, *, epoch: int = 0,
                     drop_last: bool = True):
        iters = [b.iter_batches(batch_size, epoch=epoch, drop_last=drop_last)
                 for b in self.buckets]
        order = [bi for bi, b in enumerate(self.buckets)
                 for _ in range(b.steps_per_epoch(batch_size, drop_last))]
        if self.shuffle:
            np.random.default_rng(self.seed + 31 * epoch).shuffle(order)
        for bi in order:
            yield next(iters[bi])

    def sample(self, n: int):
        return self.buckets[0].sample(n)

    @property
    def xs(self):  # type: ignore[override]
        raise ValueError("bucketed data is ragged across buckets; iterate "
                         "with iter_batches or use the per-bucket sets")

    @property
    def x(self):
        return self.xs

    @property
    def y(self):
        ys = [b.y for b in self.buckets]
        if any(v is None for v in ys):
            return None
        return np.concatenate([_host(v) for v in ys])
