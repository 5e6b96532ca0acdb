"""Kernel launch counters, and how a CUDA graph keeps them true.

Every kernel wrapper adds 1 to its counter where it launches its kernel
(and the CE and int8 wrappers to the counter of the route they took). A
step captured in a CUDA graph runs the wrappers once, while it is
captured, and nothing launches then; each replay launches the captured
kernels and runs no wrapper. :func:`record_launches` takes what a capture
counted off the counters and keeps it in a :class:`Launches` record,
whose :meth:`Launches.replayed` adds it back at every replay.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Tuple


class LaunchCount:
    """One kernel's (or one route's) launches; every instance is listed in
    :attr:`ALL`."""

    ALL: List["LaunchCount"] = []

    def __init__(self):
        self.launches = 0
        LaunchCount.ALL.append(self)

    def reset(self) -> None:
        self.launches = 0


class Launches:
    """The launches one captured graph makes at each replay, by counter."""

    def __init__(self):
        self.counts: List[Tuple[LaunchCount, int]] = []

    def of(self, counter: LaunchCount) -> int:
        return sum(n for c, n in self.counts if c is counter)

    def replayed(self, times: int = 1) -> None:
        for counter, n in self.counts:
            counter.launches += n * times


@contextlib.contextmanager
def record_launches() -> Iterator[Launches]:
    """Around a capture: every counter's increase inside the block goes
    into the yielded record and off the counter."""
    counters = list(LaunchCount.ALL)
    before = [c.launches for c in counters]
    record = Launches()
    try:
        yield record
    finally:
        for counter, n in zip(counters, before):
            if counter.launches != n:
                record.counts.append((counter, counter.launches - n))
                counter.launches = n
