"""Host spans at the layer boundaries of the program, on the profiler's clock.

    with span("phase.step"):
        train_step(...)

records one interval of host time: the span's name, its start and end in ns
on ``time.time_ns()``'s clock (the wall clock that ``torch.profiler`` stamps
its host and device events with, so a span and the kernels it enqueued can
be laid on one timeline), the span it ran inside (one parent stack per
thread), the outermost span of that stack (``root``: the spans of one call
share it), whether a torch profiler was recording when it opened
(``under_profiler``: its host cost then includes the profiler's), and the
keyword attributes it was given. Only the start is read from the wall clock:
the length (``ns``) is measured on the monotonic ``time.perf_counter_ns()``
and ``end_ns`` is the start plus it, so a step or slew of the wall clock
during a span can shift the span but never stretch it or make it negative.

Recording is always on and costs one to two microseconds per span on the host.
A span never synchronises the device and never enters the profiler (no
``record_function``, no NVTX range): the profiler would count such a range
as device activity. Records go into one bounded queue per process, oldest
dropped first, so a run of any length holds at most ``CAPACITY`` of them.

Readers: ``spans(name)`` and ``children(span)``.
"""

from __future__ import annotations

import collections
import itertools
import threading
from time import perf_counter_ns, time_ns
from typing import Any, Deque, List, Optional

from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16

_records: Deque["Span"] = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()


class Span:
    """One recorded interval (see the module's docstring); ``end_ns`` is None
    while it is open. Used as a context manager, through ``span``."""

    __slots__ = ("id", "parent", "root", "name", "start_ns", "end_ns", "under_profiler", "attrs",
                 "_t0")

    def __init__(self, name: str, **attrs: Any):
        self.name = name
        self.attrs = attrs
        self.end_ns: Optional[int] = None

    def __enter__(self) -> "Span":
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.id = i = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.root = top.id, top.root
        else:
            self.parent, self.root = None, i
        # The flag that every torch.profiler sets while it records.
        self.under_profiler = _profiler._is_profiler_enabled
        stack.append(self)
        _records.append(self)
        self._t0 = perf_counter_ns()
        self.start_ns = time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = self.start_ns + perf_counter_ns() - self._t0
        _local.stack.pop()

    @property
    def ns(self) -> int:
        """The span's length in ns (closed spans only)."""
        return self.end_ns - self.start_ns


span = Span  # ``with span(name, **attrs):`` records from ``with`` to the block's end


def spans(name: Optional[str] = None) -> List[Span]:
    """The records still held, oldest first (in order of opening); only those
    named ``name`` when given."""
    return [s for s in list(_records) if name is None or s.name == name]


def children(parent: Span) -> List[Span]:
    """The spans opened directly inside ``parent``, in order of opening."""
    return [s for s in list(_records) if s.parent == parent.id]

