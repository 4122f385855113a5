"""In-memory spans of the program's stages, with each thread's CPU time.

One recorder per process, off by default; the tracker, the fused step and
the mapping worker write to it.  A span records its name, the name of the
thread it ran on, its start and end in Unix nanoseconds (`time.time_ns()`,
the clock of `torch.profiler`'s device events, so spans and kernels line
up), the CPU nanoseconds the thread spent in it (`time.thread_time_ns()`)
and its place in the tree: its own id and the id of the enclosing span of
the same thread (-1 at the top).  A span's wall time less its CPU time is
the time its thread was ready but not running: waiting for the GIL or a
lock, blocked on the device, or descheduled.  The thread CPU clock's
resolution is the platform's (some virtual machines count it in 10 ms
ticks), so CPU times are compared as sums over many spans.

    from spslam_tpu_torch import tracing
    tracing.enable()
    with tracing.span("mapper.keyframe"):
        ...
    spans = tracing.records()

Spans go at stage boundaries only, never inside a loop over points,
planes or iterations.  Off, `span` costs one flag test and returns a
shared no-op context manager: no clock is read, nothing is allocated.
Records are kept in a bounded deque (the oldest fall out) and nothing is
exported while the program runs.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

MAX_RECORDS = 400_000

ENABLED = False

_records: deque = deque(maxlen=MAX_RECORDS)
_ids = itertools.count()
_local = threading.local()
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    thread: str
    start_ns: int
    end_ns: int
    cpu_ns: Optional[int]    # None for a span that `mark` closed on another thread
    id: int
    parent: int              # the enclosing span of the same thread, -1 at the top


def enable():
    global ENABLED
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


def reset():
    """Drop every record."""
    _records.clear()


def records() -> List[Span]:
    """The spans recorded so far, in the order they ended."""
    return list(_records)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _parent() -> int:
    stack = _stack()
    return stack[-1] if stack else -1


class _Open:
    __slots__ = ("name", "id", "parent", "t0", "c0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else -1
        self.id = next(_ids)
        stack.append(self.id)
        self.t0 = time.time_ns()
        self.c0 = time.thread_time_ns()    # read inside the wall interval
        return self

    def __exit__(self, *exc):
        c1 = time.thread_time_ns()
        t1 = time.time_ns()
        _stack().pop()
        _records.append(Span(self.name, threading.current_thread().name, self.t0, t1,
                             c1 - self.c0, self.id, self.parent))
        return False


def span(name: str):
    """A context manager that records `name` around its block while the
    recorder is on."""
    if not ENABLED:
        return _OFF
    return _Open(name)


def stamp() -> tuple:
    """(Unix ns, this thread's CPU ns) now: the two ends of a `section`."""
    return time.time_ns(), time.thread_time_ns()


def section(name: str, t0: tuple, t1: tuple):
    """Record a finished span of this thread between two `stamp`s, as a
    child of the span open around it (callers that time sections with
    their own clock readings)."""
    if ENABLED:
        _records.append(Span(name, threading.current_thread().name, t0[0], t1[0],
                             t1[1] - t0[1], next(_ids), _parent()))


def mark(name: str, t0_ns: int):
    """Record a span that started at `t0_ns` (a `time.time_ns()` taken on
    any thread) and ends now on this one; it has no CPU time."""
    if ENABLED:
        _records.append(Span(name, threading.current_thread().name, t0_ns, time.time_ns(),
                             None, next(_ids), _parent()))
