"""Spans and counts: the port's one way to time a phase.

    with spans.span("grid_build") as s:
        grid = build_grid_host(...)
    s.seconds                      # its wall seconds, once closed

A span records its name; its parent, the span open around it on the same
thread; its pair (given on a root span, inherited by its children); its
thread; its start and end on ``time.perf_counter_ns``, the host's
monotonic clock; and the thread's CPU nanoseconds between
them (``time.thread_time_ns``), so that wall time less CPU time is the
time the thread was off the CPU (blocked on the device, on a lock or on
the interpreter lock). :func:`count` records a timestamped count.

Records go into one ring of :data:`RING` records in memory, the oldest
dropped first; :func:`records` reads it. Nothing is written out. A record
is packed into 68 bytes; with its ``bytes`` object and its slot in the
ring it takes :data:`RECORD_BYTES` = 109 bytes, so a full ring holds 7.1 MB.

While ``torch.profiler`` records, a span on the recording thread is also a
profiler range named ``pcr/<name>`` (a FUNCTION-scope range: a user-scope
``record_function`` would add a device-side annotation that a trace reader
takes for device work). The range lies in the trace on the timeline of
the device's activity, whose clock is the Unix epoch:
:func:`trace_offset_ns` maps a record's stamps onto it, so that the spans
of a thread the profiler does not see (a sequence's prep thread) go on
the same timeline.
"""
from __future__ import annotations

import itertools
import struct
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

RING = 65_536
PREFIX = "pcr/"
# name index, id, parent, pair, thread, start, end, CPU ns, count (-1: a span)
_RECORD = struct.Struct("<i8q")
RECORD_BYTES = _RECORD.size + 33 + 8  # payload, the bytes object, its ring slot

_ring: deque = deque(maxlen=RING)
_written = itertools.count()  # records ever written; next() is atomic
_dropped = False  # whether the ring has dropped a record
_ids = itertools.count(1)
_pairs = itertools.count(1)
_names: List[str] = []
_name_index: dict = {}
_names_lock = threading.Lock()
_local = threading.local()


class Record(NamedTuple):
    name: str
    id: int
    parent: Optional[int]  # the enclosing span's id on the same thread
    pair: Optional[int]
    thread: int  # threading.get_ident()
    start_ns: int  # time.perf_counter_ns()
    end_ns: int  # == start_ns for a count
    cpu_ns: int  # the thread's CPU time over the span; 0 for a count
    count: Optional[int]  # None for a span


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _name_id(name: str) -> int:
    index = _name_index.get(name)
    if index is None:
        with _names_lock:
            index = _name_index.get(name)
            if index is None:
                _names.append(name)
                index = _name_index[name] = len(_names) - 1
    return index


def _write(name, id_, parent, pair, start, end, cpu, count) -> None:
    global _dropped
    if next(_written) >= RING:
        _dropped = True
    _ring.append(_RECORD.pack(
        _name_id(name), id_, -1 if parent is None else parent, -1 if pair is None else pair,
        threading.get_ident(), start, end, cpu, count))


class span:
    """A span of ``name``; ``pair`` on a root span names the pair it works
    for (children inherit their parent's). After the ``with`` block,
    ``seconds`` holds its wall seconds."""

    __slots__ = ("name", "pair", "id", "parent", "start_ns", "_cpu", "_range", "seconds")

    def __init__(self, name: str, pair: Optional[int] = None):
        self.name = name
        self.pair = pair
        self.seconds: Optional[float] = None

    def __enter__(self) -> "span":
        stack = _stack()
        outer = stack[-1] if stack else None
        if self.pair is None and outer is not None:
            self.pair = outer.pair
        self.parent = None if outer is None else outer.id
        self.id = next(_ids)
        stack.append(self)
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        self._cpu = time.thread_time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        cpu = time.thread_time_ns() - self._cpu
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _stack().pop()
        _write(self.name, self.id, self.parent, self.pair, self.start_ns, end, cpu, -1)
        self.seconds = (end - self.start_ns) * 1e-9
        return False

    def elapsed(self) -> float:
        """Wall seconds since the span opened."""
        return (time.perf_counter_ns() - self.start_ns) * 1e-9


def count(name: str, n: int = 1) -> None:
    """Record ``n`` (>= 0) events of ``name`` now, under the open span."""
    if n < 0:
        raise ValueError(f"count({name!r}, {n}): a count is not negative")
    stack = _stack()
    outer = stack[-1] if stack else None
    now = time.perf_counter_ns()
    _write(name, next(_ids), None if outer is None else outer.id,
           None if outer is None else outer.pair, now, now, 0, n)


def new_pair() -> int:
    """A new pair id, from a process-wide counter."""
    return next(_pairs)


def pair_or_new(pair: Optional[int] = None) -> int:
    """``pair``; else the pair of the innermost span open on this thread;
    else a new pair id."""
    if pair is None:
        stack = _stack()
        pair = stack[-1].pair if stack else None
    return new_pair() if pair is None else pair


def records() -> Tuple[List[Record], int]:
    """(every record the ring holds, oldest first; the ``perf_counter_ns``
    stamp it reaches back to). Once the ring has dropped a record, the
    stamp is the end of the oldest record it still holds: every span that
    started at or after it is there. While nothing was dropped it is 0."""
    held = list(_ring)  # one C-level copy: safe beside writing threads
    dropped = _dropped  # read after the copy: a drop during it counts
    out = []
    for packed in held:
        name, id_, parent, pair, thread, start, end, cpu, n = _RECORD.unpack(packed)
        out.append(Record(_names[name], id_, None if parent < 0 else parent,
                          None if pair < 0 else pair, thread, start, end, cpu,
                          None if n < 0 else n))
    return out, out[0].end_ns if dropped and out else 0


def trace_offset_ns() -> int:
    """Nanoseconds to add to a ``perf_counter_ns`` stamp to put it on the
    profiler's clock (the Unix epoch, ``time.time_ns``): the tightest of
    five bracketed reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]
