"""Spans, and the profiler's trace of a slice of the measured window.

The harness times each call it makes into a layer of the program with the
host clock (:class:`Spans`); while the profiler is on, the same span is
also a ``record_function`` range named ``portbench:<span>``, so that the
trace places it on the host's timeline beside the device's work. From the
trace :func:`summarize` takes the device's busy time over the traced
units, its idle gaps labelled by the span the host was in, the device time
by kind of operation, and the host's launch calls.

The kind table and the launch-call names are copied from the repository's
``tools/profile_port.py``.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import Counter
from dataclasses import dataclass, field

import torch

PREFIX = "portbench:"
UNIT = "unit"  # the span around one timed unit (a pair, or a pair of a call)
# Device-op kinds, by the first matching substring of the kernel's name.
KINDS = (
    ("select_windows", "B1"), ("select_bitonic", "B4"), ("row_topk", "B2"),
    ("brute_knn", "B3"), ("gemm", "gemm"),
    ("sort", "sort"), ("scan", "scan"), ("reduce", "reduce"),
    ("index", "gather/scatter"), ("gather", "gather/scatter"),
    ("scatter", "gather/scatter"), ("elementwise", "elementwise"),
    ("memcpy", "copy"), ("memset", "copy"),
)
# The host's launch calls, by the name of the CUDA API call.
HOST_LAUNCHES = {"cudaLaunchKernel": "kernel", "cudaLaunchKernelExC": "kernel",
                 "cuLaunchKernel": "kernel", "cuLaunchKernelEx": "kernel",
                 "cudaGraphLaunch": "graph", "cuGraphLaunch": "graph"}


def kind(name: str) -> str:
    low = name.lower()
    return next((k for key, k in KINDS if key in low), "other")


@dataclass
class TraceSummary:
    window_s: float  # from the first traced unit's start to the last one's end
    busy_s: float  # union of the device's operations inside the window
    by_kind: Counter  # device seconds by kind
    by_name: Counter  # device seconds by kernel name
    idle_by_span: Counter  # idle device seconds by the host span around them
    launches_in: Counter  # host launch calls inside each span name
    graph_launches_in: Counter = field(default_factory=Counter)


class Tracer:
    """Runs ``torch.profiler`` from :meth:`start` to :meth:`stop`, once;
    :meth:`finish` reads the trace once the window has closed."""

    def __init__(self, enabled: bool, cuda: bool = True):
        self.enabled = enabled
        self.cuda = cuda
        self.active = False
        self.summary: TraceSummary | None = None
        self._prof = None

    def start(self) -> None:
        if not self.enabled or self._prof is not None:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.active = False

    def finish(self) -> None:
        self.stop()
        if self._prof is not None and self.summary is None:
            self.summary = summarize(_events(self._prof))
            self._prof = None

    def range(self, name: str):
        if self.active:
            return torch.profiler.record_function(PREFIX + name)
        return contextlib.nullcontext()


class Spans:
    """Host-clock spans of the harness's calls into the program; each is
    also a profiler range while the tracer is on."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer

    @contextlib.contextmanager
    def __call__(self, name: str, into: dict):
        start = time.perf_counter()
        with self.tracer.range(name):
            yield
        into[name] = into.get(name, 0.0) + time.perf_counter() - start


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _label(inner, starts, t):
    """The name of the latest-starting span in ``inner`` (sorted by start)
    that covers time ``t``, looking back over at most 64 spans; None."""
    j = bisect.bisect_right(starts, t) - 1
    for s, e, name in reversed(inner[max(0, j - 63):j + 1]):
        if e >= t:
            return name
    return None


def _events(prof):
    """(name, on the device, start us, end us) of each event of a finished
    profile, from its raw results (building ``profile.events()`` takes
    seconds a pair)."""
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        yield e.name(), e.device_type() == cuda, start, start + e.duration_ns() / 1e3


def summarize(events) -> TraceSummary:
    """The window, busy time, idle gaps and launch counts of a trace: an
    iterable of (name, on the device, start us, end us)."""
    device, spans, launches = [], [], []
    for name, on_device, start, end in events:
        if on_device:
            if not name.startswith(PREFIX):  # the spans' device-side ranges
                device.append((start, end, name))
        elif name.startswith(PREFIX):
            spans.append((start, end, name[len(PREFIX):]))
        elif name in HOST_LAUNCHES:
            launches.append((start, HOST_LAUNCHES[name]))
    units = [(s, e) for s, e, n in spans if n == UNIT]
    if not units:
        raise RuntimeError(f"the trace holds no unit span; its spans: {Counter(n for *_, n in spans)}, "
                           f"{len(device)} device operations")
    lo, hi = min(s for s, _ in units), max(e for _, e in units)
    by_kind, by_name = Counter(), Counter()
    inside = []
    for s, e, n in device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            inside.append((s, e))
            by_kind[kind(n)] += (e - s) / 1e6
            by_name[n] += (e - s) / 1e6
    busy = _union(inside)
    # Idle gaps, each labelled by the innermost span the host was in at its
    # middle (the latest-starting span that covers it).
    inner = sorted((s, e, n) for s, e, n in spans if n != UNIT)
    starts = [s for s, _, _ in inner]
    idle = Counter()
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for gap_start, gap_end in zip(edges[0::2], edges[1::2]):
        if gap_end <= gap_start:
            continue
        mid = 0.5 * (gap_start + gap_end)
        label = _label(inner, starts, mid) or "harness"
        idle[label] += (gap_end - gap_start) / 1e6
    launches_in, graphs_in = Counter(), Counter()
    for t, what in launches:
        label = _label(inner, starts, t)
        if label is not None:
            (graphs_in if what == "graph" else launches_in)[label] += 1
    return TraceSummary(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6,
        by_kind=by_kind,
        by_name=by_name,
        idle_by_span=idle,
        launches_in=launches_in,
        graph_launches_in=graphs_in,
    )
