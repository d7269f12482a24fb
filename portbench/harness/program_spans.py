"""The program's own spans and counts over a run's units, for the
per-layer metrics that read them.

The port records spans and counts in memory (its ``utils/spans.py``:
name, parent, pair, thread, start and end on ``time.perf_counter_ns``, the
thread's CPU time). A metric here is a sum over the records whose start
falls inside the units it reads, over the number of those units: the
completed units timed with the profiler off (``Run.untraced``: every
completed unit where the profiler traced them all), so that the profiler's
cost stays out of the reading.

A reading is None, never a partial figure, where the program keeps no
such records (a tree without the recorder), where the run completed no
unit, or where the recorder's ring no longer reaches back to the first
unit read.
"""
from __future__ import annotations

import bisect
import importlib

RECORDER = "probabilistic_point_clouds_registration_tpu_torch.utils.spans"


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        return importlib.import_module(RECORDER)
    except ImportError:
        return None


def selected(run):
    """(the records that start inside the run's read units, the number of
    those units), or None (see the module's docstring)."""
    rec = recorder()
    if rec is None:
        return None
    units = sorted((round(u["start"] * 1e9), round(u["end"] * 1e9))
                   for u in run.untraced() if u["ok"])
    if not units:
        return None
    records, since_ns = rec.records()
    if since_ns > units[0][0]:
        return None
    starts = [s for s, _ in units]
    inside = []
    for r in records:
        j = bisect.bisect_right(starts, r.start_ns) - 1
        if j >= 0 and r.start_ns <= units[j][1]:
            inside.append(r)
    return inside, len(units)


def wall_ns(r) -> int:
    return r.end_ns - r.start_ns


def offcpu_ns(r) -> int:
    """Wall time less the thread's CPU time: the thread off the CPU."""
    return r.end_ns - r.start_ns - r.cpu_ns


def self_ns(r, children) -> int:
    """Wall time less the wall time of the span's direct children."""
    return wall_ns(r) - sum(wall_ns(c) for c in children.get(r.id, ()))


def mean_ms(run, names, part: str = "wall"):
    """Milliseconds a unit in the spans named ``names`` (``part``: their
    ``wall`` time, their ``self`` time, or their time ``offcpu``)."""
    picked = selected(run)
    if picked is None:
        return None
    records, n_units = picked
    spans = [r for r in records if r.count is None and r.name in names]
    if part == "self":
        children = {}
        for r in records:
            if r.count is None and r.parent is not None:
                children.setdefault(r.parent, []).append(r)
        total = sum(self_ns(r, children) for r in spans)
    else:
        total = sum((offcpu_ns if part == "offcpu" else wall_ns)(r) for r in spans)
    return 1e-6 * total / n_units


def per_unit(run, name):
    """The count ``name`` a unit."""
    picked = selected(run)
    if picked is None:
        return None
    records, n_units = picked
    return sum(r.count for r in records if r.count is not None and r.name == name) / n_units
