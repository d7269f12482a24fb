"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

A driver (``drivers/<name>.py``, named by the traffic mix) provides:

  setup(run) -> state        make the inputs from the seed, warm up
  window(run, state, end)    run timed units until ``end`` (host clock),
                             appending each to ``run.units``; the profiler,
                             when on, runs from the window's start until the
                             driver calls ``run.tracer.stop()``
  release(run, state)        drop the program's state
  check(run, state) -> list  the compared numbers of each checked answer
                             (``harness.check.compare``)

Metric readers (``metrics/<name>.py``) take the finished :class:`Run`.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from . import check as _check
from .manifest import Cell
from .trace import Spans, Tracer

FORBIDDEN = {"jax", "jaxlib", "flax", "probabilistic_point_clouds_registration_tpu"}


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float  # host clock at process start
    tracer: Tracer = None
    spans: Spans = None
    setup_s: float = None
    units: list = field(default_factory=list)  # one dict a timed unit
    extras: dict = field(default_factory=dict)  # what a driver hands its readers

    def __post_init__(self):
        self.tracer = Tracer(self.trace, cuda=self.device == "cuda")
        self.spans = Spans(self.tracer)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def untraced(self) -> list:
        """The units timed with the profiler off (all, if none was)."""
        plain = [u for u in self.units if not u.get("traced")]
        return plain or self.units


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def execute(cell: Cell, *, seed: int, seconds: float, trace: bool, device: str,
            started: float) -> tuple[Run, dict]:
    """Run one cell once; returns the run and its result object."""
    run = Run(cell, seed, seconds, trace, device, started)
    driver = cell.driver()
    if device == "cuda":
        print(f"card: {card()}", file=sys.stderr)
    state = driver.setup(run)
    _sync(device)
    run.setup_s = time.perf_counter() - started
    loop_before = host_loop_ms()
    run.tracer.start()  # starting the profiler takes seconds: not in the window
    host = _host_times()
    window_start = time.perf_counter()
    driver.window(run, state, window_start + seconds)
    _sync(device)
    window_s = time.perf_counter() - window_start
    host = [b - a if a is not None and b is not None else None
            for a, b in zip(host, _host_times())]
    print(f"host: window {window_s:.3f} s, this process's CPU {host[0]:.3f} s, the "
          f"machine's steal {host[1]} s (all cores); a fixed pure-Python loop "
          f"{loop_before:.2f} ms before the window, {host_loop_ms():.2f} ms after",
          file=sys.stderr)
    run.tracer.finish()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    driver.release(run, state)
    if device == "cuda":
        torch.cuda.empty_cache()
    failed = sum(1 for u in run.units if not u["ok"])
    times = sorted((u["end"] - u["start"], j) for j, u in enumerate(run.units))
    if times:
        print(f"units {len(times)}: fastest {times[0][0]:.4f} s, median "
              f"{times[len(times) // 2][0]:.4f} s, slowest (s, index) "
              f"{[(round(t, 4), j) for t, j in times[-5:][::-1]]}", file=sys.stderr)
    numbers = _check.worst(driver.check(run, state))
    correct, checks = _check.judge(numbers, cell.limits, failed)

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(run.units), "failed": failed,
              "metrics": metrics, "device": dev}
    summary = run.tracer.summary
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in summary.by_kind.most_common(10)],
            "idle_gaps": [[k, v] for k, v in summary.idle_by_span.most_common(10)],
        }
    result["checks"] = checks
    return run, result


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    _check.print_checks(result["checks"])
    sys.stdout.flush()
    print(json.dumps(result), flush=True)


def _host_times() -> tuple:
    """(this process's CPU seconds, the machine's steal seconds over all
    cores from /proc/stat, or None where it cannot be read)."""
    steal = None
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        if fields[0] == "cpu" and len(fields) > 8:
            steal = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError):
        pass
    return time.process_time(), steal


def host_loop_ms() -> float:
    """Milliseconds of a fixed pure-Python loop: the host's single-thread
    speed at that moment, printed beside the run's times (it moves by up to
    twice from second to second on a shared host)."""
    t = time.perf_counter()
    acc = 0
    for i in range(300_000):
        acc += i % 7
    return 1e3 * (time.perf_counter() - t)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()
