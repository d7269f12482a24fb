"""The reader of the batch's ``batch_targets`` count
(``metrics/batch_targets.batch.py``): its mean a call on planted records,
None without the batched path's spans, and the program's own count of a
batch on the CPU."""
import time

import numpy as np
import pytest

from portbench.harness import program_spans
from probabilistic_point_clouds_registration_tpu_torch.io.synthetic import (
    sequence_from_world,
    wave_grid,
)
from probabilistic_point_clouds_registration_tpu_torch.parallel import batch

from .test_portbench_program_spans import FakeRun, plant, reader, rec, unit

NAME = "batch_targets.batch"


def call(base_ms, targets, root=True):
    """One call's records at ``base_ms``: the root span ``batch`` (unless
    ``root`` is False) over a plan span and the count."""
    i = base_ms * 100
    out = [rec("batch_plan", base_ms + 1, 4, i + 2, i + 1),
           rec("batch_targets", base_ms + 1, 0, i + 3, i + 1, count=targets)]
    return out + [rec("batch", base_ms, 30, i + 1)] if root else out


def test_the_mean_count_a_call_over_the_untraced_calls(monkeypatch):
    # A traced call at 0 ms (40 targets) is left out; 10 and 12 are read.
    plant(monkeypatch, call(0, 40) + call(100, 10) + call(200, 12))
    run = FakeRun([unit(0, 40, traced=True), unit(100, 140), unit(200, 240)])
    assert reader(NAME).read(run) == pytest.approx(11.0)


def test_none_without_the_batched_paths_spans(monkeypatch):
    plant(monkeypatch, call(100, 10, root=False))
    assert reader(NAME).read(FakeRun([unit(100, 140)])) is None
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    assert reader(NAME).read(FakeRun([unit(100, 140)])) is None


def test_the_programs_count_of_a_batch():
    scans, _ = sequence_from_world(wave_grid(), 0.05, (0.15, -0.05, 0.02), 4)
    start = time.perf_counter()
    poses, _ = batch.run_odometry_batched(scans, k=10, radius=0.5, n_outer=2, pad_multiple=128,
                                          dtype="float64", search_impl="pool", device="cpu")
    run = FakeRun([{"start": start, "end": time.perf_counter(), "traced": False, "ok": True}])
    assert reader(NAME).read(run) == len(scans) - 1  # no mesh: every pair's target
    assert np.all(np.isfinite(poses[-1]))
