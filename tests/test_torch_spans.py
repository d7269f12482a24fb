"""The port's recorder (``utils/spans.py``): nesting, parents and self
time, a thread's own stack, the pair id from ``prepare_target`` through
the ctor to ``align()``, the ring's bound, counts, profiler ranges only
under a profiler and on the profiler's clock, and the spans a CPU
registration, a three-scan sequence and a batch of pairs on each engine
record.

The ring is shared by the whole process, so each test reads only the
records that started after its own first stamp."""
import itertools
import sys
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from probabilistic_point_clouds_registration_tpu_torch import (
    ProbabilisticRegistration,
    RegistrationParams,
)
from probabilistic_point_clouds_registration_tpu_torch.io.synthetic import (
    sequence_from_world,
    wave_grid,
)
from probabilistic_point_clouds_registration_tpu_torch.models.odometry import run_odometry
from probabilistic_point_clouds_registration_tpu_torch.parallel import batch
from probabilistic_point_clouds_registration_tpu_torch.utils import spans

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_port_mesh_worker as W  # noqa: E402


def _since(t0: int) -> list:
    return [r for r in spans.records()[0] if r.start_ns >= t0]


def _by_name(records) -> dict:
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_nesting_parents_and_self_time():
    t0 = time.perf_counter_ns()
    with spans.span("outer", pair=7) as outer:
        time.sleep(0.02)
        with spans.span("inner") as inner:
            time.sleep(0.01)
            assert spans.pair_or_new() == 7
        with spans.span("inner"):
            pass
    fresh = spans.pair_or_new()
    assert fresh not in (None, 7) and spans.pair_or_new(5) == 5
    got = _by_name(_since(t0))
    (o,), (i1, i2) = got["outer"], got["inner"]
    assert o.parent is None and o.pair == 7 and o.count is None
    assert i1.parent == i2.parent == o.id and i1.pair == i2.pair == 7
    assert o.start_ns <= i1.start_ns <= i1.end_ns <= i2.start_ns <= i2.end_ns <= o.end_ns
    assert outer.seconds == pytest.approx((o.end_ns - o.start_ns) * 1e-9)
    assert inner.seconds == pytest.approx((i1.end_ns - i1.start_ns) * 1e-9)
    own = (o.end_ns - o.start_ns) - (i1.end_ns - i1.start_ns) - (i2.end_ns - i2.start_ns)
    assert own >= 0.02e9  # the outer span's self time holds its own sleep
    assert 0 <= o.cpu_ns < (o.end_ns - o.start_ns)  # asleep: off the CPU


def test_a_second_thread_has_its_own_stack():
    t0 = time.perf_counter_ns()
    seen = {}

    def work():
        with spans.span("worker") as w:
            pass
        seen["seconds"] = w.seconds

    with spans.span("main", pair=3):
        thread = threading.Thread(target=work)
        thread.start()
        thread.join(timeout=30)
    assert not thread.is_alive()
    got = _by_name(_since(t0))
    (m,), (w,) = got["main"], got["worker"]
    assert w.parent is None and w.pair is None
    assert w.thread != m.thread == threading.get_ident()
    assert seen["seconds"] is not None


def test_count_sits_under_the_open_span():
    t0 = time.perf_counter_ns()
    with spans.span("work", pair=11):
        spans.count("events", 3)
    spans.count("events")
    with pytest.raises(ValueError):
        spans.count("events", -1)
    got = _by_name(_since(t0))
    (w,), (c1, c2) = got["work"], got["events"]
    assert (c1.parent, c1.pair, c1.count, c1.cpu_ns) == (w.id, 11, 3, 0)
    assert c1.start_ns == c1.end_ns and w.start_ns <= c1.start_ns <= w.end_ns
    assert (c2.parent, c2.pair, c2.count) == (None, None, 1)


def test_the_ring_drops_its_oldest_records_and_says_how_far_back_it_reaches(monkeypatch):
    assert spans.RING == 65_536
    assert spans.RECORD_BYTES == sys.getsizeof(spans._RECORD.pack(*[0] * 9)) + 8
    assert spans.RING * spans.RECORD_BYTES < 16 * 2**20
    monkeypatch.setattr(spans, "RING", 4)
    monkeypatch.setattr(spans, "_ring", deque(maxlen=4))
    monkeypatch.setattr(spans, "_written", itertools.count())
    monkeypatch.setattr(spans, "_dropped", False)
    for j in range(4):
        spans.count(f"c{j}")
    held, since = spans.records()
    assert [r.name for r in held] == ["c0", "c1", "c2", "c3"] and since == 0
    for j in range(4, 7):
        spans.count(f"c{j}")
    held, since = spans.records()
    assert [r.name for r in held] == ["c3", "c4", "c5", "c6"]
    assert since == held[0].end_ns > 0


def test_no_profiler_range_without_a_profiler(monkeypatch):
    opened = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    with spans.span("quiet"):
        pass
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("loud"):
            pass
    assert opened == ["pcr/loud"]


def test_profiler_ranges_match_their_records_on_the_profilers_clock():
    x = torch.randn(64, 64)
    t0 = time.perf_counter_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("outer"):
            for _ in range(20):
                with spans.span("inner"):
                    x = x @ x / 64
    offset = spans.trace_offset_ns()
    ranges = sorted((e.name()[len(spans.PREFIX):], e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(spans.PREFIX))
    records = sorted((r.name, r.start_ns + offset, r.end_ns + offset) for r in _since(t0))
    assert [r[0] for r in ranges] == [r[0] for r in records] == ["inner"] * 20 + ["outer"]
    # The median over the spans: a thread the scheduler parks between a
    # range's edge and the record's clock read moves that one span alone.
    starts = sorted(abs(s0 - s1) for (_, s0, _), (_, s1, _) in zip(ranges, records))
    ends = sorted(abs(e0 - e1) for (_, _, e0), (_, _, e1) in zip(ranges, records))
    assert starts[len(starts) // 2] < 1e6 and ends[len(ends) // 2] < 1e6  # within 1 ms


def test_spans_of_many_threads_keep_their_parents():
    t0 = time.perf_counter_ns()
    n_threads, depth, rounds = 16, 3, 40
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(rounds):
                with spans.span("a", pair=10**9 + k), spans.span("b"), spans.span("c"):
                    pass

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    mine = [r for r in _since(t0) if r.pair is not None and r.pair >= 10**9]
    assert len(mine) == n_threads * depth * rounds
    assert len({r.id for r in mine}) == len(mine)
    by_id = {r.id: r for r in mine}
    for r in mine:
        if r.name == "a":
            assert r.parent is None
        else:
            parent = by_id[r.parent]
            assert parent.name == {"b": "a", "c": "b"}[r.name]
            assert (parent.thread, parent.pair) == (r.thread, r.pair)


def _pair_clouds():
    scans, _ = sequence_from_world(wave_grid(), 0.05, (0.15, -0.05, 0.02), 3)
    return scans


def test_one_pair_id_from_prepare_target_through_the_ctor_to_align():
    scans = _pair_clouds()
    params = RegistrationParams(max_neighbours=10, radius=1.0, n_iter=4, search_impl="pool",
                                dtype="float64")
    t0 = time.perf_counter_ns()
    prepared = ProbabilisticRegistration.prepare_target(scans[0], params, "cpu")
    reg = ProbabilisticRegistration(scans[1], scans[0], params, prepared_target=prepared,
                                    device="cpu")
    reg.align()
    records = _since(t0)
    pair = prepared["pair"]
    mine = _by_name(r for r in records if r.pair == pair)
    # plan_native, the native plan's count, is held by test_torch_pool_plan_native.py.
    assert set(mine) - {"plan_native"} == {
        "prepare_target", "grid_build", "pool_plan", "ctor", "pool_build",
        "align", "chunk", "search", "lm", "lm_read", "chunk_read"}
    assert all(r.pair == pair for r in records)
    ids = {r.id: r for r in records}
    for child, parent in [("grid_build", "prepare_target"), ("pool_plan", "prepare_target"),
                          ("pool_build", "ctor"), ("chunk", "align"), ("search", "chunk"),
                          ("lm", "chunk"), ("lm_read", "lm"), ("chunk_read", "chunk")]:
        assert all(ids[r.parent].name == parent for r in mine[child]), child
    assert [r.parent for r in mine["prepare_target"] + mine["ctor"] + mine["align"]] == \
        [None] * 3
    # iteration_times spreads each chunk's time, as measured up to its
    # consume, over its iterations: within the chunk spans' walls.
    assert len(reg.iteration_times) == len(reg.records) == len(mine["search"])
    chunk_s = sum(r.end_ns - r.start_ns for r in mine["chunk"]) * 1e-9
    assert 0 < sum(reg.iteration_times) <= chunk_s
    # A ctor without a prepared target takes a new pair, its own plan too.
    t1 = time.perf_counter_ns()
    again = ProbabilisticRegistration(scans[1], scans[0], params, device="cpu")
    got = _by_name(_since(t1))
    assert again._pair not in (None, pair)
    assert {r.pair for r in got["ctor"] + got["prepare_target"] + got["pool_plan"]} == \
        {again._pair}
    assert got["prepare_target"][0].parent == got["ctor"][0].id


def test_a_sequence_records_its_prep_thread_wait_and_checkpoint(tmp_path):
    scans = _pair_clouds()
    params = RegistrationParams(max_neighbours=10, radius=1.0, n_iter=4, search_impl="grid",
                                dtype="float64")
    t0 = time.perf_counter_ns()
    result = run_odometry(scans, params, checkpoint_path=tmp_path / "t.json", device="cpu")
    got = _by_name(_since(t0))
    assert {"prep", "prepare_target", "grid_build", "prep_wait", "ctor", "align", "chunk",
            "search", "lm", "lm_read", "chunk_read", "checkpoint"} <= set(got)
    main = threading.get_ident()
    assert len(got["prep"]) == len(got["prep_wait"]) == len(got["checkpoint"]) == 2
    assert all(r.thread != main and r.parent is None for r in got["prep"])
    assert all(r.thread == main for r in got["prep_wait"] + got["ctor"] + got["align"])
    for prep, wait, ctor, align, ckpt in zip(got["prep"], got["prep_wait"], got["ctor"],
                                             got["align"], got["checkpoint"]):
        assert prep.pair == wait.pair == ctor.pair == align.pair == ckpt.pair
    assert [r.pair for r in got["prepare_target"]] == [r.pair for r in got["prep"]]
    assert result.prep_seconds == pytest.approx(
        [(r.end_ns - r.start_ns) * 1e-9 for r in got["prep"]])
    assert result.prep_wait_seconds == pytest.approx(
        [(r.end_ns - r.start_ns) * 1e-9 for r in got["prep_wait"]])
    assert np.all(np.isfinite(result.poses[-1]))


# The children of a batch's root span on each engine ("redo": the pooled
# engine with its budgets starved, so that the grid engine redoes pairs).
BATCH_PHASES = {
    "pool": {"batch_grid", "batch_plan", "batch_build", "batch_loop", "batch_gather"},
    "grid": {"batch_grid", "batch_build", "batch_loop", "batch_gather"},
    "brute": {"batch_build", "batch_loop", "batch_gather"},
    "redo": {"batch_grid", "batch_plan", "batch_build", "batch_loop", "batch_gather",
             "batch_redo"},
}


@pytest.mark.parametrize("impl", sorted(BATCH_PHASES))
def test_a_batch_records_its_phases_and_host_seconds(monkeypatch, impl):
    if impl == "redo":
        monkeypatch.setattr(batch, "_batched_pools_host",
                            W.starved_pools(batch._batched_pools_host))
    stats = {}
    t0 = time.perf_counter_ns()
    poses, _ = batch.run_odometry_batched(
        _pair_clouds(), k=10, radius=0.5, n_outer=3, pad_multiple=128, dtype="float64",
        search_impl="pool" if impl == "redo" else impl, device="cpu", stats=stats)
    records = _since(t0)
    got = _by_name(records)
    ids = {r.id: r for r in records}
    (root,) = got["batch"]
    assert root.parent is None and root.count is None
    assert {r.name for r in records if r.parent == root.id and r.count is None} == \
        BATCH_PHASES[impl]
    redone = stats.get("redone", [])
    assert bool(redone) == (impl == "redo")
    if impl in ("pool", "redo"):
        (count,) = got["redo_pairs"]
        assert count.parent == root.id and count.count == len(redone)
        (targets,) = got["batch_targets"]
        assert targets.parent == root.id and targets.count == len(_pair_clouds()) - 1
    else:
        assert "redo_pairs" not in got
    if impl == "redo":
        (redo,) = got["batch_redo"]
        assert {ids[r.parent].name for r in got["batch_grid"] + got["batch_build"]} == \
            {"batch", "batch_redo"}
        # The redo's own loop sits in batch_redo (its LM reads, no batch_loop).
        assert {r.name for r in records if r.parent == redo.id and r.count is None} - \
            {"lm_read", "lm_capture"} == {"batch_grid", "batch_build"}
    # host_seconds is the host phases' sum, wherever they sit under the root.
    host = [r for r in records if r.name in ("batch_grid", "batch_plan", "batch_build")]
    assert stats["host_seconds"] == pytest.approx(
        sum(r.end_ns - r.start_ns for r in host) * 1e-9, rel=1e-9, abs=1e-12)
    for r in records:
        if r is not root:
            assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
    assert np.all(np.isfinite(poses[-1]))
