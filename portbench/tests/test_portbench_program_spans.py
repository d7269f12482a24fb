"""The readers of the program's own spans and counts
(``harness/program_spans.py`` and the metrics that use it): their
arithmetic on planted records, the units they read, and None where the
ring no longer reaches back, where no unit completed, or where the
program keeps no records."""
import time
from types import SimpleNamespace

import pytest

from portbench.harness import manifest, program_spans
from probabilistic_point_clouds_registration_tpu_torch.utils import spans
from probabilistic_point_clouds_registration_tpu_torch.utils.spans import Record

MS = 1_000_000  # ns
READERS = {  # metric -> its reading on the planted records below
    "grid_build_ms.pair": 3.0, "pool_plan_ms.pair": 5.0, "pool_build_ms.pair": 2.0,
    "search_host_ms.pair": 6.0, "lm_host_ms.pair": 3.0, "sync_wait_ms.pair": 2.5,
    "chunk_redos.pair": 1.5, "align_offcpu_ms.pair": 3.5, "align_offcpu_ms.seq": 3.5,
    "prep_ms.seq": 10.0, "checkpoint_ms.seq": 0.5,
}


class FakeRun:
    def __init__(self, units):
        self.units = units

    def untraced(self):  # harness.runner.Run's rule
        return [u for u in self.units if not u.get("traced")] or self.units


def unit(start_ms, end_ms, traced=False, ok=True):
    return {"start": start_ms * 1e-3, "end": end_ms * 1e-3, "traced": traced, "ok": ok}


def rec(name, start_ms, wall_ms, id_, parent=None, cpu_ms=None, count=None):
    start = round(start_ms * MS)
    end = start if count is not None else start + round(wall_ms * MS)
    cpu = 0 if count is not None else round((wall_ms if cpu_ms is None else cpu_ms) * MS)
    return Record(name, id_, parent, 1, 1, start, end, cpu, count)


def planted(base):
    """One pair's records starting at ``base`` ms (times in ms): prepare
    12 (grid 3, plan 5), ctor 3 (pool build 2), align 20 at 16.5 ms of CPU
    (chunk: search 6, lm 4 with a read of 1, chunk read 1.5), a redo count,
    and the sequence's prep 10 and checkpoint 0.5."""
    b, i = base, base * 100
    return [
        rec("prepare_target", b, 12, i + 1), rec("grid_build", b + 1, 3, i + 2, i + 1),
        rec("pool_plan", b + 5, 5, i + 3, i + 1),
        rec("ctor", b + 13, 3, i + 4), rec("pool_build", b + 13.5, 2, i + 5, i + 4),
        rec("align", b + 17, 20, i + 6, cpu_ms=16.5), rec("chunk", b + 17.5, 19, i + 7, i + 6),
        rec("search", b + 18, 6, i + 8, i + 7), rec("lm", b + 25, 4, i + 9, i + 7),
        rec("lm_read", b + 27, 1, i + 10, i + 9), rec("chunk_read", b + 30, 1.5, i + 11, i + 7),
        rec("redo", b + 31, 0, i + 12, i + 7, count=1 if base < 200 else 2),
        rec("prep", b + 2, 10, i + 13), rec("checkpoint", b + 38, 0.5, i + 14),
    ]


def plant(monkeypatch, records, since_ns=0):
    fake = SimpleNamespace(records=lambda: (list(records), since_ns))
    monkeypatch.setattr(program_spans, "recorder", lambda: fake)


def reader(name):
    root = manifest.HERE
    return manifest.load_module(manifest.reader_path(root, name),
                                "test_metric_" + name.replace(".", "_"))


def test_readers_sum_the_records_inside_the_untraced_units(monkeypatch):
    # Two untraced pairs at 100 and 200 ms; a traced pair at 0 and records
    # outside every unit (at 400 ms) are left out.
    records = planted(0) + planted(100) + planted(200) + planted(400)
    units = [unit(0, 40, traced=True), unit(100, 140), unit(200, 240)]
    plant(monkeypatch, records)
    run = FakeRun(units)
    for name, want in READERS.items():
        assert reader(name).read(run) == pytest.approx(want), name
    # The helper's parts on their own.
    assert program_spans.mean_ms(run, {"align"}) == pytest.approx(20.0)
    assert program_spans.mean_ms(run, {"lm"}, part="self") == pytest.approx(3.0)
    assert program_spans.mean_ms(run, {"chunk"}, part="self") == pytest.approx(19 - 6 - 4 - 1.5)
    assert program_spans.mean_ms(run, {"align"}, part="offcpu") == pytest.approx(3.5)
    assert program_spans.per_unit(run, "redo") == pytest.approx(1.5)
    assert program_spans.mean_ms(run, {"no_such_span"}) == 0.0


def test_failed_units_are_left_out_and_every_traced_unit_is_read_without_an_untraced_one(
        monkeypatch):
    plant(monkeypatch, planted(0) + planted(100))
    run = FakeRun([unit(0, 40, traced=True), unit(100, 140, ok=False)])
    assert reader("prep_ms.seq").read(run) is None  # the one untraced unit failed
    run = FakeRun([unit(0, 40, traced=True), unit(100, 140, traced=True)])
    assert reader("prep_ms.seq").read(run) == pytest.approx(10.0)  # Run.untraced(): all


def test_none_on_a_ring_that_no_longer_reaches_back(monkeypatch):
    run = FakeRun([unit(100, 140), unit(200, 240)])
    plant(monkeypatch, planted(100) + planted(200), since_ns=round(150 * MS))
    assert all(reader(name).read(run) is None for name in READERS)
    plant(monkeypatch, planted(100) + planted(200), since_ns=round(100 * MS))
    assert all(reader(name).read(run) is not None for name in READERS)


def test_none_without_a_completed_unit_or_without_the_recorder(monkeypatch):
    plant(monkeypatch, planted(100))
    assert all(reader(name).read(FakeRun([])) is None for name in READERS)
    assert all(reader(name).read(FakeRun([unit(100, 140, ok=False)])) is None
               for name in READERS)
    monkeypatch.setattr(program_spans, "recorder", lambda: None)  # a tree without it
    assert all(reader(name).read(FakeRun([unit(100, 140)])) is None for name in READERS)


def test_the_programs_own_recorder_is_read():
    start = time.perf_counter()
    with spans.span("align") as align:
        with spans.span("search"):
            time.sleep(0.005)
        spans.count("redo", 2)
    run = FakeRun([{"start": start, "end": time.perf_counter(), "traced": False, "ok": True}])
    assert program_spans.recorder() is spans
    assert reader("search_host_ms.pair").read(run) >= 5.0
    assert reader("chunk_redos.pair").read(run) == 2.0
    offcpu = reader("align_offcpu_ms.pair").read(run)
    assert 4.0 <= offcpu <= 1e3 * align.seconds  # asleep in the search: off the CPU
