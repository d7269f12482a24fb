"""The batch cell's driver (``drivers/batch.py``) on the CPU: two ``gloo``
ranks (this process is rank 0) over a tiny drive, on the pooled engine.

Every rank leaves the window at the same call, each pair counts once, the
per-layer metrics read the batched path's spans, and every number the
check emits has a limit; the check fails a pair handed its neighbour's
answer; a rank that raises ends the run with a failed unit, well before
any collective's timeout; the control (the reference in TF32) fails the
limits."""
import copy
import json
import time
from pathlib import Path

import pytest
import torch

from portbench.calibrate_batch import control_numbers
from portbench.drivers import batch as B
from portbench.harness import manifest
from portbench.harness.check import judge
from probabilistic_point_clouds_registration_tpu_torch.parallel import batch as port_batch

from .conftest import run_cpu

CELL = "kitti131k_mesh4.batch"
LIMITS = json.loads((Path(__file__).resolve().parents[1] / "limits" / f"{CELL}.json").read_text())
TIMEOUT_S = 300


def tiny(**traffic):
    """The cell cut to two ranks of two pairs each (5 scans of 4,096
    points a call), three outer iterations, three calls, every pair
    checked."""
    cell = manifest.Cell(manifest.load_json(manifest.HERE.parent / "BENCHMARK.json"), CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(ranks=2, pairs_per_rank=2)
    cell.config["cloud"]["n_points"] = 4096
    cell.config["params"].update(pad_multiple=256, search_impl="pool")
    cell.traffic = {**cell.traffic, "min_distinct_calls": 2, "distinct_calls_per_second": 0,
                    "stopping": {**cell.traffic["stopping"], "n_outer": 3},
                    "max_calls": 3, "checked_pairs": 4, "collective_timeout_s": TIMEOUT_S,
                    **traffic}
    return cell


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sound():
    run, result = run_cpu(tiny(), seconds=1e6, trace=True)
    return run, result


def test_every_rank_leaves_at_the_same_call_and_pairs_count_once(sound):
    run, result = sound
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] == 3
    assert run.extras["rank_calls"] == [4, 4]  # the warm-up call and three
    assert [u["pairs"] for u in run.units] == [4, 4, 4]
    assert [u["index"] for u in run.units] == [1, 2, 3]  # the warm-up took stretch 0


def test_every_number_the_check_emits_has_a_limit(sound):
    _, result = sound
    emitted = {k for k in result["checks"] if k != "failed_units"}
    assert emitted == set(LIMITS) == {"pose_gap", "cost_gap", "corr_gap", "iters_gap",
                                      "compose_gap"}
    assert all(result["checks"][k]["limit"] is not None for k in emitted)


def test_per_layer_metrics_read_the_batched_spans(sound):
    run, result = sound
    wanted = {m["name"] for m in run.cell.per_layer}
    assert set(result["metrics"]) == wanted
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["redo_pairs.batch"] == 0 and got["device_idle_pct.batch"] == 100.0
    assert all(got[k] > 0 for k in ("batch_plan_ms.batch", "batch_build_ms.batch",
                                    "batch_loop_ms.batch", "gather_wait_ms.batch"))
    # host_seconds is the sum of rank 0's host-phase spans, call by call.
    phases = B._host_phases(run)
    assert len(phases) == 3
    for host_s, span_s, _ in phases:
        assert host_s == pytest.approx(span_s, rel=1e-6)


def test_the_gather_sits_in_batch_gather(sound):
    run, _ = sound
    records, _ = B.program_spans.recorder().records()
    lo, hi = round(run.units[0]["start"] * 1e9), round(run.units[-1]["end"] * 1e9)
    mine = [r for r in records if lo <= r.start_ns <= hi]
    ids = {r.id: r for r in mine}
    gathers = [r for r in mine if r.name == "all_gather"]
    assert len(gathers) == 3 * 7  # one a field of the result, a call
    assert {ids[r.parent].name for r in gathers} == {"batch_gather"}


def _neighbour_answer(monkeypatch, pair=1):
    # After the gather, pair ``pair`` holds the rotation and translation of
    # the pair before it.
    real = port_batch._gather_result

    def gather(result, mesh):
        out = real(result, mesh)
        q, t = out.q.clone(), out.t.clone()
        q[pair], t[pair] = q[pair - 1], t[pair - 1]
        return out._replace(q=q, t=t)

    monkeypatch.setattr(port_batch, "_gather_result", gather)


def test_a_pair_handed_its_neighbours_answer_is_not_correct(monkeypatch):
    _neighbour_answer(monkeypatch)
    run, result = run_cpu(tiny(max_calls=1), seconds=1e6)
    assert result["failed"] == 0
    assert not result["correct"], result["checks"]
    assert result["checks"]["pose_gap"]["value"] > result["checks"]["pose_gap"]["limit"]


@pytest.mark.parametrize("rank", [0, 1])
def test_a_raising_rank_ends_the_run_with_a_failed_unit(rank):
    t0 = time.perf_counter()
    run, result = run_cpu(tiny(raise_at=[rank, 2]), seconds=1e6)  # the window's second call
    assert time.perf_counter() - t0 < TIMEOUT_S / 3  # not a collective's timeout
    assert not result["correct"] and result["failed"] == 1
    assert result["attempted"] == 2 and run.units[0]["ok"] and not run.units[1]["ok"]


@pytest.mark.parametrize("seed", [1, 2**33 + 9])
def test_control_is_not_correct_at_a_small_size(seed):
    cell = tiny()
    ok, checks = judge(control_numbers(cell.config, cell.traffic, seed, "cpu"), LIMITS, failed=0)
    assert not ok, checks


def test_a_run_makes_about_as_many_stretches_as_its_calls():
    traffic = {"min_distinct_calls": 4, "distinct_calls_per_second": 0.2, "warmup_calls": 1}
    assert B.distinct_calls(traffic, 51) == 11 and B.distinct_calls(traffic, 5) == 4
    assert B.distinct_calls({**traffic, "max_calls": 1}, 1e6) == 2
