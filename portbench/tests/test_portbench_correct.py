"""What decides ``correct``: the harness's run passes the sound program
and fails a broken one, and the control (the reference in TF32 put in the
program's place) fails the limits."""
import json
from pathlib import Path

import pytest
import torch

from portbench.calibrate import control_numbers
from portbench.harness.check import judge
from probabilistic_point_clouds_registration_tpu_torch.models import em_lm, registration

from .conftest import run_cpu

LIMITS = Path(__file__).resolve().parents[1] / "limits"
PR = registration.ProbabilisticRegistration


CELLS = ["kitti131k.pair", "kitti131k.seq"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(tiny_cell, cell):
    run, result = run_cpu(tiny_cell(cell))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


def _state_unchanged(monkeypatch):
    # Each outer step's solve hands back the state it started from: the
    # increment is the identity, so the transform never moves.
    real = em_lm.LMBlocks.solve

    def solve(self, source, targets, mask, q0, t0, *args, **kwargs):
        result, status = real(self, source, targets, mask, q0, t0, *args, **kwargs)
        return result._replace(q=torch.zeros_like(result.q) + q0.to(result.q.dtype),
                               t=torch.zeros_like(result.t) + t0.to(result.t.dtype)), status

    monkeypatch.setattr(em_lm.LMBlocks, "solve", solve)


def _half_left_out(monkeypatch):
    # The search drops the second half of the source rows (the solve then
    # takes its mean over the rest).
    real = PR._associate

    def associate(self, moved):
        a = real(self, moved)
        mask = a.mask.clone()
        mask[mask.shape[0] // 2:] = False
        return a._replace(mask=mask, n_corr=mask.sum())

    monkeypatch.setattr(PR, "_associate", associate)


def _answer_altered(monkeypatch):
    # The transform is altered where align() produces it.
    real = PR.align

    def align(self):
        out = real(self)
        out[:3, 3] += 1e-2
        return out

    monkeypatch.setattr(PR, "align", align)


def _answer_of_the_pair_before(monkeypatch):
    # Each pair hands back the transform and report of the pair registered
    # before it (a pipeline one pair behind); the first pair its own.
    real_align, real_report = PR.align, PR.report
    before = {}

    def align(self):
        own = real_align(self)
        mine = (own, real_report(self))
        self._handed, before["last"] = before.get("last", mine), mine
        return self._handed[0].copy()

    def report(self):
        return self._handed[1]

    monkeypatch.setattr(PR, "align", align)
    monkeypatch.setattr(PR, "report", report)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _answer_altered,
                                   _answer_of_the_pair_before])
def test_broken_program_is_not_correct(tiny_cell, monkeypatch, fault, cell):
    fault(monkeypatch)
    run, result = run_cpu(tiny_cell(cell))
    assert not result["correct"], result["checks"]


def test_a_number_without_a_limit_fails():
    ok, checks = judge({"pose_gap": 0.0, "corr_gap": 0.0}, {"pose_gap": 1e-3}, failed=0)
    assert not ok and checks["corr_gap"]["limit"] is None
    ok, _ = judge({"pose_gap": 0.0}, {"pose_gap": 1e-3, "iters_gap": 0}, failed=0)
    assert not ok
    assert judge({"pose_gap": 0.0}, {"pose_gap": 1e-3}, failed=0)[0]


@pytest.mark.parametrize("cell", ["kitti131k.pair"])
def test_control_is_not_correct_at_a_small_size(tiny_cell, cell):
    config = tiny_cell(cell).config
    for seed in (1, 2**33 + 9):
        ok, checks = judge(control_numbers(config, {"driver": "pair"}, seed, "cpu"), json.loads(
            (LIMITS / f"{cell}.json").read_text()), failed=0)
        assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["kitti131k.pair", "kitti131k.seq"])
def test_control_is_not_correct_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control at the cell's own size runs on a CUDA card")
    from portbench.harness import manifest

    c = manifest.Cell(manifest.load_json(manifest.HERE.parent / "BENCHMARK.json"), cell)
    for seed in (11, 2**33 + 12, 2**40 + 13):
        ok, checks = judge(control_numbers(c.config, c.traffic, seed, "cuda"), c.limits,
                           failed=0)
        assert not ok, checks
