"""The port's outer chunks against its one-iteration loop and against the
JAX package's scans: ``outer_chunk``, the device-side stopping rule,
``trace_inner``, ``profile_dir`` and the pooled overflow handling inside a
chunk.

Inputs are made with numpy from a seed and fed to both packages, the JAX
side's dtype passed explicitly (x64 is on in these tests). Tolerances:
in float64 the final 4x4 and the translations at 1e-9, the costs at 1e-9
relative (the chunked loop composes the cumulative transform on the device
between the host's float64 compositions, which moves the last bits);
correspondence counts and record counts equal. LM trace values at 1e-6
relative in float64.
"""
import re

import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core.params import (
    RegistrationParams as JParams,
)
from probabilistic_point_clouds_registration_tpu.models import registration as j_reg
from probabilistic_point_clouds_registration_tpu_torch import (
    ProbabilisticRegistration,
    RegistrationParams,
    register_pair,
)
from probabilistic_point_clouds_registration_tpu_torch.io.synthetic import (
    transform_cloud,
    wave_grid,
)
from probabilistic_point_clouds_registration_tpu_torch.models import registration as t_reg

# tests/test_registration.py:164-198's setting: the reference's cost-drop
# rule fires mid-chunk.
_STOP_RULE = dict(dof=5.0, radius=3.0, max_neighbours=10, n_iter=50,
                  cost_drop_thresh=0.01, n_cost_drop_it=3, dtype="float64",
                  pad_multiple=64, summary=True)
_ROW = re.compile(r"lm_iter \d+: cost=\S+ step_quality=\S+ trust_radius=\S+ "
                  r"(?:accepted|rejected)")


def _wave_pair(angle=0.1, tx=0.3):
    source = wave_grid()
    m = np.eye(4)
    c, s = np.cos(angle), np.sin(angle)
    m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    m[0, 3] = tx
    return source, transform_cloud(source, m)


def _same_records(got, want, atol=1e-9):
    assert got.current_iteration == want.current_iteration
    assert len(got.records) == len(want.records)
    np.testing.assert_allclose(got.transformation(), want.transformation(), rtol=0, atol=atol)
    for g, w in zip(got.records, want.records):
        assert g.iteration == w.iteration
        assert g.num_correspondences == w.num_correspondences
        assert g.num_successful_steps == w.num_successful_steps
        np.testing.assert_allclose(g.translation, w.translation, rtol=0, atol=atol)
        np.testing.assert_allclose(g.initial_cost, w.initial_cost, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(g.final_cost, w.final_cost, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("chunk", [4, 16])
def test_outer_chunk_matches_the_one_iteration_loop(chunk):
    """The device's stopping rule stops where the host's does: the rule
    fires mid-chunk, and every record equals the one-iteration loop's."""
    source, target = _wave_pair()
    one = ProbabilisticRegistration(source, target, RegistrationParams(outer_chunk=1, **_STOP_RULE),
                                    device="cpu")
    one.align()
    chunked = ProbabilisticRegistration(
        source, target, RegistrationParams(outer_chunk=chunk, **_STOP_RULE), device="cpu")
    chunked.align()
    assert one.current_iteration < 50  # converged by the cost-drop rule
    assert one.current_iteration % chunk != 0  # ... inside a chunk
    _same_records(chunked, one)


def test_outer_chunk_matches_the_jax_scan():
    """``outer_chunk=4`` on both sides: the port's chunks against the JAX
    package's ``_registration_scan_*`` with its device-side rule."""
    source, target = _wave_pair()
    want_T, want = j_reg.register_pair(source, target, JParams(outer_chunk=4, **_STOP_RULE))
    got_T, got = register_pair(source, target, RegistrationParams(outer_chunk=4, **_STOP_RULE),
                               device="cpu")
    assert got.engine == "brute"  # the density check drops the grid, on both sides
    _same_records(got, want)
    np.testing.assert_allclose(got_T, np.asarray(want_T), rtol=0, atol=1e-9)


def _traced(monkeypatch, cls):
    """Record every (rows, n) handed to ``cls._print_lm_trace``."""
    seen = []
    original = cls._print_lm_trace

    def record(self, rows, n):
        seen.append(np.array(rows, dtype=np.float64)[: int(n)])
        original(self, rows, n)

    monkeypatch.setattr(cls, "_print_lm_trace", record)
    return seen


@pytest.mark.parametrize("engine", ["brute", "pool"], ids=["chunked", "pooled"])
def test_trace_inner_rows_match_jax(engine, monkeypatch, capsys):
    """``trace_inner`` streams one row per LM iteration out of the chunks
    (the pooled engine included), in the JAX package's format; the values
    are the JAX package's. Its grid engine stands in for the pool on the
    JAX side (the two engines select the same neighbors)."""
    rng = np.random.default_rng(5)
    tgt = rng.uniform(0, 20, size=(2000, 3))
    tgt[:, 2] = rng.normal(scale=0.3, size=2000)
    src = tgt + np.array([0.1, -0.05, 0.02])
    kw = dict(max_neighbours=8, radius=0.7, n_iter=3, cost_drop_thresh=-1.0, dof=5.0,
              dtype="float64", verbose=True, trace_inner=True, outer_chunk=3,
              pad_multiple=128)
    got_rows = _traced(monkeypatch, t_reg.ProbabilisticRegistration)
    reg = ProbabilisticRegistration(src, tgt, RegistrationParams(search_impl=engine, **kw),
                                    device="cpu")
    assert reg.engine == engine
    reg.align()
    out = capsys.readouterr().out
    assert len(_ROW.findall(out)) == sum(reg.inner_iterations) >= 3
    want_rows = _traced(monkeypatch, j_reg.ProbabilisticRegistration)
    j_reg.register_pair(src, tgt, JParams(search_impl="grid" if engine == "pool" else engine,
                                          **kw))
    j_out = capsys.readouterr().out
    assert len(got_rows) == len(want_rows) == 3
    for g, w in zip(got_rows, want_rows):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12)
    assert len(_ROW.findall(j_out)) == len(_ROW.findall(out))


def test_trace_inner_in_float32_prints_the_reference_format(capsys):
    """tests/test_registration.py:142-161's run, on the port."""
    rng = np.random.default_rng(3)
    tgt = rng.uniform(0, 4, size=(400, 3)).astype(np.float32)
    src = tgt + np.array([0.05, -0.03, 0.02], dtype=np.float32)
    p = RegistrationParams(max_neighbours=5, radius=0.6, n_iter=4, cost_drop_thresh=-1.0,
                           dof=5.0, dtype="float32", verbose=True, trace_inner=True,
                           outer_chunk=4)
    _, reg = register_pair(src, tgt, p, device="cpu")
    assert reg.current_iteration == 4
    assert len(_ROW.findall(capsys.readouterr().out)) == sum(reg.inner_iterations) >= 4


def test_profile_dir_leaves_a_trace(tmp_path):
    source, target = _wave_pair()
    p = RegistrationParams(dof=5.0, radius=3.0, max_neighbours=5, n_iter=2,
                           dtype="float64", pad_multiple=64, profile_dir=str(tmp_path))
    reg = ProbabilisticRegistration(source, target, p, device="cpu")
    final = reg.align()
    assert np.all(np.isfinite(final)) and reg.current_iteration == 2
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def _sheet_pair():
    """tests/test_registration.py:266-269's pair."""
    rng = np.random.default_rng(11)
    tgt = rng.uniform(0, 15, size=(2500, 3))
    tgt[:, 2] = rng.normal(scale=0.3, size=2500)
    src = tgt + np.array([0.1, -0.05, 0.02])
    return src.astype(np.float32), tgt.astype(np.float32)


@pytest.mark.parametrize("thresh,n_drop", [(-1.0, 5), (0.99, 3)],
                         ids=["fixed-iterations", "stall-rule"])
def test_pool_overflow_in_a_chunk_falls_back_to_grid(thresh, n_drop, capsys):
    """tests/test_registration.py:252-300 on the port, at outer_chunk=4:
    every pooled chunk overflows a strangled class budget, is discarded,
    escalates twice and falls back; the records equal a forced-grid run,
    and the stall-rule variant ends on the same iteration (a lost counter
    restore would end it one iteration early)."""
    src, tgt = _sheet_pair()
    base = dict(max_neighbours=8, radius=0.7, n_iter=10, cost_drop_thresh=thresh,
                n_cost_drop_it=n_drop, dof=5.0, dtype="float32", outer_chunk=4,
                pad_multiple=128, verbose=True)
    reg = ProbabilisticRegistration(src, tgt, RegistrationParams(search_impl="pool", **base),
                                    device="cpu")
    assert reg._pool is not None and reg._grid is None
    assert len(reg._pool.class_widths) >= 2, reg._pool.class_widths
    strangled = type(reg).pool_budgets

    def pool_budgets():
        budget, class_budgets = strangled(reg)
        return budget, (16,) * (len(class_budgets) - 1) + (class_budgets[-1],)

    reg.pool_budgets = pool_budgets
    reg.align()
    out = capsys.readouterr().out
    assert out.count("Pooled-engine budget overflow") == 3
    assert reg._pool is None and reg._grid is not None and reg.engine_fallbacks == 1
    ref = ProbabilisticRegistration(src, tgt, RegistrationParams(search_impl="grid", **base),
                                    device="cpu")
    ref.align()
    assert reg.current_iteration == ref.current_iteration >= 1
    np.testing.assert_array_equal(reg.transformation(), ref.transformation())
    assert len(reg.records) == len(ref.records)
    for a, b in zip(reg.records, ref.records):
        assert a.num_correspondences == b.num_correspondences
        assert a.initial_cost == b.initial_cost and a.final_cost == b.final_cost
        np.testing.assert_array_equal(a.translation, b.translation)
