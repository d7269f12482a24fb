"""The port's loop closure (``models/loop_closure.py``) against the JAX
package's: tests/test_loop_closure.py's drifted square walk through both
packages gives the same closures (i, j) with the same messages, closure
transforms within 1e-4 (float32 registrations) and refined poses within
1e-6; the non-overlapping candidate is rejected by both."""
import re

import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core.params import RegistrationParams as JParams
from probabilistic_point_clouds_registration_tpu.models import loop_closure as j_lc
from probabilistic_point_clouds_registration_tpu.models.odometry import (
    OdometryResult as JResult,
)
from probabilistic_point_clouds_registration_tpu_torch import RegistrationParams
from probabilistic_point_clouds_registration_tpu_torch.io.synthetic import (
    drifted_moves,
    square_loop,
    wave_grid,
)
from probabilistic_point_clouds_registration_tpu_torch.models import loop_closure as t_lc
from probabilistic_point_clouds_registration_tpu_torch.models.odometry import (
    OdometryResult as TResult,
)

# tests/test_loop_closure.py's parameters, on the grid engine in both
# packages (the JAX package's ``auto`` takes brute force here).
KW = dict(max_neighbours=10, radius=1.0, n_iter=8, cost_drop_thresh=0.003, dtype="float32",
          search_impl="grid")


def _detect(capsys, scans, poses, rels, **kw):
    """Both packages' detect_loop_closures, verbose: (port closures, JAX
    closures, port messages, JAX messages)."""
    out = {}
    for name, lc, result, params in (
            ("port", t_lc, TResult, RegistrationParams(**KW)),
            ("jax", j_lc, JResult, JParams(**KW))):
        extra = {"device": "cpu"} if name == "port" else {}
        closures = lc.detect_loop_closures(
            scans, result(poses=poses, relative_transforms=rels), params, verbose=True,
            **kw, **extra)
        out[name] = (closures, capsys.readouterr().out)
    return out["port"][0], out["jax"][0], out["port"][1], out["jax"][1]


def _numbers_masked(text):
    return re.sub(r"[-+]?\d+\.\d+(e[-+]?\d+)?", "#", text)


def test_square_loop_matches_jax(capsys):
    scans, gt, moves = square_loop(wave_grid(), 0.4)
    rels, poses = drifted_moves(moves, seed=0)
    got, want, got_msg, want_msg = _detect(capsys, scans, poses, rels,
                                           max_distance=0.5, min_index_gap=4)
    assert [(c.i, c.j) for c in got] == [(c.i, c.j) for c in want] != []
    assert _numbers_masked(got_msg) == _numbers_masked(want_msg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.relative_transform, b.relative_transform, rtol=0, atol=1e-4)
        assert a.mean_cost == pytest.approx(b.mean_cost, rel=1e-4)
    # The pose-graph refinement, from the same closures: within 1e-6.
    refined, cost = t_lc.refine_trajectory(TResult(poses=poses, relative_transforms=rels), want,
                                           device="cpu")
    j_refined, j_cost = j_lc.refine_trajectory(JResult(poses=poses, relative_transforms=rels),
                                               want)
    assert cost == pytest.approx(j_cost, rel=1e-9)
    for a, b in zip(refined, j_refined):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    drift_before = np.linalg.norm(poses[-1][:3, 3] - gt[-1][:3, 3])
    assert np.linalg.norm(refined[-1][:3, 3] - gt[-1][:3, 3]) < 0.6 * drift_before


def test_non_overlapping_candidate_rejected(capsys):
    world = wave_grid()
    scans = [world, world + 0.0, world + np.array([100.0, 0.0, 0.0])]
    poses, rels = [np.eye(4)] * 3, [np.eye(4)] * 2
    got, want, got_msg, want_msg = _detect(capsys, scans, poses, rels,
                                           max_distance=0.5, min_index_gap=2)
    assert got == want == []
    assert "rejected closure 0 <- 2" in got_msg
    assert _numbers_masked(got_msg) == _numbers_masked(want_msg)
