"""The port's sequence odometry (``models/odometry.py``) against the JAX
package's: the 4-scan sequence of tests/test_odometry.py through both
packages (relative transforms within 1e-6 in float64 and 1e-4 in float32),
checkpoints that either package resumes, reports that stay aligned across a
resume, the staged target (``prepare_target(stage=True)``) equal to the
unstaged one, and the refusals (a bool device, a mesh that is not a
``parallel.Mesh``)."""
import json

import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core.params import RegistrationParams as JParams
from probabilistic_point_clouds_registration_tpu.models import odometry as j_odo
from probabilistic_point_clouds_registration_tpu_torch import (
    ProbabilisticRegistration,
    RegistrationParams,
)
from probabilistic_point_clouds_registration_tpu_torch.io.synthetic import (
    sequence_from_world,
    wave_grid,
)
from probabilistic_point_clouds_registration_tpu_torch.models import odometry as t_odo

# tests/test_odometry.py's parameters, on the grid engine in both packages
# (the JAX package's ``auto`` takes brute force here, ~4x slower on a CPU).
KW = dict(max_neighbours=10, radius=1.0, n_iter=12, cost_drop_thresh=0.003, search_impl="grid")


def _sequence(n_scans=4):
    """tests/test_odometry.py's wave-surface sequence."""
    return sequence_from_world(wave_grid(), 0.05, (0.15, -0.05, 0.02), n_scans)


def _both(scans, dtype, **run):
    want = j_odo.run_odometry(scans, JParams(**KW, dtype=dtype), **run.get("jax", {}))
    got = t_odo.run_odometry(scans, RegistrationParams(**KW, dtype=dtype), device="cpu",
                             **run.get("port", {}))
    return got, want


@pytest.mark.parametrize("dtype, atol", [("float64", 1e-6), ("float32", 1e-4)])
def test_sequence_matches_jax(dtype, atol):
    scans, gt = _sequence()
    got, want = _both(scans, dtype)
    assert len(got.relative_transforms) == len(want.relative_transforms) == 3
    for a, b in zip(got.relative_transforms, want.relative_transforms):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    for a, b in zip(got.reports, want.reports):
        assert len(a.splitlines()) == len(b.splitlines())  # the same iteration counts
    np.testing.assert_allclose(got.per_pair_cost, want.per_pair_cost, rtol=1e-4)
    assert got.inner_cap_hits == want.inner_cap_hits == 0
    assert got.engine_fallbacks == 0
    assert got.ate_rmse(gt) < 0.05
    assert len(got.prep_seconds) == len(got.prep_wait_seconds) == 3


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    scans, _ = _sequence()
    ckpt = tmp_path / "traj.json"
    first, second = (j_odo, t_odo) if writer == "jax" else (t_odo, j_odo)
    p32 = dict(KW, dtype="float32")
    if writer == "jax":
        partial = first.run_odometry(scans[:2], JParams(**p32), checkpoint_path=ckpt)
    else:
        partial = first.run_odometry(scans[:2], RegistrationParams(**p32), checkpoint_path=ckpt,
                                     device="cpu")
    assert json.loads(ckpt.read_text())["version"] == t_odo.CHECKPOINT_VERSION == 1
    counted = []
    on_pair = lambda i, p: counted.append(i)  # noqa: E731
    if writer == "jax":
        full = second.run_odometry(scans, RegistrationParams(**p32), checkpoint_path=ckpt,
                                   on_pair=on_pair, device="cpu")
    else:
        full = second.run_odometry(scans, JParams(**p32), checkpoint_path=ckpt, on_pair=on_pair)
    assert counted == [1, 2]
    np.testing.assert_array_equal(full.poses[1], partial.poses[1])
    assert full.reports[0] == partial.reports[0]
    loaded_t, loaded_j = t_odo.load_checkpoint(ckpt), j_odo.load_checkpoint(ckpt)
    for a, b in zip(loaded_t.poses, loaded_j.poses):
        np.testing.assert_array_equal(a, b)
    assert loaded_t.reports == loaded_j.reports and loaded_t.per_pair_cost == loaded_j.per_pair_cost


def test_resume_keeps_reports_aligned(tmp_path):
    scans, _ = _sequence()
    ckpt = tmp_path / "traj.json"
    params = RegistrationParams(**KW, dtype="float64")
    partial = t_odo.run_odometry(scans[:3], params, checkpoint_path=ckpt, device="cpu")
    assert len(partial.reports) == 2
    full = t_odo.run_odometry(scans, params, checkpoint_path=ckpt, device="cpu")
    assert len(full.reports) == len(full.relative_transforms) == len(full.per_pair_cost) == 3
    assert full.reports[:2] == partial.reports
    assert len(full.prep_seconds) == 1  # only the pair this run registered
    fresh = t_odo.run_odometry(scans, params, device="cpu")
    for a, b in zip(full.relative_transforms, fresh.relative_transforms):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("search_impl", ["pool", "auto"])
def test_staged_target_equals_unstaged_on_the_cpu(search_impl):
    """``stage=True`` builds the pool ahead of the ctor when the plan
    accepts the target (``pool``; ``auto`` on the CPU plans no pool); the
    registration is the same bit for bit."""
    scans, _ = _sequence(2)
    params = RegistrationParams(**dict(KW, search_impl=search_impl), dtype="float32")
    staged = ProbabilisticRegistration.prepare_target(scans[0], params, "cpu", stage=True)
    plain = ProbabilisticRegistration.prepare_target(scans[0], params, "cpu")
    assert ("pool_prepack" in staged) == (search_impl == "pool")
    assert "pool_prepack" not in plain
    regs = [ProbabilisticRegistration(scans[1], scans[0], params, prepared_target=p, device="cpu")
            for p in (staged, plain, None)]
    finals = [r.align() for r in regs]
    assert regs[0].engine == ("pool" if search_impl == "pool" else regs[1].engine)
    for reg, final in zip(regs[1:], finals[1:]):
        np.testing.assert_array_equal(final, finals[0])
        assert reg.report() == regs[0].report()


def test_jax_style_positional_stage_flag_fails_loudly():
    """The JAX package's ``prepare_target(scan, params, True)`` means
    "stage the device state"; here the third argument is the device, so a
    bool is refused, pointing to ``stage=``, before anything runs."""
    scans, _ = _sequence(1)
    params = RegistrationParams(**KW)
    for call in (lambda: ProbabilisticRegistration.prepare_target(scans[0], params, True),
                 lambda: ProbabilisticRegistration.prepare_target(scans[0], params, device=False)):
        with pytest.raises(TypeError, match="stage=True"):
            call()


def test_mesh_and_missing_card_are_refused():
    import torch

    scans, _ = _sequence(2)
    with pytest.raises(TypeError, match="pass a parallel.Mesh"):
        t_odo.run_odometry(scans, RegistrationParams(**KW), mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_odo.run_odometry(scans, RegistrationParams(**KW))
