"""The frozen generators equal the port's today, and a drive's pairs all
differ."""
import numpy as np
import pytest

from portbench.gen import drive
from portbench.gen import synthetic as frozen
from probabilistic_point_clouds_registration_tpu_torch.io import synthetic as port


@pytest.mark.parametrize("seed", [0, 2**32 + 17])
@pytest.mark.parametrize("name,n", [("bunny_like", 3000), ("kitti_like", 5000)])
def test_cloud_generators_equal_the_ports(name, n, seed):
    np.testing.assert_array_equal(getattr(frozen, name)(n, seed=seed),
                                  getattr(port, name)(n, seed=seed))


DRIVE = dict(world_seed=0, world_ratio=1.5, range_m=120.0, ground_range_m=50.0, ground_height_m=0.4,
             noise_m=0.02, forward_m=[0.6, 1.0], yaw_rad=[0.0, 0.02], lateral_m=0.1,
             vertical_m=0.02)


def _steps(poses):
    return [np.linalg.inv(a) @ b for a, b in zip(poses, poses[1:])]


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_a_drives_consecutive_pairs_differ(seed):
    scans, poses = drive.drive(8, 3000, seed, **DRIVE)
    assert all(s.shape == (3000, 3) for s in scans)
    fwd = [d[0, 3] for d in _steps(poses)]
    assert all(0.6 - 1e-12 <= f <= 1.0 + 1e-12 for f in fwd)
    # Two consecutive steps differ by at least half the range's width.
    assert min(abs(a - b) for a, b in zip(fwd, fwd[1:])) >= 0.2 - 1e-12
    # No two scans share a point: each is a fresh, noisy draw.
    assert not np.isin(scans[1] @ poses[1][:3, :3].T + poses[1][:3, 3], scans[0]).any()
    again, _ = drive.drive(8, 3000, seed, **DRIVE)
    assert all(np.array_equal(a, b) for a, b in zip(scans, again))


def test_every_seed_drives_the_same_step_sizes():
    a = sorted(d[0, 3] for d in drive.steps(39, 1, **{k: DRIVE[k] for k in
                                                     ("forward_m", "yaw_rad", "lateral_m",
                                                      "vertical_m")}))
    b = sorted(d[0, 3] for d in drive.steps(39, 2**33 + 7, **{k: DRIVE[k] for k in
                                                              ("forward_m", "yaw_rad",
                                                               "lateral_m", "vertical_m")}))
    np.testing.assert_allclose(a, b)
