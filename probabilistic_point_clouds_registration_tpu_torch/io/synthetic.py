"""Synthetic point-cloud generators for tests and benchmarks."""
from __future__ import annotations

import numpy as np


def wave_grid(width: int = 30, height: int = 50, spacing: float = 0.5, dtype=np.float64):
    """The smooth z = sin(x) + cos(y) surface grid.

    Same fixture as the reference's solver integration tests
    (test/PointCloudRegistrationTest.cc:12-28): ``width`` x ``height`` points
    with the given spacing.
    """
    xs = np.arange(width, dtype=dtype) * spacing
    ys = np.arange(height, dtype=dtype) * spacing
    x, y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([x, y, np.sin(x) + np.cos(y)], axis=-1).reshape(-1, 3)
    return np.ascontiguousarray(pts, dtype=dtype)


def random_cloud(n: int, *, scale: float = 10.0, seed: int = 0, dtype=np.float64):
    """Uniform random cloud in a cube of side ``scale``."""
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)) * scale).astype(dtype)


def bunny_like(n: int = 35_000, *, seed: int = 0, dtype=np.float64):
    """A bunny-scale benchmark stand-in: noisy multi-lobe surface, ~n points.

    The repo ships no datasets (reference likewise ships none); this produces
    a surface-like cloud with the Stanford-Bunny point count used by
    BASELINE.json config #1.
    """
    rng = np.random.default_rng(seed)
    theta = rng.random(n) * 2 * np.pi
    phi = np.arccos(2 * rng.random(n) - 1)
    r = 1.0 + 0.25 * np.sin(4 * theta) * np.sin(3 * phi) + 0.02 * rng.standard_normal(n)
    pts = np.stack(
        [r * np.sin(phi) * np.cos(theta), r * np.sin(phi) * np.sin(theta), r * np.cos(phi)],
        axis=-1,
    )
    return pts.astype(dtype)


def kitti_like(n: int = 131_072, *, seed: int = 0, dtype=np.float64):
    """Deterministic LiDAR-like outdoor scan (~KITTI Velodyne statistics).

    ~75% ground returns with ring-style 1/range density over a ~150 m disk
    (slightly undulating ground), ~25% vertical structure (building faces /
    poles) clustered at random azimuths — reproduces the occupancy profile
    that drives the sparse-grid engine paths (mean cell occupancy ~1 at a
    0.5 m cell, large dense LUT), unlike the surface-dense `bunny_like`.
    """
    rng = np.random.default_rng(seed)
    n_ground = int(n * 0.75)
    n_struct = n - n_ground

    # Ground: radius sampled so areal density falls ~1/r (ring spacing grows
    # with range), azimuth uniform.
    r = 2.0 + 73.0 * rng.random(n_ground) ** 2.0
    az = rng.uniform(0, 2 * np.pi, n_ground)
    gx = r * np.cos(az)
    gy = r * np.sin(az)
    gz = (
        0.3 * np.sin(gx * 0.05) * np.cos(gy * 0.04)
        + rng.normal(scale=0.02, size=n_ground)
    )
    ground = np.stack([gx, gy, gz], axis=1)

    # Structure: vertical planes/poles at clustered azimuth+range anchors.
    n_anchor = 40
    anchor_r = rng.uniform(5, 70, n_anchor)
    anchor_az = rng.uniform(0, 2 * np.pi, n_anchor)
    ax = anchor_r * np.cos(anchor_az)
    ay = anchor_r * np.sin(anchor_az)
    which = rng.integers(0, n_anchor, n_struct)
    normal_az = anchor_az[which] + rng.normal(scale=0.1, size=n_struct)
    along = rng.uniform(-4, 4, n_struct)
    sx = ax[which] + along * np.cos(normal_az + np.pi / 2)
    sy = ay[which] + along * np.sin(normal_az + np.pi / 2)
    sz = rng.uniform(0.0, 6.0, n_struct)
    jitter = rng.normal(scale=0.03, size=(n_struct, 3))
    struct = np.stack([sx, sy, sz], axis=1) + jitter

    cloud = np.concatenate([ground, struct])[rng.permutation(n)]
    return cloud.astype(dtype)


def transform_cloud(points: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to an (n, 3) numpy cloud."""
    r = matrix[:3, :3]
    t = matrix[:3, 3]
    return points @ r.T + t


# ---------------------------------------------------------------------------
# Sequences, loops and pose graphs (the workloads of the sequence entry
# points; the JAX package's benchmarks/common.py, tests/test_loop_closure.py
# and tests/test_pose_graph.py build the same ones).
# ---------------------------------------------------------------------------


def _rot_z(theta: float) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = [
        [np.cos(theta), -np.sin(theta), 0.0],
        [np.sin(theta), np.cos(theta), 0.0],
        [0.0, 0.0, 1.0],
    ]
    return m


def sequence_from_world(world: np.ndarray, theta: float, translation, n_scans: int):
    """Scans of a static world from a sensor moving by a fixed SE(3) step
    (``theta`` about z, then ``translation``): (scans, ground-truth poses)."""
    delta = _rot_z(theta)
    delta[:3, 3] = translation
    pose = np.eye(4)
    scans, poses = [], []
    for _ in range(n_scans):
        inv = np.linalg.inv(pose)
        scans.append(world @ inv[:3, :3].T + inv[:3, 3])
        poses.append(pose.copy())
        pose = pose @ delta
    return scans, poses


def kitti_sequence(n_scans: int, n_points: int = 131_072, seed: int = 0):
    """LiDAR-like scan sequence: a ``kitti_like`` world seen from a sensor
    moving 0.8 m / 0.01 rad per step (KITTI-like ego-motion at 10 Hz)."""
    return sequence_from_world(kitti_like(n_points, seed=seed), 0.01, [0.8, 0.1, 0.02], n_scans)


def square_loop(world: np.ndarray, step: float):
    """A sensor walking a square of two ``step`` moves a side and back to
    the start: (9 scans, 9 ground-truth poses, the 8 moves)."""
    gt = [np.eye(4)]
    moves = []
    for d in ([step, 0, 0], [step, 0, 0], [0, step, 0], [0, step, 0],
              [-step, 0, 0], [-step, 0, 0], [0, -step, 0], [0, -step, 0]):
        m = np.eye(4)
        m[:3, 3] = d
        moves.append(m)
        gt.append(gt[-1] @ m)
    scans = []
    for pose in gt:
        inv = np.linalg.inv(pose)
        scans.append(world @ inv[:3, :3].T + inv[:3, 3])
    return scans, gt, moves


def drifted_moves(moves, seed: int = 0, scale: float = 0.02):
    """Odometry of ``moves`` with Gaussian translation noise per step, and
    the poses it integrates to: (relative transforms, poses)."""
    rng = np.random.default_rng(seed)
    noisy = []
    for m in moves:
        d = np.eye(4)
        d[:3, 3] = m[:3, 3] + rng.normal(scale=scale, size=3)
        noisy.append(d)
    poses = [np.eye(4)]
    for m in noisy:
        poses.append(poses[-1] @ m)
    return noisy, poses


def circle_trajectory(n: int, radius: float = 5.0, lap: int | None = None):
    """Ground-truth poses on a circle, ``lap`` poses a lap (default ``n``:
    one lap), heading along the tangent."""
    lap = n if lap is None else lap
    poses = []
    for k in range(n):
        a = 2 * np.pi * k / lap
        m = _rot_z(a)
        m[:3, 3] = [radius * np.cos(a), radius * np.sin(a), 0.0]
        poses.append(m)
    return poses


def noisy_odometry(gt_poses, seed: int = 0, rot_noise: float = 0.01, t_noise: float = 0.02):
    """Relative transforms between consecutive ground-truth poses, each
    perturbed by a random yaw and translation."""
    rng = np.random.default_rng(seed)
    rels = []
    for k in range(len(gt_poses) - 1):
        rel = np.linalg.inv(gt_poses[k]) @ gt_poses[k + 1]
        noise = _rot_z(rng.normal(scale=rot_noise))
        noise[:3, 3] = rng.normal(scale=t_noise, size=3)
        rels.append(rel @ noise)
    return rels
