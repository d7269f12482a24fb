"""Frozen copies of the port's synthetic generators (``io/synthetic.py``):
``bunny_like``, ``kitti_like`` and the helper ``_rot_z``, copied line for
line so that the benchmark's inputs cannot move when the
program's generators change. A test holds each copy equal to the port's
function at two seeds, for as long as the two agree.
"""
from __future__ import annotations

import numpy as np


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


def _rot_z(theta: float) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = [
        [np.cos(theta), -np.sin(theta), 0.0],
        [np.sin(theta), np.cos(theta), 0.0],
        [0.0, 0.0, 1.0],
    ]
    return m
