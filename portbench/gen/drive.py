"""A drive: scans of one static world from a moving LiDAR, each scan a
fresh sample of what the sensor sees, so that no two pairs of a sequence
are the same registration.

The world is one ``kitti_like`` scene (``synthetic.kitti_like`` at
``world_seed``, the same for every seed: the route) of ``world_ratio`` x
``n_points`` points. At each pose the sensor sees the
world within its range (``ground_range_m`` for returns below
``ground_height_m``, the pavement; ``range_m`` for the rest), keeps
``n_points`` of those points drawn afresh, and reads each with Gaussian
noise of ``noise_m`` a coordinate. Every scan holds ``n_points`` points,
so every pair has the same shapes.

The ego-motion varies from step to step: a step moves ``forward_m`` (a
[low, high] range) along x and turns ``yaw_rad`` (a [low, high] range)
about z, with ``lateral_m`` and ``vertical_m`` fixed. Forward steps
alternate between the range's lower and upper quarter, so two consecutive
steps differ by at least half of its width; the yaw alternates the same
way, out of phase. The step sizes of a sequence are a fixed set, in an
order drawn from the seed: every seed drives the same distances through
the same world, and draws its own points, noise and order of steps.
"""
from __future__ import annotations

import numpy as np

from .synthetic import _rot_z, kitti_like


def _alternating(n: int, low: float, high: float, rng, phase: int) -> np.ndarray:
    """``n`` values alternating between [low, low + w/4] and
    [high - w/4, high] (w = high - low); each quarter's values a fixed set,
    in an order drawn from ``rng``."""
    quarter = (high - low) / 4.0
    up = (np.arange(n) + phase) % 2 == 1
    out = np.empty(n)
    out[~up] = low + rng.permutation(np.linspace(0.0, quarter, int((~up).sum())))
    out[up] = high - rng.permutation(np.linspace(0.0, quarter, int(up.sum())))
    return out


def steps(n: int, seed: int, *, forward_m, yaw_rad, lateral_m: float,
          vertical_m: float) -> list:
    """The ``n`` SE(3) steps of a drive (4x4, the sensor's motion in its
    own frame)."""
    rng = np.random.default_rng([seed, 1])
    fwd = _alternating(n, *forward_m, rng, phase=0)
    yaw = _alternating(n, *yaw_rad, rng, phase=1)
    out = []
    for f, y in zip(fwd, yaw):
        d = _rot_z(float(y))
        d[:3, 3] = [f, lateral_m, vertical_m]
        out.append(d)
    return out


def drive(n_scans: int, n_points: int, seed: int, *, world_seed: int, world_ratio: float,
          range_m: float, ground_range_m: float, ground_height_m: float, noise_m: float,
          forward_m, yaw_rad, lateral_m: float, vertical_m: float):
    """(scans, ground-truth poses) of a drive; each scan (n_points, 3)
    float64 in the sensor's frame, pose[0] = I."""
    world = kitti_like(int(round(world_ratio * n_points)), seed=world_seed)
    limit = np.where(world[:, 2] < ground_height_m, ground_range_m, range_m)
    rng = np.random.default_rng([seed, 2])
    pose = np.eye(4)
    scans, poses = [], []
    for step in steps(n_scans, seed, forward_m=forward_m, yaw_rad=yaw_rad,
                      lateral_m=lateral_m, vertical_m=vertical_m):
        seen = np.flatnonzero(np.linalg.norm(world - pose[:3, 3], axis=1) <= limit)
        if seen.size < n_points:
            raise ValueError(f"the sensor sees {seen.size} points, under the {n_points} a "
                             f"scan holds: raise world_ratio")
        pts = world[np.sort(rng.choice(seen, size=n_points, replace=False))]
        pts = pts + rng.normal(scale=noise_m, size=pts.shape)
        inv = np.linalg.inv(pose)
        scans.append(pts @ inv[:3, :3].T + inv[:3, 3])
        poses.append(pose.copy())
        pose = pose @ step
    return scans, poses
