"""KITTI odometry dataset I/O (a copy of the JAX package's ``io/kitti.py``,
which imports no JAX).

BASELINE.json config #4 runs scan-to-scan odometry on KITTI Velodyne
sequences. The reference has no dataset loaders (PCD only, via PCL); these
cover the two KITTI file formats needed to drive the pipeline end-to-end:

  * Velodyne scans: raw little-endian float32 records (x, y, z, reflectance),
    file per scan (``000000.bin`` ...).
  * Ground-truth poses: one line per scan, 12 floats = row-major 3x4 [R | t]
    of the left-camera frame; converted to 4x4.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

import numpy as np


def load_velodyne_bin(path) -> np.ndarray:
    """(n, 3) xyz float32 from a KITTI Velodyne .bin scan (drops intensity)."""
    raw = np.fromfile(str(path), dtype=np.float32)
    if raw.size % 4:
        raise ValueError(f"{path}: size {raw.size} not a multiple of 4 floats")
    return raw.reshape(-1, 4)[:, :3].copy()


def list_velodyne_scans(directory) -> List[Path]:
    """Sorted .bin scan paths of a KITTI sequence directory."""
    return sorted(Path(directory).glob("*.bin"))


def load_poses(path) -> List[np.ndarray]:
    """KITTI ground-truth poses file -> list of 4x4 numpy matrices."""
    poses = []
    for line in Path(path).read_text().splitlines():
        vals = [float(v) for v in line.split()]
        if not vals:
            continue
        if len(vals) != 12:
            raise ValueError(f"pose line has {len(vals)} values, expected 12")
        m = np.eye(4)
        m[:3, :4] = np.asarray(vals).reshape(3, 4)
        poses.append(m)
    return poses


def load_calibration(path) -> np.ndarray:
    """4x4 ``Tr`` (Velodyne -> left camera) from a KITTI odometry calib.txt.

    KITTI ground-truth poses live in the left-camera frame while scans are
    Velodyne-frame; compare trajectories via
    ``P_velo = Tr^-1 @ P_cam @ Tr`` (see :func:`camera_poses_to_velodyne`).
    """
    for line in Path(path).read_text().splitlines():
        if line.startswith("Tr:") or line.startswith("Tr "):
            vals = [float(v) for v in line.split()[1:]]
            if len(vals) != 12:
                raise ValueError(f"calib Tr line has {len(vals)} values, expected 12")
            m = np.eye(4)
            m[:3, :4] = np.asarray(vals).reshape(3, 4)
            return m
    raise ValueError(f"no 'Tr:' line in {path}")


def camera_poses_to_velodyne(poses: Sequence[np.ndarray], tr: np.ndarray):
    """Re-express left-camera-frame poses in the Velodyne frame.

    Without this, comparing Velodyne odometry against raw KITTI ground truth
    mixes axes conventions (camera z-forward/y-down vs Velodyne x-forward/
    z-up) and the ATE is meaningless.
    """
    tr_inv = np.linalg.inv(tr)
    return [tr_inv @ np.asarray(p, dtype=np.float64) @ tr for p in poses]


def save_poses(path, poses: Sequence[np.ndarray]) -> None:
    """Write 4x4 poses in the KITTI 12-float row-major [R | t] format."""
    with open(path, "w") as f:
        for m in poses:
            f.write(" ".join(f"{v:.9e}" for v in np.asarray(m)[:3, :4].ravel()))
            f.write("\n")
