"""Voxel-grid downsampling with PCL ``VoxelGrid`` semantics (a copy of the
JAX package's ``ops/voxel.py``, which imports no JAX).

The reference filters the source (into a separate cloud) and the target (in
place) with cubic leaves before registration
(src/prob_point_cloud_registration.cc:24-41). PCL semantics reproduced here:
one output point per occupied leaf = centroid of its points, leaves indexed
by ``floor(p / leaf)`` per axis, output ordered by ascending linear voxel
index (x fastest, then y, then z).

Host-side: this runs once per cloud before registration, through the native
library when it loads (``native/``), else through the numpy body below.
"""
from __future__ import annotations

import numpy as np


def voxel_downsample(points: np.ndarray, leaf_size: float) -> np.ndarray:
    """Centroid-per-occupied-voxel downsample; returns (m, 3) float array.

    ``leaf_size <= 0`` returns the input unchanged (the reference skips
    filtering for non-positive sizes, cc:24,34).
    """
    points = np.asarray(points)
    if leaf_size <= 0 or points.shape[0] == 0:
        return points.copy()

    from .. import native

    native_out = native.voxel_downsample(points, leaf_size)
    if native_out is not None:
        return native_out

    ijk = np.floor(points / float(leaf_size)).astype(np.int64)
    ijk -= ijk.min(axis=0)
    dims = ijk.max(axis=0) + 1
    lin = ijk[:, 0] + ijk[:, 1] * dims[0] + ijk[:, 2] * dims[0] * dims[1]

    uniq, inverse, counts = np.unique(lin, return_inverse=True, return_counts=True)
    sums = np.zeros((uniq.shape[0], 3), dtype=np.float64)
    np.add.at(sums, inverse, points.astype(np.float64))
    return (sums / counts[:, None]).astype(points.dtype)
