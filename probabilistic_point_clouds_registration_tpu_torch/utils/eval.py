"""Evaluation / metric utilities (port of the JAX package's
``utils/eval.py``).

Re-creation of the reference's benchmark-evaluation toolkit
(include/prob_point_cloud_registration/utilities.hpp:16-263) with identical
numerics, including its quirks, so trajectory/ATE comparisons against the
reference are apples-to-apples:

* ``calculate_mse`` is — despite the name — the **mean Euclidean (non-squared)
  distance** between index-aligned clouds (utilities.hpp:16-26). It is the
  ground-truth metric of the whole pipeline.
* Every kd-tree-based statistic operates on FLANN's **squared** NN distances
  (pcl::KdTreeFLANN returns squared L2), e.g. ``averageClosestDistance``
  actually averages squared distances. Reproduced as-is.
* The reference's median picks element ``(n+1)/2`` for odd n and averages
  elements ``n/2`` and ``n/2+1`` for even n (utilities.hpp:83-88) — one past
  the textbook median on both branches. Reproduced as-is (helper
  ``_reference_median``).

The nearest-neighbor queries run the tiled search of ``ops/neighbors.py``
in float64 on ``device`` (a CUDA device unless the caller asks for the
CPU); inputs are arrays of shape (n, 3).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.neighbors import nearest_neighbor
from .device import resolve_device


def calculate_mse(cloud1, cloud2) -> float:
    """Mean Euclidean distance between index-aligned clouds (utilities.hpp:16-26)."""
    a = np.asarray(cloud1, dtype=np.float64)
    b = np.asarray(cloud2, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError("calculate_mse requires index-aligned clouds")
    return float(np.mean(np.linalg.norm(a - b, axis=1)))


def _nn_sq_dists(cloud1, cloud2, device="cuda") -> np.ndarray:
    """Squared distance from each point of cloud1 to its nearest in cloud2."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(cloud1, dtype=np.float64), device=dev)
    b = torch.as_tensor(np.asarray(cloud2, dtype=np.float64), device=dev)
    _, sq, _ = nearest_neighbor(a, b)
    return sq.cpu().numpy()


def _reference_median(values: np.ndarray) -> float:
    """The reference's (off-by-one) median (utilities.hpp:83-88).

    The reference's indexing is out-of-bounds UB in C++ for n <= 2; here the
    indices are clamped so tiny inputs return a sane value instead of
    crashing (n >= 3 reproduces the reference exactly).
    """
    v = np.sort(np.asarray(values, dtype=np.float64))
    n = v.shape[0]
    if n == 0:
        return float("nan")
    if n % 2 != 0:
        return float(v[min((n + 1) // 2, n - 1)])
    return float((v[n // 2] + v[min(n // 2 + 1, n - 1)]) / 2.0)


def average_closest_distance(cloud1, cloud2, device="cuda") -> float:
    """Mean squared 1-NN distance (utilities.hpp:28-45; FLANN distances are squared)."""
    return float(_nn_sq_dists(cloud1, cloud2, device).mean())


def sum_squared_error(cloud1, cloud2, device="cuda") -> float:
    """Sum of squared 1-NN distances (utilities.hpp:47-63)."""
    return float(_nn_sq_dists(cloud1, cloud2, device).sum())


def robust_sum_squared_error(cloud1, cloud2, factor: float = 3.0, device="cuda") -> float:
    """Median-band filtered sum of squared 1-NN distances (utilities.hpp:65-137).

    Keeps distances within [median/factor, median*factor]; returns float max
    (the reference's DBL_MAX sentinel) if fewer than 10 survive.
    """
    d = _nn_sq_dists(cloud1, cloud2, device)
    med = _reference_median(d)
    keep = (d <= med * factor) & (d >= med / factor)
    if keep.sum() < 10:
        return float(np.finfo(np.float64).max)
    return float(d[keep].sum())


def robust_averaged_sum_squared_error(cloud1, cloud2, device="cuda") -> float:
    """Mean over the median-band-filtered squared distances (utilities.hpp:139-174)."""
    d = _nn_sq_dists(cloud1, cloud2, device)
    med = _reference_median(d)
    keep = (d <= med * 3.0) & (d >= med / 3.0)
    if keep.sum() < 10:
        return float(np.finfo(np.float64).max)
    return float(d[keep].sum() / keep.sum())


def median_closest_distance(cloud1, cloud2, device="cuda") -> float:
    """Reference-median of squared 1-NN distances (utilities.hpp:176-198)."""
    return _reference_median(_nn_sq_dists(cloud1, cloud2, device))


def robust_median_closest_distance(cloud1, cloud2, device="cuda") -> float:
    """Band-filtered re-median, divided by the survivor count
    (utilities.hpp:200-234 — the division is part of the reference metric)."""
    d = _nn_sq_dists(cloud1, cloud2, device)
    med = _reference_median(d)
    keep = d[(d <= med * 3.0) & (d >= med / 3.0)]
    return _reference_median(keep) / keep.shape[0]


def median_distance(sq_dists, mask=None) -> float:
    """Reference-median over an association table's stored (squared) search
    distances (utilities.hpp:236-250 operates on the triplet values)."""
    d = np.asarray(sq_dists, dtype=np.float64)
    if mask is not None:
        d = d[np.asarray(mask, dtype=bool)]
    return _reference_median(d.ravel())


def ate_rmse(trajectory_a, trajectory_b) -> float:
    """Absolute trajectory error (RMSE over translation components).

    Not in the reference (which compares per-pair aligned-cloud MSE
    instead); for sequence runs.
    """
    ta = np.asarray([m[:3, 3] for m in trajectory_a], dtype=np.float64)
    tb = np.asarray([m[:3, 3] for m in trajectory_b], dtype=np.float64)
    if ta.shape != tb.shape:
        raise ValueError("ate_rmse requires trajectories of the same length")
    return float(np.sqrt(np.mean(np.sum((ta - tb) ** 2, axis=1))))
