"""Dense, static-shape data structures (port of the JAX package's
``core/types.py``).

The reference stores data association as a row-major sparse matrix whose
*structure* (not values) drives the EM weight update
(src/prob_point_cloud_registration.cc:69-83, probabilistic_weights.hpp:48-105).
Here it is a dense padded ``(N, K)`` neighbor table: indices, squared
distances and a validity mask, with masked semantics identical to the
sparse ones (a masked slot contributes nothing, like an absent sparse entry).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Correspondences(NamedTuple):
    """Padded (N, K) data-association table.

    Attributes:
      indices: int32 (N, K) target indices; 0 where invalid.
      sq_dists: (N, K) squared search distances (diagnostic; like the sparse
        values in the reference, never consumed by the weight math).
      mask: bool (N, K); True where a real association exists.
    """

    indices: torch.Tensor
    sq_dists: torch.Tensor
    mask: torch.Tensor


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pow2(n: int) -> int:
    """Smallest power of two >= n (>= 2)."""
    return 1 << (max(int(n), 2) - 1).bit_length()


def bucket_rows(n: int, floor: int = 64, step_bits: int = 4) -> int:
    """Round ``n`` up at pow2 / 2**(step_bits-1) granularity (>= ``floor``;
    the default is ~12.5% steps). Kept identical to the JAX package so that
    every padded size, and with it every intermediate, compares equal."""
    n = max(int(n), floor)
    q = max(floor, 1 << max(n.bit_length() - step_bits, 0))
    return round_up(n, q)


def pad_cloud(points: np.ndarray, multiple: int, pad_value: float = np.inf):
    """Pad an (n, 3) cloud to (round_up(n, multiple), 3).

    Returns (padded_points, n_valid). Padding rows are ``pad_value``.
    """
    points = np.asarray(points)
    n = points.shape[0]
    n_pad = round_up(max(n, 1), multiple)
    if n_pad == n:
        return points, n
    padded = np.full((n_pad, points.shape[1]), pad_value, dtype=points.dtype)
    padded[:n] = points
    return padded, n


def valid_mask(n_total: int, n_valid: int, dtype=torch.bool, device=None):
    """(n_total,) mask with the first ``n_valid`` entries True."""
    return (torch.arange(n_total, device=device) < n_valid).to(dtype)
