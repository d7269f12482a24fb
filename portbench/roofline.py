"""The radius search's least time on one NVIDIA H100, from the inputs alone.

Bytes and operations are counted from the cell's inputs and parameters,
never from the program's pool plan, class widths, layout or launch
arguments, so that whatever implements the search later reads against the
same work. Per outer iteration:

  * each live source row is read once (3 float32 = 12 B);
  * each target within ``radius`` of that row is read once (12 B);
  * the row's ``k`` neighbour slots are written once, each as
    (id, d2, xyz) = 20 B;
  * 8 float32 operations per in-radius distance (3 subtractions,
    3 multiplications, 2 additions).

Any exact radius search does at least this much, so the count is a lower
bound on its work. These are computed, not measured, bytes. The least time
is the larger of bytes over the peak bandwidth and operations over the
peak float32 rate, NVIDIA's data sheet for the H100 SXM at its 700 W limit.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
POINT_BYTES = 12
SLOT_BYTES = 20
OPS_PER_DISTANCE = 8


def search_work(in_radius: np.ndarray, k: int) -> tuple[float, float]:
    """(bytes, float32 operations) of one search, given each live source
    row's number of targets within the radius."""
    counts = np.asarray(in_radius, dtype=np.float64)
    rows = counts.size
    pairs = float(counts.sum())
    return rows * POINT_BYTES + pairs * POINT_BYTES + rows * k * SLOT_BYTES, \
        OPS_PER_DISTANCE * pairs


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
