"""Host-side target hash grid (numpy; copied from the JAX package's
``ops/grid.py`` so that every table compares equal).

The target is bucketed into a voxel grid of cell size = search radius ONCE
per registration; a source's in-radius neighbors all lie in its 3x3x3 cell
neighborhood. The fused engine (ops/fused_grid.py) prepacks candidate
windows from these tables; the pooled engine (ops/fused_pool.py) reads only
the cell-sorted view (``buckets=False``). The JAX package's device grid engine
(``grid_radius_search``, ``merge_overflow``) is not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..core.types import bucket_rows, pow2, round_up

_INT32_MAX = 2**31 - 1
# Dense cell->bucket LUT cap: 32M cells = 128 MB of int32.
_MAX_DENSE_LUT_CELLS = 1 << 25


def _quantize_capacity(cap: int) -> int:
    """Bucket capacity for a max cell occupancy of ``cap``: next power of
    two (>= 8)."""
    return max(8, 1 << (cap - 1).bit_length())


def build_grid_host(
    target: np.ndarray,
    cell_size: float,
    *,
    num_valid: int | None = None,
    max_overflow: int = 0,
    buckets: bool = True,
) -> dict | None:
    """Host-side grid build: all numpy.

    Returns a dict of grid tables, or None when a grid would be invalid or
    useless: degenerate cell size, a grid whose linear id overflows int32,
    or occupancy so high that 27 * capacity >= M (brute force is cheaper).

    ``max_overflow`` > 0 enables quantile capacity under pathological
    occupancy skew: capacity is then the smallest power of two whose
    clipped-out points number at most ``max_overflow``, and those points
    land in ``overflow_pts``/``overflow_idx``.

    ``buckets=False`` skips the (U, capacity[, 3]) bucket tensors, the
    overflow split and the dense LUT; :func:`add_buckets_host` fills them in
    place later.
    """
    target = np.asarray(target, dtype=np.float64)
    m_total = target.shape[0]
    n = num_valid if num_valid is not None else m_total
    if n == 0 or cell_size <= 0 or not np.isfinite(cell_size):
        return None
    pts = target[:n]

    origin = pts.min(axis=0)
    ijk = np.floor((pts - origin) / cell_size).astype(np.int64)
    dims = ijk.max(axis=0) + 1
    if int(dims[0]) * int(dims[1]) * int(dims[2]) >= _INT32_MAX:
        return None
    lin = ijk[:, 0] + dims[0] * (ijk[:, 1] + dims[1] * ijk[:, 2])

    order = np.argsort(lin, kind="stable")
    lin_sorted = lin[order]
    cell_ids, start, counts = np.unique(
        lin_sorted, return_index=True, return_counts=True
    )
    capacity = _quantize_capacity(int(counts.max()))
    if max_overflow > 0:
        # Engage the overflow cap only under pathological occupancy skew.
        hot_cap = _quantize_capacity(int(np.ceil(8 * np.percentile(counts, 99))))
        if capacity > hot_cap or 27 * capacity >= max(n, 1):
            cap = 8
            while cap < capacity and np.maximum(counts - cap, 0).sum() > max_overflow:
                cap *= 2
            capacity = min(cap, capacity)
    if 27 * capacity >= max(n, 1):
        return None  # occupancy too high for the grid to pay off

    u = cell_ids.shape[0]
    # Bucketed occupied-cell count; pad rows are empty cells (idx -1, cell
    # id = dims_prod, one past any real id). "num_cells" is the real count.
    dims_prod = int(dims[0]) * int(dims[1]) * int(dims[2])
    u_pad = bucket_rows(u)
    cell_ids_pad = np.full((u_pad,), dims_prod, dtype=np.int32)
    cell_ids_pad[:u] = cell_ids
    start_pad = np.full((u_pad,), n, dtype=np.int32)
    start_pad[:u] = start
    counts_pad_arr = np.zeros((u_pad,), dtype=np.int32)
    counts_pad_arr[:u] = counts
    out = {
        "cell_ids": cell_ids_pad,
        "num_cells": u,
        "capacity": capacity,
        "origin": origin,
        "dims": dims.astype(np.int32),
        "cell_size": float(cell_size),
        "num_valid": n,
        # Cell-sorted view of the target (stable sort by linear cell id, so
        # within-cell order == bucket slot order).
        "sort_order": order.astype(np.int32),
        "cell_start": start_pad,
        "cell_count": counts_pad_arr,
        "_target_dtype": target.dtype,
    }
    if buckets:
        add_buckets_host(out, target)
    return out


def add_buckets_host(grid: dict, target: np.ndarray) -> dict:
    """Materialize the bucket tensors / overflow split / dense LUT a
    ``buckets=False`` build skipped (in place; idempotent)."""
    if "bucket_idx" in grid:
        return grid
    target = np.asarray(target, dtype=grid.get("_target_dtype", np.float64))
    n = grid["num_valid"]
    pts = target[:n]
    u = grid["num_cells"]
    u_pad = grid["cell_ids"].shape[0]
    capacity = grid["capacity"]
    order = grid["sort_order"]
    start = grid["cell_start"][:u].astype(np.int64)
    counts = grid["cell_count"][:u].astype(np.int64)
    dims = grid["dims"].astype(np.int64)
    dims_prod = int(dims[0]) * int(dims[1]) * int(dims[2])
    cell_ids = grid["cell_ids"][:u]

    # Points past ``capacity`` within their cell become overflow.
    cell_row = np.repeat(np.arange(u), counts)
    slot_of = np.arange(n) - np.repeat(start, counts)
    in_cap = slot_of < capacity
    bucket_idx = np.full((u_pad, capacity), -1, dtype=np.int32)
    bucket_idx[cell_row[in_cap], slot_of[in_cap]] = order[in_cap].astype(
        np.int32
    )
    bucket_pts = np.zeros((u_pad, capacity, 3), dtype=target.dtype)
    live = bucket_idx >= 0
    bucket_pts[live] = pts[bucket_idx[live]]
    grid["bucket_pts"] = bucket_pts
    grid["bucket_idx"] = bucket_idx
    n_over = int((~in_cap).sum())
    if n_over:
        op = round_up(n_over, 128)
        ov_rows = order[~in_cap]
        overflow_idx = np.full((op,), -1, dtype=np.int32)
        overflow_idx[:n_over] = ov_rows.astype(np.int32)
        overflow_pts = np.zeros((op, 3), dtype=target.dtype)
        overflow_pts[:n_over] = pts[ov_rows]
        grid["overflow_pts"] = overflow_pts
        grid["overflow_idx"] = overflow_idx
    if dims_prod <= _MAX_DENSE_LUT_CELLS:
        lut_np = np.full((pow2(dims_prod),), -1, dtype=np.int32)
        lut_np[cell_ids] = np.arange(u, dtype=np.int32)
        grid["lut"] = lut_np
    return grid
