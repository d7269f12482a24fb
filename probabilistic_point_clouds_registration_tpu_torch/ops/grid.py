"""Spatial-hash-grid radius search (port of the JAX package's
``ops/grid.py``): the host-side grid build (numpy; copied so that every
table compares equal) and the device search against it.

The target is bucketed into a voxel grid of cell size = search radius ONCE
per registration; a source's in-radius neighbors all lie in its 3x3x3 cell
neighborhood. Every outer iteration then queries the static grid on the
device:

  1. each (moved) source point maps to its cell,
  2. the 27 neighbor cells resolve to bucket rows through a dense
     linear-cell-id -> bucket table (``torch.searchsorted`` over the sorted
     occupied-cell ids for grids too large to materialize densely),
  3. candidate coordinates come from a (U, capacity, 3) padded bucket
     tensor, so the gather moves whole buckets,
  4. one k-selection over (S, 27 * capacity) candidates per source block
     (the CUDA row top-k kernel B2 on a GPU, ops/select_pallas.py).

Neighbor sets equal brute force's (up to distance ties at the k-th slot).
This engine is what the pooled and fused engines fall back to. The fused
engine (ops/fused_grid.py) prepacks candidate windows from the host tables;
the pooled engine (ops/fused_pool.py) reads only the cell-sorted view
(``buckets=False``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.types import Correspondences, bucket_rows, pow2, round_up

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


class HashGrid(NamedTuple):
    """Static-shape target voxel grid (device tensors; built host-side).

    Attributes:
      bucket_pts: (U, capacity, 3) padded per-cell member coordinates.
      bucket_idx: (U, capacity) original target index per slot; -1 = padding.
      cell_ids: (U,) sorted linear ids of occupied cells (the searchsorted
        fallback when ``lut`` is None).
      capacity: quantile-capped cell occupancy, pow2-quantized.
      origin: (3,) grid origin (min corner of the target bbox).
      dims: (3,) int32 grid dimensions.
      cell_size: cell edge length (== search radius).
      num_valid: number of real (non-padding) target points.
      lut: int32 dense linear-cell-id -> occupied-cell row (-1 = empty), or
        None for grids too large to materialize densely.
      overflow_pts / overflow_idx: points of cells hotter than ``capacity``
        ((Op, 3) coords + (Op,) original rows, -1 = padding), searched by a
        streaming brute pass and merged into the top-k; None when empty.
    """

    bucket_pts: torch.Tensor
    bucket_idx: torch.Tensor
    cell_ids: torch.Tensor
    capacity: int
    origin: torch.Tensor
    dims: torch.Tensor
    cell_size: float
    num_valid: int
    lut: torch.Tensor | None
    overflow_pts: torch.Tensor | None = None
    overflow_idx: torch.Tensor | None = None


def grid_to_device(grid: dict, dtype, device) -> HashGrid:
    """Upload a host grid (with its bucket tensors) as a :class:`HashGrid`;
    coordinates in numpy dtype ``dtype``."""

    def up(name, cast=None):
        if name not in grid:
            return None
        arr = grid[name] if cast is None else grid[name].astype(cast)
        return torch.as_tensor(arr, device=device)

    return HashGrid(
        bucket_pts=up("bucket_pts", dtype),
        bucket_idx=up("bucket_idx"),
        cell_ids=up("cell_ids"),
        capacity=grid["capacity"],
        origin=up("origin", dtype),
        dims=up("dims"),
        cell_size=grid["cell_size"],
        num_valid=grid["num_valid"],
        lut=up("lut"),
        overflow_pts=up("overflow_pts", dtype),
        overflow_idx=up("overflow_idx"),
    )


def build_grid(
    target: np.ndarray,
    cell_size: float,
    *,
    num_valid: int | None = None,
    max_overflow: int = 0,
    device: str | torch.device = "cuda",
):
    """Build a :class:`HashGrid` over the target cloud on ``device``, in the
    target array's dtype (float64 for other dtypes).

    See :func:`build_grid_host` for the build itself and the None conditions.
    """
    target = np.asarray(target)
    if target.dtype not in (np.float32, np.float64):
        target = target.astype(np.float64)
    g = build_grid_host(
        target, cell_size, num_valid=num_valid, max_overflow=max_overflow
    )
    if g is None:
        return None
    return grid_to_device(g, target.dtype, device)


def merge_overflow(
    corr: Correspondences,
    source,
    overflow_pts,
    overflow_idx,
    *,
    k: int,
    radius: float,
    source_valid,
):
    """Merge hot-cell overflow candidates into grid search results.

    Runs the streaming brute engine over the (small, padded) overflow set and
    re-selects the global k best per source. Exact: grid buckets + overflow
    partition the target, so the union of candidate sets equals the brute
    engine's. On a distance tie the grid's entry is kept (a stable sort of
    [grid k | overflow k], which is what ``lax.top_k`` selects).
    """
    from .neighbors import topk_neighbors

    op = overflow_pts.shape[0]
    ko = min(k, op)
    # exact=True: direct-difference distances. The matmul expansion's f32
    # cancellation error (~eps * coordinate^2) mis-SELECTS candidates at
    # LiDAR coordinate scales; every other candidate of this merge (grid
    # buckets) is computed from exact differences, so the overflow side must
    # be too or the merge silently drops true neighbors.
    ov_idx_local, ov_d2, ov_found = topk_neighbors(
        source,
        overflow_pts,
        k=ko,
        source_valid=source_valid,
        target_valid=overflow_idx >= 0,
        source_tile=4096,
        target_tile=min(2048, op),
        exact=True,
    )
    inf = float("inf")
    r2 = torch.tensor(radius, dtype=ov_d2.dtype, device=ov_d2.device) ** 2
    ov_found = ov_found & (ov_d2 <= r2)
    ov_rows = torch.where(ov_found, overflow_idx[ov_idx_local.long()], 0)

    cand_d = torch.cat(
        [
            torch.where(corr.mask, corr.sq_dists, inf),
            torch.where(ov_found, ov_d2, inf).to(corr.sq_dists.dtype),
        ],
        dim=1,
    )
    cand_i = torch.cat([corr.indices, ov_rows], dim=1)
    best_d, args = torch.sort(cand_d, dim=1, stable=True)
    best_d, args = best_d[:, :k], args[:, :k]
    best_i = torch.gather(cand_i, 1, args)
    found = torch.isfinite(best_d)
    return Correspondences(
        indices=torch.where(found, best_i, 0),
        sq_dists=torch.where(found, best_d, 0.0),
        mask=found,
    )


_NEIGHBOR_OFFSETS = np.stack(
    np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"), axis=-1
).reshape(27, 3)


def _stable_topk(d2: torch.Tensor, k: int):
    """k smallest per row, ascending, lowest column on ties (what
    ``lax.top_k`` of the negated matrix selects)."""
    vals, cols = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], cols[..., :k]


def candidate_distances(
    s_blk: torch.Tensor,
    v_blk: torch.Tensor,
    bucket_pts: torch.Tensor,
    bucket_idx: torch.Tensor,
    cell_ids: torch.Tensor,
    origin: torch.Tensor,
    dims: torch.Tensor,
    lut: torch.Tensor | None,
    *,
    radius: float,
    capacity: int,
):
    """One source block's candidates: the buckets of each source's 27
    neighbor cells, as (d2 (S, 27 * capacity) with +inf for a dead slot, an
    invalid source or a candidate past the radius; cand_idx (S, 27 *
    capacity) target ids; cand_pts (S, 27 * capacity, 3) coordinates).

    The k-selection over ``d2`` is what :func:`grid_radius_search` hands to
    its ``select_impl``.
    """
    s = s_blk.shape[0]
    dtype = s_blk.dtype
    dev = s_blk.device
    u = cell_ids.shape[0]
    w = 27 * capacity
    cell = torch.tensor(radius, dtype=dtype, device=dev)
    r2 = cell ** 2
    offsets = torch.as_tensor(_NEIGHBOR_OFFSETS, dtype=torch.int32, device=dev)
    # The clamp before the cast keeps far-away sources out of range, not
    # wrapped.
    ijk = torch.floor((s_blk - origin.to(dtype)) / cell).clamp(-(2**30), 2**30).to(torch.int32)
    nijk = ijk[:, None, :] + offsets[None, :, :]  # (S, 27, 3)
    in_bounds = torch.all((nijk >= 0) & (nijk < dims[None, None, :]), dim=-1)
    safe = torch.minimum(nijk.clamp_min(0), dims[None, None, :] - 1)
    nlin = safe[..., 0] + dims[0] * (safe[..., 1] + dims[1] * safe[..., 2])

    if lut is not None:
        row = lut[nlin.long()]  # (S, 27); -1 = unoccupied cell
        hit = in_bounds & (row >= 0)
        pos_safe = row.clamp_min(0).long()
    else:
        pos = torch.searchsorted(cell_ids, nlin)  # (S, 27)
        pos_safe = pos.clamp_max(u - 1)
        hit = in_bounds & (cell_ids[pos_safe] == nlin)

    # Whole-bucket gathers: (S, 27, C, 3) coordinates + (S, 27, C) ids.
    cand_pts = bucket_pts[pos_safe].reshape(s, w, 3)
    cand_idx = bucket_idx[pos_safe].reshape(s, w)
    live = hit[..., None].expand(s, 27, capacity).reshape(s, w) & (cand_idx >= 0)

    diff = cand_pts - s_blk[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(live & v_blk[:, None] & (d2 <= r2), d2, float("inf"))
    return d2, cand_idx, cand_pts


def grid_radius_search(
    source: torch.Tensor,
    bucket_pts: torch.Tensor,
    bucket_idx: torch.Tensor,
    cell_ids: torch.Tensor,
    origin: torch.Tensor,
    dims: torch.Tensor,
    lut: torch.Tensor | None,
    *,
    k: int,
    radius: float,
    capacity: int,
    source_valid: torch.Tensor,
    source_tile: int = 4096,
    select_impl: str = "auto",
    return_points: bool = False,
):
    """Radius-capped KNN against a prebuilt target grid.

    Same contract as ops.neighbors.radius_search: (N, k) original-target
    indices + squared distances + mask, k nearest within ``radius`` per valid
    source row. Cell edge must equal ``radius``. The source is searched in
    blocks of ``source_tile`` rows, which bounds the candidate buffers and
    changes no output.

    ``select_impl`` names the k-selection over a block's (S, 27 * capacity)
    candidate distances. Every mode is exact and returns the same slots
    (ascending distance, lowest candidate column on ties): "topk" (one
    stable sort per row), "hier" (per-cell selection, then a merge over
    27 * k candidates), "pallas" (the row top-k kernel B2,
    ops/select_pallas.py), "approx" (the JAX package's approximate top-k
    with a recall target of 0.99, which is exact off its accelerator; here
    the exact selection, recall 1). "auto" takes "pallas" for a CUDA tensor
    and "topk" for a CPU tensor (the JAX package's "auto" also picks by
    backend). Any other value selects as "topk", as in the JAX package.

    ``return_points=True`` additionally returns the selected neighbors'
    coordinates (N, k, 3) gathered from the bucket tensor.
    """
    if select_impl == "auto":
        select_impl = "pallas" if source.device.type == "cuda" else "topk"
    n = source.shape[0]
    dev = source.device
    sval = source_valid.bool()

    def search_block(s_blk, v_blk):  # (S, 3), (S,)
        s = s_blk.shape[0]
        d2, cand_idx, cand_pts = candidate_distances(
            s_blk, v_blk, bucket_pts, bucket_idx, cell_ids, origin, dims, lut,
            radius=radius, capacity=capacity,
        )
        if select_impl == "pallas":
            from .select_pallas import pallas_row_topk

            best_d, args_ = pallas_row_topk(d2, k=k)
        elif select_impl == "hier":
            # Exact two-stage selection: per-cell top-k (narrow, cheap) then
            # a merge over 27 * k candidates; the global k best cannot
            # include more than k members of any one cell.
            kc = min(k, capacity)
            d1, a1 = _stable_topk(d2.reshape(s, 27, capacity), kc)
            cols1 = (
                torch.arange(27, device=dev)[None, :, None] * capacity + a1
            ).reshape(s, 27 * kc)
            best_d, a2 = _stable_topk(d1.reshape(s, 27 * kc), k)
            args_ = torch.gather(cols1, 1, a2)
        else:
            best_d, args_ = _stable_topk(d2, k)
        found = torch.isfinite(best_d)
        args_ = args_.long()
        best_idx = torch.gather(cand_idx, 1, args_)
        out = (torch.where(found, best_idx, 0), best_d, found)
        if return_points:
            best_pts = torch.gather(cand_pts, 1, args_[..., None].expand(-1, -1, 3))
            out = out + (torch.where(found[..., None], best_pts, 0.0),)
        return out

    blocks = [
        search_block(source[s0:s0 + source_tile], sval[s0:s0 + source_tile])
        for s0 in range(0, max(n, 1), source_tile)
    ]
    outs = tuple(
        parts[0] if len(parts) == 1 else torch.cat(parts) for parts in zip(*blocks)
    )
    idx, d2, found = outs[:3]
    corr = Correspondences(
        indices=idx, sq_dists=torch.where(found, d2, 0.0), mask=found
    )
    if return_points:
        return corr, outs[3]
    return corr


# Candidate-buffer budget behind :func:`pick_source_tile`, chosen by timing
# warm pairs on the grid engine at several budgets on an NVIDIA H100 80GB
# HBM3 at 700 W (the ``search`` spans of ``utils/spans.py`` time the same
# phase today): the 131k LiDAR pair took 1.23-1.30 s at 1,024 MB
# (8 blocks per search) against 1.44-1.51 s at 192 MB (37 blocks) and 1.27 s
# at 512 MB in one call; past 1,024 MB the 16,384-row cap holds the block.
SOURCE_TILE_BUDGET_BYTES = 1024 * 1024 * 1024


def pick_source_tile(capacity: int, budget_bytes: int | None = None, pairs: int = 1) -> int:
    """Source-block size keeping the (S, 27 * capacity) candidate buffers
    (points gather + distances, ~16 B/candidate) within ``budget_bytes``
    (default: ``SOURCE_TILE_BUDGET_BYTES``), between 64 and 16,384 rows;
    with ``pairs`` > 1, rows a pair of a batch whose blocks stack that many
    pairs' rows (:func:`batched_grid_radius_search`).

    The block size changes no output, only how many blocks (and so how many
    rounds of small launches) one search takes."""
    if budget_bytes is None:
        budget_bytes = SOURCE_TILE_BUDGET_BYTES
    per_row = 27 * capacity * 16 * pairs
    tile = budget_bytes // max(per_row, 1)
    tile = max(64, min(16384, tile))
    return (tile // 64) * 64


def batched_grid_radius_search(
    sources: torch.Tensor,
    bucket_pts: torch.Tensor,
    bucket_idx: torch.Tensor,
    luts: torch.Tensor,
    origins: torch.Tensor,
    dims: torch.Tensor,
    *,
    k: int,
    radius: float,
    capacity: int,
    source_valid: torch.Tensor,
    source_tile: int,
    select_impl: str = "auto",
    return_points: bool = False,
):
    """:func:`grid_radius_search` over B pairs, each against its own grid
    (the JAX package's batched grid engine, ``vmap`` of the search): sources
    (B, N, 3), ``source_valid`` (B, N), grids padded to one capacity and
    cell count, (B, U, capacity, 3) / (B, U, capacity), dense cell tables
    ``luts`` (B, L), ``origins`` / ``dims`` (B, 3).

    Per block of ``source_tile`` rows a pair, the pairs' (S, 27 * capacity)
    candidate distances stack into one (B * S, 27 * capacity) matrix, so
    that the k-selection is ONE launch across the batch (B2 on a CUDA
    device; ``select_impl`` as in :func:`grid_radius_search`), then each
    pair gathers its own ids. Returns Correspondences (B, N, k) [and the
    neighbors' coordinates (B, N, k, 3)].
    """
    if select_impl == "auto":
        select_impl = "pallas" if sources.device.type == "cuda" else "topk"
    n_pairs, n = sources.shape[:2]
    sval = source_valid.bool()
    no_ids = torch.zeros(bucket_idx.shape[1], dtype=torch.int32, device=sources.device)

    def search_block(s0):
        cands = [
            candidate_distances(
                sources[b, s0:s0 + source_tile], sval[b, s0:s0 + source_tile], bucket_pts[b],
                bucket_idx[b], no_ids, origins[b], dims[b], luts[b], radius=radius,
                capacity=capacity,
            )
            for b in range(n_pairs)
        ]
        d2 = torch.cat([d for d, _, _ in cands])  # (B * S, 27 * capacity)
        if select_impl == "pallas":
            from .select_pallas import pallas_row_topk

            best_d, args_ = pallas_row_topk(d2, k=k)
        else:
            best_d, args_ = _stable_topk(d2, k)
        best_d = best_d.view(n_pairs, -1, k)
        args_ = args_.long().view(n_pairs, -1, k)
        found = torch.isfinite(best_d)
        best_idx = torch.stack([torch.gather(i, 1, a) for (_, i, _), a in zip(cands, args_)])
        out = (torch.where(found, best_idx, 0), best_d, found)
        if return_points:
            best_pts = torch.stack([torch.gather(p, 1, a[..., None].expand(-1, -1, 3))
                                    for (_, _, p), a in zip(cands, args_)])
            out = out + (torch.where(found[..., None], best_pts, 0.0),)
        return out

    blocks = [search_block(s0) for s0 in range(0, max(n, 1), source_tile)]
    outs = tuple(parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
                 for parts in zip(*blocks))
    idx, d2, found = outs[:3]
    corr = Correspondences(indices=idx, sq_dists=torch.where(found, d2, 0.0), mask=found)
    if return_points:
        return corr, outs[3]
    return corr


def grid_search(grid: HashGrid, source, *, k: int, radius: float, source_valid,
                source_tile: int | None = None) -> Correspondences:
    """Convenience wrapper unpacking :class:`HashGrid` into the query (plus
    the hot-cell overflow merge when the grid carries one)."""
    if abs(grid.cell_size - radius) > 1e-12:
        raise ValueError("grid cell_size must equal the search radius")
    if source_tile is None:
        source_tile = pick_source_tile(grid.capacity)
    corr = grid_radius_search(
        source,
        grid.bucket_pts,
        grid.bucket_idx,
        grid.cell_ids,
        grid.origin,
        grid.dims,
        grid.lut,
        k=k,
        radius=radius,
        capacity=grid.capacity,
        source_valid=source_valid,
        source_tile=source_tile,
    )
    if grid.overflow_pts is not None:
        corr = merge_overflow(
            corr, source, grid.overflow_pts,
            grid.overflow_idx, k=k, radius=radius, source_valid=source_valid,
        )
    return corr
