"""Target-sharded hash-grid search, the top-k merges and the sharded grid
step (port of the JAX package's ``parallel/grid_sharded.py``).

  * Target rows are dealt round-robin over the ``"targets"`` axis, so every
    shard sees ~1/T of the density in the SAME cells. Each shard's sub-grid
    has the global origin / dims / cell size and a capacity quantized from
    the largest shard occupancy; ``bucket_idx`` holds GLOBAL target rows,
    so per-shard results merge with no re-indexing.
  * The merges combine per-shard (N, k) lists into the global k best:
    :func:`merge_topk` on lists gathered from every shard,
    :func:`merge_topk_tree` (a butterfly of paired exchanges, O(k log T)
    payload) and :func:`merge_topk_scatter` (recursive halving: rank r of
    the axis ends owning block r of the rows, fully merged, and the solve
    then reduces over both axes). The selected neighbors' coordinates
    travel with the merge, so no rank holds the whole target.
  * Ties at the k-th slot resolve by shard order, then slot: the JAX
    package's ``lax.top_k`` over the concatenated lists keeps the lowest
    index among equal values, and so does a stable ascending sort here.
  * Source rows shard over ``"points"``; the EM-LM moments are summed over
    that axis (models/em_lm.py).

Every function runs on one rank with its own shard of the inputs; the
collectives are the :class:`~.mesh.Mesh`'s. The grid search selects with
the row top-k kernel (B2, ``csrc/row_topk.cu``) on a CUDA device.

Replaces the reference's per-iteration FLANN kd-tree rebuild + query loop
(src/prob_point_cloud_registration.cc:66-81) at multi-device scale.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.se3 import quat_rotate_points
from ..models.em_lm import LMBlocks, LMConfig, LMResult, em_lm_solve
from ..models.registration import Association, scan_convergence
from ..ops.grid import _quantize_capacity, grid_radius_search, pick_source_tile
from .mesh import POINTS_AXIS, TARGETS_AXIS, Mesh

_INT32_MAX = 2**31 - 1


class ShardedGrid(NamedTuple):
    """Host-side sharded grid arrays (leading axis = T * per-shard rows)."""

    bucket_pts: np.ndarray  # (T * U_max, capacity, 3)
    bucket_idx: np.ndarray  # (T * U_max, capacity) global target rows; -1 pad
    lut: np.ndarray  # (T * dims_prod,) linear cell -> local bucket row
    origin: np.ndarray  # (3,) global
    dims: np.ndarray  # (3,) int32 global
    capacity: int  # max over shards
    u_max: int  # padded per-shard occupied-cell count
    cell_size: float
    n_shards: int


class GridShard(NamedTuple):
    """One rank's target shard of a :class:`ShardedGrid`, on its device."""

    bucket_pts: torch.Tensor
    bucket_idx: torch.Tensor
    lut: torch.Tensor
    origin: torch.Tensor
    dims: torch.Tensor
    capacity: int


def build_sharded_grid_host(
    target: np.ndarray, cell_size: float, n_shards: int, *, num_valid: int | None = None
) -> ShardedGrid | None:
    """Deal target rows round-robin into ``n_shards`` sub-grids (numpy).

    Returns None when the cloud is empty, the cell size is not positive
    and finite, or the dense LUT would not fit (the sharded engine reads
    only the LUT).
    """
    target = np.asarray(target, dtype=np.float64)
    n = num_valid if num_valid is not None else target.shape[0]
    if n == 0 or cell_size <= 0 or not np.isfinite(cell_size):
        return None
    pts = target[:n]
    origin = pts.min(axis=0)
    ijk = np.floor((pts - origin) / cell_size).astype(np.int64)
    dims = ijk.max(axis=0) + 1
    dims_prod = int(dims[0]) * int(dims[1]) * int(dims[2])
    if dims_prod >= _INT32_MAX or dims_prod > (1 << 25) // max(n_shards, 1):
        return None
    lin = ijk[:, 0] + dims[0] * (ijk[:, 1] + dims[1] * ijk[:, 2])

    shard_of = np.arange(n) % n_shards
    per_shard = []
    u_max, cap_max = 1, 1
    for s in range(n_shards):
        rows = np.nonzero(shard_of == s)[0]
        lin_s = lin[rows]
        order = np.argsort(lin_s, kind="stable")
        cells, start, counts = np.unique(
            lin_s[order], return_index=True, return_counts=True
        )
        per_shard.append((rows, order, cells, start, counts))
        u_max = max(u_max, len(cells))
        cap_max = max(cap_max, int(counts.max()) if counts.size else 1)
    capacity = _quantize_capacity(cap_max)

    bucket_pts = np.zeros((n_shards, u_max, capacity, 3), dtype=np.float64)
    bucket_idx = np.full((n_shards, u_max, capacity), -1, dtype=np.int32)
    lut = np.full((n_shards, dims_prod), -1, dtype=np.int32)
    for s, (rows, order, cells, start, counts) in enumerate(per_shard):
        if not len(cells):
            continue
        lin_sorted = lin[rows][order]
        cell_row = np.searchsorted(cells, lin_sorted)
        slot = np.arange(len(rows)) - start[cell_row]
        bucket_idx[s, cell_row, slot] = rows[order].astype(np.int32)
        bucket_pts[s, cell_row, slot] = pts[rows[order]]
        lut[s, cells] = np.arange(len(cells), dtype=np.int32)

    return ShardedGrid(
        bucket_pts=bucket_pts.reshape(n_shards * u_max, capacity, 3),
        bucket_idx=bucket_idx.reshape(n_shards * u_max, capacity),
        lut=lut.reshape(n_shards * dims_prod),
        origin=origin,
        dims=dims.astype(np.int32),
        capacity=capacity,
        u_max=u_max,
        cell_size=float(cell_size),
        n_shards=n_shards,
    )


def grid_shard_to_device(sg: ShardedGrid, shard: int, dtype, device) -> GridShard:
    """Shard ``shard`` of ``sg`` on ``device`` (coordinates in ``dtype``)."""
    u, dprod = sg.u_max, sg.lut.shape[0] // sg.n_shards
    rows = slice(shard * u, (shard + 1) * u)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return GridShard(
        bucket_pts=put(sg.bucket_pts[rows].astype(np.dtype(dtype))),
        bucket_idx=put(sg.bucket_idx[rows]),
        lut=put(sg.lut[shard * dprod:(shard + 1) * dprod]),
        origin=put(sg.origin.astype(np.dtype(dtype))),
        dims=put(sg.dims),
        capacity=sg.capacity,
    )


def _take_k(cand_d, cand_i, cand_p, k: int):
    """The k best of concatenated candidate lists: ascending distance, the
    lowest candidate column on ties (``lax.top_k`` of the negated list)."""
    d, args = torch.sort(cand_d, dim=1, stable=True)
    args = args[:, :k]
    i = torch.gather(cand_i, 1, args)
    p = None
    if cand_p is not None:
        p = torch.gather(cand_p, 1, args[..., None].expand(-1, -1, 3))
    return d[:, :k], i, p


def merge_topk(all_d, all_i, all_p=None, *, k: int):
    """Merge (D, N, k) per-shard candidate sets into the global (N, k)
    best; ties resolve by shard order, then slot. Returns (best_i, best_d,
    found[, best_p])."""
    d, n, _ = all_d.shape
    cand_d = all_d.permute(1, 0, 2).reshape(n, d * k)
    cand_i = all_i.permute(1, 0, 2).reshape(n, d * k)
    cand_p = None if all_p is None else all_p.permute(1, 0, 2, 3).reshape(n, d * k, 3)
    best_d, best_i, best_p = _take_k(cand_d, cand_i, cand_p, k)
    found = torch.isfinite(best_d)
    best_i = torch.where(found, best_i, 0)
    if all_p is None:
        return best_i, best_d, found
    return best_i, best_d, found, best_p


def _ordered(low_first: bool, mine, other):
    """The lower rank's candidates first (the tournament tie order)."""
    return torch.cat([mine, other] if low_first else [other, mine], dim=1)


def merge_topk_tree(local_d, local_i, local_p=None, *, k: int, mesh: Mesh,
                    axis_name: str = TARGETS_AXIS):
    """Butterfly top-k combine over ``axis_name``: at each of log2(T)
    stages exchange the (N, k) lists with the rank at coordinate
    ``index ^ stage`` and keep the k best of both, the lower rank's first.
    Every rank ends with the same lists. Needs a power-of-two axis;
    ``local_d`` carries +inf in unfound slots."""
    t = mesh.shape[axis_name]
    if t & (t - 1):
        raise ValueError("the butterfly merge needs a power-of-two axis")
    idx = mesh.index(axis_name)
    d, i, p = local_d, local_i, local_p
    stage = 1
    while stage < t:
        partner = idx ^ stage
        od = mesh.exchange(d, axis_name, partner)
        oi = mesh.exchange(i, axis_name, partner)
        low_first = (idx & stage) == 0
        op = None if p is None else mesh.exchange(p, axis_name, partner)
        d, i, p = _take_k(
            _ordered(low_first, d, od), _ordered(low_first, i, oi),
            None if p is None else _ordered(low_first, p, op), k,
        )
        stage <<= 1
    found = torch.isfinite(d)
    i = torch.where(found, i, 0)
    if p is None:
        return i, d, found
    return i, d, found, p


def merge_topk_scatter(local_d, local_i, local_p, *, k: int, mesh: Mesh,
                       axis_name: str = TARGETS_AXIS):
    """Recursive-halving reduce-scatter top-k over ``axis_name``: at each of
    log2(T) stages send the half of the rows the partner keeps, and merge
    what arrives into the half this rank keeps (the lower rank's
    candidates first). Rank r of the axis ends owning rows [r N/T, (r+1)
    N/T) of its local source slice, fully merged, so the solve can shard
    over both axes. Needs a power-of-two axis and N divisible by T.

    Returns (best_i, best_d, found, best_p, row_offset), the first four
    (N/T, k)."""
    t = mesh.shape[axis_name]
    if t & (t - 1):
        raise ValueError("the reduce-scatter merge needs a power-of-two axis")
    n = local_d.shape[0]
    if n % t:
        raise ValueError("the rows must divide the targets axis")
    idx = mesh.index(axis_name)
    d, i, p = local_d, local_i, local_p
    stages = t.bit_length() - 1
    for s in range(stages):
        bit_pos = stages - 1 - s
        half = d.shape[0] // 2
        keep_low = (idx >> bit_pos) & 1 == 0
        partner = idx ^ (1 << bit_pos)

        def split(x):
            lo, hi = x[:half], x[half:]
            return (lo, hi) if keep_low else (hi, lo)  # (kept, sent)

        keep_d, send_d = split(d)
        keep_i, send_i = split(i)
        od = mesh.exchange(send_d, axis_name, partner)
        oi = mesh.exchange(send_i, axis_name, partner)
        cat_p = None
        if p is not None:
            keep_p, send_p = split(p)
            op = mesh.exchange(send_p, axis_name, partner)
            cat_p = _ordered(keep_low, keep_p, op)
        d, i, p = _take_k(_ordered(keep_low, keep_d, od), _ordered(keep_low, keep_i, oi),
                          cat_p, k)
    found = torch.isfinite(d)
    i = torch.where(found, i, 0)
    return i, d, found, p, idx * (n // t)


def sharded_merge_topk(local_d, local_i, local_p=None, *, k: int, mesh: Mesh,
                       axis_name: str = TARGETS_AXIS, tree: bool | None = None):
    """Merge per-shard top-k lists into the global (N, k) best on every
    rank of ``axis_name``: the butterfly on power-of-two axes, the
    gather-everything merge otherwise; ``tree`` forces one of them."""
    t = mesh.shape[axis_name]
    if tree is None:
        tree = t & (t - 1) == 0 and t > 1
    if tree:
        return merge_topk_tree(local_d, local_i, local_p, k=k, mesh=mesh,
                               axis_name=axis_name)
    all_d = mesh.all_gather(local_d, axis_name)
    all_i = mesh.all_gather(local_i, axis_name)
    all_p = None if local_p is None else mesh.all_gather(local_p, axis_name)
    return merge_topk(all_d, all_i, all_p, k=k)


def replication_check(mesh: Mesh, res: LMResult, probe) -> LMResult:
    """``debug_replication``: NaN into the solve's quaternion unless
    ``probe`` is the same on every rank of the "targets" axis (it is
    compared with its mean there, as the JAX package does with
    ``lax.pmean``)."""
    dev = torch.max(torch.abs(probe - mesh.pmean(probe, TARGETS_AXIS)))
    poison = torch.where(dev == 0, 0.0, float("nan")).to(res.q.dtype)
    return res._replace(q=res.q + poison)


class ShardedGridStepResult(NamedTuple):
    result: LMResult
    num_correspondences: torch.Tensor


def _grid_associate(mesh: Mesh, grid: GridShard, sv, *, k, radius, source_tile, tree):
    """The sharded grid search + merge as an :class:`Association`."""

    def associate(moved):
        corr, pts = grid_radius_search(
            moved, grid.bucket_pts, grid.bucket_idx,
            torch.zeros((grid.bucket_pts.shape[0],), dtype=torch.int32, device=moved.device),
            grid.origin, grid.dims, grid.lut, k=k, radius=radius, capacity=grid.capacity,
            source_valid=sv, source_tile=source_tile, return_points=True,
        )
        local_d = torch.where(corr.mask, corr.sq_dists, float("inf"))
        _, best_d, found, best_p = sharded_merge_topk(
            local_d, corr.indices, pts, k=k, mesh=mesh, tree=tree)
        n_corr = mesh.psum(found.sum(), POINTS_AXIS)
        return Association(moved, best_p, found, n_corr, None,
                           torch.where(found, best_d, 0.0))

    return associate


def make_sharded_grid_registration_step(
    mesh: Mesh,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    source_tile: Optional[int] = None,
    tree_merge: bool = False,
):
    """One full outer iteration with the grid engine on this rank:

      step(fs, sv, grid, q_cum, t_cum, q0, t0) -> ShardedGridStepResult

    ``fs`` / ``sv`` are this rank's source rows (its "points" block),
    ``grid`` its target shard (:func:`grid_shard_to_device`). The results
    are the same on every rank.
    """
    cfg = lm_config._replace(axis_name=POINTS_AXIS)

    def step(fs, sv, grid: GridShard, q_cum, t_cum, q0, t0):
        tile = source_tile or pick_source_tile(grid.capacity)
        assoc = _grid_associate(mesh, grid, sv, k=k, radius=radius, source_tile=tile,
                                tree=True if tree_merge else False)
        a = assoc(quat_rotate_points(q_cum, fs) + t_cum)
        result = em_lm_solve(a.source, a.targets, a.mask, q0, t0, cfg, mesh=mesh)
        return ShardedGridStepResult(result=result, num_correspondences=a.n_corr)

    return step


def make_sharded_grid_align_scan(
    mesh: Mesh,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    chunk: int,
    n_iter: int,
    cost_drop_thresh: float,
    n_cost_drop_it: int,
    source_tile: Optional[int] = None,
    debug_replication: bool = False,
    lm: Optional[LMBlocks] = None,
):
    """Up to ``chunk`` sharded grid outer iterations with the stopping rule
    carried on the device (``models.registration.scan_convergence``): the
    fallback of :class:`~.align.DistributedRegistration` once the pooled
    engine's budget ladder is spent.

      scan(fs, sv, grid, t_cum, conv0, q0, t0, slots=chunk) -> rows

    ``t_cum`` is the host's 4x4, ``conv0`` its (cost drop, stall counter,
    iteration); the rows are ``scan_convergence``'s (one float64 row per
    slot run, the same on every rank). ``lm`` holds the LM blocks (eager
    ones of one step when None).
    """
    cfg = lm_config._replace(axis_name=POINTS_AXIS)
    blocks = lm if lm is not None else LMBlocks(graphs=False, block=1)

    def scan(fs, sv, grid: GridShard, t_cum, conv0, q0, t0, slots: int = chunk):
        tile = source_tile or pick_source_tile(grid.capacity)
        assoc = _grid_associate(mesh, grid, sv, k=k, radius=radius, source_tile=tile,
                                tree=None)
        check = None
        if debug_replication:
            def check(res, a):
                return replication_check(mesh, res, a.probe)
        return scan_convergence(
            assoc, blocks, fs, t_cum, conv0, q0, t0, cfg, slots=slots, n_iter=n_iter,
            cost_drop_thresh=cost_drop_thresh, n_cost_drop_it=n_cost_drop_it, mesh=mesh,
            check=check,
        )

    return scan
