"""Target-sharded capacity-free pooled search and the sharded pooled step
(port of the JAX package's ``parallel/pool_sharded.py``).

  * Target rows are dealt round-robin over the ``"targets"`` axis
    (statistically alike shards: the same cells at ~1/T density), and each
    shard gets its own width-class pool built from its rows, so each
    shard's window unions shrink ~T-fold.
  * The shards' plans share one static layout
    (``ops.fused_pool.plan_pool_host_group``: one class ladder, per-class
    padded sizes, scatter-table sizes and upload shapes as maxima over the
    shards), as the JAX package's one SPMD program needs; here it keeps
    every rank's pools and budgets alike, so the ranks' overflow decisions
    and collectives line up.
  * Pool payloads carry GLOBAL target rows (lane 3 of the packed target),
    so per-shard results merge like the grid engine's
    (``grid_sharded.merge_topk`` and the butterfly / reduce-scatter merges),
    the neighbors' coordinates travelling with the merge.
  * Source rows shard over ``"points"``; the EM-LM moments are summed over
    that axis, or over both axes after the reduce-scatter merge.

Each class pass runs a select kernel on a CUDA device (B4,
``csrc/select_bitonic.cu``, or B1, ``csrc/select_windows.cu``, where B4 does
not apply), on every rank.

Tie semantics: merged results resolve exact-distance ties at the k-th slot
by shard order, then slot; neighbor SETS equal the single-device engines'.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.se3 import quat_rotate_points
from ..models.em_lm import LMBlocks, LMConfig, LMResult, em_lm_solve
from ..models.registration import Association, scan_convergence
from ..ops import fused_pool as _fp
from ..ops.fused_grid import small_unions_of
from ..ops.grid import build_grid_host
from .grid_sharded import merge_topk_scatter, replication_check, sharded_merge_topk
from .mesh import POINTS_AXIS, TARGETS_AXIS, Mesh


class ShardedPoolPlan(NamedTuple):
    """Host-side harmonized per-shard pool plans (numpy, before upload).

    ``seeds`` holds the stacked upload arrays (leading axis = n_shards);
    every shard's slice has the same shape by the force-mode contract.
    """

    seeds: dict  # str -> (T, ...) numpy arrays
    plan_key: tuple  # (ladder, padded ends, prod_d_pad, prod_e_pad, dtype, bands)
    class_widths: tuple
    class_ends: tuple  # pool-row ends per class (harmonized)
    class_budgets: tuple  # max over shards (the last entry fixed by the step)
    budget_rows: int  # max over shards (floored by the step's source count)
    cell_size: float
    n_shards: int
    small_unions: bool
    select_max_w: int | None
    # True when budget_rows already covers the measured per-(slice, shard)
    # grouping demand of the real source: the step then drops the 8x
    # source-rows floor.
    demand_sized: bool = False


def choose_pool_shard_layout(
    n_src: int,
    n_tgt: int,
    occupied_cells: int,
    n_devices: int,
    tp: int,
    *,
    select_max_w: int | None = None,
    device="cuda",
) -> dict:
    """Occupancy-aware shard-axis decision for the pooled engine.

    Target-axis sharding shrinks per-shard window unions ~tp-fold but keeps
    every rank's full source slice grouping against ~the same window set,
    so sparse scans inflate padded rows toward 8 x sources / device row.
    Points-only sharding divides sources S ways at unchanged window widths.
    From three host statistics:

      U  = occupied grid cells ~= candidate windows
      w  = 27 * n_tgt / U      mean window union lanes, clamped to the
                               width floor AFTER the tp split (128 when
                               every class runs a kernel, cutoff 0)
      rows(m) = 8 * min(U, m) * ceil(max(m/U, 1) / 8)

      W_targets = rows(n_src / (S/tp)) * clamp(w / tp)
      W_points  = rows(n_src / S)      * clamp(w)

    Returns {"layout": "targets"|"points", "w_targets", "w_points",
    "occ_per_devrow"}. The cutoff is ``select_max_w``, else ``device``'s
    (``ops.fused_pool._select_max_w``).
    """
    smw = _fp._select_max_w(device) if select_max_w is None else select_max_w
    floor = 128 if smw == 0 else 8
    u = max(int(occupied_cells), 1)
    w_bar = 27.0 * n_tgt / u

    def clamp(w: float) -> int:
        return max(1 << int(np.ceil(np.log2(max(w, 1.0)))), floor)

    def rows(m: float) -> float:
        live = min(float(u), m)
        occ = max(m / u, 1.0)
        return 8.0 * live * np.ceil(occ / 8.0)

    tp = max(1, min(tp, n_devices))
    dp = max(1, n_devices // tp)
    w_targets = rows(n_src / dp) * clamp(w_bar / tp)
    w_points = rows(n_src / n_devices) * clamp(w_bar)
    return {
        "layout": "points" if w_points < w_targets else "targets",
        "w_targets": float(w_targets),
        "w_points": float(w_points),
        "occ_per_devrow": float(n_src / dp / u),
    }


def build_sharded_pool_host(
    target: np.ndarray,
    cell_size: float,
    n_shards: int,
    *,
    num_valid: int | None = None,
    k: int = 20,
    source_slices: list | None = None,
    device="cuda",
) -> ShardedPoolPlan | None:
    """Deal target rows round-robin into ``n_shards`` pooled prepacks
    (numpy). Returns None when any shard declines the pooled engine.

    ``source_slices`` (the per-points-shard source rows the step will run)
    sizes the budgets from the measured grouping demand
    (:func:`demand_sized_plan`) instead of the 8x source-rows floor; the
    overflow flag and the budget ladder still guard drift. The plans are
    made for ``device``'s narrow-class cutoff.
    """
    target = np.asarray(target, dtype=np.float64)
    n = num_valid if num_valid is not None else target.shape[0]
    if n < n_shards or cell_size <= 0 or not np.isfinite(cell_size):
        return None
    rows_of = [np.arange(s, n, n_shards) for s in range(n_shards)]

    grids = []
    for rows in rows_of:
        # buckets=False: the pooled plan reads only the cell-sorted view.
        g = build_grid_host(target[rows], cell_size, buckets=False)
        if g is None:
            return None
        grids.append(g)
    smw = _fp._select_max_w(device)
    plans2 = _fp.plan_pool_host_group(
        grids, [target[rows] for rows in rows_of], select_max_w=smw
    )
    if plans2 is None:
        return None
    for rows, g, p2 in zip(rows_of, grids, plans2):
        # Lane 3 of the packed cell-sorted rows carries the target row
        # (int32 bits): make it the GLOBAL row, so that per-shard results
        # need no re-indexing before the merge.
        n_s = g["num_valid"]
        order = g["sort_order"][:n_s]
        p2["packed"][:n_s, 3] = rows[order].astype(np.int32).view(np.float32)

    seed_keys = (
        "packed", "cell_start", "cell_count", "base_e", "d_cells_e",
        "off_e", "d_cells", "row_vals", "qmeta_vals", "width_lut",
        "union_lut",
    )
    seeds = {key: np.stack([p[key] for p in plans2]) for key in seed_keys}
    seeds["dims_d"] = np.stack([p["dil"]["dims_d"] for p in plans2])
    seeds["origin_d"] = np.stack([p["dil"]["origin_d"] for p in plans2])

    ladder = list(plans2[0]["widths"])
    plan_key = (
        tuple(ladder),
        tuple(plans2[0]["ends"]),
        plans2[0]["prod_d_pad"],
        plans2[0]["prod_e_pad"],
        "float32",
        plans2[0]["bands"],  # one F=1 band per class, shared
    )
    budget_rows, budgets = _fp.plan_budgets(plans2)
    sp = ShardedPoolPlan(
        seeds=seeds,
        plan_key=plan_key,
        class_widths=tuple(ladder),
        class_ends=tuple(int(e) for e in plans2[0]["row_ends"]),
        class_budgets=budgets,
        budget_rows=budget_rows,
        cell_size=float(cell_size),
        n_shards=n_shards,
        small_unions=small_unions_of(sum(_fp.small_unions_part(p, k, smw) for p in plans2), k),
        select_max_w=smw,
    )
    return demand_sized_plan(sp, source_slices) if source_slices else sp


def estimate_sharded_demand_rows(
    sp: ShardedPoolPlan, sources: list, with_classes: bool = False
):
    """Measured grouping demand of real source slices against a sharded
    plan, from its own seeds (max over every (slice, shard) pair).
    ``with_classes=True`` returns ``(rows, cum_groups)`` with the per-class
    cumulative group counts (max over the pairs)."""
    seeds = sp.seeds
    keys = [_fp.ReplayKeys(seeds["d_cells"][s], seeds["qmeta_vals"][s], sp.plan_key[2],
                           seeds["dims_d"][s], seeds["origin_d"][s], sp.cell_size)
            for s in range(sp.n_shards)]
    rows, cum = _fp.pool_demand([(key, src) for key in keys for src in sources],
                                sp.class_ends if with_classes else ())
    return (rows, cum) if with_classes else rows


def demand_sized_plan(sp: ShardedPoolPlan, sources: list) -> ShardedPoolPlan:
    """``sp`` with its row and class-prefix budgets sized from the grouping
    demand of the source slices the step will run
    (:func:`estimate_sharded_demand_rows`): a plan made on a prep thread
    before the pair's source existed is sized here by the ctor. The class
    budgets come from the replay, not clamped to the plans' 2x estimates
    (the replay may exceed them)."""
    rows, cum = estimate_sharded_demand_rows(sp, sources, with_classes=True)
    return sp._replace(budget_rows=_fp.demand_row_budget(sp.budget_rows, rows),
                       class_budgets=_fp.demand_class_budgets(cum, sp.class_budgets[-1]),
                       demand_sized=True)


class ShardedPools(NamedTuple):
    """One rank's target shard's pool state, on its device (the row of
    the JAX package's ``ShardedPools`` at this rank's "targets"
    coordinate)."""

    pool_xyz: tuple  # per class: (R_c + 1, 3, W_c)
    pool_idx: tuple  # per class: (R_c + 1, W_c) global target rows
    select_xyz: tuple  # pool_xyz in float32, as the select kernels read it
    class_width_luts: tuple  # per class: (R_c + 1,) class-local kernel widths
    width_lut: torch.Tensor  # (R_pad + 1,)
    union_lut: torch.Tensor  # (R_pad + 1,)
    lut_d: torch.Tensor  # (prod_d_pad,) packed grouping keys
    origin_d: torch.Tensor  # (3,)
    dims_d: torch.Tensor  # (3,)


# The seeds _build_pools reads; the other derived tables it rebuilds.
_BUILD_KEYS = ("packed", "cell_start", "cell_count", "base_e", "d_cells_e", "off_e",
               "row_vals", "dims_d")


def _shard_plan(sp: ShardedPoolPlan, shard: int) -> dict:
    """What ``ops.fused_pool._build_pools`` reads of a plan, for one shard."""
    widths, ends, prod_d_pad, prod_e_pad, _, bands = sp.plan_key
    return {"widths": list(widths), "ends": list(ends), "prod_d_pad": prod_d_pad,
            "prod_e_pad": prod_e_pad, "bands": bands,
            "dil": {"dims_d": sp.seeds["dims_d"][shard]}}


def _pool_shapes(sp: ShardedPoolPlan, dtype: torch.dtype) -> list:
    """(shape, dtype) of each tensor ``_build_pools`` returns for a shard of
    ``sp``, in its flattened output order (pool_xyz per class, pool_idx per
    class, lut_d, width_lut, union_lut)."""
    widths, _, prod_d_pad, _, _, bands = sp.plan_key
    rows = [sum(npad // f for _, f, npad in layout) + 1 for layout in bands]
    n_rows = sum(rows) - len(rows)
    return ([((r, 3, w), dtype) for r, w in zip(rows, widths)]
            + [((r, w), torch.int32) for r, w in zip(rows, widths)]
            + [((prod_d_pad,), torch.int32), ((n_rows + 1,), torch.int32),
               ((n_rows + 1,), torch.int32)])


def pack_sharded_pools(mesh: Mesh, sp: ShardedPoolPlan, dtype=np.float32):
    """Pack this rank's target shard's pools, on the rank at "points"
    coordinate 0 of its column (None elsewhere): the device half of the
    pool prepack, with no collective (a prep thread may run it). Returns
    the flattened ``_build_pools`` outputs (see :func:`_pool_shapes`)."""
    if mesh.index(POINTS_AXIS) != 0:
        return None
    shard = mesh.index(TARGETS_AXIS)
    device = mesh.device
    dev = {
        key: torch.as_tensor(np.ascontiguousarray(sp.seeds[key][shard]), device=device)
        for key in _BUILD_KEYS if key != "packed"
    }
    # The packed target travels as int32 bits: its index column must never
    # pass through float conversion.
    dev["packed"] = torch.as_tensor(
        np.ascontiguousarray(sp.seeds["packed"][shard]).view(np.int32), device=device)
    torch_dtype = getattr(torch, np.dtype(dtype).name)
    pool_xyz, pool_idx, lut_d, width_lut, union_lut = _fp._build_pools(
        dev, _shard_plan(sp, shard), torch_dtype)
    flat = list(pool_xyz) + list(pool_idx) + [lut_d, width_lut, union_lut]
    want = _pool_shapes(sp, torch_dtype)
    got = [(tuple(x.shape), x.dtype) for x in flat]
    if got != want:
        raise AssertionError(f"pool build shapes {got} differ from the plan's {want}")
    return flat


def share_sharded_pools(mesh: Mesh, sp: ShardedPoolPlan, packed, dtype=np.float32
                        ) -> ShardedPools:
    """Broadcast each column's pools from its "points" row 0 to the rest of
    the column (``packed`` is :func:`pack_sharded_pools`'s result on the
    rank that packed, None elsewhere) and assemble this rank's
    :class:`ShardedPools`. Every rank of the mesh calls it, on the thread
    that runs the pair's collectives."""
    torch_dtype = getattr(torch, np.dtype(dtype).name)
    device = mesh.device
    if packed is None:
        packed = [torch.empty(shape, dtype=dt, device=device)
                  for shape, dt in _pool_shapes(sp, torch_dtype)]
    for x in packed:
        mesh.broadcast_(x, POINTS_AXIS, 0)
    nc = len(sp.class_widths)
    pool_xyz, pool_idx = tuple(packed[:nc]), tuple(packed[nc:2 * nc])
    lut_d, width_lut, union_lut = packed[2 * nc:]
    shard = mesh.index(TARGETS_AXIS)
    ends = sp.class_ends
    return ShardedPools(
        pool_xyz=pool_xyz,
        pool_idx=pool_idx,
        select_xyz=tuple(p.float().contiguous() for p in pool_xyz),
        class_width_luts=tuple(
            torch.cat([width_lut[lo:hi], width_lut.new_zeros(1)])
            for lo, hi in zip((0,) + tuple(ends[:-1]), ends)
        ),
        width_lut=width_lut,
        union_lut=union_lut,
        lut_d=lut_d,
        origin_d=torch.as_tensor(sp.seeds["origin_d"][shard].astype(np.dtype(dtype)),
                                 device=device),
        dims_d=torch.as_tensor(sp.seeds["dims_d"][shard], device=device),
    )


def build_sharded_pools_device(mesh: Mesh, sp: ShardedPoolPlan, dtype=np.float32
                               ) -> ShardedPools:
    """Each target shard's pools packed once, on the "points" row 0 rank of
    its mesh column, and broadcast along ``"points"`` (the JAX package
    sums zeros from the other rows, which is the same). Every rank ends
    with its column's pools: the search reads them on every row."""
    return share_sharded_pools(mesh, sp, pack_sharded_pools(mesh, sp, dtype), dtype)


class ShardedPoolStepResult(NamedTuple):
    result: LMResult
    num_correspondences: torch.Tensor
    overflow: torch.Tensor  # total budget overflows (must be 0 to consume)


def _use_scatter(mesh: Mesh, source_rows_per_shard: int) -> bool:
    tp = mesh.shape[TARGETS_AXIS]
    return tp & (tp - 1) == 0 and source_rows_per_shard % tp == 0


def _pool_budgets(sp: ShardedPoolPlan, source_rows_per_shard: int, boost: int = 0):
    """(row budget, class-prefix budgets) of the sharded pooled search at
    rung ``boost`` (``ops.fused_pool.search_budgets``): without demand
    sizing, the 8x source-rows floor; the mid-class budgets were estimated
    for a shard's own target count, so they grow with the row budget."""
    return _fp.search_budgets(sp.budget_rows, source_rows_per_shard,
                              class_budgets=sp.class_budgets, boost=boost,
                              demand_sized=sp.demand_sized, inflate=True)


def _pool_associate(mesh: Mesh, sp: ShardedPoolPlan, pools: ShardedPools, sv, *, k, radius,
                    budget, budgets, scatter: bool):
    """The sharded pooled search + merge as an :class:`Association`: the
    solve's rows are the whole local slice, or, after the reduce-scatter
    merge, this rank's block of it."""
    tp = mesh.shape[TARGETS_AXIS]

    def associate(moved):
        corr, overflow, pts = _fp.fused_pool_search(
            moved, sv, pools.select_xyz, pools.pool_idx, pools.class_width_luts,
            pools.lut_d, pools.origin_d, pools.dims_d, k=k, radius=radius,
            class_widths=sp.class_widths, class_ends=sp.class_ends,
            class_budgets=budgets, budget_rows=budget, small_unions=sp.small_unions,
            select_max_w=sp.select_max_w,
        )
        local_d = torch.where(corr.mask, corr.sq_dists, float("inf"))
        ov = mesh.psum(mesh.psum(overflow, TARGETS_AXIS), POINTS_AXIS)
        if scatter:
            _, best_d, found, best_p, off = merge_topk_scatter(
                local_d, corr.indices, pts, k=k, mesh=mesh)
            blk = moved.shape[0] // tp
            n_corr = mesh.psum(mesh.psum(found.sum(), TARGETS_AXIS), POINTS_AXIS)
            return Association(moved[off:off + blk], best_p, found, n_corr, ov, None)
        _, best_d, found, best_p = sharded_merge_topk(
            local_d, corr.indices, pts, k=k, mesh=mesh)
        n_corr = mesh.psum(found.sum(), POINTS_AXIS)
        return Association(moved, best_p, found, n_corr, ov, torch.where(found, best_d, 0.0))

    return associate


def _solve_config(lm_config: LMConfig, scatter: bool) -> LMConfig:
    """The solve reduces over "points", or over both axes after the
    reduce-scatter merge (its rows are then split over both)."""
    return lm_config._replace(
        axis_name=(POINTS_AXIS, TARGETS_AXIS) if scatter else POINTS_AXIS)


def _replication(mesh: Mesh, scatter: bool):
    """``debug_replication``'s check: the merged distances must agree along
    "targets" (the solve's translation after the reduce-scatter merge,
    whose merged blocks differ by design)."""

    def check(res, a):
        return replication_check(mesh, res, res.t if scatter else a.probe)

    return check


def make_sharded_pool_registration_step(
    mesh: Mesh,
    sp: ShardedPoolPlan,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    source_rows_per_shard: int,
    debug_replication: bool = False,
):
    """One full outer iteration with the pooled engine on this rank:

      step(fs, sv, pools, q_cum, t_cum, q0, t0) -> ShardedPoolStepResult

    ``fs`` / ``sv`` are this rank's source rows, ``pools`` its
    :class:`ShardedPools`; ``source_rows_per_shard`` = padded source rows
    / "points" size. A power-of-two "targets" axis that divides those rows
    takes the reduce-scatter merge and the two-axis solve. A nonzero
    ``overflow`` means the budget missed: redo the step on the grid engine.
    The results are the same on every rank.
    """
    scatter = _use_scatter(mesh, source_rows_per_shard)
    budget, budgets = _pool_budgets(sp, source_rows_per_shard)
    cfg = _solve_config(lm_config, scatter)

    def step(fs, sv, pools: ShardedPools, q_cum, t_cum, q0, t0):
        assoc = _pool_associate(mesh, sp, pools, sv, k=k, radius=radius, budget=budget,
                                budgets=budgets, scatter=scatter)
        a = assoc(quat_rotate_points(q_cum, fs) + t_cum)
        result = em_lm_solve(a.source, a.targets, a.mask, q0, t0, cfg, mesh=mesh)
        if debug_replication:
            result = _replication(mesh, scatter)(result, a)
        return ShardedPoolStepResult(result=result, num_correspondences=a.n_corr,
                                     overflow=a.overflow)

    return step


def make_sharded_pool_align_scan(
    mesh: Mesh,
    sp: ShardedPoolPlan,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    source_rows_per_shard: int,
    chunk: int,
    n_iter: int,
    cost_drop_thresh: float,
    n_cost_drop_it: int,
    budget_boost: int = 0,
    debug_replication: bool = False,
    lm: Optional[LMBlocks] = None,
):
    """The outer-loop chunk of :class:`~.align.DistributedRegistration`: up
    to ``chunk`` sharded pooled outer iterations with the reference
    stopping rule carried on the device
    (``models.registration.scan_convergence``).

      scan(fs, sv, pools, t_cum, conv0, q0, t0, slots=chunk) -> rows

    ``t_cum`` is the host's 4x4 and ``conv0`` its (cost drop, stall
    counter, iteration); the rows (one float64 row per slot run, the
    overflow in its column) are the same on every rank, because every
    value the loop branches on is reduced or replicated. ``budget_boost``
    doubles the row budget per unit (the host's escalation ladder);
    ``debug_replication`` poisons the solve's quaternion with NaN where
    ranks disagree. ``lm`` holds the LM blocks (eager ones of one step when
    None).
    """
    scatter = _use_scatter(mesh, source_rows_per_shard)
    budget, budgets = _pool_budgets(sp, source_rows_per_shard, budget_boost)
    cfg = _solve_config(lm_config, scatter)
    blocks = lm if lm is not None else LMBlocks(graphs=False, block=1)
    check = _replication(mesh, scatter) if debug_replication else None

    def scan(fs, sv, pools: ShardedPools, t_cum, conv0, q0, t0, slots: int = chunk):
        assoc = _pool_associate(mesh, sp, pools, sv, k=k, radius=radius, budget=budget,
                                budgets=budgets, scatter=scatter)
        return scan_convergence(
            assoc, blocks, fs, t_cum, conv0, q0, t0, cfg, slots=slots, n_iter=n_iter,
            cost_drop_thresh=cost_drop_thresh, n_cost_drop_it=n_cost_drop_it, mesh=mesh,
            check=check,
        )

    return scan
