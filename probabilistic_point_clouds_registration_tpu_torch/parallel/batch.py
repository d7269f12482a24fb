"""Scan-pair batch parallelism: many registrations in one device program
(port of the JAX package's ``parallel/batch.py``).

Sequential odometry registers consecutive pairs (scan_k -> scan_{k+1});
every pair is INDEPENDENT, so a sequence of S scans is S-1 embarrassingly
parallel registrations. The JAX package stacks the pairs on a batch axis
and runs the whole outer loop under ``vmap`` + ``lax.while_loop``. Here the
pair axis is written out: every tensor of the loop carries it, each search
engine takes all pairs at once, and the LM solve steps the (B, ...) state
(``models/em_lm.py``). On a CUDA device every pooled class pass is one
select launch across the batch (B4 or B1 on the pairs' flattened pools,
``ops/fused_pool.py::batched_fused_pool_search``) and every grid block one
B2 launch on the pairs' stacked candidate rows
(``ops/grid.py::batched_grid_radius_search``); the LM blocks are CUDA graphs,
captured once per batch shape.

Convergence semantics: each pair carries the reference's stopping rule
(src/prob_point_cloud_registration.cc:138-158: max iterations, plus
cost-drop-below-threshold for more than ``n_cost_drop_it`` consecutive
checks, counter reset on any good iteration, checked BEFORE each iteration
with the previous drop) as per-pair state. A finished pair's state freezes
(its LM solve too) while the others go on, and the loop ends when every
pair is done, as JAX's batched ``while_loop`` does. The host reads one
flag a loop iteration: whether every pair's check stopped it, in which case
the iteration JAX would still run changes nothing and is skipped.

Engines: ``search_impl="brute"`` streams the full target per pair (a loop
over the pairs: it runs no kernel); ``"grid"`` batches per-pair hash grids
(common padded capacity / cell count); ``"pool"`` the pooled engine on
per-pair prepacks sharing one static layout.

On a mesh (``mesh=``) each rank runs its contiguous block of the padded
pairs (``shard_rows``' rule) with no collective inside the loop, and one
``all_gather`` over "points" returns the whole result on every rank, as
JAX returns a global array. The pooled engine prepares only the rank's
block (its scans, grids, plans, prepacks, demand replays and uploads);
two small ``all_gather``s agree what every rank's program shares, so that
each rank runs the geometry the whole batch's group plan gives. The grid
and brute engines, and the grid redo of overflowed pooled pairs, prepare
the whole batch on every rank.

Spans (``utils/spans.py``): one root ``batch`` a call, over its children
``batch_grid`` (the targets' hash grids), ``batch_plan`` (the group pool
plan), ``batch_build`` (padding and uploads, the prepacks, their stacking,
the demand estimate), ``batch_loop`` (the outer loop), ``batch_gather``
(the gather and the overflow read: the wait on the slowest rank) and
``batch_redo`` (the grid engine's redo and its splice, with its own
``batch_grid`` and ``batch_build``); inside ``batch_plan`` and
``batch_build`` on a mesh, ``batch_agree`` (an exchange of the pooled
geometry, and the wait on the slowest rank's planning); the counts
``batch_targets`` (the distinct targets whose pool plan this rank made)
and ``redo_pairs``. The host phases (``batch_grid``, ``batch_plan``,
``batch_build``) feed ``stats["host_seconds"]``.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.se3 import (
    np_quat_to_matrix,
    quat_multiply,
    quat_normalize,
    quat_rotate_points,
    unit_quat_rotate,
)
from ..core.types import round_up
from ..models.em_lm import LMBlocks, LMConfig
from ..ops import fused_pool as _fp
from ..ops.fused_grid import small_unions_of
from ..ops.grid import batched_grid_radius_search, build_grid_host, pick_source_tile
from ..ops.neighbors import radius_search
from ..utils import spans
from ..utils.device import resolve_device
from .mesh import POINTS_AXIS, Mesh, shard_rows


class BatchedPairResult(NamedTuple):
    q: torch.Tensor  # (B, 4) cumulative rotation per pair
    t: torch.Tensor  # (B, 3) cumulative translation per pair
    initial_costs: torch.Tensor  # (B, n_outer); 0 where not executed
    final_costs: torch.Tensor  # (B, n_outer)
    num_correspondences: torch.Tensor  # (B, n_outer)
    num_iterations: torch.Tensor  # (B,) outer iterations actually executed
    # (B,) pooled-engine budget overflow count. From
    # batched_pair_register_pool directly: nonzero pairs' results are
    # INVALID and must be redone on the grid engine. From
    # run_odometry_batched: the redo already happened — nonzero just marks
    # which pairs the grid engine recomputed (results valid). Always 0 for
    # the brute/grid engines.
    overflow: Optional[torch.Tensor] = None


def _outer_loop(search_fn, src, q0, t0, lm_config: LMConfig, n_outer: int,
                cost_drop_thresh: float, n_cost_drop_it: int, stats: Optional[dict] = None):
    """Per-pair outer loop with the reference's convergence rule as carried
    state (the JAX package's ``_outer_loop``). ``search_fn(moved (B, N, 3))
    -> (neighbor_pts (B, N, k, 3), mask (B, N, k), n_corr (B,), overflow
    (B,))``. ``stats`` (a dict), when given, adds up the loop iterations
    run (``outer_loops``), the LM capture seconds and the shapes captured
    as CUDA graphs (``graphs_captured``)."""
    dtype, dev = src.dtype, src.device
    n_pairs = src.shape[0]
    thresh = torch.tensor(cost_drop_thresh, dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    it = torch.zeros(n_pairs, **i32)
    q = q0.expand(n_pairs, 4).clone()
    t = t0.expand(n_pairs, 3).clone()
    drop = torch.zeros(n_pairs, dtype=dtype, device=dev)
    unuseful = torch.zeros(n_pairs, **i32)
    ic = torch.zeros((n_pairs, n_outer), dtype=dtype, device=dev)
    fc = torch.zeros_like(ic)
    nc = torch.zeros((n_pairs, n_outer), **i32)
    ovf = torch.zeros(n_pairs, **i32)
    lm = LMBlocks.for_device(dev)
    q0b, t0b = q0.expand(n_pairs, 4).contiguous(), t0.expand(n_pairs, 3).contiguous()
    loops = 0
    while True:
        # Pre-iteration convergence check on the PREVIOUS drop (cc:138-158).
        low = drop < thresh
        done_now = (it >= n_outer) | (low & (unuseful > n_cost_drop_it))
        if bool(done_now.all()):
            break  # JAX's last iteration would change nothing
        loops += 1
        keep = ~done_now
        moved = quat_rotate_points(q, src) + t[:, None, :]
        pts, mask, n_corr, ovf_b = search_fn(moved)
        # A stopped pair's solve takes no step (its result is dropped).
        res, _ = lm.solve(moved, pts, mask, q0b, t0b, lm_config, frozen=done_now)
        qn = quat_normalize(res.q)
        ric, rfc = res.initial_cost, res.final_cost
        drop_new = torch.where(ric != 0, (ric - rfc) / torch.where(ric != 0, ric, 1.0), 0.0)
        slot = torch.clamp(it, 0, n_outer - 1).long()[:, None]

        def upd(buf, val):
            return torch.where(keep[:, None], buf.scatter(1, slot, val.to(buf.dtype)[:, None]),
                               buf)

        ic, fc, nc = upd(ic, ric), upd(fc, rfc), upd(nc, n_corr)
        unuseful = torch.where(keep, torch.where(low, unuseful + 1, 0), unuseful)
        q = torch.where(keep[:, None], quat_multiply(qn, q), q)
        t = torch.where(keep[:, None], unit_quat_rotate(qn, t) + res.t, t)
        drop = torch.where(keep, drop_new.to(dtype), drop)
        ovf = ovf + torch.where(keep, ovf_b.to(torch.int32), 0)
        it = torch.where(keep, it + 1, it)
    if stats is not None:
        stats["outer_loops"] = stats.get("outer_loops", 0) + loops
        stats["capture_seconds"] = stats.get("capture_seconds", 0.0) + lm.capture_seconds
        stats["graphs_captured"] = stats.get("graphs_captured", 0) + len(lm._captured)
    return BatchedPairResult(q=q, t=t, initial_costs=ic, final_costs=fc,
                             num_correspondences=nc, num_iterations=it, overflow=ovf)


def _identity(sources):
    dtype, dev = sources.dtype, sources.device
    return (torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev),
            torch.zeros(3, dtype=dtype, device=dev))


def batched_pair_register(
    sources: torch.Tensor,  # (B, N, 3)
    targets: torch.Tensor,  # (B, M, 3)
    source_valid: torch.Tensor,  # (B, N)
    target_valid: torch.Tensor,  # (B, M)
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    n_outer: int,
    source_tile: int = 4096,
    target_tile: int = 2048,
    cost_drop_thresh: float = -1.0,
    n_cost_drop_it: int = 5,
    stats: Optional[dict] = None,
) -> BatchedPairResult:
    """Register every (source, target) pair, streaming brute-force engine
    (``ops/neighbors.py::radius_search`` pair by pair: it runs no kernel).

    ``cost_drop_thresh < 0`` disables the convergence rule (fixed ``n_outer``
    iterations — benchmarking); otherwise each pair stops exactly where the
    sequential host loop would. ``stats`` as :func:`_outer_loop`'s."""

    def search(moved):
        pts, masks = [], []
        for b in range(moved.shape[0]):
            corr = radius_search(
                moved[b], targets[b], k=k, radius=radius, source_valid=source_valid[b],
                target_valid=target_valid[b], source_tile=source_tile,
                target_tile=target_tile,
            )
            pts.append(targets[b][corr.indices.long()])
            masks.append(corr.mask)
        mask = torch.stack(masks)
        return torch.stack(pts), mask, mask.sum(dim=(1, 2)), torch.zeros_like(mask[:, 0, 0],
                                                                              dtype=torch.int32)

    return _outer_loop(search, sources, *_identity(sources), lm_config, n_outer,
                       cost_drop_thresh, n_cost_drop_it, stats)


def batched_pair_register_grid(
    sources: torch.Tensor,  # (B, N, 3)
    targets: torch.Tensor,  # (B, M, 3)
    source_valid: torch.Tensor,  # (B, N)
    bucket_pts: torch.Tensor,  # (B, U_max, capacity, 3)
    bucket_idx: torch.Tensor,  # (B, U_max, capacity)
    luts: torch.Tensor,  # (B, lut_len)
    origins: torch.Tensor,  # (B, 3)
    dims: torch.Tensor,  # (B, 3) int32
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    n_outer: int,
    capacity: int,
    source_tile: Optional[int] = None,
    cost_drop_thresh: float = -1.0,
    n_cost_drop_it: int = 5,
    stats: Optional[dict] = None,
) -> BatchedPairResult:
    """Batched registration with per-pair hash grids — the production
    single-device engine (ops/grid.py), batch-padded to a common capacity and
    occupied-cell count so every pair shares one program. Each source block
    is one k-selection launch across the pairs; ``source_tile`` (rows a
    pair) defaults to :func:`pick_source_tile` over the stacked rows."""
    if source_tile is None:
        source_tile = pick_source_tile(capacity, pairs=sources.shape[0])

    def search(moved):
        corr = batched_grid_radius_search(
            moved, bucket_pts, bucket_idx, luts, origins, dims, k=k, radius=radius,
            capacity=capacity, source_valid=source_valid, source_tile=source_tile,
        )
        pts = torch.stack([targets[b][corr.indices[b].long()] for b in range(moved.shape[0])])
        return (pts, corr.mask, corr.mask.sum(dim=(1, 2)),
                torch.zeros(moved.shape[0], dtype=torch.int32, device=moved.device))

    return _outer_loop(search, sources, *_identity(sources), lm_config, n_outer,
                       cost_drop_thresh, n_cost_drop_it, stats)


def batched_pair_register_pool(
    sources: torch.Tensor,  # (B, N, 3)
    source_valid: torch.Tensor,  # (B, N)
    select_xyz: tuple,  # per class: (B, n_c + 1, 3, W_c) float32
    pool_idx: tuple,  # per class: (B, n_c + 1, W_c)
    class_width_luts: tuple,  # per class: (B, n_c + 1) class-local kernel widths
    lut_d: torch.Tensor,  # (B, prod_d_pad) packed grouping keys
    origin_d: torch.Tensor,  # (B, 3)
    dims_d: torch.Tensor,  # (B, 3)
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    n_outer: int,
    class_widths: tuple,
    class_ends: tuple,
    class_budgets: tuple,
    budget_rows: int,
    small_unions: bool = False,
    select_max_w: int | None = None,
    cost_drop_thresh: float = -1.0,
    n_cost_drop_it: int = 5,
    stats: Optional[dict] = None,
) -> BatchedPairResult:
    """Batched registration with per-pair capacity-free POOLED prepacks —
    the flagship engine (ops/fused_pool.py), batch-harmonized to one static
    geometry (``plan_pool_host_group``) so every pair shares one program;
    each class pass is one select launch across the batch. The kernel emits
    the selected neighbors' coordinates, so no per-pair target cloud is
    consulted inside the loop at all. Pairs whose runtime budget flag fires
    report ``overflow > 0`` and must be redone on the grid engine.

    The pools' arguments follow ``fused_pool_search``'s: the float32
    ``select_xyz`` and the class-local width tables; the JAX package's
    ``union_lut``, ``interpret`` and ``dyn_rounds`` are not taken
    (``small_unions`` is its ``dyn_rounds`` hint)."""

    def search(moved):
        corr, overflow, pts = _fp.batched_fused_pool_search(
            moved, source_valid, select_xyz, pool_idx, class_width_luts, lut_d, origin_d,
            dims_d, k=k, radius=radius, class_widths=class_widths, class_ends=class_ends,
            class_budgets=class_budgets, budget_rows=budget_rows, small_unions=small_unions,
            select_max_w=select_max_w,
        )
        return pts, corr.mask, corr.mask.sum(dim=(1, 2)), overflow

    return _outer_loop(search, sources, *_identity(sources), lm_config, n_outer,
                       cost_drop_thresh, n_cost_drop_it, stats)


def shard_batch(arrays, mesh: Mesh, axis_name: str = POINTS_AXIS):
    """This rank's contiguous block of each array's leading (batch) axis
    over ``axis_name`` (the JAX package's ``PartitionSpec(axis_name)``
    placement); tuples of arrays are sharded element by element."""
    return tuple(
        shard_batch(a, mesh, axis_name) if isinstance(a, tuple)
        else shard_rows(a, mesh, axis_name)
        for a in arrays
    )


class _HostPhases:
    """Opens the spans of a batch's host phases; ``seconds`` sums their
    wall seconds (``stats["host_seconds"]``)."""

    def __init__(self):
        self.seconds = 0.0

    @contextlib.contextmanager
    def __call__(self, name: str):
        with spans.span(name) as s:
            yield s
        self.seconds += s.seconds


class _PaddedScans(dict):
    """The batch's scans by index, each padded with zero rows to one row
    count (the longest scan's, rounded up to ``pad_multiple``) at its first
    use, so that a rank pads only the scans its pairs read."""

    def __init__(self, scans, pad_multiple: int):
        super().__init__()
        self.scans = scans
        self.rows = round_up(max(s.shape[0] for s in scans), pad_multiple)
        self.counts = np.asarray([s.shape[0] for s in scans])

    def __missing__(self, i) -> np.ndarray:
        p = self[i] = np.zeros((self.rows, 3))
        p[: self.counts[i]] = self.scans[i]
        return p

    def stack(self, ids) -> np.ndarray:
        return np.stack([self[int(i)] for i in ids])


def _batched_grids_host(clouds, counts, idx_tgt, radius, host: Optional[_HostPhases] = None):
    """Per-pair hash grids padded to a common (U_max, capacity, lut_len),
    built in a ``batch_grid`` span (``host``'s, when given); ``clouds[i]``
    is scan i padded.

    Returns None if any pair can't build a grid (degenerate / LUT too big /
    occupancy too high) — caller falls back to the brute engine.
    """
    host = _HostPhases() if host is None else host
    uniq = {}
    with host("batch_grid"):
        for i in np.unique(idx_tgt):
            g = build_grid_host(clouds[i], radius, num_valid=int(counts[i]))
            if g is None or "lut" not in g:
                return None
            uniq[int(i)] = g
    cap = max(g["capacity"] for g in uniq.values())
    cap = 1 << (cap - 1).bit_length()
    u_max = max(g["cell_ids"].shape[0] for g in uniq.values())
    lut_len = max(g["lut"].shape[0] for g in uniq.values())

    b = len(idx_tgt)
    bp = np.zeros((b, u_max, cap, 3), dtype=clouds[int(idx_tgt[0])].dtype)
    bi = np.full((b, u_max, cap), -1, dtype=np.int32)
    luts = np.full((b, lut_len), -1, dtype=np.int32)
    origins = np.zeros((b, 3))
    dims = np.zeros((b, 3), dtype=np.int32)
    for row, i in enumerate(idx_tgt):
        g = uniq[int(i)]
        u, c = g["bucket_idx"].shape
        bp[row, :u, :c] = g["bucket_pts"]
        bi[row, :u, :c] = g["bucket_idx"]
        luts[row, : g["lut"].shape[0]] = g["lut"]
        origins[row] = g["origin"]
        dims[row] = g["dims"]
    return bp, bi, luts, origins, dims, cap


def _agree(mesh: Mesh | None, **fields) -> dict:
    """This rank's named int64 fields merged with every rank's over
    "points", from one ``all_gather`` in the span ``batch_agree``, read
    back on the host (the wait on the slowest rank). Each field is ``(rule,
    value)``, the value one shape on every rank; the rule merges the ranks'
    values: "max" elementwise, "each" their (ranks, ...) stack, "distinct"
    rows keyed by their first column (-1: none) summed over distinct keys.
    Without a mesh this rank is every rank."""
    vals = [np.asarray(value, np.int64) for _, value in fields.values()]
    got = np.concatenate([v.ravel() for v in vals])[None]
    if mesh is not None:
        with spans.span("batch_agree"):
            x = torch.as_tensor(got[0], device=mesh.device)
            got = mesh.all_gather(x, POINTS_AXIS, span=False).cpu().numpy()
    out, at = {}, 0
    for (name, (rule, _)), v in zip(fields.items(), vals):
        g = got[:, at:at + v.size].reshape((len(got),) + v.shape)
        at += v.size
        if rule == "max":
            out[name] = g.max(axis=0)
        elif rule == "each":
            out[name] = g
        else:
            rows = {int(r[0]): r[1:] for r in g.reshape(-1, v.shape[-1]) if r[0] >= 0}
            out[name] = np.sum(list(rows.values()), axis=0)
    return out


def _agree_statics(statics, rows: int, mesh: Mesh | None):
    """The pool statics of every rank's block merged, the same on every
    rank; None when any rank declined (``statics`` None). Each rank's
    histogram is padded to ``rows`` plans."""
    nb, ns = _fp.WIDTH_BINS, len(_fp.STATIC_SIZES)
    mine = statics or _fp.PoolStatics(np.zeros(nb), np.zeros((0, nb)), np.zeros(ns))
    got = _agree(mesh, declined=("max", statics is None), widths=("each", mine.widths),
                 hist=("each", np.pad(mine.hist, ((0, rows - len(mine.hist)), (0, 0)))),
                 sizes=("each", mine.sizes))
    if got["declined"]:
        return None
    return _fp.merge_pool_statics([_fp.PoolStatics(*part) for part in zip(
        got["widths"], got["hist"], got["sizes"])])


def _batched_pools_host(clouds, counts, idx_tgt, radius, k, dtype, idx_src,
                        device="cuda", host: Optional[_HostPhases] = None,
                        mesh: Mesh | None = None):
    """Per-pair POOLED prepacks harmonized to one static geometry
    (ops.fused_pool.plan_pool_host_group), built on ``device`` and stacked on
    the batch axis, with the search's final budgets; the grids, the plan
    and the rest in ``host``'s spans ``batch_grid``, ``batch_plan`` and
    ``batch_build``. ``clouds[i]`` is scan i padded (one row count for
    every scan); the count ``batch_targets`` records the distinct targets
    planned.

    ``idx_tgt`` / ``idx_src`` are the pairs this call prepares. On a
    ``mesh`` they are this rank's block of the batch (the same number of
    pairs on every rank): the rank plans and builds only its block's
    targets, and two ``all_gather`` of a few hundred int64 agree what every
    rank's program shares: the plan statics (ladder, per-class real counts,
    padded sizes) before the forced plans, then the inputs of the budgets
    (``ops.fused_pool.search_budgets``) and of the small-unions hint. Every
    rank thus runs the geometry the whole batch's group plan gives.

    The row budget covers the most grouping demand of any pair's real
    source (the plans' target-occupancy proxy undercounts REAL pairs ~1.5x
    at KITTI scale, and in the batched engine an undercount sends those
    pairs to the grid-redo splice: correct but a whole second engine
    pass); the class-prefix budgets are the plans' own.

    Returns None when any pair (on any rank) declines the pooled engine —
    callers fall back to the batched grid engine.
    """
    host = _HostPhases() if host is None else host
    uniq_ids = sorted({int(i) for i in idx_tgt})
    spans.count("batch_targets", len(uniq_ids))
    smw = _fp._select_max_w(device)
    grids = {}
    with host("batch_grid"):
        for i in uniq_ids:
            # buckets=False: the pooled plan reads only the cell-sorted view.
            g = build_grid_host(clouds[i], radius, num_valid=int(counts[i]), buckets=False)
            if g is None:
                grids = None
                break
            grids[i] = g
    with host("batch_plan"):
        members = None if grids is None else ([grids[i] for i in uniq_ids],
                                              [clouds[i] for i in uniq_ids])
        statics = None if members is None else _fp.pool_group_statics(*members, device=device)
        statics = _agree_statics(statics, len(idx_tgt), mesh)
        force = None if statics is None else _fp.pool_group_force(statics)
        plans = None if force is None else _fp.plan_pool_host_forced(*members, force,
                                                                     device=device)
    if force is None:  # the same on every rank
        return None
    with host("batch_build"):
        n_classes = len(force["widths"])
        plan_of = dict(zip(uniq_ids, plans or ()))
        pres = {i: _fp.build_pool_prepack(grids[i], clouds[i], dtype=np.dtype(dtype), plan=plan,
                                          k=k, device=device) for i, plan in plan_of.items()}
        # The budgets' inputs (zeros where this rank declined): the plans'
        # own budgets, the replayed demand of the block's pairs, and each
        # distinct target's small-unions part.
        plan_rows, plan_classes = _fp.plan_budgets(plans) if plans else (0, (0,) * n_classes)
        demand, _ = _fp.pool_demand(
            (_fp.ReplayKeys.of(plan_of[int(t)]), clouds[int(s)][:int(counts[int(s)])])
            for s, t in (zip(idx_src, idx_tgt) if plans else ()))
        unions = np.full((len(idx_tgt), 3), -1, np.int64)
        for row, (i, plan) in zip(unions, plan_of.items()):
            row[0], row[1:] = i, _fp.small_unions_part(plan, k, smw)
        got = _agree(mesh, declined=("max", plans is None), plan_rows=("max", plan_rows),
                     plan_classes=("max", plan_classes), demand=("max", demand),
                     unions=("distinct", unions))
        if got["declined"]:
            return None
        budget_rows, class_budgets = _fp.search_budgets(
            _fp.demand_row_budget(got["plan_rows"], got["demand"]), clouds[uniq_ids[0]].shape[0],
            class_budgets=tuple(int(b) for b in got["plan_classes"]))

        first = pres[uniq_ids[0]]
        rows = [pres[int(i)] for i in idx_tgt]

        def stacked(field):
            return tuple(torch.stack([getattr(r, field)[c] for r in rows])
                         for c in range(n_classes))

        return {
            "select_xyz": stacked("select_xyz"),
            "pool_idx": stacked("pool_idx"),
            "class_width_luts": stacked("class_width_luts"),
            "lut_d": torch.stack([r.lut_d for r in rows]),
            "origin_d": torch.stack([r.origin_d for r in rows]),
            "dims_d": torch.stack([r.dims_d for r in rows]),
            "class_widths": first.class_widths,
            "class_ends": first.class_ends,
            "class_budgets": class_budgets,
            "budget_rows": budget_rows,
            "small_unions": small_unions_of(got["unions"], k),
            "select_max_w": smw,
        }


def _gather_result(result: BatchedPairResult, mesh: Mesh) -> BatchedPairResult:
    """Every rank's block of pairs, gathered over "points" in rank order:
    the whole batch's result on every rank."""
    return BatchedPairResult(*(
        mesh.all_gather(x, POINTS_AXIS).flatten(0, 1) for x in result
    ))


def run_odometry_batched(
    scans,
    *,
    k: int = 20,
    radius: float = 1.0,
    lm_config: LMConfig = LMConfig(),
    n_outer: int = 10,
    pad_multiple: int = 1024,
    mesh: Mesh | None = None,
    dtype=torch.float32,
    search_impl: str = "auto",
    cost_drop_thresh: float = -1.0,
    n_cost_drop_it: int = 5,
    device: str | torch.device | None = None,
    stats: Optional[dict] = None,
):
    """Whole-sequence odometry in one (optionally sharded) device program.

    Args:
      scans: list of (n_i, 3) numpy arrays.
      mesh: when given, the pair axis is sharded over its "points" axis
        (pairs padded up to a multiple of the axis size with dummy entries);
        each rank runs its contiguous block and the result is gathered on
        every rank. On the pooled engine a rank plans, builds and uploads
        only its block's pairs.
      dtype: a torch dtype or its name ("float32", "float64").
      search_impl: "auto" (the POOLED engine on a CUDA device when every
        pair supports it, grid otherwise; the JAX package's rule is pool on
        a TPU) | "pool" | "grid" | "brute". Pooled pairs whose runtime
        budget flag fires are automatically redone on the batched grid
        engine and spliced back.
      cost_drop_thresh / n_cost_drop_it: per-pair convergence rule
        (threshold < 0 = fixed n_outer iterations).
      device: where the batch runs: ``mesh.device`` on a mesh, else "cuda"
        unless the CPU is asked for.
      stats: a dict that receives ``engine`` ("pool", "grid" or "brute"),
        ``host_seconds`` (this rank's grids, pool plans and builds, uploads:
        the sum of its host phases' spans, the waits of the agree steps
        included), ``outer_loops`` (loop iterations the batch ran),
        ``capture_seconds`` and ``graphs_captured`` (the LM graphs') and,
        on the pooled engine, ``class_widths``, ``class_ends``,
        ``class_budgets``, ``budget_rows`` and ``pool_shapes`` (a pair's
        shape of each stacked pool array: the geometry every rank runs) and
        ``redone`` (the pairs the grid engine redid).

    Returns (poses [len(scans) x 4x4 numpy], BatchedPairResult).
    """
    n_scans = len(scans)
    if n_scans < 2:
        return [np.eye(4) for _ in range(n_scans)], None
    with spans.span("batch"):
        return _run_batch(scans, k=k, radius=radius, lm_config=lm_config, n_outer=n_outer,
                          pad_multiple=pad_multiple, mesh=mesh, dtype=dtype,
                          search_impl=search_impl, cost_drop_thresh=cost_drop_thresh,
                          n_cost_drop_it=n_cost_drop_it, device=device,
                          stats={} if stats is None else stats)


def _run_batch(scans, *, k, radius, lm_config, n_outer, pad_multiple, mesh, dtype, search_impl,
               cost_drop_thresh, n_cost_drop_it, device, stats):
    """:func:`run_odometry_batched` of two scans or more, inside its
    ``batch`` span."""
    n_scans = len(scans)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    dev = resolve_device(mesh.device if mesh is not None else device or "cuda")
    host = _HostPhases()
    b = n_scans - 1
    d = 1 if mesh is None else mesh.shape[POINTS_AXIS]
    b_pad = ((b + d - 1) // d) * d
    idx_src = np.minimum(np.arange(b_pad) + 1, n_scans - 1)
    idx_tgt = np.minimum(np.arange(b_pad), n_scans - 1)
    # This rank's contiguous block of the padded pairs (shard_rows' rule):
    # the pooled engine prepares only its pairs.
    per = b_pad // d
    lo = 0 if mesh is None else mesh.index(POINTS_AXIS) * per
    block = slice(lo, lo + per)
    clouds = _PaddedScans(scans, pad_multiple)
    counts = clouds.counts
    row = np.arange(clouds.rows)

    def upload(ids):
        """The pairs' sources ``ids`` as (B, N, 3) and their valid rows."""
        return (torch.as_tensor(clouds.stack(ids).astype(np_dtype), device=dev),
                torch.as_tensor(row[None, :] < counts[ids, None], device=dev))

    # The (B, N, 3) target stack uploads only for the grid/brute engines —
    # the pooled path's kernel emits the selected neighbors' coordinates
    # and never reads the target clouds.
    def mk_targets():
        return torch.as_tensor(clouds.stack(idx_tgt).astype(np_dtype), device=dev)

    def mk_tv():
        return torch.as_tensor(row[None, :] < counts[idx_tgt, None], device=dev)

    def local(arrays):
        return arrays if mesh is None else shard_batch(arrays, mesh)

    rule = dict(k=k, radius=radius, lm_config=lm_config, n_outer=n_outer,
                cost_drop_thresh=cost_drop_thresh, n_cost_drop_it=n_cost_drop_it,
                stats=stats)

    def grid_arrays(grids):
        bp, bi, luts, origins, dims, cap = grids
        return (torch.as_tensor(bp.astype(np_dtype), device=dev), torch.as_tensor(bi, device=dev),
                torch.as_tensor(luts, device=dev),
                torch.as_tensor(origins.astype(np_dtype), device=dev),
                torch.as_tensor(dims, device=dev)), cap

    pools = grids = None
    if search_impl == "pool" or (search_impl == "auto" and dev.type == "cuda"):
        with host("batch_build"):
            sources, sv = upload(idx_src[block])
        pools = _batched_pools_host(clouds, counts, idx_tgt[block], radius, k, np_dtype,
                                    idx_src=idx_src[block], device=dev, host=host, mesh=mesh)
        if pools is None and search_impl == "pool":
            raise ValueError("pool engine requested but some pair declines it")
    if pools is None:
        if search_impl in ("auto", "grid"):
            grids = _batched_grids_host(clouds, counts, idx_tgt, radius, host=host)
            if grids is None and search_impl == "grid":
                raise ValueError("grid engine requested but some pair has no grid")
        with host("batch_build"):
            sources, sv = upload(idx_src)

    stats["engine"] = "pool" if pools is not None else "grid" if grids is not None else "brute"
    if pools is not None:
        with host("batch_build"):
            # Already this rank's block: nothing to shard.
            arrays = (sources, sv, pools["select_xyz"], pools["pool_idx"],
                      pools["class_width_luts"], pools["lut_d"], pools["origin_d"],
                      pools["dims_d"])
        stats["host_seconds"] = host.seconds
        stats["class_widths"] = pools["class_widths"]
        stats["class_ends"] = pools["class_ends"]
        stats["class_budgets"] = pools["class_budgets"]
        stats["budget_rows"] = pools["budget_rows"]
        stats["pool_shapes"] = tuple(tuple(x.shape[1:]) for x in arrays[2:] for x in (
            x if isinstance(x, tuple) else (x,)))
        with spans.span("batch_loop"):
            result = batched_pair_register_pool(
                *arrays, class_widths=pools["class_widths"], class_ends=pools["class_ends"],
                class_budgets=pools["class_budgets"], budget_rows=pools["budget_rows"],
                small_unions=pools["small_unions"],
                select_max_w=pools["select_max_w"], **rule,
            )
        del arrays, pools, sources, sv
    elif grids is not None:
        with host("batch_build"):
            tables, cap = grid_arrays(grids)
            arrays = local((sources, mk_targets(), sv) + tables)
        stats["host_seconds"] = host.seconds
        with spans.span("batch_loop"):
            result = batched_pair_register_grid(*arrays, capacity=cap, **rule)
    else:
        with host("batch_build"):
            arrays = local((sources, mk_targets(), sv, mk_tv()))
        stats["host_seconds"] = host.seconds
        with spans.span("batch_loop"):
            result = batched_pair_register(*arrays, **rule)
    with spans.span("batch_gather"):
        if mesh is not None:
            result = _gather_result(result, mesh)
        if stats["engine"] == "pool":
            # The gathered flags are the same on every rank: every rank takes
            # the same branch (and redoes the same pairs).
            bad = np.flatnonzero(result.overflow.cpu().numpy() > 0)

    if stats["engine"] == "pool":
        stats["redone"] = [int(i) for i in bad]
        spans.count("redo_pairs", int(bad.size))
        if bad.size:
            # The runtime budget flag fired for these pairs — their results
            # are invalid; redo them on the batched grid engine and splice
            # (the batched analogue of the single-pair mid-pair fallback).
            with spans.span("batch_redo"):
                # Replicated on every rank, over pairs of every block.
                sub = _batched_grids_host(clouds, counts, idx_tgt[bad], radius, host=host)
                if sub is None:
                    raise RuntimeError("pooled budget overflow and no grid fallback available")
                with host("batch_build"):
                    tables, cap = grid_arrays(sub)
                    sel = torch.as_tensor(bad, device=dev)
                    redo_src, redo_sv = upload(idx_src[bad])
                    redo_tgt = torch.as_tensor(clouds.stack(idx_tgt[bad]).astype(np_dtype),
                                               device=dev)
                stats["host_seconds"] = host.seconds
                redo = batched_pair_register_grid(
                    redo_src, redo_tgt, redo_sv, *tables, capacity=cap, **rule)
                # Keep the pooled flags: nonzero now reads as "this pair was
                # redone on the grid engine" (results valid).
                result = BatchedPairResult(*(
                    x if name == "overflow" else x.index_copy(0, sel, part)
                    for name, x, part in zip(BatchedPairResult._fields, result, redo)
                ))

    qs = result.q.cpu().double().numpy()
    ts = result.t.cpu().double().numpy()
    poses = [np.eye(4)]
    for pair in range(b):
        rel = np.eye(4)
        q = qs[pair] / np.linalg.norm(qs[pair])
        rel[:3, :3] = np_quat_to_matrix(q)
        rel[:3, 3] = ts[pair]
        poses.append(poses[-1] @ rel)
    return poses, result
