"""Probabilistic point-cloud registration: the outer EM-ICP loop (port of
the JAX package's ``models/registration.py``).

The reference's main class (prob_point_cloud_registration.h:18-64,
src/prob_point_cloud_registration.cc:15-158):

  while not converged:
    re-associate (radius-capped KNN against the target)      cc:66-83
    inner EM solve for an incremental SE(3)                  cc:85-100
    left-compose onto the cumulative transform               cc:101-107
    move the source clouds                                   cc:110-112
    track cost drop + CSV report row                         cc:119-129

The loop runs in chunks of up to ``outer_chunk`` outer iterations, as the
JAX package's scans do (``_scan_convergence`` there): per slot the device
rotates the source by the cumulative transform it carries, searches, runs
the EM-LM solve (models/em_lm.py: blocks of fixed-shape steps, CUDA graphs
on a card), composes the increment onto the carried transform and applies
the reference's stopping rule to the carried cost drop and stall counter.
The host fetches a chunk's per-slot outputs in one transfer and replays the
same rule on them in float64 (``_consume_chunk``), composing the 4x4
transforms and appending the report rows. A slot the device's rule stopped
takes no LM step and ends the chunk: the host learns it from the solve's
block read.

Search engines: "pool" (ops/fused_pool.py, the capacity-free pooled engine,
through the CUDA select kernels on a GPU), "fused" (ops/fused_grid.py, the
dense prepack), "grid" (ops/grid.py, the hash-grid engine every other grid
engine falls back to; its k-selection is ``search_select``), "pallas"
(ops/neighbors_pallas.py, brute force through the KNN kernel; no grid is
built) and "brute" (ops/neighbors.py). Brute force is also what runs when no
grid exists: the host build declined, or ``auto``'s density check dropped
it.

``auto`` with a grid, on a CUDA device, follows the JAX package's ``auto``
on its accelerator: the pooled engine when the pool plan accepts the scan;
else the fused engine when the fit estimate holds (grouped rows <= 1.7 x
padded targets) and it prepacks; else the grid engine. ``auto`` with
``device="cpu"`` skips the pooled engine and the fit estimate: the fused
engine when it prepacks, else the grid engine. (The JAX package's ``auto``
off its accelerator is the grid engine; neighbor sets are equal.) The fused
engine merges a grid's hot-cell overflow set after its search.

When the pooled engine's budget overflows in a chunk, the chunk is
discarded and redone at twice the row budget, twice; past that, and when
the fused engine's group budget overflows, the rest of the pair runs on the
grid engine, as in the JAX package: the loop says so through the output
stream and counts it in ``engine_fallbacks``. A pooled pair uploads the
grid's bucket tensors only then.

Fidelity notes:
  * The inner solve is seeded with params.initial_rotation/translation every
    outer iteration, exactly like the reference (iteration.hpp:31-34).
  * Convergence reproduces cc:138-158 including the quirk that the check runs
    before the first iteration with cost_drop == 0, so the stall counter
    effectively starts at 1.
  * The source and target are voxel-filtered first when
    ``source_filter_size`` / ``target_filter_size`` > 0 (cc:24-41); the
    search and solve use the filtered source, the MSE columns the
    unfiltered one. The caller's arrays are not mutated.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core.params import RegistrationParams
from ..core.se3 import (
    matrix_euler_xyz,
    np_matrix_to_quat,
    np_quat_to_matrix,
    np_se3_matrix,
    quat_multiply,
    quat_normalize,
    quat_rotate_points,
    unit_quat_rotate,
)
from ..core.types import pad_cloud
from ..ops import fused_grid as _fg
from ..ops import fused_pool as _fp
from ..ops.grid import (
    add_buckets_host,
    build_grid_host,
    grid_radius_search,
    grid_to_device,
    merge_overflow,
    pick_source_tile,
)
from ..ops.neighbors import radius_search
from ..ops.neighbors_pallas import pallas_radius_search
from ..ops.voxel import voxel_downsample
from ..utils import spans
from ..utils.device import resolve_device
from ..utils.eval import calculate_mse
from ..utils.ostream import OutputStream
from .em_lm import LMBlocks, LMConfig

REPORT_HEADER = (
    "iter, n_success_steps, initial_cost, final_cost, tx, ty, tz, "
    "roll, pitch, yaw, mse_prev_iter, mse_gtruth"
)

_ENGINES = ("auto", "pool", "fused", "grid", "pallas", "brute")
# Columns of a chunk slot's output row (one float64 row per slot, fetched
# for the whole chunk in one transfer); the LM trace follows at _TRACE.
_Q, _T, _IC, _FC, _NIT, _NSUCC, _NCORR, _OVF, _EXEC, _TRACE = (
    slice(0, 4), slice(4, 7), 7, 8, 9, 10, 11, 12, 13, 14)


class Association(NamedTuple):
    """One outer iteration's search result as the solve takes it."""

    source: torch.Tensor  # (N', 3) the moved source rows the solve runs over
    targets: torch.Tensor  # (N', K, 3) their gathered neighbors
    mask: torch.Tensor  # (N', K)
    n_corr: torch.Tensor  # 0-d correspondences (over every rank of a mesh)
    overflow: Optional[torch.Tensor]  # 0-d budget overflow; None: the engine has none
    probe: Optional[torch.Tensor] = None  # what a replication check compares


@dataclass
class IterationRecord:
    """One outer-iteration report row (the CSV columns at cc:44-46)."""

    iteration: int
    num_successful_steps: int
    initial_cost: float
    final_cost: float
    translation: np.ndarray  # cumulative (3,)
    rpy_deg: np.ndarray  # cumulative roll/pitch/yaw, degrees, Eigen (0,1,2)
    mse_prev_iter: float
    mse_ground_truth: float
    num_correspondences: int

    def csv(self) -> str:
        t = self.translation
        r = self.rpy_deg
        return (
            f"{self.iteration}, {self.num_successful_steps}, {self.initial_cost}, "
            f"{self.final_cost}, {t[0]}, {t[1]}, {t[2]}, {r[0]}, {r[1]}, {r[2]}, "
            f"{self.mse_prev_iter}, {self.mse_ground_truth}"
        )


class ProbabilisticRegistration:
    """Outer registration loop (ProbPointCloudRegistration equivalent).

    Args:
      source_cloud: (n, 3) numpy array.
      target_cloud: (m, 3) numpy array (not mutated).
      params: RegistrationParams.
      ground_truth_cloud: optional (n, 3) aligned ground truth for the source;
        enables the MSE-vs-ground-truth column (cc:50-61).
      prepared_target: the result of :meth:`prepare_target`, if made earlier
        (for any device: a pool plan made for another device's narrow-class
        cutoff is made again, and the bucket tensors a pooled grid skipped
        are added when another engine takes the grid).
      device: where the search and solve run. "cuda" by default; CPU use
        must be asked for with "cpu". Nothing falls back to the CPU.
    """

    _pair = None  # the pair id of the ctor's spans

    @staticmethod
    def prepare_target(target_cloud: np.ndarray, params: RegistrationParams,
                       device: str | torch.device = "cuda", *,
                       stage: bool = False) -> dict:
        """Target preprocessing for a run on ``device``: voxel filter
        (``target_filter_size`` > 0), pad, grid build and, when the pooled
        engine is the expected one, its host plan. Without ``stage`` it is
        host only, so a sequence pipeline can run it on a background thread
        for the next pair's target while the current pair computes.

        The pooled engine reads only the grid's cell-sorted view, so its
        grid skips the bucket tensors; they are added the moment the plan
        declines. ``pool_plan`` is False when the plan was attempted and
        declined, None when it was not attempted; ``pool_cutoff`` is the
        narrow-class cutoff it was made for.

        ``stage=True`` (the JAX package's ``device=True``) also builds the
        pooled engine's device state when the plan accepted the target
        (``pool_prepack``): on a CUDA device on a stream of its own, with an
        event (``pool_event``) that the ctor makes its stream wait on before
        the first use. The ctor then skips its own build.

        The result carries the pair id (``pair``) of its spans: that of the
        span open around the call, else a new one; the ctor takes it over.
        """
        if isinstance(device, bool):
            raise TypeError(
                f"prepare_target(..., device={device!r}): the third argument is "
                "the device here; to stage the pooled engine's device state "
                "(the JAX package's positional device=True) pass stage=True"
            )
        with spans.span("prepare_target", pair=spans.pair_or_new()) as s:
            target = np.asarray(target_cloud, dtype=np.float64)
            if params.target_filter_size > 0:
                target = voxel_downsample(target, params.target_filter_size)
            tg, n_tgt = pad_cloud(target, params.pad_multiple, pad_value=0.0)
            try_pool = _pool_expected(params, device)
            grid = None
            pool_plan = None
            if params.search_impl in ("auto", "grid", "fused", "pool"):
                with spans.span("grid_build"):
                    grid = build_grid_host(
                        tg, params.radius, num_valid=n_tgt,
                        max_overflow=params.grid_max_overflow, buckets=not try_pool,
                    )
            # The ctor drops the grid on "auto" when the candidate set is too
            # close to M; no plan is made for a grid it will not use.
            if grid is not None and try_pool and not _too_dense(grid, n_tgt, params):
                with spans.span("pool_plan"):
                    pool_plan = _fp.plan_pool_host(grid, tg, device=device) or False
                if pool_plan is False:
                    add_buckets_host(grid, tg)  # for the engines after the pool
            prepared = {"target_cloud": target, "tg": tg, "n_tgt": n_tgt, "grid": grid,
                        "pool_plan": pool_plan, "pool_cutoff": _fp._select_max_w(device),
                        "pair": s.pair}
            if stage and pool_plan:
                dev = resolve_device(device)
                prepared["pool_device"] = dev
                prepared["pool_prepack"], prepared["pool_event"] = _stage_pool(
                    grid, tg, pool_plan, params, dev)
        return prepared

    def __init__(
        self,
        source_cloud: np.ndarray,
        target_cloud: np.ndarray,
        params: RegistrationParams,
        ground_truth_cloud: Optional[np.ndarray] = None,
        prepared_target: Optional[dict] = None,
        device: str | torch.device = "cuda",
    ):
        pair = spans.pair_or_new((prepared_target or {}).get("pair"))
        with spans.span("ctor", pair=pair):
            self._pair = pair
            self._init_host_prelude(source_cloud, params, device)
            np_dtype = np.dtype(params.dtype)
            if prepared_target is None:
                if params.target_filter_size > 0:
                    self.out << (f"Filtering target point cloud with leaf of size "
                                 f"{params.target_filter_size}\n")
                prepared_target = self.prepare_target(target_cloud, params, self.device)
            self.target_cloud = prepared_target["target_cloud"]
            self._init_ground_truth(ground_truth_cloud)

            fs, self._n_src = pad_cloud(self.filtered_source, params.pad_multiple, pad_value=0.0)
            tg, self._n_tgt = prepared_target["tg"], prepared_target["n_tgt"]
            dev = self.device
            self._src = torch.as_tensor(fs.astype(np_dtype), device=dev)
            self._src_valid = torch.arange(fs.shape[0], device=dev) < self._n_src
            self._tgt = torch.as_tensor(tg.astype(np_dtype), device=dev)
            self._tgt_valid = torch.arange(tg.shape[0], device=dev) < self._n_tgt

            # Engine choice. The density check: a candidate set too close to M
            # is cheaper brute force (registration.py:865-873 of the JAX package).
            grid = prepared_target["grid"]
            if grid is not None and _too_dense(grid, self._n_tgt, params):
                grid = None
            self._grid = None  # the device grid, uploaded lazily
            self._grid_host = grid
            self._tg_padded = tg
            self._prepack = None
            self._pool = None
            self._pool_budget_base = 0
            self._pool_class_cum = None
            plan = prepared_target.get("pool_plan")
            staged = prepared_target.get("pool_prepack")
            if prepared_target.get("pool_cutoff") != _fp._select_max_w(dev):
                plan = staged = None  # planned for another device's cutoff
            if prepared_target.get("pool_device") != dev:
                staged = None  # staged on another device
            if grid is not None and _pool_expected(params, dev):
                if plan is None:
                    with spans.span("pool_plan"):
                        plan = _fp.plan_pool_host(grid, tg, device=dev) or False
                if plan:
                    self._init_pool(grid, tg, plan, np_dtype, staged,
                                    prepared_target.get("pool_event"))
            if (self._pool is None and grid is not None
                    and params.search_impl in ("auto", "fused")):
                # Live bucket slots per cell = min(count, capacity), which needs
                # no bucket tensors.
                counts = np.minimum(grid["cell_count"], grid["capacity"])
                est_rows = int(np.ceil(counts / _fg.GROUP).sum()) * _fg.GROUP
                dense_fit = est_rows <= 1.7 * tg.shape[0]
                # Explicit "fused" skips the fit estimate (the runtime overflow
                # flag still protects correctness), and so does the CPU's auto.
                if params.search_impl == "fused" or dev.type != "cuda" or dense_fit:
                    g = self._ensure_grid_device()
                    pre = _fg.build_prepack(
                        grid, g.bucket_pts, g.bucket_idx, k=params.max_neighbours
                    )
                    if pre is not None:
                        self._prepack = pre
                        self.out << (
                            f"Fused engine: {pre.n_dilated} dilated cells, "
                            f"{pre.n_lanes} candidate lanes\n"
                        )
            if self._pool is None and grid is not None:
                self._ensure_grid_device()
            self.engine = (
                "pool" if self._pool is not None
                else "fused" if self._prepack is not None
                else "grid" if self._grid is not None
                else "pallas" if params.search_impl == "pallas"
                else "brute"
            )

            self._lm_config = self._make_lm_config(params)
            # The inner solve's blocks: on a card CUDA graphs, captured at the
            # pair's first solve and replayed for the rest of the pair.
            self._lm = LMBlocks.for_device(self.device)
            self._init_bookkeeping(params)

    def _init_host_prelude(self, source_cloud, params: RegistrationParams, device,
                           main: bool = True) -> None:
        """Ctor prelude shared with ``parallel.align.DistributedRegistration``:
        validation, device, output stream (silent unless ``main``, the rank
        that prints), source load and voxel filter."""
        params.validate()
        _check_ported(params)
        self.params = params
        self.device = resolve_device(device)
        self._is_main = main
        self.out = OutputStream(params.verbose and main)
        self.dtype = getattr(torch, params.dtype)
        self.source_cloud = np.array(source_cloud, dtype=np.float64)
        if params.source_filter_size > 0:
            self.out << (f"Filtering source point cloud with leaf of size "
                         f"{params.source_filter_size}\n")
            self.filtered_source = voxel_downsample(self.source_cloud, params.source_filter_size)
        else:
            self.filtered_source = self.source_cloud.copy()

    def _init_ground_truth(self, ground_truth_cloud: Optional[np.ndarray]) -> None:
        """Ground-truth MSE bookkeeping (reference ..._ex.cc:128-139)."""
        self.ground_truth = ground_truth_cloud is not None
        self.mse_ground_truth = 0.0
        if self.ground_truth:
            self.ground_truth_cloud = np.array(ground_truth_cloud, dtype=np.float64)
            self.mse_ground_truth = calculate_mse(self.source_cloud, self.ground_truth_cloud)
            self.out << f"Initial MSE w.r.t. ground truth: {self.mse_ground_truth}\n"

    @staticmethod
    def _make_lm_config(params: RegistrationParams) -> LMConfig:
        return LMConfig(
            dof=params.dof,
            dimension=3,
            function_tolerance=params.function_tolerance,
            max_iterations=params.max_inner_iterations,
            initial_radius=params.initial_trust_region_radius,
            min_lm_diagonal=params.min_lm_diagonal,
            max_lm_diagonal=params.max_lm_diagonal,
            min_relative_decrease=params.min_relative_decrease,
            use_nonmonotonic_steps=params.use_nonmonotonic_steps,
        )

    def _init_bookkeeping(self, params: RegistrationParams) -> None:
        """Outer-loop state shared with the multi-device ``align()``:
        history, records, convergence counters, the pooled budget rung."""
        self.transformation_history: List[np.ndarray] = []
        self.records: List[IterationRecord] = []
        self.iteration_times: List[float] = []  # wall seconds per outer iter
        self.inner_iterations: List[int] = []  # LM iterations per outer iter
        # Inner solves that ran into max_inner_iterations (the reference runs
        # Ceres unbounded, cc:96 — a hit means results may diverge from it).
        self.inner_cap_hits = 0
        # Mid-pair moves from the pooled or fused engine to the grid engine.
        self.engine_fallbacks = 0
        # Pooled row-budget escalation rung (x2 per overflow, twice).
        self._pool_budget_boost = 0
        self.current_iteration = 0
        self.cost_drop = 0.0
        self.num_unuseful_iter = 0
        self.mse_prev_it = 0.0
        self._prev_source = self.source_cloud.copy() if params.summary else None

    def _init_pool(self, grid: dict, tg: np.ndarray, plan: dict, np_dtype,
                   staged=None, event=None) -> None:
        """Build the pool, or take the one :meth:`prepare_target` staged,
        and size its budgets (registration.py:917-986 of the JAX package)."""
        with spans.span("pool_build"):
            p = self.params
            pool = staged
            if pool is None:
                pool = _fp.build_pool_prepack(
                    grid, tg, dtype=np_dtype, plan=plan, k=p.max_neighbours,
                    device=self.device,
                )
            elif event is not None:
                # Staged on another stream: this stream waits for the build, and
                # the allocator keeps the pool's blocks until this stream's work
                # on them is done (not only the staging stream's).
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for t in _pool_tensors(pool):
                    t.record_stream(stream)
            # Row budget from the real source's grouping demand: the plan's
            # target-occupancy proxy undercounts moved sources (they land in
            # dilated shell cells it scores 0). The class-prefix budgets come
            # from the same replay; the overflow flag still guards drift.
            rot = np_quat_to_matrix(np.asarray(p.initial_rotation, np.float64))
            moved0 = self.filtered_source @ rot.T + np.asarray(p.initial_translation, np.float64)
            demand, self._pool_class_cum = _fp.estimate_pool_demand_rows(
                plan, moved0, class_row_ends=pool.class_ends
            )
            self._pool_budget_base = _fp.demand_row_budget(pool.budget_rows, demand)
            self._pool = pool
            self.out << (
                f"Pooled engine: {pool.n_dilated} dilated cells, "
                f"classes {pool.class_widths} x {pool.class_ends}\n"
            )

    def _ensure_grid_device(self):
        """Upload the hash grid (idempotent); returns the HashGrid, or None
        when no grid exists.

        Pooled pairs defer this: the pooled path never reads the bucket
        tensors, only the mid-pair budget-overflow fallback does. A grid
        prepared for the pool gets its bucket tensors and overflow split
        here.
        """
        if self._grid is not None or self._grid_host is None:
            return self._grid
        grid = add_buckets_host(self._grid_host, self._tg_padded)
        self._grid = grid_to_device(grid, np.dtype(self.params.dtype), self.device)
        n_over = 0 if self._grid.overflow_pts is None else self._grid.overflow_pts.shape[0]
        self.out << (
            f"Target grid: {self._grid.cell_ids.shape[0]} occupied cells, "
            f"capacity {self._grid.capacity}, overflow {n_over}\n"
        )
        return self._grid

    def _merge_overflow(self, corr, moved):
        """Merge the grid's hot-cell overflow set into ``corr``."""
        g = self._grid
        p = self.params
        return merge_overflow(
            corr, moved, g.overflow_pts, g.overflow_idx, k=p.max_neighbours,
            radius=p.radius, source_valid=self._src_valid,
        )

    def pool_budgets(self) -> tuple[int, tuple]:
        """The pooled search's (row budget, class-prefix budgets) at the
        current escalation rung (registration.py:1331-1362 of the JAX
        package)."""
        return _fp.search_budgets(
            self._pool_budget_base, self._src.shape[0], cum_groups=self._pool_class_cum,
            boost=self._pool_budget_boost, row_step=2048,
        )

    def _pool_search(self, moved):
        """One pooled search at the current escalation rung:
        (Correspondences, overflow, points)."""
        p = self.params
        pool = self._pool
        budget, class_budgets = self.pool_budgets()
        return _fp.fused_pool_search(
            moved, self._src_valid, pool.select_xyz, pool.pool_idx,
            pool.class_width_luts, pool.lut_d, pool.origin_d,
            pool.dims_d, k=p.max_neighbours, radius=p.radius,
            class_widths=pool.class_widths, class_ends=pool.class_ends,
            class_budgets=class_budgets, budget_rows=budget,
            small_unions=pool.small_unions, select_max_w=pool.select_max_w,
        )

    def _search(self, moved):
        """One search on the pair's engine: (Correspondences, overflow flag
        or None, gathered target points (N, K, 3))."""
        p = self.params
        if self._pool is not None:
            return self._pool_search(moved)
        if self._prepack is not None:
            pre = self._prepack
            corr, overflow, gathered = _fg.fused_grid_search(
                moved, self._src_valid, pre.cand_xyz, pre.cand_idx, pre.width_lut,
                pre.lut_d, pre.origin_d, pre.dims_d, k=p.max_neighbours,
                radius=p.radius, n_lanes=pre.n_lanes,
            )
            if self._grid.overflow_pts is not None:
                # The merge can reorder or replace selections: gather again.
                corr = self._merge_overflow(corr, moved)
                gathered = self._tgt[corr.indices.long()]
            return corr, overflow, gathered
        if self._grid is not None:
            g = self._grid
            corr = grid_radius_search(
                moved, g.bucket_pts, g.bucket_idx, g.cell_ids, g.origin, g.dims, g.lut,
                k=p.max_neighbours, radius=p.radius, capacity=g.capacity,
                source_valid=self._src_valid, source_tile=pick_source_tile(g.capacity),
                select_impl=p.search_select,
            )
            if g.overflow_pts is not None:
                corr = self._merge_overflow(corr, moved)
            return corr, None, self._tgt[corr.indices.long()]
        search = pallas_radius_search if p.search_impl == "pallas" else radius_search
        corr = search(
            moved, self._tgt, k=p.max_neighbours, radius=p.radius,
            source_valid=self._src_valid, target_valid=self._tgt_valid,
            target_tile=p.search_target_tile,
        )
        return corr, None, self._tgt[corr.indices.long()]

    def _associate(self, moved) -> Association:
        """One search on the pair's engine, as the solve takes it."""
        corr, overflow, gathered = self._search(moved)
        return Association(moved, gathered, corr.mask, corr.mask.sum(), overflow)

    def _run_chunk(self, conv0, slots: int, q0, t0, lm_config: LMConfig) -> np.ndarray:
        """Up to ``slots`` outer iterations from the host's state (see
        :func:`scan_convergence`)."""
        p = self.params
        return scan_convergence(
            self._associate, self._lm, self._src, self.transformation(), conv0, q0, t0,
            lm_config, slots=slots, n_iter=p.n_iter, cost_drop_thresh=p.cost_drop_thresh,
            n_cost_drop_it=p.n_cost_drop_it,
        )

    def _overflowed(self) -> None:
        """A chunk's pooled or fused search overflowed its budget: escalate
        the pooled row budget (x2, twice), else move the rest of the pair to
        the grid engine (uploaded only now)."""
        if self._pool is not None:
            if self._pool_budget_boost < 2:
                self._pool_budget_boost += 1
                self.out << (
                    "Pooled-engine budget overflow; retrying with a "
                    f"{1 << self._pool_budget_boost}x row budget\n"
                )
                return
            self._pool = None
            self._ensure_grid_device()
            self.out << ("Pooled-engine budget overflow; falling back to the "
                         "grid engine for this pair\n")
        else:
            # Pathologically scattered sources blew the fused engine's 2N
            # group budget.
            self._prepack = None
            self.out << ("Fused-engine group overflow; falling back to the "
                         "grid engine for this pair\n")
        self.engine_fallbacks += 1

    # -- reference API ------------------------------------------------------

    def align(self) -> np.ndarray:
        """Run the outer loop to convergence; returns the final 4x4 transform.

        Per-outer-iteration wall times land in ``self.iteration_times``.
        With ``params.profile_dir`` set, the loop runs under
        ``torch.profiler`` (CPU and, with a card, CUDA activity) and its
        trace is written into that directory (the JAX package's
        ``jax.profiler.trace``), with the loop's spans as ``pcr/`` ranges.
        """
        if self.params.profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            handler = torch.profiler.tensorboard_trace_handler(self.params.profile_dir)
            with torch.profiler.profile(activities=acts, on_trace_ready=handler):
                return self._align_loop()
        return self._align_loop()

    def _align_loop(self) -> np.ndarray:
        with spans.span("align", pair=self._pair):
            p = self.params
            q0 = torch.tensor(p.initial_rotation, dtype=self.dtype, device=self.device)
            t0 = torch.tensor(p.initial_translation, dtype=self.dtype, device=self.device)
            chunk = max(1, int(p.outer_chunk))
            lm_config = self._lm_config._replace(trace=True) if p.trace_inner else self._lm_config
            converged = False
            while not converged:
                # The device replays the host's check sequence from this
                # snapshot, taken before has_converged() moves the counter.
                conv0 = (np.float32(self.cost_drop), self.num_unuseful_iter,
                         self.current_iteration)
                if self.has_converged():
                    break
                # Slots past n_iter are stopped by the device's rule (an exact
                # integer test): none is launched.
                slots = max(1, min(chunk, p.n_iter - self.current_iteration))
                with spans.span("chunk") as c:
                    outs = self._run_chunk(conv0, slots, q0, t0, lm_config)
                    if outs[:, _OVF].sum() > 0:
                        # Nothing of the chunk is consumed; the loop-top check ran
                        # for an iteration that never happened: restore its counter.
                        self.num_unuseful_iter = conv0[1]
                        spans.count("redo")
                        self._overflowed()
                        continue
                    converged = self._consume_chunk(outs, c.elapsed())

            if self.ground_truth:
                final = self.transformation()
                aligned = self.source_cloud @ final[:3, :3].T + final[:3, 3]
                self.mse_ground_truth = calculate_mse(aligned, self.ground_truth_cloud)
                if self._is_main:
                    print(f"MSE w.r.t. ground truth: {self.mse_ground_truth}")
            return self.transformation()

    def _print_lm_trace(self, trace_rows, n_lm: int) -> None:
        """Per-LM-iteration diagnostics, the analogue of the reference's
        per-outer-iteration ``summary.FullReport()`` print (cc:108)."""
        for i in range(int(n_lm)):
            cost, quality, radius, accepted = trace_rows[i]
            self.out << (
                f"   lm_iter {i}: cost={cost:.6g} step_quality={quality:.4g} "
                f"trust_radius={radius:.4g} {'accepted' if accepted else 'rejected'}\n"
            )

    def _consume_chunk(self, outs: np.ndarray, seconds: float) -> bool:
        """Host bookkeeping for a chunk (the JAX package's
        ``_consume_chunk``, models/registration.py:1193-1234 there): the
        reference stopping rule re-applied row by row, exactly like a
        one-iteration loop (cc:65,138-158); ``seconds``, the chunk's time so
        far, is spread evenly over its iterations. Returns True when it
        fired mid-chunk."""
        executed = outs[:, _EXEC] > 0
        per_iter = seconds / max(1, int(executed.sum()))
        for j, row in enumerate(outs):
            unuseful_before = self.num_unuseful_iter
            if j > 0 and self.has_converged():
                return True
            if not executed[j]:
                if j == 0:
                    # The device stopped at slot 0 where the host's check
                    # said continue. Unreachable (the device's threshold is
                    # strictly conservative); fail rather than loop forever.
                    raise RuntimeError(
                        "device/host convergence rules diverged at a chunk "
                        "boundary — report this as a bug"
                    )
                # The device's conservative rule stopped here and the host's
                # has not fired (boundary slack): undo this check's counter
                # move; the next chunk re-checks the same iteration.
                self.num_unuseful_iter = unuseful_before
                return False
            if self.params.trace_inner:
                self._print_lm_trace(row[_TRACE:].reshape(-1, 4), row[_NIT])
            self._process_iteration(
                row[_Q], row[_T], row[_IC], row[_FC], row[_NIT], row[_NSUCC],
                row[_NCORR], per_iter,
            )
        return False

    def _process_iteration(
        self, q_raw, t_raw, initial_cost, final_cost, num_iterations,
        num_successful, n_corr, iter_time,
    ) -> None:
        """Host bookkeeping for one completed outer iteration (host values
        of one chunk row): compose the incremental transform (f64), cost
        drop, MSE metrics, CSV record."""
        p = self.params
        t_cum = self.transformation()
        # Incremental transform (iteration.hpp:59-67: quaternion normalized
        # on extraction), left-composed (cc:101-107).
        q = np.asarray(q_raw, dtype=np.float64)
        q = q / np.linalg.norm(q)
        t = np.asarray(t_raw, dtype=np.float64)
        current = np_se3_matrix(q, t) @ t_cum
        self.transformation_history.append(current)

        initial_cost = float(initial_cost)
        final_cost = float(final_cost)
        self.cost_drop = (initial_cost - final_cost) / initial_cost if initial_cost else 0.0

        # Conservative: a solve that converged exactly on its last allowed
        # iteration also counts as a hit.
        if int(num_iterations) >= p.max_inner_iterations:
            self.inner_cap_hits += 1
            if self.inner_cap_hits == 1:
                warnings.warn(
                    f"inner LM solve hit max_inner_iterations="
                    f"{p.max_inner_iterations}; the reference runs Ceres "
                    f"unbounded (prob_point_cloud_registration.cc:96) — "
                    f"results may diverge from it. Consider raising the cap.",
                    RuntimeWarning,
                    stacklevel=3,
                )

        if self.ground_truth or p.summary:
            moved_source = self.source_cloud @ current[:3, :3].T + current[:3, 3]
        if self.ground_truth:
            self.mse_ground_truth = calculate_mse(moved_source, self.ground_truth_cloud)
            self.out << f"MSE w.r.t. ground truth: {self.mse_ground_truth}\n"
        if p.summary:
            self.mse_prev_it = calculate_mse(moved_source, self._prev_source)
            self._prev_source = moved_source
        rpy = np.degrees(matrix_euler_xyz(current[:3, :3]))
        self.records.append(
            IterationRecord(
                iteration=self.current_iteration,
                num_successful_steps=int(num_successful),
                initial_cost=initial_cost,
                final_cost=final_cost,
                translation=current[:3, 3].copy(),
                rpy_deg=rpy,
                mse_prev_iter=self.mse_prev_it,
                mse_ground_truth=self.mse_ground_truth,
                num_correspondences=int(n_corr),
            )
        )
        self.iteration_times.append(iter_time)
        self.inner_iterations.append(int(num_iterations))
        self.out << (
            f"[iter {self.current_iteration}] correspondences={int(n_corr)} "
            f"cost {initial_cost:.6g} -> {final_cost:.6g} "
            f"(drop {self.cost_drop:.4f}), lm_iters={int(num_iterations)}, "
            f"{iter_time * 1e3:.1f} ms\n"
        )
        self.current_iteration += 1

    def has_converged(self) -> bool:
        """Stopping rule, reproducing cc:138-158 (incl. counter semantics)."""
        p = self.params
        if self.current_iteration == p.n_iter:
            self.out << (
                f"Terminating because maximum number of iterations has been reached "
                f"( {self.current_iteration} iter)\n"
            )
            return True
        if self.cost_drop < p.cost_drop_thresh:
            if self.num_unuseful_iter > p.n_cost_drop_it:
                self.out << (
                    f"Terminating because cost drop has been under "
                    f"{p.cost_drop_thresh * 100} % for more than {p.n_cost_drop_it} iterations\n"
                )
                return True
            self.num_unuseful_iter += 1
        else:
            self.num_unuseful_iter = 0
        return False

    def transformation(self) -> np.ndarray:
        """Cumulative 4x4 transform (identity before the first iteration)."""
        if self.transformation_history:
            return self.transformation_history[-1].copy()
        return np.eye(4)

    def report(self) -> str:
        """Per-iteration CSV report (header cc:44-46, rows cc:120-129)."""
        lines = [REPORT_HEADER]
        lines += [r.csv() for r in self.records]
        return "\n".join(lines) + "\n"


def scan_convergence(associate, lm: LMBlocks, source, t_cum: np.ndarray, conv0, q0, t0,
                     lm_config: LMConfig, *, slots: int, n_iter: int, cost_drop_thresh: float,
                     n_cost_drop_it: int, mesh=None, check=None) -> np.ndarray:
    """Up to ``slots`` outer iterations with the cumulative transform and
    the reference stopping rule carried on the device (the JAX package's
    ``_scan_convergence``, models/registration.py:205-275 there), from the
    host's 4x4 ``t_cum`` and state ``conv0`` = (cost drop as float32, stall
    counter, iteration). Each slot rotates ``source``, takes
    ``associate(moved)`` (an :class:`Association`) and solves on it with
    ``lm`` (``mesh`` serves ``lm_config.axis_name``); ``check(result,
    association)``, when given, may replace the result. Returns one float64
    row per slot run (columns ``_Q`` ... ``_TRACE``), fetched in one
    transfer.

    The rule is decided in float32 here and in float64 by the host
    (``_consume_chunk``), so the threshold is shifted down by more than
    float32's slack: the device may run a slot the host then discards,
    never stop where the host continues. A stopped slot takes no LM step,
    outputs the identity quaternion and zeros, and ends the chunk (its solve
    reads done at iteration 0); its search still ran. A slot whose search
    overflowed ends the chunk the same way, flagged. On a mesh every value
    the loop branches on is replicated, so every rank takes the same path.
    """
    dev, dtype = source.device, source.dtype
    carry = torch.as_tensor(
        np.concatenate([np_matrix_to_quat(t_cum[:3, :3]), t_cum[:3, 3],
                        np.array(conv0, dtype=np.float64)]),
        device=dev,
    )  # one upload per chunk
    qc, tc = carry[:4].to(dtype), carry[4:7].to(dtype)
    drop, unuseful, it = carry[7].float(), carry[8].int(), carry[9].int()
    done = torch.zeros((), dtype=torch.bool, device=dev)
    thresh = float(np.float32(
        cost_drop_thresh - max(abs(cost_drop_thresh), 1.0) * 1e-5))
    rows = []
    for _ in range(slots):
        low = drop < thresh
        stop = done | (it >= n_iter) | (low & (unuseful > n_cost_drop_it))
        unuseful = torch.where(stop, unuseful, torch.where(low, unuseful + 1, 0))
        moved = quat_rotate_points(qc, source) + tc
        with spans.span("search"):
            a = associate(moved)
        # An overflowed search's chunk is discarded: its solve takes no
        # step either, and the chunk ends there.
        halt = stop if a.overflow is None else stop | (a.overflow > 0)
        with spans.span("lm"):
            res, (lm_done, lm_iterations, _) = lm.solve(
                a.source, a.targets, a.mask, q0, t0, lm_config, frozen=halt, mesh=mesh)
        if check is not None:
            res = check(res, a)
        qn = quat_normalize(res.q)
        qc = torch.where(stop, qc, quat_multiply(qn, qc))
        tc = torch.where(stop, tc, unit_quat_rotate(qn, tc) + res.t)
        ic, fc = res.initial_cost.float(), res.final_cost.float()
        drop = torch.where(
            stop, drop,
            torch.where(ic != 0, (ic - fc) / torch.where(ic != 0, ic, 1.0), 0.0),
        )
        it = torch.where(stop, it, it + 1)
        done = stop
        f64 = torch.float64
        counts = [res.num_iterations, res.num_successful_steps, a.n_corr,
                  a.overflow if a.overflow is not None else a.mask.new_zeros(())]
        row = torch.cat([
            res.q.to(f64), res.t.to(f64),
            torch.stack([res.initial_cost.to(f64), res.final_cost.to(f64)]),
            torch.stack([c.reshape(()).to(f64) for c in counts]),
            torch.ones(1, dtype=f64, device=dev), res.trace.to(f64).reshape(-1),
        ])
        frozen = torch.zeros_like(row)
        frozen[0] = 1.0  # the identity quaternion; executed = 0
        rows.append(torch.where(stop, frozen, row))
        if lm_done and lm_iterations == 0:
            break  # stopped (and so would be the rest) or overflowed
    rows = torch.stack(rows)
    with spans.span("chunk_read"):
        return rows.cpu().numpy()


def _stage_pool(grid: dict, tg: np.ndarray, plan: dict, params: RegistrationParams,
                dev: torch.device):
    """(the pool prepack, the event that marks its build) for
    ``prepare_target(stage=True)``: on a CUDA device the build runs on a
    stream of its own, so a prep thread overlaps it with the current pair's
    work; elsewhere it runs in line (no event)."""
    kw = dict(dtype=np.dtype(params.dtype), plan=plan, k=params.max_neighbours, device=dev)
    if dev.type != "cuda":
        return _fp.build_pool_prepack(grid, tg, **kw), None
    stream = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(stream):
        pool = _fp.build_pool_prepack(grid, tg, **kw)
        event = torch.cuda.Event()
        event.record(stream)
    return pool, event


def _pool_tensors(pool):
    """Every tensor a pool prepack holds (fields and tuples of them)."""
    for value in pool:
        for item in value if isinstance(value, tuple) else (value,):
            if isinstance(item, torch.Tensor):
                yield item


def _too_dense(grid: dict, n_tgt: int, params: RegistrationParams) -> bool:
    """``auto``'s density check: a candidate set too close to M is cheaper
    brute force (registration.py:865-873 of the JAX package)."""
    return params.search_impl == "auto" and 27 * grid["capacity"] * 8 > n_tgt


def _pool_expected(params: RegistrationParams, device) -> bool:
    """Whether the pooled engine is tried first: asked for, or ``auto`` on
    a CUDA device."""
    return params.search_impl == "pool" or (
        params.search_impl == "auto" and torch.device(device).type == "cuda"
    )


def _check_ported(params: RegistrationParams) -> None:
    """Raise for a search engine this package does not have."""
    if params.search_impl not in _ENGINES:
        raise NotImplementedError(
            f"search_impl={params.search_impl!r} is not ported yet "
            f"(available: {', '.join(_ENGINES)})"
        )


def register_pair(
    source_cloud: np.ndarray,
    target_cloud: np.ndarray,
    params: Optional[RegistrationParams] = None,
    ground_truth_cloud: Optional[np.ndarray] = None,
    device: str | torch.device = "cuda",
):
    """Functional one-shot: align source onto target, return (4x4, registration)."""
    params = params or RegistrationParams()
    reg = ProbabilisticRegistration(
        source_cloud, target_cloud, params, ground_truth_cloud, device=device
    )
    final = reg.align()
    return final, reg
