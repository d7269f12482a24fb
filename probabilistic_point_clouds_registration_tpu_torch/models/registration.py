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

Per outer iteration the device rotates the source, searches, and runs the
EM-LM solve; the host composes 4x4 float64 transforms, applies the stopping
rule and appends report rows. This is the JAX package's one-iteration host
loop; its multi-iteration device scans are not ported (``outer_chunk`` is
ignored), and by contract they give the same host-visible result.

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

When the pooled engine's budget overflows mid-pair, the iteration is redone
at twice the row budget, twice; past that, and when the fused engine's group
budget overflows, the rest of the pair runs on the grid engine, as in the
JAX package: the loop says so through the output stream and counts it in
``engine_fallbacks``. A pooled pair uploads the grid's bucket tensors only
then.

Fidelity notes:
  * The inner solve is seeded with params.initial_rotation/translation every
    outer iteration, exactly like the reference (iteration.hpp:31-34).
  * Convergence reproduces cc:138-158 including the quirk that the check runs
    before the first iteration with cost_drop == 0, so the stall counter
    effectively starts at 1.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core.params import RegistrationParams
from ..core.se3 import (
    matrix_euler_xyz,
    np_matrix_to_quat,
    np_quat_to_matrix,
    np_se3_matrix,
    quat_rotate_points,
)
from ..core.types import bucket_rows, pad_cloud, round_up
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
from ..utils.eval import calculate_mse
from ..utils.ostream import OutputStream
from .em_lm import LMConfig, em_lm_solve

REPORT_HEADER = (
    "iter, n_success_steps, initial_cost, final_cost, tx, ty, tz, "
    "roll, pitch, yaw, mse_prev_iter, mse_gtruth"
)

_ENGINES = ("auto", "pool", "fused", "grid", "pallas", "brute")


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

    @staticmethod
    def prepare_target(target_cloud: np.ndarray, params: RegistrationParams,
                       device: str | torch.device = "cuda") -> dict:
        """Host-side target preprocessing for a run on ``device``: pad, grid
        build and, when the pooled engine is the expected one, its host plan
        (numpy only).

        The pooled engine reads only the grid's cell-sorted view, so its
        grid skips the bucket tensors; they are added the moment the plan
        declines. ``pool_plan`` is False when the plan was attempted and
        declined, None when it was not attempted; ``pool_cutoff`` is the
        narrow-class cutoff it was made for.
        """
        target = np.asarray(target_cloud, dtype=np.float64)
        tg, n_tgt = pad_cloud(target, params.pad_multiple, pad_value=0.0)
        try_pool = _pool_expected(params, device)
        grid = None
        pool_plan = None
        if params.search_impl in ("auto", "grid", "fused", "pool"):
            grid = build_grid_host(
                tg, params.radius, num_valid=n_tgt,
                max_overflow=params.grid_max_overflow, buckets=not try_pool,
            )
        # The ctor drops the grid on "auto" when the candidate set is too
        # close to M; no plan is made for a grid it will not use.
        if grid is not None and try_pool and not _too_dense(grid, n_tgt, params):
            pool_plan = _fp.plan_pool_host(grid, tg, device=device) or False
            if pool_plan is False:
                add_buckets_host(grid, tg)  # for the engines after the pool
        return {"target_cloud": target, "tg": tg, "n_tgt": n_tgt, "grid": grid,
                "pool_plan": pool_plan, "pool_cutoff": _fp._select_max_w(device)}

    def __init__(
        self,
        source_cloud: np.ndarray,
        target_cloud: np.ndarray,
        params: RegistrationParams,
        ground_truth_cloud: Optional[np.ndarray] = None,
        prepared_target: Optional[dict] = None,
        device: str | torch.device = "cuda",
    ):
        params.validate()
        _check_ported(params)
        self.params = params
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; pass "
                "device='cpu' to run on the CPU"
            )
        self.out = OutputStream(params.verbose)
        self.dtype = getattr(torch, params.dtype)
        np_dtype = np.dtype(params.dtype)

        self.source_cloud = np.array(source_cloud, dtype=np.float64)
        self.filtered_source = self.source_cloud.copy()
        if prepared_target is None:
            prepared_target = self.prepare_target(target_cloud, params, self.device)
        self.target_cloud = prepared_target["target_cloud"]
        self.ground_truth = ground_truth_cloud is not None
        self.mse_ground_truth = 0.0
        if self.ground_truth:
            self.ground_truth_cloud = np.array(ground_truth_cloud, dtype=np.float64)
            self.mse_ground_truth = calculate_mse(self.source_cloud, self.ground_truth_cloud)
            self.out << f"Initial MSE w.r.t. ground truth: {self.mse_ground_truth}\n"

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
        # Pooled row-budget escalation rung (x2 per overflow, twice).
        self._pool_budget_boost = 0
        plan = prepared_target.get("pool_plan")
        if prepared_target.get("pool_cutoff") != _fp._select_max_w(dev):
            plan = None  # planned for another device's cutoff
        if grid is not None and _pool_expected(params, dev):
            if plan is None:
                plan = _fp.plan_pool_host(grid, tg, device=dev) or False
            if plan:
                self._init_pool(grid, tg, plan, np_dtype)
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

        self._lm_config = LMConfig(
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
        self.transformation_history: List[np.ndarray] = []
        self.records: List[IterationRecord] = []
        self.iteration_times: List[float] = []  # wall seconds per outer iter
        # Inner solves that ran into max_inner_iterations (the reference runs
        # Ceres unbounded, cc:96 — a hit means results may diverge from it).
        self.inner_cap_hits = 0
        # Mid-pair moves from the pooled or fused engine to the grid engine.
        self.engine_fallbacks = 0
        self.current_iteration = 0
        self.cost_drop = 0.0
        self.num_unuseful_iter = 0
        self.mse_prev_it = 0.0
        self._prev_source = self.source_cloud.copy() if params.summary else None

    def _init_pool(self, grid: dict, tg: np.ndarray, plan: dict, np_dtype) -> None:
        """Build the pool and size its budgets (registration.py:917-986 of
        the JAX package)."""
        p = self.params
        pool = _fp.build_pool_prepack(
            grid, tg, dtype=np_dtype, plan=plan, k=p.max_neighbours,
            device=self.device,
        )
        # Row budget from the real source's grouping demand: the plan's
        # target-occupancy proxy undercounts moved sources (they land in
        # dilated shell cells it scores 0). The class-prefix budgets come
        # from the same replay; the overflow flag still guards drift.
        rot = np_quat_to_matrix(np.asarray(p.initial_rotation, np.float64))
        moved0 = self.filtered_source @ rot.T + np.asarray(p.initial_translation, np.float64)
        demand, self._pool_class_cum = _fp.estimate_pool_demand_rows(
            plan, moved0, class_row_ends=pool.class_ends
        )
        self._pool_budget_base = max(
            pool.budget_rows, bucket_rows(int(1.25 * demand), step_bits=3)
        )
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
        # Boost the EFFECTIVE budget (the source-rows floor may dominate).
        budget = round_up(
            max(self._pool_budget_base, self._src.shape[0] + 4096)
            << self._pool_budget_boost,
            2048,
        )
        ng_b = round_up(budget, 2 * _fg.BLOCK_GROUPS * _fg.GROUP) // _fg.GROUP
        class_budgets = _fp.demand_class_budgets(
            self._pool_class_cum, ng_b, boost=self._pool_budget_boost, cap=ng_b
        )
        return budget, class_budgets

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

    # -- reference API ------------------------------------------------------

    def align(self) -> np.ndarray:
        """Run the outer loop to convergence; returns the final 4x4 transform.

        Per-outer-iteration wall times land in ``self.iteration_times``.
        """
        p = self.params
        q0 = torch.tensor(p.initial_rotation, dtype=self.dtype, device=self.device)
        t0 = torch.tensor(p.initial_translation, dtype=self.dtype, device=self.device)
        while True:
            # has_converged() mutates the stall counter; a fallback redo of
            # this iteration restores it so the redo's check is a replay.
            unuseful_before = self.num_unuseful_iter
            if self.has_converged():
                break
            iter_start = time.perf_counter()
            t_cum = self.transformation()
            q_cum = torch.as_tensor(
                np_matrix_to_quat(t_cum[:3, :3]), dtype=self.dtype, device=self.device
            )
            t_cum_dev = torch.as_tensor(t_cum[:3, 3], dtype=self.dtype, device=self.device)
            moved = quat_rotate_points(q_cum, self._src) + t_cum_dev
            if self._pool is not None:
                corr, overflow, gathered = self._pool_search(moved)
                if int(overflow) > 0:
                    # A row or class-prefix budget overflowed: nothing was
                    # consumed. Redo the iteration at a doubled budget
                    # (twice), then on the grid engine for the rest of the
                    # pair (uploaded only now).
                    self.num_unuseful_iter = unuseful_before
                    if self._pool_budget_boost < 2:
                        self._pool_budget_boost += 1
                        self.out << (
                            "Pooled-engine budget overflow; retrying with a "
                            f"{1 << self._pool_budget_boost}x row budget\n"
                        )
                        continue
                    self._pool = None
                    self._ensure_grid_device()
                    self.engine_fallbacks += 1
                    self.out << (
                        "Pooled-engine budget overflow; falling back to the "
                        "grid engine for this pair\n"
                    )
                    continue
            elif self._prepack is not None:
                pre = self._prepack
                corr, overflow, gathered = _fg.fused_grid_search(
                    moved,
                    self._src_valid,
                    pre.cand_xyz,
                    pre.cand_idx,
                    pre.width_lut,
                    pre.lut_d,
                    pre.origin_d,
                    pre.dims_d,
                    k=p.max_neighbours,
                    radius=p.radius,
                    n_lanes=pre.n_lanes,
                )
                if int(overflow) > 0:
                    # Pathologically scattered sources blew the 2N group
                    # budget: redo this iteration, and the rest of the pair,
                    # on the grid engine.
                    self._prepack = None
                    self.engine_fallbacks += 1
                    self.num_unuseful_iter = unuseful_before
                    self.out << (
                        "Fused-engine group overflow; falling back to the "
                        "grid engine for this pair\n"
                    )
                    continue
                if self._grid.overflow_pts is not None:
                    # The merge can reorder or replace selections: gather
                    # again.
                    corr = self._merge_overflow(corr, moved)
                    gathered = self._tgt[corr.indices.long()]
            elif self._grid is not None:
                g = self._grid
                corr = grid_radius_search(
                    moved, g.bucket_pts, g.bucket_idx, g.cell_ids, g.origin,
                    g.dims, g.lut,
                    k=p.max_neighbours,
                    radius=p.radius,
                    capacity=g.capacity,
                    source_valid=self._src_valid,
                    source_tile=pick_source_tile(g.capacity),
                    select_impl=p.search_select,
                )
                if g.overflow_pts is not None:
                    corr = self._merge_overflow(corr, moved)
                gathered = self._tgt[corr.indices.long()]
            else:
                search = (
                    pallas_radius_search if p.search_impl == "pallas" else radius_search
                )
                corr = search(
                    moved,
                    self._tgt,
                    k=p.max_neighbours,
                    radius=p.radius,
                    source_valid=self._src_valid,
                    target_valid=self._tgt_valid,
                    target_tile=p.search_target_tile,
                )
                gathered = self._tgt[corr.indices.long()]
            result = em_lm_solve(moved, gathered, corr.mask, q0, t0, self._lm_config)
            self._process_iteration(
                result.q,
                result.t,
                result.initial_cost,
                result.final_cost,
                result.num_iterations,
                result.num_successful_steps,
                torch.sum(corr.mask),
                time.perf_counter() - iter_start,
            )

        if self.ground_truth:
            final = self.transformation()
            aligned = self.source_cloud @ final[:3, :3].T + final[:3, 3]
            self.mse_ground_truth = calculate_mse(aligned, self.ground_truth_cloud)
            print(f"MSE w.r.t. ground truth: {self.mse_ground_truth}")
        return self.transformation()

    def _process_iteration(
        self, q_raw, t_raw, initial_cost, final_cost, num_iterations,
        num_successful, n_corr, iter_time,
    ) -> None:
        """Host bookkeeping for one completed outer iteration: compose the
        incremental transform (f64), cost drop, MSE metrics, CSV record."""
        p = self.params
        t_cum = self.transformation()
        # Incremental transform (iteration.hpp:59-67: quaternion normalized
        # on extraction), left-composed (cc:101-107).
        q = q_raw.detach().cpu().numpy().astype(np.float64)
        q = q / np.linalg.norm(q)
        t = t_raw.detach().cpu().numpy().astype(np.float64)
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
    """Raise for the options whose code is not ported yet."""
    if params.search_impl not in _ENGINES:
        raise NotImplementedError(
            f"search_impl={params.search_impl!r} is not ported yet "
            f"(available: {', '.join(_ENGINES)})"
        )
    if params.source_filter_size > 0 or params.target_filter_size > 0:
        raise NotImplementedError("the voxel filter is not ported yet")
    if params.trace_inner or params.profile_dir:
        raise NotImplementedError("trace_inner and profile_dir are not ported yet")


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
