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

Search engines: "fused" (ops/fused_grid.py, through the CUDA window-select
kernel on a GPU) and "brute" (ops/neighbors.py). ``auto`` takes the fused
engine when the target grid is kept by the density check, has no hot-cell
overflow set, and prepacks; otherwise brute force. When the fused engine's
group budget overflows mid-pair, the rest of the pair runs on the brute
engine: the loop says so through the output stream and counts it in
``engine_fallbacks``.

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
    np_se3_matrix,
    quat_rotate_points,
)
from ..core.types import pad_cloud
from ..ops import fused_grid as _fg
from ..ops.grid import build_grid_host
from ..ops.neighbors import radius_search
from ..utils.eval import calculate_mse
from ..utils.ostream import OutputStream
from .em_lm import LMConfig, em_lm_solve

REPORT_HEADER = (
    "iter, n_success_steps, initial_cost, final_cost, tx, ty, tz, "
    "roll, pitch, yaw, mse_prev_iter, mse_gtruth"
)

_ENGINES = ("auto", "fused", "brute")


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
      prepared_target: the result of :meth:`prepare_target`, if made earlier.
      device: where the search and solve run. "cuda" by default; CPU use
        must be asked for with "cpu". Nothing falls back to the CPU.
    """

    @staticmethod
    def prepare_target(target_cloud: np.ndarray, params: RegistrationParams) -> dict:
        """Host-side target preprocessing: pad + grid build (numpy only)."""
        target = np.asarray(target_cloud, dtype=np.float64)
        tg, n_tgt = pad_cloud(target, params.pad_multiple, pad_value=0.0)
        grid = None
        if params.search_impl in ("auto", "fused"):
            grid = build_grid_host(
                tg, params.radius, num_valid=n_tgt,
                max_overflow=params.grid_max_overflow,
            )
        return {"target_cloud": target, "tg": tg, "n_tgt": n_tgt, "grid": grid}

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
            prepared_target = self.prepare_target(target_cloud, params)
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
        if (
            grid is not None
            and params.search_impl == "auto"
            and 27 * grid["capacity"] * 8 > self._n_tgt
        ):
            grid = None
        self._prepack = None
        if grid is not None and "overflow_pts" in grid:
            # The hot-cell overflow merge is not ported: only brute force
            # finds those neighbors here.
            if params.search_impl == "fused":
                raise NotImplementedError(
                    "the target grid has a hot-cell overflow set; its merge "
                    "is not ported yet (use search_impl='brute')"
                )
            grid = None
        if grid is not None:
            pre = _fg.build_prepack(
                grid,
                torch.as_tensor(grid["bucket_pts"].astype(np_dtype), device=dev),
                torch.as_tensor(grid["bucket_idx"], device=dev),
                k=params.max_neighbours,
            )
            if pre is not None:
                self._prepack = pre
                self.out << (
                    f"Fused engine: {pre.n_dilated} dilated cells, "
                    f"{pre.n_lanes} candidate lanes\n"
                )
        self.engine = "fused" if self._prepack is not None else "brute"

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
        # Mid-pair moves from the fused engine to the brute engine.
        self.engine_fallbacks = 0
        self.current_iteration = 0
        self.cost_drop = 0.0
        self.num_unuseful_iter = 0
        self.mse_prev_it = 0.0
        self._prev_source = self.source_cloud.copy() if params.summary else None

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
            if self._prepack is not None:
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
                    # on the brute engine.
                    self._prepack = None
                    self.engine_fallbacks += 1
                    self.num_unuseful_iter = unuseful_before
                    self.out << (
                        "Fused-engine group overflow; falling back to the "
                        "brute-force engine for this pair\n"
                    )
                    continue
            else:
                corr = radius_search(
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
