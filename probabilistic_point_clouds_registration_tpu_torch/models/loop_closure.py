"""Loop-closure detection + trajectory refinement over an odometry run
(port of the JAX package's ``models/loop_closure.py``; the verification
registrations and the pose-graph solve run on ``device``, a CUDA device
unless the caller asks for the CPU).

Closes the loop (literally) on the sequence pipeline: odometry drift is
corrected by re-registering scan pairs whose estimated poses come back near
each other after a long excursion, then solving the pose graph
(models/pose_graph.py) over odometry + closure edges. No reference
counterpart — the reference stops at per-pair alignment
(src/prob_point_cloud_registration_ex.cc) and lets drift accumulate.

Detection is deliberately simple and fully deterministic: candidate pairs
(i, j) with |i - j| >= min_index_gap whose estimated positions lie within
``max_distance``; each candidate is verified by running the probabilistic
registration seeded at the odometry-predicted relative transform and
accepted when the solver's mean point-to-neighbor cost stays under
``max_mean_cost`` (rejects spurious matches in aliased geometry).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.params import RegistrationParams
from ..utils.device import resolve_device
from ..utils.ostream import OutputStream
from .odometry import OdometryResult, _load_scan
from .pose_graph import PoseGraphConfig, odometry_edges, optimize_pose_graph
from .registration import ProbabilisticRegistration


def _alignment_ratio(
    aligned_src: np.ndarray, tgt: np.ndarray, sample: int = 2048, device="cuda"
) -> float:
    """Residual misalignment in units of the target's own point spacing.

    Numerator: median NN distance of a (subsampled) aligned source into the
    target. Denominator: the target's median point spacing, estimated by
    matching an even-index sample against the odd-index half (self-matches
    excluded by construction). Subsampling keeps the host-side brute-force
    nearest-neighbor cost bounded for sequence-scale scans.
    """
    from ..utils.eval import median_closest_distance

    rng = np.random.default_rng(0)
    src = np.asarray(aligned_src, dtype=np.float64)
    tgt = np.asarray(tgt, dtype=np.float64)
    if src.shape[0] > sample:
        src = src[rng.choice(src.shape[0], sample, replace=False)]
    tgt_ref = tgt
    if tgt_ref.shape[0] > 8 * sample:
        tgt_ref = tgt_ref[rng.choice(tgt_ref.shape[0], 8 * sample, replace=False)]
    d_align = median_closest_distance(src, tgt_ref, device)
    even, odd = tgt_ref[0::2], tgt_ref[1::2]
    if even.shape[0] > sample:
        even = even[rng.choice(even.shape[0], sample, replace=False)]
    spacing = median_closest_distance(even, odd, device)
    if not np.isfinite(spacing) or spacing <= 0:
        return float("inf")
    return float(d_align / spacing)


@dataclass
class LoopClosure:
    i: int
    j: int
    relative_transform: np.ndarray  # maps scan j into scan i's frame
    mean_cost: float


def detect_loop_closures(
    scans: Sequence,
    result: OdometryResult,
    params: Optional[RegistrationParams] = None,
    *,
    max_distance: float = 1.0,
    min_index_gap: int = 5,
    max_candidates: int = 10,
    max_mean_cost: Optional[float] = None,
    min_correspondences_per_point: float = 1.0,
    max_alignment_ratio: float = 3.0,
    verbose: bool = False,
    device="cuda",
) -> List[LoopClosure]:
    """Find and verify loop closures against an estimated trajectory.

    Candidates are greedily limited to ``max_candidates`` pairs with the
    largest index gaps (the most drift-informative closures).

    Verification gates (all must pass — a non-overlapping candidate pair
    under drift yields near-zero correspondences and hence near-zero cost,
    the strongest *false* acceptance signal, so cost alone cannot gate):
      * ``min_correspondences_per_point``: the final outer iteration must
        retain at least this many correspondences per source point on
        average (k-capped neighbor hits; 0 disables).
      * ``max_alignment_ratio``: median NN distance of the refined-aligned
        source into the target, relative to the target's own median point
        spacing (self-calibrating: a well-registered overlapping pair sits
        at ~1x spacing whatever the absolute scale; residual misalignment
        shows up as a multiple of it). 0 or inf disables.
      * ``max_mean_cost``: final cost per *source point*. A row's cost is
        bounded by ~``radius**2 / 2`` (posterior weights sum to ~1 per
        row); the default ``0.5 * radius**2`` rejects solves whose weights
        are smeared to the radius rim (no alignment signal at all) while
        staying geometry-independent. ``float('inf')`` disables.

    Each verification registration runs on ``device``.
    """
    dev = resolve_device(device)
    params = params or RegistrationParams()
    if max_mean_cost is None:
        max_mean_cost = 0.5 * params.radius**2
    out = OutputStream(verbose)
    positions = np.stack([p[:3, 3] for p in result.poses])
    n = positions.shape[0]

    candidates: List[Tuple[int, int, float]] = []
    for i in range(n):
        delta = positions[i + min_index_gap :] - positions[i]
        if delta.size == 0:
            continue
        dist = np.linalg.norm(delta, axis=1)
        for off in np.nonzero(dist <= max_distance)[0]:
            j = i + min_index_gap + int(off)
            candidates.append((i, j, j - i))
    # Largest index gap first; deduplicate endpoints greedily.
    candidates.sort(key=lambda c: -c[2])
    used: set = set()
    picked = []
    for i, j, _ in candidates:
        if i in used or j in used:
            continue
        picked.append((i, j))
        used.update((i, j))
        if len(picked) >= max_candidates:
            break

    closures: List[LoopClosure] = []
    for i, j in picked:
        # Register scan j onto scan i, seeded by the odometry prediction.
        predicted = np.linalg.inv(result.poses[i]) @ result.poses[j]
        src = _load_scan(scans[j])
        tgt = _load_scan(scans[i])
        moved = src @ predicted[:3, :3].T + predicted[:3, 3]
        reg = ProbabilisticRegistration(moved, tgt, params, device=dev)
        t_refine = reg.align()
        rel = t_refine @ predicted
        n_src = max(reg._n_src, 1)
        n_corr = reg.records[-1].num_correspondences if reg.records else 0
        mean_cost = (
            reg.records[-1].final_cost / n_src if reg.records else float("inf")
        )
        corr_per_point = n_corr / n_src
        if corr_per_point < min_correspondences_per_point:
            out << (
                f"rejected closure {i} <- {j}: only {corr_per_point:.2f} "
                f"correspondences/point (no overlap)\n"
            )
            continue
        ratio = _alignment_ratio(moved @ t_refine[:3, :3].T + t_refine[:3, 3], tgt,
                                 device=dev)
        if 0 < max_alignment_ratio < float("inf") and ratio > max_alignment_ratio:
            out << (
                f"rejected closure {i} <- {j}: residual misalignment "
                f"{ratio:.2f}x target point spacing\n"
            )
        elif mean_cost <= max_mean_cost:
            out << (
                f"loop closure {i} <- {j}: mean cost {mean_cost:.3g}, "
                f"alignment {ratio:.2f}x spacing\n"
            )
            closures.append(
                LoopClosure(i=i, j=j, relative_transform=rel, mean_cost=mean_cost)
            )
        else:
            out << f"rejected closure {i} <- {j}: mean cost {mean_cost:.3g}\n"
    return closures


def refine_trajectory(
    result: OdometryResult,
    closures: Sequence[LoopClosure],
    *,
    odometry_weight: float = 1.0,
    closure_weight: float = 10.0,
    config: PoseGraphConfig = PoseGraphConfig(),
    device="cuda",
):
    """Pose-graph solve over odometry + closure edges on ``device``; returns
    (refined poses, final cost).

    Closure (i, j, T_rel maps scan j into scan i) becomes the constraint
    P_i^{-1} P_j = T_rel.
    """
    edges = odometry_edges(result.relative_transforms)
    weights = [odometry_weight] * len(edges)
    for c in closures:
        edges.append((c.i, c.j, c.relative_transform))
        weights.append(closure_weight)
    refined, cost = optimize_pose_graph(
        result.poses, edges, weights=weights, config=config, device=device
    )
    return refined, cost
