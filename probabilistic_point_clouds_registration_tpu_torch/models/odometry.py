"""Sequential scan-to-scan odometry over a sequence of point clouds (port of
the JAX package's ``models/odometry.py``).

The reference is a single-pair tool: sequences (ETH ASL, KITTI) are driven
by external scripts invoking the binary per pair. This module makes the
sequence a pipeline: consecutive scans are registered pairwise, relative
transforms compose into a trajectory, and the trajectory is checkpointed
after every pair so a killed job resumes at the last registered scan (the
reference's durable outputs are only the aligned cloud and the summary TXT,
src/prob_point_cloud_registration_ex.cc:161-183). The checkpoint is the JAX
package's JSON format, so either package resumes the other's.

While pair i runs, a prep thread prepares pair i+1's target (voxel filter,
pad, grid build, pool plan) and stages the pooled engine's device state on
a CUDA stream of its own (``prepare_target(stage=True)``), and a
:class:`~..io.prefetch.ScanPrefetcher` reads the next scans.

With a mesh (``parallel/``) every rank runs the sequence, each pair as a
``DistributedRegistration``; the prep thread makes the shard plans and
packs this rank's shard's pools, with no collective (the pair's ctor
broadcasts them on the main thread, so the ranks' collectives keep one
order). Only rank 0 prints and writes the checkpoint.
"""
from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from ..core.params import RegistrationParams
from ..utils import spans
from ..utils.device import resolve_device
from ..utils.eval import ate_rmse
from ..utils.ostream import OutputStream
from .registration import ProbabilisticRegistration

CHECKPOINT_VERSION = 1

ScanSource = Union[np.ndarray, str, Path]


def result_final_cost(reg: ProbabilisticRegistration) -> float:
    """Final weighted EM cost of the last outer iteration."""
    return float(reg.records[-1].final_cost)


def _load_scan(scan: ScanSource) -> np.ndarray:
    if isinstance(scan, (str, Path)):
        if str(scan).endswith(".bin"):
            from ..io.kitti import load_velodyne_bin

            return load_velodyne_bin(scan).astype(np.float64)
        if str(scan).endswith(".csv"):
            from ..io.eth_csv import load_eth_csv

            return load_eth_csv(scan)
        from ..io.pcd import load_pcd

        return load_pcd(str(scan))
    return np.asarray(scan, dtype=np.float64)


@dataclass
class OdometryResult:
    """Trajectory estimate for a scan sequence.

    Attributes:
      poses: absolute 4x4 poses, one per scan; poses[0] is identity (the
        first scan's frame is the world frame).
      relative_transforms: per-pair incremental transforms; entry i maps scan
        i+1 into scan i's frame.
      per_pair_cost: final weighted EM cost of each pair's last outer
        iteration (diagnostic; from the CSV report's final_cost column).
      reports: per-pair CSV iteration reports.
      inner_cap_hits: total inner LM solves across the sequence that ran
        into params.max_inner_iterations (the reference runs Ceres
        unbounded, src/prob_point_cloud_registration.cc:96 — nonzero means
        some solves were truncated relative to reference behavior).
      engine_fallbacks: mid-pair engine fallbacks over the pairs this run
        registered (not checkpointed).
      prep_seconds / prep_wait_seconds / capture_seconds: per pair this
        run registered, the prep thread's seconds on the pair's target, the
        seconds the main thread waited for it, and the seconds spent
        capturing the pair's LM graphs (not checkpointed).
    """

    poses: List[np.ndarray] = field(default_factory=list)
    relative_transforms: List[np.ndarray] = field(default_factory=list)
    per_pair_cost: List[float] = field(default_factory=list)
    reports: List[str] = field(default_factory=list)
    inner_cap_hits: int = 0
    engine_fallbacks: int = 0
    prep_seconds: List[float] = field(default_factory=list)
    prep_wait_seconds: List[float] = field(default_factory=list)
    capture_seconds: List[float] = field(default_factory=list)

    def ate_rmse(self, ground_truth_poses: Sequence[np.ndarray]) -> float:
        return ate_rmse(self.poses, list(ground_truth_poses))


def save_checkpoint(path: Union[str, Path], result: OdometryResult) -> None:
    """Atomically write the trajectory checkpoint (JSON; small and durable)."""
    path = Path(path)
    payload = {
        "version": CHECKPOINT_VERSION,
        "num_pairs": len(result.relative_transforms),
        "poses": [p.tolist() for p in result.poses],
        "relative_transforms": [t.tolist() for t in result.relative_transforms],
        "per_pair_cost": result.per_pair_cost,
        # Reports persist too so reports[i] stays aligned with
        # relative_transforms[i] across resume.
        "reports": result.reports,
        "inner_cap_hits": result.inner_cap_hits,
    }
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(payload))
    tmp.replace(path)


def load_checkpoint(path: Union[str, Path]) -> Optional[OdometryResult]:
    path = Path(path)
    if not path.exists():
        return None
    payload = json.loads(path.read_text())
    if payload.get("version") != CHECKPOINT_VERSION:
        raise ValueError(
            f"checkpoint version {payload.get('version')} != {CHECKPOINT_VERSION}"
        )
    return OdometryResult(
        poses=[np.asarray(p, dtype=np.float64) for p in payload["poses"]],
        relative_transforms=[
            np.asarray(t, dtype=np.float64) for t in payload["relative_transforms"]
        ],
        per_pair_cost=list(payload["per_pair_cost"]),
        reports=list(payload.get("reports", [])),
        inner_cap_hits=int(payload.get("inner_cap_hits", 0)),
    )


def run_odometry(
    scans: Sequence[ScanSource],
    params: Optional[RegistrationParams] = None,
    *,
    checkpoint_path: Optional[Union[str, Path]] = None,
    on_pair: Optional[Callable[[int, np.ndarray], None]] = None,
    mesh=None,
    device="cuda",
) -> OdometryResult:
    """Register consecutive scans and return the composed trajectory.

    Scan i+1 (source) is aligned onto scan i (target); the estimated relative
    transform ``T_rel`` maps new-scan coordinates into the previous frame, so
    absolute poses compose as ``pose[i+1] = pose[i] @ T_rel``.

    Args:
      scans: sequence of (n, 3) arrays or scan paths (PCD, KITTI ``.bin``,
        ETH ``.csv``; read ahead by a prefetcher).
      params: per-pair registration parameters.
      checkpoint_path: when set, the trajectory is written after every pair
        and a pre-existing checkpoint resumes the run at the first
        unregistered pair.
      on_pair: optional callback (pair_index, absolute_pose) after each pair.
      mesh: a ``parallel.Mesh``: each pair then runs the multi-device
        align (``parallel.align.DistributedRegistration``) on every rank,
        the mesh's device in place of ``device``. A pair whose target the
        sharded pooled engine declines runs single-device, on every rank.
      device: where the pairs run ("cuda" unless the caller asks for "cpu").
    """
    if mesh is not None:
        from ..parallel.align import DistributedRegistration
        from ..parallel.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh={mesh!r}: pass a parallel.Mesh (parallel.make_mesh)")
    dev = resolve_device(device) if mesh is None else mesh.device
    main = mesh is None or mesh.rank == 0
    params = params or RegistrationParams()
    out = OutputStream(params.verbose and main)
    n_scans = len(scans)
    if n_scans == 0:
        return OdometryResult()

    result: Optional[OdometryResult] = None
    if checkpoint_path is not None:
        result = load_checkpoint(checkpoint_path)
        if result is not None:
            out << (
                f"Resuming odometry from checkpoint "
                f"({len(result.relative_transforms)}/{n_scans - 1} pairs done)\n"
            )
    if result is None:
        result = OdometryResult(poses=[np.eye(4)])

    from ..io.prefetch import ScanPrefetcher

    def prep(scan, pair):
        with spans.span("prep", pair=pair) as s:
            if mesh is None:
                prepared = ProbabilisticRegistration.prepare_target(scan, params, dev, stage=True)
            else:
                prepared = DistributedRegistration.prepare_target(scan, params, mesh, stage=True)
        return prepared, s.seconds

    start_pair = len(result.relative_transforms)
    # Target-prep pipeline: pair i's TARGET is scan i, which was pair i-1's
    # source — so while pair i-1 computes on the device, a background thread
    # voxel-filters, pads, grid-builds and plans scan i and stages its pool.
    prep_pool = ThreadPoolExecutor(max_workers=1)
    try:
        with ScanPrefetcher(scans) as prefetcher:
            prev_scan = prefetcher.get(start_pair) if start_pair < n_scans - 1 else None
            prep_future = None
            if prev_scan is not None:
                prep_pair = spans.new_pair()
                prep_future = prep_pool.submit(prep, prev_scan, prep_pair)

            for i in range(start_pair, n_scans - 1):
                # Overlaps the next scans' disk read/decompress with device compute.
                source = prefetcher.get(i + 1)
                target = prev_scan if prev_scan is not None else prefetcher.get(i)
                pair = prep_pair
                with spans.span("prep_wait", pair=pair) as wait:
                    prepared, prep_s = prep_future.result()
                result.prep_wait_seconds.append(wait.seconds)
                result.prep_seconds.append(prep_s)
                # Schedule the NEXT pair's target prep (this pair's source)
                # before the device work starts.
                if i + 1 < n_scans - 1:
                    prep_pair = spans.new_pair()
                    prep_future = prep_pool.submit(prep, source, prep_pair)
                else:
                    prep_future = None
                out << f"[pair {i}] registering scan {i + 1} ({source.shape[0]} pts) onto scan {i} ({target.shape[0]} pts)\n"

                if mesh is None:
                    reg = ProbabilisticRegistration(
                        source, target, params, prepared_target=prepared, device=dev
                    )
                elif prepared["sp"] is not None:
                    reg = DistributedRegistration(
                        source, target, params, mesh=mesh, prepared_target=prepared
                    )
                else:
                    out << f"[pair {i}] sharded pooled engine declined; single-device fallback\n"
                    reg = ProbabilisticRegistration(source, target, params, device=dev)
                t_rel = reg.align()

                pose = result.poses[-1] @ t_rel
                result.relative_transforms.append(t_rel)
                result.poses.append(pose)
                result.per_pair_cost.append(
                    result_final_cost(reg) if reg.records else float("nan")
                )
                result.reports.append(reg.report())
                result.inner_cap_hits += reg.inner_cap_hits
                result.engine_fallbacks += reg.engine_fallbacks
                result.capture_seconds.append(reg._lm.capture_seconds)

                if checkpoint_path is not None and main:
                    with spans.span("checkpoint", pair=pair if reg._pair is None else reg._pair):
                        save_checkpoint(checkpoint_path, result)
                if on_pair is not None:
                    on_pair(i, pose)
                prev_scan = source  # next pair's target is this (unmoved) scan
    finally:
        prep_pool.shutdown(wait=True, cancel_futures=True)

    return result
