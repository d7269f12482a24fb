"""Sequence-odometry CLI: scan-to-scan registration over a directory of PCDs.

No reference counterpart — the reference binary handles one pair per
invocation (src/prob_point_cloud_registration_ex.cc), leaving sequence runs
to external scripts. This command covers BASELINE.json configs #3/#4
(ETH ASL / KITTI sequential odometry) with durable per-pair checkpointing.

Port of the JAX package's ``cli_odometry.py``: the same flags, output and
files, with ``--device {cuda,cpu}`` (default ``cuda``) in place of
``--backend``; ``--dtype`` sets the compute dtype only.

``--mesh DPxTP`` runs each pair's align on a mesh of DP x TP ranks, one
process per rank under torchrun (``torchrun --standalone --nproc-per-node N
-m probabilistic_point_clouds_registration_tpu_torch.cli_odometry ...
--mesh DPxTP``, N = DP * TP); ``--mesh 1x1`` runs in one process. A world
size other than DP * TP is refused with exit code 2. Only rank 0 prints and
writes files.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

from .core.params import RegistrationParams
from .models.odometry import run_odometry
from .utils.eval import ate_rmse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="prob-point-clouds-odometry-torch",
        description="Sequential scan-to-scan probabilistic registration (PyTorch, CUDA)",
    )
    p.add_argument("scan_dir", help="Directory of .pcd scans (sorted by name) or a glob")
    p.add_argument("-o", "--output", default="trajectory.json",
                   help="Output trajectory / checkpoint file (JSON)")
    p.add_argument("-s", "--source_filter_size", type=float, default=0)
    p.add_argument("-t", "--target_filter_size", type=float, default=0)
    p.add_argument("-m", "--max_neighbours", type=int, default=20)
    p.add_argument("-i", "--num_iter", type=int, default=1000)
    p.add_argument("-d", "--dof", type=float, default=5)
    p.add_argument("-r", "--radius", type=float, default=3)
    p.add_argument("-c", "--cost_drop_treshold", type=float, default=0.01)
    p.add_argument("-n", "--num_drop_iter", type=int, default=5)
    p.add_argument("-u", "--use_gaussian", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--ground_truth", default=None,
                   help="Ground-truth trajectory for ATE RMSE: JSON ([[4x4], ...]) "
                        "or a KITTI poses file (12 floats per line)")
    p.add_argument("--calib", default=None,
                   help="KITTI calib.txt with the 'Tr' Velodyne->camera extrinsic; "
                        "required for meaningful ATE against KITTI camera-frame "
                        "ground truth (poses are re-expressed in the Velodyne frame)")
    p.add_argument("--max_scans", type=int, default=None,
                   help="Limit the number of scans (debug / benchmarking)")
    p.add_argument("--no_resume", action="store_true",
                   help="Ignore an existing checkpoint and start over")
    p.add_argument("--pose_graph", action="store_true",
                   help="After odometry: detect loop closures and refine the "
                        "trajectory with a pose-graph solve")
    p.add_argument("--closure_distance", type=float, default=1.0,
                   help="Max estimated-position distance for closure candidates")
    p.add_argument("--closure_min_gap", type=int, default=5,
                   help="Min scan-index gap for closure candidates")
    p.add_argument("--closure_max_mean_cost", type=float, default=None,
                   help="Max final cost per source point to accept a closure "
                        "(default 0.5 * radius^2; 'inf' disables)")
    p.add_argument("--closure_min_corr", type=float, default=1.0,
                   help="Min average correspondences per source point to "
                        "accept a closure (rejects non-overlapping pairs)")
    p.add_argument("--closure_max_alignment", type=float, default=3.0,
                   help="Max residual misalignment of an accepted closure, "
                        "in multiples of the target's median point spacing")
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the registrations and the pose-graph solve run")
    p.add_argument("--mesh", default=None, metavar="DPxTP",
                   help="Multi-device mesh for each pair's align, e.g. 2x2 = 2 "
                        "'points' shards x 2 'targets' shards: one process per "
                        "rank under torchrun (world size DP*TP); per-pair shard "
                        "plans and pool packing run on the prep thread")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    mesh = None
    started_group = False
    if args.mesh:
        import torch.distributed as dist

        from .parallel import initialize_multihost, make_mesh

        try:
            dp, tp = (int(x) for x in args.mesh.lower().split("x"))
            started_group = not dist.is_initialized() and initialize_multihost(
                device=args.device)
            mesh = make_mesh(dp, tp, device=None if args.device == "cuda" else "cpu")
        except ValueError as err:
            print(f"--mesh {args.mesh}: {err}")
            return 2
    main_rank = mesh is None or mesh.rank == 0

    def say(*parts):
        if main_rank:
            print(*parts, flush=True)

    scan_dir = Path(args.scan_dir)
    if scan_dir.is_dir():
        from .io.eth_csv import list_eth_scans
        from .io.kitti import list_velodyne_scans

        scans = (
            sorted(scan_dir.glob("*.pcd"))
            or list_eth_scans(scan_dir)  # ETH ASL challenging-datasets CSVs
            or list_velodyne_scans(scan_dir)
        )
    else:
        import glob as _glob  # stdlib glob handles absolute patterns

        scans = sorted(Path(p) for p in _glob.glob(args.scan_dir))
    if args.max_scans:
        scans = scans[: args.max_scans]
    if len(scans) < 2:
        say(f"Need at least 2 scans, found {len(scans)}")
        return 1
    say(f"Odometry over {len(scans)} scans ({len(scans) - 1} pairs)")

    params = RegistrationParams(
        max_neighbours=args.max_neighbours,
        dof=math.inf if args.use_gaussian else args.dof,
        radius=args.radius,
        n_iter=args.num_iter,
        cost_drop_thresh=args.cost_drop_treshold,
        n_cost_drop_it=args.num_drop_iter,
        verbose=args.verbose,
        summary=True,
        source_filter_size=args.source_filter_size,
        target_filter_size=args.target_filter_size,
        dtype=args.dtype,
    )

    ckpt = Path(args.output)
    if args.no_resume and ckpt.exists() and main_rank:
        ckpt.unlink()
    if mesh is not None and mesh.backend is not None:
        dist.barrier()  # no rank resumes from a checkpoint rank 0 is removing

    result = run_odometry(scans, params, checkpoint_path=ckpt, device=args.device, mesh=mesh)
    say(f"Trajectory written to {ckpt} ({len(result.poses)} poses)")

    poses = result.poses
    if args.pose_graph:
        from .models.loop_closure import detect_loop_closures, refine_trajectory

        closures = detect_loop_closures(
            scans, result, params,
            max_distance=args.closure_distance,
            min_index_gap=args.closure_min_gap,
            max_mean_cost=args.closure_max_mean_cost,
            min_correspondences_per_point=args.closure_min_corr,
            max_alignment_ratio=args.closure_max_alignment,
            verbose=args.verbose and main_rank,
            device=args.device,
        )
        say(f"Detected {len(closures)} loop closures")
        if closures:
            poses, cost = refine_trajectory(result, closures, device=args.device)
            refined_path = ckpt.with_name(ckpt.stem + "_refined" + ckpt.suffix)
            if main_rank:
                refined_path.write_text(
                    json.dumps({"poses": [p.tolist() for p in poses]})
                )
            say(f"Refined trajectory written to {refined_path} (cost {cost:.4g})")

    if args.ground_truth:
        # Dispatch by content, not filename: JSON trajectories keep working
        # whatever they are called; anything else is the KITTI pose format.
        gt_text = Path(args.ground_truth).read_text()
        try:
            gt = json.loads(gt_text)
            gt_poses = [np.asarray(m, dtype=np.float64) for m in gt]
        except json.JSONDecodeError:
            from .io.kitti import load_poses

            gt_poses = load_poses(args.ground_truth)
        if args.calib:
            from .io.kitti import camera_poses_to_velodyne, load_calibration

            tr = load_calibration(args.calib)
            gt_poses = camera_poses_to_velodyne(gt_poses, tr)
        # Anchor both trajectories at the first pose (odometry starts at I).
        gt0 = np.linalg.inv(gt_poses[0])
        gt_poses = [gt0 @ p for p in gt_poses]
        n = min(len(gt_poses), len(poses))
        rmse = ate_rmse(poses[:n], gt_poses[:n])
        say(f"ATE RMSE vs ground truth over {n} poses: {rmse}")
    if started_group:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
