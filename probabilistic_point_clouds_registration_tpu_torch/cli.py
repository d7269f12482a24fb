"""Command line, flag-compatible with the reference executable.

Mirrors the tclap surface of src/prob_point_cloud_registration_ex.cc:34-93:
positional source/target PCD paths, the same short/long option names and
defaults (note the CLI default radius is 3 while the library default is 1,
..._ex.cc:49 vs params.hpp:8), ``--use_gaussian`` implemented as dof=inf
(..._ex.cc:93-97), verbose aligned-cloud dump (..._ex.cc:153-165), and the
``--dump`` summary file (..._ex.cc:166-183).

Port of the JAX package's ``cli.py``: the same flags, standard output and
files, with ``--device {cuda,cpu}`` (default ``cuda``; asking for CUDA where
there is none is an error) in place of ``--backend``, every search engine
of this package under ``--search_impl``, ``--dtype`` setting the compute
dtype only, and ``--profile_dir`` writing a ``torch.profiler`` trace.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

from .core.params import RegistrationParams
from .core.se3 import np_matrix_to_quat
from .io.pcd import load_pcd, save_pcd
from .models.registration import ProbabilisticRegistration
from .utils.eval import calculate_mse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="prob-point-clouds-registration-torch",
        description="Probabilistic point cloud registration (PyTorch, CUDA)",
    )
    p.add_argument("source_file_name", help="The path of the source point cloud")
    p.add_argument("target_file_name", help="The path of the target point cloud")
    p.add_argument(
        "-s", "--source_filter_size", type=float, default=0,
        help="The leaf size of the voxel filter of the source cloud",
    )
    p.add_argument(
        "-t", "--target_filter_size", type=float, default=0,
        help="The leaf size of the voxel filter of the target cloud",
    )
    p.add_argument(
        "-m", "--max_neighbours", type=int, default=20,
        help="The max cardinality of the neighbours' set",
    )
    p.add_argument(
        "-i", "--num_iter", type=int, default=1000,
        help="The maximum number of iterations to perform",
    )
    p.add_argument(
        "-d", "--dof", type=float, default=5,
        help="The Degree of freedom of t-distribution",
    )
    p.add_argument(
        "-r", "--radius", type=float, default=3,
        help="The radius of the neighborhood search",
    )
    p.add_argument(
        "-c", "--cost_drop_treshold", type=float, default=0.01,
        help="If the cost_drop drops below this threshold for too many iterations, "
        "the algorithm terminate",
    )
    p.add_argument(
        "-n", "--num_drop_iter", type=int, default=5,
        help="The maximum number of iterations during which the cost drop is "
        "allowed to be under cost_drop_thresh",
    )
    p.add_argument(
        "-u", "--use_gaussian", action="store_true",
        help="Whether to use a gaussian instead the a t-distribution",
    )
    p.add_argument("-v", "--verbose", action="store_true", help="Verbosity")
    p.add_argument(
        "-g", "--ground_truth", default=None,
        help="The path of the ground truth for the source cloud, if available",
    )
    p.add_argument("--dump", action="store_true", help="Dump registration data to file")
    # --- extensions (no reference counterpart) -------------------------------
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"],
                   help="device compute dtype")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the registration runs")
    p.add_argument("--search_impl", default="auto",
                   choices=["auto", "pool", "fused", "grid", "pallas", "brute"],
                   help="data-association engine")
    p.add_argument("--outer_chunk", type=int, default=4,
                   help="outer iterations carried on the device per chunk")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of align() to this directory")
    p.add_argument("--inner_report", action="store_true",
                   help="print per-LM-iteration diagnostics when verbose (the "
                        "reference's Ceres FullReport analogue)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    params = RegistrationParams(
        max_neighbours=args.max_neighbours,
        dof=math.inf if args.use_gaussian else args.dof,
        radius=args.radius,
        n_iter=args.num_iter,
        cost_drop_thresh=args.cost_drop_treshold,
        n_cost_drop_it=args.num_drop_iter,
        verbose=args.verbose,
        trace_inner=args.inner_report,
        summary=args.dump,
        source_filter_size=args.source_filter_size,
        target_filter_size=args.target_filter_size,
        dtype=args.dtype,
        search_impl=args.search_impl,
        outer_chunk=args.outer_chunk,
        profile_dir=args.profile_dir,
    )

    if args.verbose:
        if args.use_gaussian:
            print("Using gaussian model")
        else:
            print(f"Using a t-distribution with {params.dof} dof")
        print(f"Radius of the neighborhood search: {params.radius}")
        print(f"Max number of neighbours: {params.max_neighbours}")
        print(f"Max number of iterations: {params.n_iter}")
        print(f"Cost drop threshold: {params.cost_drop_thresh}")
        print(f"Num cost drop iter: {params.n_cost_drop_it}")
        print(f"Loading source point cloud from {args.source_file_name}")
    try:
        source_cloud = load_pcd(args.source_file_name)
    except (OSError, ValueError) as e:
        print(f"Could not load source cloud, closing ({e})")
        return 1
    if args.verbose:
        print(f"Loading target point cloud from {args.target_file_name}")
    try:
        target_cloud = load_pcd(args.target_file_name)
    except (OSError, ValueError) as e:
        print(f"Could not load target cloud, closing ({e})")
        return 1

    ground_truth_cloud = None
    if args.ground_truth is not None:
        print(f"Loading ground truth point cloud from {args.ground_truth}")
        try:
            ground_truth_cloud = load_pcd(args.ground_truth)
        except (OSError, ValueError):
            # Degrade to no-ground-truth mode (..._ex.cc:132-135).
            print("Could not load ground truth")
            ground_truth_cloud = None

    registration = ProbabilisticRegistration(
        source_cloud, target_cloud, params, ground_truth_cloud, device=args.device
    )
    if args.verbose:
        print("Registration")
    estimated = registration.align()
    aligned_source = source_cloud @ estimated[:3, :3].T + estimated[:3, 3]

    if args.verbose:
        print("Transformation history:")
        for trans in registration.transformation_history:
            q = np_matrix_to_quat(trans[:3, :3])
            t = trans[:3, 3]
            # Reference prints x, y, z, w order (..._ex.cc:156-159).
            print(
                f"T: {t[0]}, {t[1]}, {t[2]} ||| R: {q[1]}, {q[2]}, {q[3]}, {q[0]}"
            )
        aligned_name = "aligned_" + Path(args.source_file_name).name
        print(f"Saving aligned source cloud to: {aligned_name}")
        save_pcd(aligned_name, aligned_source)

    if args.dump:
        report_name = (
            Path(args.source_file_name).stem + "_" + Path(args.target_file_name).stem + "_summary.txt"
        )
        print(f"Saving registration report to: {report_name}")
        with open(report_name, "w") as f:
            f.write(
                f"Source: {args.source_file_name} with filter size: {params.source_filter_size}\n"
            )
            f.write(
                f"Target:{args.target_file_name} with filter size: {params.target_filter_size}\n"
            )
            f.write(
                f"dof: {params.dof} | Radius: {params.radius} | Max_iter: {params.n_iter} | "
                f"Max neigh: {params.max_neighbours} | Cost_drop_thresh_: {params.cost_drop_thresh} | "
                f"N_cost_drop_it: {params.n_cost_drop_it}\n"
            )
            f.write(registration.report())

    if ground_truth_cloud is not None:
        mse = calculate_mse(aligned_source, ground_truth_cloud)
        print(f"MSE w.r.t. ground truth: {mse}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
