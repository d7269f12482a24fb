"""Reference fixtures for the PyTorch port's main path.

Runs the JAX package's registration of a bench pair on the CPU and records
the final 4x4 and every outer iteration's (initial cost, final cost,
correspondences). ``chip_smoke.py`` holds the port's run on the GPU against
these files. Two pairs:

* ``bunny35k``: ``bench.py``'s 35k ``bunny_like`` pair and parameters
  (tests/data/torch_port_bunny35k_ref.json);
* ``kitti131k``: ``benchmarks/bench_kitti.py``'s 131,072-point
  ``kitti_like`` pair and parameters, 10 fixed outer iterations
  (tests/data/torch_port_kitti131k_ref.json). Its file also records the
  plan-level facts of the target grid (capacity, hot-cell overflow count,
  the pool's class widths at the narrow-class cutoff 0);
* ``bunny35k_voxel``: the ``bunny35k`` pair with both clouds voxel-filtered
  at a 0.02 leaf before registration (``source_filter_size``,
  ``target_filter_size``; 35,000 -> about 30,000 points each)
  (tests/data/torch_port_bunny35k_voxel_ref.json).

The reference runs its XLA grid engine here, whose neighbor sets equal the
fused and pooled engines' (tests/test_fused_grid.py, tests/test_fused_pool.py;
the grid engine merges the hot-cell overflow set), because the Pallas
engines' interpret mode is too slow on a CPU at these sizes. ``outer_chunk=1``
keeps the reference on its one-iteration host loop, which the port's chunks
reproduce.

Four more fixtures hold the entry points around the pair (``chip_smoke.py``
phases 16-18); their workloads come from the port's ``io/synthetic.py``,
which the smoke run rebuilds them from:

* ``cli_bunny35k``: the JAX package's pair CLI on the ``bunny35k`` pair
  written as PCD files (source binary_compressed, target binary, ground
  truth ascii) with ``-v --dump -g ... -r 0.075 -m 20 -i 15 -c -1``: each
  iteration's correspondences (from the verbose lines) and summary row,
  and the final 4x4 (tests/data/torch_port_cli_bunny35k_ref.json);
* ``seq_kitti131k``: ``benchmarks/bench_sequence.py --kitti_like``'s
  sequence (6 scans of 131,072 ``kitti_like`` points, 0.8 m and 0.01 rad a
  step) written as KITTI ``.bin`` files and read back through the JAX
  package's ``io/kitti.py`` (so both packages see the float32 scans), its
  parameters (the reference stopping rule: cost drop 0.005, 12 outer
  iterations), through ``run_odometry``: each pair's relative 4x4, outer
  iterations and correspondences (tests/data/torch_port_seq_kitti131k_ref.json);
* ``loop_bunny35k``: tests/test_loop_closure.py's square walk with a
  35,000-point ``bunny_like`` world, drifted odometry (seed 0), through
  ``detect_loop_closures`` and ``refine_trajectory``
  (tests/data/torch_port_loop_bunny35k_ref.json);
* ``pose_graph4541``: a pose graph the size of KITTI sequence 00: two laps
  of a circle (4,541 poses, 2,271 a lap, radius 300 m: 0.83 m a step),
  noisy odometry (seed 0; 0.0003 rad and 0.02 m a step) and an exact
  closure (k, k + 2,271) every 50th k of the first lap, weight 10, through
  ``optimize_pose_graph`` in float64: the final cost, every 100th pose and
  the Gauss-Newton step count (tests/data/torch_port_pose_graph4541_ref.json).

Regenerate with (CPU seconds on one core of this repository's CI machine
in brackets: bunny35k ~10, kitti131k ~75, cli_bunny35k ~30, seq_kitti131k
~300-480, loop_bunny35k ~60, pose_graph4541 ~90)::

    JAX_PLATFORMS=cpu python tests/torch_port_fixture.py bunny35k
    JAX_PLATFORMS=cpu python tests/torch_port_fixture.py kitti131k
    JAX_PLATFORMS=cpu python tests/torch_port_fixture.py bunny35k_voxel
    JAX_PLATFORMS=cpu python tests/torch_port_fixture.py cli_bunny35k
    JAX_PLATFORMS=cpu python tests/torch_port_fixture.py seq_kitti131k
    JAX_PLATFORMS=cpu python tests/torch_port_fixture.py loop_bunny35k
    JAX_PLATFORMS=cpu python tests/torch_port_fixture.py pose_graph4541
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"

PAIRS = {
    "bunny35k": {
        # bench.py:build_pair: the target rotated about z and shifted.
        "pair": {"cloud": "bunny_like", "n_points": 35_000, "seed": 0,
                 "theta": 0.02, "shift": [0.02, -0.015, 0.01]},
        # bench.py:run_once's parameters (outer_chunk aside).
        "params": dict(
            max_neighbours=20, dof=5.0, radius=0.075, n_iter=15,
            cost_drop_thresh=-1.0, dtype="float32", pad_multiple=1024,
            max_inner_iterations=50,
        ),
    },
    "kitti131k": {
        # benchmarks/bench_kitti.py:54-63: ~1 m of ego-motion at 10 Hz.
        "pair": {"cloud": "kitti_like", "n_points": 131_072, "seed": 0,
                 "theta": 0.01, "shift": [0.8, 0.1, 0.02]},
        # benchmarks/bench_kitti.py:65-70 (outer_chunk aside).
        "params": dict(
            max_neighbours=20, dof=5.0, radius=0.5, n_iter=10,
            cost_drop_thresh=-1.0, dtype="float32", pad_multiple=4096,
            max_inner_iterations=50, grid_max_overflow=4096,
        ),
    },
}
PAIRS["bunny35k_voxel"] = {
    "pair": PAIRS["bunny35k"]["pair"],
    "params": dict(PAIRS["bunny35k"]["params"], source_filter_size=0.02,
                   target_filter_size=0.02),
}


def fixture_path(name: str) -> Path:
    return DATA / f"torch_port_{name}_ref.json"


FIXTURE = fixture_path("bunny35k")


def make_pair(pair: dict, generators) -> tuple[np.ndarray, np.ndarray]:
    """(source, target) of a pair spec: the target rotated by ``theta``
    about z and shifted. ``generators`` maps a cloud name to its function
    (the JAX package's or the port's ``io.synthetic``)."""
    tgt = getattr(generators, pair["cloud"])(pair["n_points"], seed=pair["seed"])
    c, s = np.cos(pair["theta"]), np.sin(pair["theta"])
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return tgt @ rot.T + np.array(pair["shift"]), tgt


def reference_run(name: str = "bunny35k", n_iter: int | None = None):
    """The JAX package's registration of pair ``name``: (4x4, records)."""
    from probabilistic_point_clouds_registration_tpu.core.params import (
        RegistrationParams,
    )
    from probabilistic_point_clouds_registration_tpu.io import synthetic
    from probabilistic_point_clouds_registration_tpu.models.registration import (
        register_pair,
    )

    spec = PAIRS[name]
    src, tgt = make_pair(spec["pair"], synthetic)
    kw = dict(spec["params"])
    if n_iter is not None:
        kw["n_iter"] = n_iter
    params = RegistrationParams(**kw, search_impl="grid", outer_chunk=1)
    final, reg = register_pair(src, tgt, params)
    return final, reg.records


def plan_facts(name: str) -> dict:
    """The JAX package's host facts for pair ``name``'s target: grid
    capacity, hot-cell overflow count and the pool's class widths when every
    class runs a kernel (cutoff 0)."""
    from probabilistic_point_clouds_registration_tpu.core.types import pad_cloud
    from probabilistic_point_clouds_registration_tpu.io import synthetic
    from probabilistic_point_clouds_registration_tpu.ops.fused_pool import (
        plan_pool_host,
    )
    from probabilistic_point_clouds_registration_tpu.ops.grid import build_grid_host

    spec = PAIRS[name]
    p = spec["params"]
    _, tgt = make_pair(spec["pair"], synthetic)
    tg, n_tgt = pad_cloud(tgt, p["pad_multiple"], pad_value=0.0)
    grid = build_grid_host(tg, p["radius"], num_valid=n_tgt,
                           max_overflow=p.get("grid_max_overflow", 4096))
    plan = plan_pool_host(grid, tg, select_max_w=0)
    return {
        "capacity": int(grid["capacity"]),
        "overflow_points": int((grid.get("overflow_idx", np.zeros(0)) >= 0).sum()),
        "class_widths_cutoff0": [int(w) for w in plan["widths"]],
    }


# The entry points' workloads (chip_smoke.py phases 16-18).
CLI = {
    "pair": "bunny35k",
    # File names in the working directory, and the modes they are written in.
    "files": {"src.pcd": "binary_compressed", "tgt.pcd": "binary", "gt.pcd": "ascii"},
    "argv": ["src.pcd", "tgt.pcd", "-v", "--dump", "-g", "gt.pcd", "-r", "0.075", "-m", "20",
             "-i", "15", "-c", "-1", "--search_impl", "auto"],
}
SEQUENCE = {
    "scans": 6, "n_points": 131_072, "seed": 0,
    # benchmarks/bench_sequence.py --kitti_like's parameters.
    "params": dict(max_neighbours=20, radius=0.5, n_iter=12, cost_drop_thresh=0.005,
                   dtype="float32", pad_multiple=4096, outer_chunk=12,
                   max_inner_iterations=50),
}
LOOP = {
    "n_points": 35_000, "seed": 0, "step": 0.4, "odometry_seed": 0, "odometry_noise": 0.02,
    "params": dict(max_neighbours=20, radius=0.075, n_iter=15, cost_drop_thresh=0.003,
                   dtype="float32", pad_multiple=1024),
    "detect": dict(max_distance=0.7, min_index_gap=4),
}
POSE_GRAPH = {
    "poses": 4541, "lap": 2271, "radius": 300.0, "seed": 0, "rot_noise": 0.0003,
    "t_noise": 0.02, "closure_every": 50, "closure_weight": 10.0, "keep_every": 100,
}


def pose_graph_problem(spec: dict = POSE_GRAPH):
    """(odometry poses, edges, weights) of the ``pose_graph4541`` graph,
    from the port's ``io/synthetic.py``."""
    from probabilistic_point_clouds_registration_tpu_torch.io import synthetic

    n, lap = spec["poses"], spec["lap"]
    gt = synthetic.circle_trajectory(n, spec["radius"], lap=lap)
    gt0 = [np.linalg.inv(gt[0]) @ p for p in gt]
    rels = synthetic.noisy_odometry(gt0, seed=spec["seed"], rot_noise=spec["rot_noise"],
                                    t_noise=spec["t_noise"])
    poses = [np.eye(4)]
    for r in rels:
        poses.append(poses[-1] @ r)
    edges = [(k, k + 1, r) for k, r in enumerate(rels)]
    weights = [1.0] * len(edges)
    for k in range(0, lap, spec["closure_every"]):
        if k + lap < n:
            edges.append((k, k + lap, np.linalg.inv(gt0[k]) @ gt0[k + lap]))
            weights.append(spec["closure_weight"])
    return poses, edges, weights


def write_pcd_pair(directory: Path, save_pcd, spec: dict = CLI):
    """Write the CLI pair's files with ``save_pcd`` (either package's)."""
    from probabilistic_point_clouds_registration_tpu_torch.io import synthetic

    src, tgt = make_pair(PAIRS[spec["pair"]]["pair"], synthetic)
    for (name, mode), cloud in zip(spec["files"].items(), (src, tgt, tgt)):
        save_pcd(directory / name, cloud, mode=mode)


def parse_cli_run(stdout: str, summary: str) -> dict:
    """The pair CLI's verbose output and summary file as fixture fields:
    per iteration the correspondences and the summary row, the final 4x4
    (the last line of the transformation history)."""
    import re

    from probabilistic_point_clouds_registration_tpu_torch.core.se3 import np_se3_matrix

    corr = [int(m) for m in re.findall(r"^\[iter \d+\] correspondences=(\d+)", stdout, re.M)]
    rows = [[float(v) for v in line.split(",")] for line in summary.splitlines()[4:]]
    last = [line for line in stdout.splitlines() if line.startswith("T: ")][-1]
    t_part, r_part = last[3:].split(" ||| R: ")
    x, y, z, w = (float(v) for v in r_part.split(","))  # printed x, y, z, w
    q = np.array([w, x, y, z])
    final = np_se3_matrix(q / np.linalg.norm(q), [float(v) for v in t_part.split(",")])
    return {"final_transform": final.tolist(),
            "iterations": [{"correspondences": c, "summary_row": r} for c, r in zip(corr, rows)]}


def write_velodyne_scans(directory: Path, scans) -> list:
    """Each scan as a KITTI ``.bin`` file (x, y, z, reflectance 0 as
    float32): the sorted paths."""
    paths = []
    for i, scan in enumerate(scans):
        rec = np.zeros((len(scan), 4), np.float32)
        rec[:, :3] = scan
        paths.append(directory / f"{i:06d}.bin")
        rec.tofile(paths[-1])
    return paths


def _cli_fixture() -> dict:
    import contextlib
    import io
    import tempfile

    from probabilistic_point_clouds_registration_tpu import cli
    from probabilistic_point_clouds_registration_tpu.io.pcd import save_pcd

    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            write_pcd_pair(Path(tmp), save_pcd)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(CLI["argv"])
            summary = (Path(tmp) / "src_tgt_summary.txt").read_text()
        finally:
            os.chdir(cwd)
    if rc != 0:
        raise SystemExit(f"the JAX CLI exited {rc}")
    return {"cli": CLI, **parse_cli_run(out.getvalue(), summary)}


def _sequence_fixture() -> dict:
    import tempfile

    from probabilistic_point_clouds_registration_tpu.core.params import RegistrationParams
    from probabilistic_point_clouds_registration_tpu.io.kitti import list_velodyne_scans
    from probabilistic_point_clouds_registration_tpu.models import odometry
    from probabilistic_point_clouds_registration_tpu_torch.io import synthetic

    spec = SEQUENCE
    scans, _ = synthetic.kitti_sequence(spec["scans"], spec["n_points"], seed=spec["seed"])
    # Each pair's per-iteration correspondence counts (the reports do not
    # carry them): the registrations run_odometry makes, recorded as they
    # finish.
    counts = []

    class Recorded(odometry.ProbabilisticRegistration):
        def align(self):
            final = super().align()
            counts.append([r.num_correspondences for r in self.records])
            return final

    with tempfile.TemporaryDirectory() as tmp:
        write_velodyne_scans(Path(tmp), scans)
        # The JAX package's one-iteration host loop on its grid engine.
        params = RegistrationParams(**{**spec["params"], "outer_chunk": 1}, search_impl="grid")
        real, odometry.ProbabilisticRegistration = odometry.ProbabilisticRegistration, Recorded
        try:
            result = odometry.run_odometry(list_velodyne_scans(tmp), params)
        finally:
            odometry.ProbabilisticRegistration = real
    pairs = []
    for t_rel, report, n_corr in zip(result.relative_transforms, result.reports, counts):
        rows = [line.split(", ") for line in report.splitlines()[1:]]
        pairs.append({"relative_transform": np.asarray(t_rel).tolist(),
                      "iterations": len(rows),
                      "final_cost": float(rows[-1][3]),
                      "correspondences": [int(c) for c in n_corr]})
    return {"sequence": spec, "pairs": pairs, "inner_cap_hits": result.inner_cap_hits}


def loop_problem(spec: dict = LOOP):
    """(scans, ground-truth poses, drifted relative transforms, drifted
    poses) of the ``loop_bunny35k`` walk, from the port's
    ``io/synthetic.py``."""
    from probabilistic_point_clouds_registration_tpu_torch.io import synthetic

    world = synthetic.bunny_like(spec["n_points"], seed=spec["seed"])
    scans, gt, moves = synthetic.square_loop(world, spec["step"])
    rels, poses = synthetic.drifted_moves(moves, seed=spec["odometry_seed"],
                                          scale=spec["odometry_noise"])
    return scans, gt, rels, poses


def _loop_fixture() -> dict:
    from probabilistic_point_clouds_registration_tpu.core.params import RegistrationParams
    from probabilistic_point_clouds_registration_tpu.models.loop_closure import (
        detect_loop_closures,
        refine_trajectory,
    )
    from probabilistic_point_clouds_registration_tpu.models.odometry import OdometryResult

    scans, _, rels, poses = loop_problem()
    result = OdometryResult(poses=poses, relative_transforms=rels)
    params = RegistrationParams(**LOOP["params"], search_impl="grid", outer_chunk=1)
    closures = detect_loop_closures(scans, result, params, **LOOP["detect"])
    refined, cost = refine_trajectory(result, closures)
    return {"loop": LOOP,
            "closures": [{"i": c.i, "j": c.j, "relative_transform": c.relative_transform.tolist(),
                          "mean_cost": c.mean_cost} for c in closures],
            "refined_poses": [p.tolist() for p in refined], "cost": cost}


def _pose_graph_fixture() -> dict:
    from probabilistic_point_clouds_registration_tpu.models.pose_graph import (
        PoseGraphConfig,
        optimize_pose_graph,
    )

    poses, edges, weights = pose_graph_problem()
    config = PoseGraphConfig()
    refined, cost = optimize_pose_graph(poses, edges, weights=weights, config=config)
    # The solve does not report its step count. Step m ends the loop when
    # the cost after m steps is within ``tolerance`` (relative) of the cost
    # after m - 1 (a step that does not improve leaves it equal), so the
    # count follows from the costs of solves cut at 0, 1, 2, ... steps.
    costs = [optimize_pose_graph(poses, edges, weights=weights,
                                 config=config._replace(max_iterations=0))[1]]
    steps = config.max_iterations
    for m in range(1, config.max_iterations + 1):
        costs.append(optimize_pose_graph(poses, edges, weights=weights,
                                         config=config._replace(max_iterations=m))[1])
        if abs(costs[-2] - costs[-1]) / max(costs[-2], 1e-30) < config.tolerance:
            steps = m
            break
    if costs[-1] != cost:
        raise SystemExit("the cut solves do not reproduce the full solve")
    keep = POSE_GRAPH["keep_every"]
    return {"pose_graph": POSE_GRAPH, "cost": cost, "gn_iterations": steps,
            "costs_by_step": costs,
            "poses": {str(k): refined[k].tolist() for k in range(0, len(refined), keep)}}


ENTRY_POINTS = {"cli_bunny35k": _cli_fixture, "seq_kitti131k": _sequence_fixture,
                "loop_bunny35k": _loop_fixture, "pose_graph4541": _pose_graph_fixture}


def main(name: str) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(DATA.parents[1]))
    if name in ENTRY_POINTS:
        import jax

        jax.config.update("jax_platforms", "cpu")
        if name in ("loop_bunny35k", "pose_graph4541"):
            # The pose graph and the closure gates' metrics in float64, as
            # the port computes them (the registrations stay float32).
            jax.config.update("jax_enable_x64", True)
        path = fixture_path(name)
        path.write_text(json.dumps(ENTRY_POINTS[name](), indent=1) + "\n")
        print(f"wrote {path}")
        return
    spec = PAIRS[name]
    final, records = reference_run(name)
    out = {
        "pair": spec["pair"],
        "params": {**spec["params"], "search_impl": "grid", "outer_chunk": 1},
        "final_transform": np.asarray(final).tolist(),
        "iterations": [
            {
                "initial_cost": r.initial_cost,
                "final_cost": r.final_cost,
                "correspondences": r.num_correspondences,
            }
            for r in records
        ],
    }
    if name == "kitti131k":
        out["plan"] = plan_facts(name)
    path = fixture_path(name)
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "bunny35k")
