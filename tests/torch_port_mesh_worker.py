"""Worker processes for the PyTorch port's mesh: the multi-process cases of
tests/test_torch_distributed.py (``gloo`` on the CPU) and of
``chip_smoke.py``'s mesh phases (one process per rank on the card).

:func:`run_group` spawns ``world`` processes; each starts the default
process group through ``parallel.initialize_multihost`` (a ``file://``
rendezvous in the work directory), runs the given cases in order and writes
its results to ``rank<r>.pkl`` there; a process that fails or outlives the
timeout fails the group. This module imports torch, numpy and the port
only, never JAX: a spawned process imports it to run its cases, and each
result records whether ``jax`` was in ``sys.modules``.

The inputs come from the generators here (numpy, from a seed), so a test
builds the same inputs for the JAX package in its own process.
"""
from __future__ import annotations

import json
import multiprocessing
import pickle
import sys
import time
import traceback
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"


# -- inputs ---------------------------------------------------------------------


def pair(n: int = 4000, seed: int = 4):
    """tests/test_distributed_align.py's pair: a random slab and the same
    points rotated 0.015 rad about z and shifted (float32)."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, 20, size=(n, 3))
    tgt[:, 2] = rng.normal(scale=0.5, size=n)
    theta = 0.015
    rot = np.array([
        [np.cos(theta), -np.sin(theta), 0.0],
        [np.sin(theta), np.cos(theta), 0.0],
        [0.0, 0.0, 1.0],
    ])
    src = tgt @ rot.T + np.array([0.15, -0.1, 0.02])
    return src.astype(np.float32), tgt.astype(np.float32)


def params_kw(**kw) -> dict:
    """tests/test_distributed_align.py's registration parameters."""
    base = dict(max_neighbours=8, radius=0.5, n_iter=6, cost_drop_thresh=0.01,
                n_cost_drop_it=2, dof=5.0, dtype="float32", outer_chunk=3,
                pad_multiple=256, summary=True)
    base.update(kw)
    return base


def wave_pair(n_shards: int):
    """tests/test_parallel.py's wave-grid pair, padded for ``n_shards``:
    (src_p, n_src, tgt_p, n_tgt)."""
    from probabilistic_point_clouds_registration_tpu_torch.io.synthetic import wave_grid
    from probabilistic_point_clouds_registration_tpu_torch.parallel import pad_for_mesh

    src = wave_grid()
    theta = 0.15
    rot = np.array([[np.cos(theta), -np.sin(theta), 0.0],
                    [np.sin(theta), np.cos(theta), 0.0], [0.0, 0.0, 1.0]])
    tgt = src @ rot.T + np.array([0.4, -0.2, 0.1])
    src_p, n_src = pad_for_mesh(src, n_shards, multiple=8)
    tgt_p, n_tgt = pad_for_mesh(tgt, n_shards, multiple=8)
    return src_p, n_src, tgt_p, n_tgt


def tied_lists(t: int, n: int, k: int, seed: int):
    """Per-shard sorted top-k lists (t, n, k) whose distances sit on a
    1/8 lattice, so that ties cross shards and slots, with unfound (+inf)
    tails, random ids and coordinates (float32)."""
    rng = np.random.default_rng(seed)
    d = np.sort(np.round(rng.uniform(0, 1, size=(t, n, k)) * 8) / 8, axis=2)
    cnt = rng.integers(0, k + 1, size=(t, n))
    d = np.where(np.arange(k)[None, None, :] < cnt[..., None], d, np.inf).astype(np.float32)
    i = rng.integers(0, 10_000, size=(t, n, k)).astype(np.int32)
    p = rng.normal(size=(t, n, k, 3)).astype(np.float32)
    return d, i, p


def world_sequence(n_scans: int = 4, n: int = 3000, seed: int = 11):
    """tests/test_distributed_align.py's moving-sensor sequence."""
    rng = np.random.default_rng(seed)
    world = rng.uniform(0, 20, size=(n, 3))
    world[:, 2] = rng.normal(scale=0.5, size=n)
    th = 0.02
    rot = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0],
                    [0.0, 0.0, 1.0]])
    delta = np.eye(4)
    delta[:3, :3] = rot
    delta[:3, 3] = [0.15, -0.05, 0.02]
    scans, pose = [], np.eye(4)
    for _ in range(n_scans):
        inv = np.linalg.inv(pose)
        scans.append(world @ inv[:3, :3].T + inv[:3, 3])
        pose = pose @ delta
    return scans


def wave_sequence(n_scans: int = 5):
    """tests/test_batch.py's wave-grid sequence: a sensor turning 0.04 rad
    and moving (0.12, -0.04, 0.02) a step. Returns the scans."""
    from probabilistic_point_clouds_registration_tpu_torch.io.synthetic import wave_grid

    world = wave_grid()
    th = 0.04
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    delta = np.eye(4)
    delta[:3, :3] = rot
    delta[:3, 3] = [0.12, -0.04, 0.02]
    scans, pose = [], np.eye(4)
    for _ in range(n_scans):
        inv = np.linalg.inv(pose)
        scans.append(world @ inv[:3, :3].T + inv[:3, 3])
        pose = pose @ delta
    return scans


def hot_sequence():
    """The 5-scan :func:`wave_sequence` with scan 3 seen twice (2 cm apart)
    and a blob of 40 points in it: on a 3-rank batch the second rank's
    block (pairs 2-3, targets 2 and 3) plans a wider class ladder (64 lanes
    against 16) and a larger row budget than the other blocks."""
    scans = wave_sequence(5)
    rng = np.random.default_rng(3)
    blob = rng.normal(scale=0.2, size=(40, 3)) + scans[3][700]
    again = scans[3] + rng.normal(scale=0.02, size=scans[3].shape)
    return scans[:3] + [np.concatenate([scans[3], blob, again]), scans[4]]


def starved_pools(real):
    """A batch's pool preparation (``parallel/batch.py::_batched_pools_host``
    of either package) with every non-last class's group budget at 16, so
    that the runtime coverage flag fires (the coverage check exists for
    non-last classes only): tests/test_batch.py's starved redo."""

    def strangled(*args, **kwargs):
        pools = real(*args, **kwargs)
        pools["class_budgets"] = (16,) * (len(pools["class_budgets"]) - 1) + (
            pools["class_budgets"][-1],)
        return pools

    return strangled


def loop_graph(n: int = 40, seed: int = 0, closure_weight: float = 50.0):
    """A drifted circle of ``n`` poses with one exact closure (the port's
    tests/test_torch_pose_graph.py ``_loop``): (poses, edges, weights)."""
    from probabilistic_point_clouds_registration_tpu_torch.io import synthetic as S
    from probabilistic_point_clouds_registration_tpu_torch.models.pose_graph import (
        odometry_edges,
    )

    gt = S.circle_trajectory(n)
    gt0 = [np.linalg.inv(gt[0]) @ p for p in gt]
    rels = S.noisy_odometry(gt0, seed=seed)
    edges = odometry_edges(rels)
    edges.append((n - 1, 0, np.linalg.inv(gt0[-1]) @ gt0[0]))
    weights = [1.0] * (len(edges) - 1) + [closure_weight]
    poses = [np.eye(4)]
    for r in rels:
        poses.append(poses[-1] @ r)
    return poses, edges, weights


def fixture_pair(name: str):
    """(source, target, fixture) of a bench pair's JAX fixture."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_port_fixture as fx
    from probabilistic_point_clouds_registration_tpu_torch.io import synthetic

    fixture = json.loads(fx.fixture_path(name).read_text())
    src, tgt = fx.make_pair(fixture["pair"], synthetic)
    return src, tgt, fixture


def fixture_params(fixture: dict, **kw):
    from probabilistic_point_clouds_registration_tpu_torch import RegistrationParams

    pp = {k: v for k, v in fixture["params"].items() if k not in ("search_impl", "outer_chunk")}
    pp.update(kw)
    return RegistrationParams(**pp)


# -- cases (each runs on every rank: fn(device, **kwargs) -> dict) -------------

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _np(x):
    return x.detach().cpu().numpy()


def _records(reg) -> dict:
    return {
        "final": reg.transformation(),
        "iterations": [r.iteration for r in reg.records],
        "n_corr": [r.num_correspondences for r in reg.records],
        "translation": np.array([r.translation for r in reg.records]),
        "final_cost": np.array([r.final_cost for r in reg.records]),
        "initial_cost": np.array([r.initial_cost for r in reg.records]),
        "mse_prev_iter": np.array([r.mse_prev_iter for r in reg.records]),
        "current_iteration": reg.current_iteration,
        "history": len(reg.transformation_history),
        "report_lines": len(reg.report().strip().splitlines()),
        "engine": reg.engine,
        "engine_fallbacks": reg.engine_fallbacks,
        "inner_cap_hits": reg.inner_cap_hits,
        "inner_iterations": list(reg.inner_iterations),
    }


def _launch_counters():
    from probabilistic_point_clouds_registration_tpu_torch.ops import fused_grid as fg
    from probabilistic_point_clouds_registration_tpu_torch.ops import neighbors_pallas as npal
    from probabilistic_point_clouds_registration_tpu_torch.ops.select_bitonic import (
        select_bitonic,
    )
    from probabilistic_point_clouds_registration_tpu_torch.ops.select_pallas import (
        pallas_row_topk,
    )

    return {"select_windows": fg.select_windows, "select_bitonic": select_bitonic,
            "row_topk": pallas_row_topk, "brute_knn": npal.brute_knn}


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@case
def info(device):
    """The group's facts: backend, ranks, the trajectory gather."""
    import torch.distributed as dist

    from probabilistic_point_clouds_registration_tpu_torch.parallel import (
        allgather_trajectory,
        make_global_mesh,
    )

    mesh = make_global_mesh(1, device=device)
    traj = allgather_trajectory(np.eye(4)[None] * (dist.get_rank() + 1.0))
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "rank": dist.get_rank(), "mesh_devices": mesh.devices, "traj": traj,
            "transport": mesh.transport}


@case
def brute_step(device, dp: int, tp: int):
    """parallel/distributed.py's step and parallel/search.py's search on
    the wave-grid pair (float64)."""
    import torch

    from probabilistic_point_clouds_registration_tpu_torch.models.em_lm import LMConfig
    from probabilistic_point_clouds_registration_tpu_torch.parallel import (
        POINTS_AXIS,
        TARGETS_AXIS,
        make_mesh,
        make_sharded_registration_step,
        make_target_sharded_search,
        shard_rows,
    )

    mesh = make_mesh(dp, tp, device=device)
    src_p, n_src, tgt_p, n_tgt = wave_pair(2)
    put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    src, tgt = put(src_p), put(tgt_p)
    sv, tv = put(np.arange(src_p.shape[0]) < n_src), put(np.arange(tgt_p.shape[0]) < n_tgt)
    k, radius = 10, 1.5
    step = make_sharded_registration_step(
        mesh, k=k, radius=radius, lm_config=LMConfig(dof=5.0, max_iterations=30),
        source_tile=512, target_tile=256)
    q0 = put(np.array([1.0, 0.0, 0.0, 0.0]))
    t0 = put(np.zeros(3))
    out = step(shard_rows(src, mesh, POINTS_AXIS), shard_rows(tgt, mesh, TARGETS_AXIS),
               shard_rows(sv, mesh, POINTS_AXIS), shard_rows(tv, mesh, TARGETS_AXIS),
               q0, t0, q0, t0)
    search = make_target_sharded_search(mesh, k=8, radius=radius, source_tile=512,
                                        target_tile=256)
    got = search(src, shard_rows(tgt, mesh, TARGETS_AXIS), sv,
                 shard_rows(tv, mesh, TARGETS_AXIS))
    r = out.result
    return {"q": _np(r.q), "t": _np(r.t), "final_cost": float(r.final_cost),
            "initial_cost": float(r.initial_cost), "iterations": int(r.num_iterations),
            "n_corr": int(out.num_correspondences), "search_idx": _np(got.indices),
            "search_d2": _np(got.sq_dists), "search_mask": _np(got.mask)}


@case
def grid_step(device, dp: int, tp: int, tree: bool, n: int = 2500, seed: int = 7):
    """parallel/grid_sharded.py's step on :func:`pair` (float64)."""
    import torch

    from probabilistic_point_clouds_registration_tpu_torch.core.types import pad_cloud
    from probabilistic_point_clouds_registration_tpu_torch.models.em_lm import LMConfig
    from probabilistic_point_clouds_registration_tpu_torch.parallel import (
        POINTS_AXIS,
        TARGETS_AXIS,
        build_sharded_grid_host,
        make_mesh,
        make_sharded_grid_registration_step,
        shard_rows,
    )
    from probabilistic_point_clouds_registration_tpu_torch.parallel.grid_sharded import (
        grid_shard_to_device,
    )

    mesh = make_mesh(dp, tp, device=device)
    src, tgt = pair(n, seed)
    src_p, n_src = pad_cloud(src.astype(np.float64), 256 * dp, pad_value=0.0)
    sg = build_sharded_grid_host(tgt, 0.5, tp)
    step = make_sharded_grid_registration_step(
        mesh, k=8, radius=0.5, lm_config=LMConfig(dof=5.0, max_iterations=20), tree_merge=tree)
    q0 = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64, device=device)
    t0 = torch.zeros(3, dtype=torch.float64, device=device)
    out = step(torch.as_tensor(shard_rows(src_p, mesh, POINTS_AXIS), device=device),
               torch.as_tensor(shard_rows(np.arange(src_p.shape[0]) < n_src, mesh, POINTS_AXIS),
                               device=device),
               grid_shard_to_device(sg, mesh.index(TARGETS_AXIS), "float64", device),
               q0, t0, q0, t0)
    r = out.result
    return {"q": _np(r.q), "t": _np(r.t), "final_cost": float(r.final_cost),
            "iterations": int(r.num_iterations), "n_corr": int(out.num_correspondences)}


@case
def merges(device, tp: int, n: int = 64, k: int = 5, seed: int = 0):
    """The three merges on :func:`tied_lists` over a 1 x tp mesh."""
    import torch

    from probabilistic_point_clouds_registration_tpu_torch.parallel import (
        TARGETS_AXIS,
        make_mesh,
        merge_topk_scatter,
        merge_topk_tree,
        sharded_merge_topk,
    )

    mesh = make_mesh(1, tp, device=device)
    d, i, p = tied_lists(tp, n, k, seed)
    s = mesh.index(TARGETS_AXIS)
    ld, li, lp = (torch.as_tensor(a[s], device=device) for a in (d, i, p))
    out = {}
    for name, fn in (("gather", lambda: sharded_merge_topk(ld, li, lp, k=k, mesh=mesh,
                                                         tree=False)),
                     ("tree", lambda: merge_topk_tree(ld, li, lp, k=k, mesh=mesh)),
                     ("scatter", lambda: merge_topk_scatter(ld, li, lp, k=k, mesh=mesh)[:4])):
        bi, bd, found, bp = fn()
        out[name] = {"i": _np(bi), "d": _np(bd), "found": _np(found), "p": _np(bp)}
    return out


@case
def registration(device, dp: int, tp: int, dof: float, layout: str = "auto",
                 debug_replication: bool = False, n: int = 4000, seed: int = 4, **kw):
    """DistributedRegistration on :func:`pair` with :func:`params_kw`."""
    from probabilistic_point_clouds_registration_tpu_torch import RegistrationParams
    from probabilistic_point_clouds_registration_tpu_torch.parallel import (
        DistributedRegistration,
        make_mesh,
    )

    src, tgt = pair(n, seed)
    reg = DistributedRegistration(src, tgt, RegistrationParams(**params_kw(dof=dof, **kw)),
                                  mesh=make_mesh(dp, tp, device=device), layout=layout,
                                  debug_replication=debug_replication)
    reg.align()
    return dict(_records(reg), layout=reg.layout,
                mesh_shape=(reg.mesh.shape["points"], reg.mesh.shape["targets"]))


@case
def ladder(device, dp: int, tp: int, n: int = 2500, seed: int = 7):
    """A pooled budget forced past the ladder (x2, twice) into the sharded
    grid engine."""
    from probabilistic_point_clouds_registration_tpu_torch import RegistrationParams
    from probabilistic_point_clouds_registration_tpu_torch.parallel import (
        DistributedRegistration,
        make_mesh,
    )

    src, tgt = pair(n, seed)
    p = RegistrationParams(**params_kw(n_iter=3, cost_drop_thresh=-1.0, outer_chunk=3))
    reg = DistributedRegistration(src, tgt, p, mesh=make_mesh(dp, tp, device=device),
                                  layout="targets")
    starve(reg)
    reg.align()
    return dict(_records(reg), boost=reg._pool_budget_boost)


def starve(reg) -> None:
    """Starve a registration's sharded pooled budget so that every rung of
    the ladder overflows: an 8-row plan budget without demand sizing and a
    16-row shard (a 128-row floor, 1,024 rows at the top rung)."""
    reg._sp = reg._sp._replace(budget_rows=8, demand_sized=False)
    reg._rows_per_shard = 16


@case
def prepared(device, dp: int, tp: int, n: int = 2500, seed: int = 21):
    """A registration from ``prepare_target(stage=True)`` against a fresh
    one."""
    from probabilistic_point_clouds_registration_tpu_torch import RegistrationParams
    from probabilistic_point_clouds_registration_tpu_torch.parallel import (
        DistributedRegistration,
        make_mesh,
    )

    src, tgt = pair(n, seed)
    p = RegistrationParams(**params_kw(n_iter=3, cost_drop_thresh=-1.0))
    mesh = make_mesh(dp, tp, device=device)
    fresh = DistributedRegistration(src, tgt, p, mesh=mesh)
    fresh.align()
    prep = DistributedRegistration.prepare_target(tgt, p, mesh, stage=True)
    reg = DistributedRegistration(src, tgt, p, mesh=mesh, prepared_target=prep)
    reg.align()
    return {"fresh": _records(fresh), "prepared": _records(reg),
            "sp_none": prep["sp"] is None}


@case
def replication(device, dp: int, tp: int, n: int = 2000, seed: int = 12):
    """tests/test_distributed_align.py's debug_replication scan, and the
    check fed a probe that differs across "targets" (it must poison)."""
    import torch

    from probabilistic_point_clouds_registration_tpu_torch.core.types import pad_cloud
    from probabilistic_point_clouds_registration_tpu_torch.models.em_lm import (
        LMConfig,
        em_lm_solve,
    )
    from probabilistic_point_clouds_registration_tpu_torch.parallel import (
        POINTS_AXIS,
        TARGETS_AXIS,
        build_sharded_pool_host,
        build_sharded_pools_device,
        make_mesh,
        make_sharded_pool_align_scan,
        shard_rows,
    )
    from probabilistic_point_clouds_registration_tpu_torch.parallel.grid_sharded import (
        replication_check,
    )

    src, tgt = pair(n, seed)
    mesh = make_mesh(dp, tp, device=device)
    k, radius = 8, 0.5
    sp = build_sharded_pool_host(tgt, radius, tp, num_valid=tgt.shape[0], k=k, device=device)
    pools = build_sharded_pools_device(mesh, sp)
    src_p, n_src = pad_cloud(src, 256, pad_value=0.0)
    fs = torch.as_tensor(shard_rows(src_p.astype(np.float32), mesh, POINTS_AXIS), device=device)
    sv = torch.as_tensor(shard_rows(np.arange(src_p.shape[0]) < n_src, mesh, POINTS_AXIS),
                         device=device)
    scan = make_sharded_pool_align_scan(
        mesh, sp, k=k, radius=radius, lm_config=LMConfig(dof=5.0),
        source_rows_per_shard=src_p.shape[0] // dp, chunk=2, n_iter=2,
        cost_drop_thresh=-1.0, n_cost_drop_it=5, debug_replication=True,
    )
    q0 = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    t0 = torch.zeros(3, device=device)
    rows = scan(fs, sv, pools, np.eye(4), (np.float32(0.0), 0, 0), q0, t0)
    # A rank-dependent probe must poison the solve on every rank.
    res = em_lm_solve(fs, fs[:, None, :].expand(-1, k, -1), sv[:, None].expand(-1, k),
                      q0, t0, LMConfig(dof=5.0, axis_name=POINTS_AXIS), mesh=mesh)
    bad = replication_check(mesh, res, torch.full((3,), float(mesh.index(TARGETS_AXIS)),
                                                  device=device))
    good = replication_check(mesh, res, torch.ones(3, device=device))
    return {"rows": rows, "bad_q": _np(bad.q), "good_q": _np(good.q), "q": _np(res.q)}


@case
def odometry(device, dp: int, tp: int, workdir: str):
    """run_odometry(mesh=) on :func:`world_sequence`, then a resume from its
    checkpoint (rank 0 writes it)."""
    import torch.distributed as dist

    from probabilistic_point_clouds_registration_tpu_torch import RegistrationParams
    from probabilistic_point_clouds_registration_tpu_torch.models.odometry import run_odometry
    from probabilistic_point_clouds_registration_tpu_torch.parallel import make_mesh

    mesh = make_mesh(dp, tp, device=device)
    params = RegistrationParams(**params_kw(n_iter=4, cost_drop_thresh=-1.0))
    ck = Path(workdir) / "traj.json"
    result = run_odometry(world_sequence(), params, mesh=mesh, checkpoint_path=ck)
    dist.barrier()
    redone = []
    resumed = run_odometry(world_sequence(), params, mesh=mesh, checkpoint_path=ck,
                           on_pair=lambda i, pose: redone.append(i))
    dist.barrier()
    return {"poses": np.array(result.poses), "reports": [len(r.strip().splitlines())
                                                         for r in result.reports],
            "resumed": np.array(resumed.poses), "redone": redone,
            "checkpoint_written": ck.exists()}


@case
def batch_odometry(device, dp: int, scans, starved: bool = False, **kw):
    """run_odometry_batched on a dp x 1 mesh: ``scans`` is a directory of
    KITTI ``.bin`` scans, the scan count of :func:`wave_sequence`, or a list
    of (n, 3) arrays; ``kw``
    its keyword arguments; ``starved`` runs it with :func:`starved_pools`.
    Returns the poses, the result's fields, its stats, the kernel launches
    and the program's counts of the call (name -> sum)."""
    from probabilistic_point_clouds_registration_tpu_torch.io.kitti import (
        list_velodyne_scans,
        load_velodyne_bin,
    )
    from probabilistic_point_clouds_registration_tpu_torch.parallel import batch, make_mesh
    from probabilistic_point_clouds_registration_tpu_torch.utils import spans

    if isinstance(scans, int):
        clouds = wave_sequence(scans)
    elif isinstance(scans, list):
        clouds = scans
    else:
        clouds = [load_velodyne_bin(p).astype(np.float64) for p in list_velodyne_scans(scans)]
    mesh = make_mesh(dp, 1, device=device)
    counters = _launch_counters()
    _sync(device)
    for fn in counters.values():
        fn.launches = 0
    stats = {}
    real = batch._batched_pools_host
    if starved:
        batch._batched_pools_host = starved_pools(real)
    t0_ns = time.perf_counter_ns()
    t0 = time.perf_counter()
    try:
        poses, result = batch.run_odometry_batched(clouds, mesh=mesh, stats=stats, **kw)
    finally:
        batch._batched_pools_host = real
    _sync(device)
    counts = {}
    for r in spans.records()[0]:
        if r.count is not None and r.start_ns >= t0_ns:
            counts[r.name] = counts.get(r.name, 0) + r.count
    return {"poses": np.array(poses), "seconds": time.perf_counter() - t0, "stats": stats,
            "result": {name: _np(x) for name, x in result._asdict().items()},
            "launches": {key: fn.launches for key, fn in counters.items()}, "counts": counts}


@case
def batch_pools(device, dp: int, scans: str, cutoff=None, radius: float = 0.5, k: int = 10,
                pad_multiple: int = 128):
    """``parallel/batch.py::_batched_pools_host`` on this rank's block of a
    dp x 1 mesh (no mesh when ``dp`` is 1), as ``run_odometry_batched``
    prepares it: the pooled search's (budget_rows, class_budgets,
    small_unions). ``scans`` names the sequence ("wave":
    :func:`wave_sequence`, "hot": :func:`hot_sequence`); ``cutoff``, when
    given, is the narrow-class cutoff for the call in place of the
    device's."""
    from probabilistic_point_clouds_registration_tpu_torch.ops import fused_pool
    from probabilistic_point_clouds_registration_tpu_torch.parallel import batch, make_mesh

    clouds = batch._PaddedScans(wave_sequence(5) if scans == "wave" else hot_sequence(),
                                pad_multiple)
    n = len(clouds.scans) - 1
    per = -(-n // dp)
    idx_src, idx_tgt = np.minimum(np.arange(per * dp) + 1, n), np.minimum(np.arange(per * dp), n)
    mesh = make_mesh(dp, 1, device=device) if dp > 1 else None
    rank = 0 if mesh is None else mesh.index("points")
    block = slice(rank * per, (rank + 1) * per)
    own = fused_pool._select_max_w
    if cutoff is not None:
        fused_pool._select_max_w = lambda device: cutoff
    try:
        pools = batch._batched_pools_host(clouds, clouds.counts, idx_tgt[block], radius, k,
                                          np.float32, idx_src=idx_src[block], device=device,
                                          mesh=mesh)
    finally:
        fused_pool._select_max_w = own
    return pools["budget_rows"], pools["class_budgets"], pools["small_unions"]


@case
def pose_graph(device, dp: int, n: int = 40):
    """The edge-sharded pose graph on :func:`loop_graph` (its edges cut
    into dp equal blocks; the count must divide)."""
    import torch

    from probabilistic_point_clouds_registration_tpu_torch.core.se3 import np_matrix_to_quat
    from probabilistic_point_clouds_registration_tpu_torch.models.pose_graph import (
        PoseGraphConfig,
        make_sharded_pose_graph_solver,
        optimize_pose_graph,
    )
    from probabilistic_point_clouds_registration_tpu_torch.parallel import (
        POINTS_AXIS,
        make_mesh,
        shard_rows,
    )

    mesh = make_mesh(dp, 1, device=device)
    poses, edges, weights = loop_graph(n)

    def put(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    arrays = [np.array([e[0] for e in edges]), np.array([e[1] for e in edges]),
              np.stack([np_matrix_to_quat(e[2][:3, :3]) for e in edges]),
              np.stack([e[2][:3, 3] for e in edges]), np.asarray(weights, np.float64)]
    ei, ej, rq, rt, w = (shard_rows(a, mesh, POINTS_AXIS) for a in arrays)
    solve = make_sharded_pose_graph_solver(mesh, PoseGraphConfig())
    q, t, cost = solve(put(np.stack([np_matrix_to_quat(p[:3, :3]) for p in poses])),
                       put(np.stack([p[:3, 3] for p in poses])), put(ei, torch.int64),
                       put(ej, torch.int64), put(rq), put(rt), put(w))
    # The numpy wrapper pads an edge count the axis does not divide.
    odd = edges[:-2] + edges[-1:]
    wrap_poses, wrap_cost = optimize_pose_graph(poses, odd, weights=weights[:-2] + weights[-1:],
                                                mesh=mesh)
    return {"q": _np(q), "t": _np(t), "cost": float(cost), "n_edges": len(edges),
            "wrap_poses": np.array(wrap_poses), "wrap_cost": wrap_cost}


@case
def fixture_registration(device, name: str, dp: int, tp: int, layout: str = "auto",
                         debug_replication: bool = False):
    """DistributedRegistration of a bench pair at full width against its
    JAX fixture's parameters (the card's mesh phases): the run's records,
    seconds, LM capture seconds and kernel launches."""
    from probabilistic_point_clouds_registration_tpu_torch.parallel import (
        DistributedRegistration,
        make_mesh,
    )

    src, tgt, fixture = fixture_pair(name)
    params = fixture_params(fixture, search_impl="auto")
    mesh = make_mesh(dp, tp, device=device)
    counters = _launch_counters()
    _sync(device)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    reg = DistributedRegistration(src, tgt, params, mesh=mesh, layout=layout,
                                  debug_replication=debug_replication)
    reg.align()
    _sync(device)
    seconds = time.perf_counter() - t0
    return dict(_records(reg), seconds=seconds, capture_seconds=reg._lm.capture_seconds,
                graphs=reg._lm.graphs, layout=reg.layout,
                launches={key: fn.launches for key, fn in counters.items()})


@case
def fixture_ladder(device, name: str, dp: int, tp: int):
    """A bench pair with its pooled budget starved (:func:`starve`): the
    ladder ends on the sharded grid engine (B2 on the card)."""
    from probabilistic_point_clouds_registration_tpu_torch.parallel import (
        DistributedRegistration,
        make_mesh,
    )

    src, tgt, fixture = fixture_pair(name)
    params = fixture_params(fixture, search_impl="auto")
    counters = _launch_counters()
    reg = DistributedRegistration(src, tgt, params, mesh=make_mesh(dp, tp, device=device),
                                  layout="targets")
    starve(reg)
    _sync(device)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    reg.align()
    _sync(device)
    return dict(_records(reg), seconds=time.perf_counter() - t0, layout=reg.layout,
                launches={key: fn.launches for key, fn in counters.items()})


@case
def fixture_pose_graph(device, dp: int):
    """tests/data/torch_port_pose_graph4541_ref.json's graph, its edges
    sharded over dp ranks (``optimize_pose_graph(mesh=)``)."""
    from probabilistic_point_clouds_registration_tpu_torch.models.pose_graph import (
        optimize_pose_graph,
    )
    from probabilistic_point_clouds_registration_tpu_torch.parallel import make_mesh

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_port_fixture as fx

    spec = json.loads((DATA / "torch_port_pose_graph4541_ref.json").read_text())
    poses, edges, weights = fx.pose_graph_problem(spec["pose_graph"])
    mesh = make_mesh(dp, 1, device=device)
    stats = {}
    optimize_pose_graph(poses, edges, weights=weights, mesh=mesh)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    out, cost = optimize_pose_graph(poses, edges, weights=weights, mesh=mesh, stats=stats)
    _sync(device)
    return {"poses": {k: out[int(k)] for k in spec["poses"]}, "cost": cost,
            "gn_iterations": stats["gn_iterations"], "seconds": time.perf_counter() - t0,
            "n_edges": len(edges)}


# -- processes ------------------------------------------------------------------


def _worker(rank: int, world: int, workdir: str, cases: list, device: str,
            local_world_size) -> None:
    import torch

    torch.set_num_threads(1)
    # The port of this checkout, whatever the spawning process's path.
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    out = {}
    try:
        from probabilistic_point_clouds_registration_tpu_torch.parallel import (
            initialize_multihost,
        )

        initialize_multihost(f"file://{workdir}/rendezvous", world, rank, device=device,
                             local_rank=rank, local_world_size=local_world_size)
        for name, kwargs in cases:
            out[name if "tag" not in kwargs else kwargs["tag"]] = CASES[name](
                device, **{k: v for k, v in kwargs.items() if k != "tag"})
    except BaseException:
        out["_error"] = traceback.format_exc()
    out["_jax_loaded"] = "jax" in sys.modules
    with open(Path(workdir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist

    if "_error" not in out and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    if "_error" in out:
        sys.exit(1)


def run_group(world: int, cases: list, workdir, *, device: str = "cpu",
              local_world_size=None, timeout: float = 600.0) -> list:
    """Run ``cases`` ([(case name, kwargs)], kwargs may carry a ``tag`` to
    key the result by) on ``world`` spawned ranks; returns each rank's
    results (a dict keyed by case, or tag). Raises when a rank fails, exits
    nonzero or outlives ``timeout`` seconds (all ranks are stopped)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, str(workdir), cases, device,
                                               local_world_size))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r in range(world):
        path = workdir / f"rank{r}.pkl"
        results.append(pickle.loads(path.read_bytes()) if path.exists() else {})
    errors = {r: res["_error"] for r, res in enumerate(results) if "_error" in res}
    if late or errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(
            f"mesh group of {world} ranks failed: timed out {late}, exit codes "
            f"{[p.exitcode for p in procs]}, errors {json.dumps(errors, indent=1)}")
    return results

