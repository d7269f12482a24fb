"""The port's mesh across real processes: ``gloo`` groups of 2 and 4 ranks on
the CPU (tests/torch_port_mesh_worker.py, spawned once per group), held
against the JAX package's multi-device functions on the conftest's 8-device
virtual mesh at the same shapes, and against the port's single-device path.

Tolerances are the JAX package's own (tests/test_distributed_align.py):
trajectory 5e-6, final cost rtol 2e-4, equal record and correspondence
counts; the merges bit-equal, ties included; the step 1e-9 (float64); the
sharded pose graph 1e-8 with the preconditioner. Every rank must agree with
rank 0 bit for bit, and no worker process may have loaded JAX.
"""
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core.params import (
    RegistrationParams as JParams,
)
from probabilistic_point_clouds_registration_tpu.models import pose_graph as J_pg
from probabilistic_point_clouds_registration_tpu.models.em_lm import LMConfig as JLMConfig
from probabilistic_point_clouds_registration_tpu.core.se3 import np_matrix_to_quat
from probabilistic_point_clouds_registration_tpu.parallel import (
    DistributedRegistration as JDist,
    make_mesh as j_make_mesh,
    make_sharded_registration_step as j_step,
    make_target_sharded_search as j_search,
    merge_topk as j_merge_topk,
    merge_topk_scatter as j_scatter,
    merge_topk_tree as j_tree,
    sharded_merge_topk as j_sharded_merge,
)
from probabilistic_point_clouds_registration_tpu.core.types import pad_cloud
from probabilistic_point_clouds_registration_tpu.models.registration import (
    ProbabilisticRegistration as JProb,
)
from probabilistic_point_clouds_registration_tpu.parallel import grid_sharded as j_gs
from probabilistic_point_clouds_registration_tpu.parallel.mesh import TARGETS_AXIS
from probabilistic_point_clouds_registration_tpu_torch import RegistrationParams
from probabilistic_point_clouds_registration_tpu_torch.models import pose_graph as T_pg
from probabilistic_point_clouds_registration_tpu_torch.models.odometry import run_odometry
from probabilistic_point_clouds_registration_tpu_torch.models.registration import (
    ProbabilisticRegistration,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_port_mesh_worker as W  # noqa: E402

P = jax.sharding.PartitionSpec
DOFS = {"gaussian": math.inf, "t5": 5.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch work on one CPU thread: the suite runs several
    test processes at once, and torch's thread pool per process would
    oversubscribe the cores (the spawned ranks use one thread each too)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

CASES_2 = [
    ("info", {}),
    ("brute_step", dict(dp=1, tp=2, tag="step_1x2")),
    ("brute_step", dict(dp=2, tp=1, tag="step_2x1")),
    ("merges", dict(tp=2, seed=2, tag="merges_2")),
    ("grid_step", dict(dp=1, tp=2, tree=False, tag="grid_gather")),
    ("grid_step", dict(dp=1, tp=2, tree=True, tag="grid_tree")),
    ("ladder", dict(dp=1, tp=2)),
    ("pose_graph", dict(dp=2)),
]


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    return W.run_group(2, CASES_2, tmp_path_factory.mktemp("mesh2"), timeout=300)


@pytest.fixture(scope="module")
def group4(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("mesh4")
    cases = [
        ("info", {}),
        ("merges", dict(tp=4, seed=4, tag="merges_4")),
        ("registration", dict(dp=2, tp=2, dof=math.inf, tag="reg_gaussian")),
        ("registration", dict(dp=2, tp=2, dof=5.0, tag="reg_t5")),
        ("prepared", dict(dp=2, tp=2)),
        ("replication", dict(dp=2, tp=2)),
        ("registration", dict(dp=2, tp=2, dof=5.0, debug_replication=True, tag="reg_t5_debug")),
        ("odometry", dict(dp=2, tp=2, workdir=str(workdir))),
    ]
    return W.run_group(4, cases, workdir, timeout=300)


def _same(a, b, path="result"):
    """Bit-equality of two ranks' results (NaN equal to NaN); the
    reduce-scatter merge's blocks differ by design and are skipped."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            if key != "scatter":
                _same(a[key], b[key], f"{path}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), path
    else:
        assert a == b, path


def _group(request, size):
    return request.getfixturevalue(f"group{size}")


@pytest.mark.parametrize("size", [2, 4])
def test_workers_use_gloo_and_never_load_jax(request, size):
    results = _group(request, size)
    for rank, res in enumerate(results):
        assert res["_jax_loaded"] is False
        info = res["info"]
        assert (info["backend"], info["world"], info["rank"]) == ("gloo", size, rank)
        assert info["transport"] == "device"
        np.testing.assert_array_equal(
            info["traj"], np.stack([np.eye(4) * (r + 1.0) for r in range(size)]))


@pytest.mark.parametrize("size", [2, 4])
def test_every_rank_agrees_bit_for_bit(request, size):
    results = _group(request, size)
    for res in results[1:]:
        _same({k: v for k, v in res.items() if k not in ("info",)},
              {k: v for k, v in results[0].items() if k not in ("info",)})


# -- the sharded step, the search and the merges --------------------------------


@pytest.mark.parametrize("dp, tp", [(1, 2), (2, 1)])
def test_sharded_step_matches_jax(group2, dp, tp):
    src_p, n_src, tgt_p, n_tgt = W.wave_pair(2)
    sv = jnp.asarray(np.arange(src_p.shape[0]) < n_src)
    tv = jnp.asarray(np.arange(tgt_p.shape[0]) < n_tgt)
    mesh = j_make_mesh(dp, tp)
    step = j_step(mesh, k=10, radius=1.5, lm_config=JLMConfig(dof=5.0, max_iterations=30),
                  source_tile=512, target_tile=256)
    q0, t0 = jnp.array([1.0, 0.0, 0.0, 0.0]), jnp.zeros(3)
    want = step(jnp.asarray(src_p), jnp.asarray(tgt_p), sv, tv, q0, t0, q0, t0)
    for res in group2:
        got = res[f"step_{dp}x{tp}"]
        assert got["n_corr"] == int(want.num_correspondences)
        assert got["iterations"] == int(want.result.num_iterations)
        np.testing.assert_allclose(got["q"], np.asarray(want.result.q), atol=1e-9)
        np.testing.assert_allclose(got["t"], np.asarray(want.result.t), atol=1e-9)
        np.testing.assert_allclose(got["final_cost"], float(want.result.final_cost), rtol=1e-10)


@pytest.mark.parametrize("dp, tp", [(1, 2), (2, 1)])
def test_target_sharded_search_matches_jax(group2, dp, tp):
    src_p, n_src, tgt_p, n_tgt = W.wave_pair(2)
    sv = jnp.asarray(np.arange(src_p.shape[0]) < n_src)
    tv = jnp.asarray(np.arange(tgt_p.shape[0]) < n_tgt)
    search = j_search(j_make_mesh(dp, tp), k=8, radius=1.5, source_tile=512, target_tile=256)
    want = search(jnp.asarray(src_p), jnp.asarray(tgt_p), sv, tv)
    for res in group2:
        got = res[f"step_{dp}x{tp}"]
        np.testing.assert_array_equal(got["search_mask"], np.asarray(want.mask))
        np.testing.assert_array_equal(got["search_idx"], np.asarray(want.indices))
        # XLA's CPU backend contracts the sum of squares into FMAs: 2 ulp.
        np.testing.assert_array_max_ulp(got["search_d2"], np.asarray(want.sq_dists), maxulp=2)


@pytest.mark.parametrize("merge", ["gather", "tree"])
def test_sharded_grid_step_matches_jax(group2, merge):
    src, tgt = W.pair(2500, 7)
    src_p, n_src = pad_cloud(src.astype(np.float64), 256, pad_value=0.0)
    sg = j_gs.build_sharded_grid_host(tgt, 0.5, 2)
    step = j_gs.make_sharded_grid_registration_step(
        j_make_mesh(1, 2), k=8, radius=0.5, lm_config=JLMConfig(dof=5.0, max_iterations=20),
        capacity=sg.capacity, tree_merge=merge == "tree")
    q0, t0 = jnp.array([1.0, 0.0, 0.0, 0.0]), jnp.zeros(3)
    want = step(jnp.asarray(src_p), jnp.asarray(np.arange(src_p.shape[0]) < n_src),
                jnp.asarray(sg.bucket_pts), jnp.asarray(sg.bucket_idx), jnp.asarray(sg.lut),
                jnp.asarray(sg.origin), jnp.asarray(sg.dims), q0, t0, q0, t0)
    for res in group2:
        got = res[f"grid_{merge}"]
        assert got["n_corr"] == int(want.num_correspondences)
        assert got["iterations"] == int(want.result.num_iterations)
        np.testing.assert_allclose(got["q"], np.asarray(want.result.q), atol=1e-9)
        np.testing.assert_allclose(got["t"], np.asarray(want.result.t), atol=1e-9)
        np.testing.assert_allclose(got["final_cost"], float(want.result.final_cost), rtol=1e-10)


def _jax_merges(tp, seed, n=64, k=5):
    """The JAX package's three merges on the same tied lists, per device."""
    d, i, p = (jnp.asarray(a) for a in W.tied_lists(tp, n, k, seed))
    mesh = j_make_mesh(1, tp)
    sq = lambda a: a.reshape(a.shape[1:])  # noqa: E731

    def run(body, out_specs):
        return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(TARGETS_AXIS),) * 3,
                                     out_specs=out_specs, check_vma=False))(d, i, p)

    gather = run(lambda a, b, c: j_sharded_merge(sq(a), sq(b), sq(c), k=k,
                                                 axis_name=TARGETS_AXIS, tree=False), (P(),) * 4)
    tree = run(lambda a, b, c: j_tree(sq(a), sq(b), sq(c), k=k, axis_name=TARGETS_AXIS),
               (P(),) * 4)
    scatter = run(lambda a, b, c: tuple(x[None] for x in j_scatter(
        sq(a), sq(b), sq(c), k=k, axis_name=TARGETS_AXIS)[:4]), (P(TARGETS_AXIS),) * 4)
    flat = j_merge_topk(d, i, p, k=k)
    return {"gather": gather, "tree": tree, "scatter": scatter, "flat": flat}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("merge", ["gather", "tree", "scatter"])
def test_merges_match_jax_ties_included(request, tp, merge):
    results = _group(request, tp)
    want = _jax_merges(tp, seed=tp)
    names = ("i", "d", "found", "p")
    d = W.tied_lists(tp, 64, 5, tp)[0]
    assert (d[0][np.isfinite(d[0])][:, None] == d[1][np.isfinite(d[1])][None, :]).any()
    for rank, res in enumerate(results):
        got = res[f"merges_{tp}"][merge]
        for name, w in zip(names, want[merge]):
            w = np.asarray(w)
            if merge == "scatter":
                w = w[rank]  # rank r of the axis owns block r
            np.testing.assert_array_equal(got[name], w, err_msg=f"{merge} {name}")
    if merge == "gather":  # the gather merge is the flat merge of every list
        for name, w in zip(names, want["flat"]):
            np.testing.assert_array_equal(results[0][f"merges_{tp}"]["gather"][name],
                                          np.asarray(w))


# -- DistributedRegistration ----------------------------------------------------


def _assert_same_run(got: dict, want, *, traj_atol=5e-6):
    """test_distributed_align.py's comparison of two registrations."""
    np.testing.assert_allclose(got["final"], want.transformation(), atol=traj_atol)
    assert len(got["n_corr"]) == len(want.records)
    assert got["current_iteration"] == want.current_iteration
    assert got["history"] == len(want.transformation_history)
    for j, rec in enumerate(want.records):
        assert got["iterations"][j] == rec.iteration
        assert got["n_corr"][j] == rec.num_correspondences
        np.testing.assert_allclose(got["translation"][j], rec.translation, atol=traj_atol)
        np.testing.assert_allclose(got["final_cost"][j], rec.final_cost, rtol=2e-4, atol=1e-7)
        np.testing.assert_allclose(got["mse_prev_iter"][j], rec.mse_prev_iter, rtol=1e-4,
                                   atol=5e-6)
    assert got["report_lines"] == 1 + len(want.records)


@pytest.mark.parametrize("dof", ["gaussian", "t5"])
def test_distributed_registration_matches_jax(group4, dof):
    src, tgt = W.pair(4000, 4)
    want = JDist(src, tgt, JParams(**W.params_kw(dof=DOFS[dof])), mesh=j_make_mesh(2, 2))
    want.align()
    for res in group4:
        got = res[f"reg_{dof}"]
        assert got["layout"] == want.layout and got["engine_fallbacks"] == 0
        _assert_same_run(got, want)


@pytest.mark.parametrize("dof", ["gaussian", "t5"])
def test_distributed_registration_matches_single_device(group4, dof):
    src, tgt = W.pair(4000, 4)
    single = ProbabilisticRegistration(
        src, tgt, RegistrationParams(search_impl="pool", **W.params_kw(dof=DOFS[dof])),
        device="cpu")
    single.align()
    _assert_same_run(group4[0][f"reg_{dof}"], single)


def test_budget_ladder_ends_on_the_sharded_grid(group2):
    """A starved pooled budget climbs the ladder (x2, twice) and ends on the
    sharded grid engine, with the single-device pair's results (the JAX
    package's and the port's). The JAX package's own sharded grid scan
    cannot be traced at tp=2 (ROADMAP.md queue 3), so its single-device
    pooled pair is the reference here."""
    src, tgt = W.pair(2500, 7)
    kw = W.params_kw(n_iter=3, cost_drop_thresh=-1.0, outer_chunk=3)
    want = JProb(src, tgt, JParams(search_impl="pool", **kw))
    want.align()
    single = ProbabilisticRegistration(src, tgt, RegistrationParams(search_impl="pool", **kw),
                                       device="cpu")
    single.align()
    for res in group2:
        got = res["ladder"]
        assert (got["engine"], got["boost"], got["engine_fallbacks"]) == ("grid", 2, 1)
        _assert_same_run(got, want)
        _assert_same_run(got, single)


def test_prepared_target_matches_fresh(group4):
    for res in group4:
        got = res["prepared"]
        assert not got["sp_none"]
        np.testing.assert_allclose(got["prepared"]["final"], got["fresh"]["final"], atol=5e-6)
        assert got["prepared"]["n_corr"] == got["fresh"]["n_corr"]


def test_debug_replication(group4):
    """The replication check is clean on a healthy 2x2 run (and changes
    nothing), and poisons every rank when the probe differs across
    "targets"."""
    for res in group4:
        rep = res["replication"]
        assert np.isfinite(rep["rows"]).all() and rep["rows"].shape[0] == 2
        assert np.isnan(rep["bad_q"]).all()
        np.testing.assert_array_equal(rep["good_q"], rep["q"])
        _same(res["reg_t5_debug"]["final"], res["reg_t5"]["final"])
        assert res["reg_t5_debug"]["n_corr"] == res["reg_t5"]["n_corr"]


def test_mesh_odometry_matches_single_device(group4, tmp_path):
    params = RegistrationParams(**W.params_kw(n_iter=4, cost_drop_thresh=-1.0))
    single = run_odometry(W.world_sequence(), params, device="cpu")
    for res in group4:
        got = res["odometry"]
        assert len(got["poses"]) == len(single.poses)
        np.testing.assert_allclose(got["poses"], np.array(single.poses), atol=5e-6)
        assert got["reports"] == [len(r.strip().splitlines()) for r in single.reports]
        assert got["checkpoint_written"] and got["redone"] == []
        np.testing.assert_array_equal(got["resumed"], got["poses"])


def test_odometry_cli_under_torchrun(tmp_path):
    """``torchrun --standalone --nproc-per-node 2 -m ...cli_odometry ...
    --mesh 1x2 --device cpu``: the group starts from torchrun's environment,
    rank 0 alone prints (the backend line, the trajectory line) and writes
    the trajectory, which is the single-device CLI's."""
    import json
    import os
    import subprocess

    from probabilistic_point_clouds_registration_tpu_torch import cli_odometry

    scan_dir = tmp_path / "scans"
    scan_dir.mkdir()
    for i, scan in enumerate(W.world_sequence(3)):
        rec = np.concatenate([scan.astype(np.float32), np.zeros((len(scan), 1), np.float32)], 1)
        rec.tofile(scan_dir / f"{i:06d}.bin")
    args = [str(scan_dir), "-r", "0.5", "-m", "8", "-i", "4", "--device", "cpu"]
    repo = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "probabilistic_point_clouds_registration_tpu_torch.cli_odometry", *args,
         "-o", str(tmp_path / "mesh.json"), "--mesh", "1x2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("torch.distributed: 2 ranks, backend gloo (ranks on the CPU)") == 1
    assert proc.stdout.count("Trajectory written") == 1
    assert cli_odometry.main(args + ["-o", str(tmp_path / "single.json")]) == 0
    poses = {name: np.array(json.loads((tmp_path / f"{name}.json").read_text())["poses"])
             for name in ("mesh", "single")}
    np.testing.assert_allclose(poses["mesh"], poses["single"], atol=5e-6)


# -- the edge-sharded pose graph -------------------------------------------------


def _pose_graph_arrays(poses, edges, weights):
    return (np.stack([np_matrix_to_quat(p[:3, :3]) for p in poses]),
            np.stack([p[:3, 3] for p in poses]),
            np.array([e[0] for e in edges], np.int32), np.array([e[1] for e in edges], np.int32),
            np.stack([np_matrix_to_quat(e[2][:3, :3]) for e in edges]),
            np.stack([e[2][:3, 3] for e in edges]), np.asarray(weights, np.float64))


def test_edge_sharded_pose_graph_matches_jax(group2):
    """The port's edge-sharded solve on two ranks against the JAX package's
    solve of the same graph (1e-8). The JAX package's own edge-sharded
    solver sums J^T r and J^T J v twice (test below), so its answer is the
    one the unsharded solve gives."""
    poses, edges, weights = W.loop_graph(40)
    q, t, cost = J_pg.optimize_pose_graph_qt(
        *(jnp.asarray(a) for a in _pose_graph_arrays(poses, edges, weights)),
        J_pg.PoseGraphConfig())
    odd = edges[:-2] + edges[-1:]
    single, single_cost = T_pg.optimize_pose_graph(poses, odd, weights=weights[:-2] + weights[-1:],
                                                   device="cpu")
    for res in group2:
        got = res["pose_graph"]
        assert got["n_edges"] % 2 == 0
        np.testing.assert_allclose(got["q"], np.asarray(q), rtol=0, atol=1e-8)
        np.testing.assert_allclose(got["t"], np.asarray(t), rtol=0, atol=1e-8)
        np.testing.assert_allclose(got["cost"], float(cost), rtol=1e-9)
        # An edge count the axis does not divide, padded by the wrapper.
        np.testing.assert_allclose(got["wrap_poses"], np.array(single), rtol=0, atol=1e-8)
        np.testing.assert_allclose(got["wrap_cost"], single_cost, rtol=1e-9, atol=1e-30)


class _DoubleSum:
    """A one-rank stand-in for a 2-rank "points" axis whose J^T r and
    J^T J v (the (P, 6) reductions) come out twice, the cost and the
    preconditioner's blocks once."""

    def psum(self, x, axis):
        return x * 2 if x.dim() == 2 else x


def test_jax_sharded_pose_graph_sums_twice():
    """ROADMAP.md queue 3: the JAX package's make_sharded_pose_graph_solver
    on 2 shards equals the unsharded solve with J^T r and J^T J v doubled
    (its VJP through the sharded residuals already sums over the axis, and
    the explicit psum sums again), not the unsharded solve."""
    import torch

    poses, edges, weights = W.loop_graph(40)
    arrays = _pose_graph_arrays(poses, edges, weights)
    cfg = J_pg.PoseGraphConfig(max_iterations=1)
    jq, _, jc = J_pg.make_sharded_pose_graph_solver(j_make_mesh(2, 1), cfg)(
        *(jnp.asarray(a) for a in arrays))
    sq, _, sc = J_pg.optimize_pose_graph_qt(*(jnp.asarray(a) for a in arrays), cfg)
    t = [torch.as_tensor(a) for a in arrays]
    t[2], t[3] = t[2].long(), t[3].long()
    dq, _, dc = T_pg.optimize_pose_graph_qt(
        *t, T_pg.PoseGraphConfig(max_iterations=1, axis_name="points"), mesh=_DoubleSum())
    np.testing.assert_allclose(dq.numpy(), np.asarray(jq), rtol=0, atol=1e-12)
    assert np.abs(np.asarray(jq) - np.asarray(sq)).max() > 1e-6
