"""The port's multi-device half in one process (``parallel/``) against the
JAX package's, on the same numpy inputs.

The host plans (``plan_pool_host(force=)``, ``_ladder_ends``,
``plan_pool_host_group`` and its halves merged over blocks of a group, the shard-layout chooser, the sharded pool and
grid plans, the demand replay), ``pad_for_mesh``, ``merge_topk`` on stacked
per-shard lists with exact ties, and the rank layout against
``make_mesh(dp, tp).devices`` are held equal bit for bit. Without a process
group ``make_mesh()`` is a 1x1 mesh whose collectives are the identity:
``DistributedRegistration`` on it is bit-equal to the single-device pooled
``align()``. The multi-process cases are in tests/test_torch_distributed.py.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilistic_point_clouds_registration_tpu.core.types import pad_cloud
from probabilistic_point_clouds_registration_tpu.models.em_lm import LMConfig as JLMConfig
from probabilistic_point_clouds_registration_tpu.ops import fused_pool as j_fp
from probabilistic_point_clouds_registration_tpu.ops import grid as j_grid
from probabilistic_point_clouds_registration_tpu.parallel import distributed as j_dist
from probabilistic_point_clouds_registration_tpu.parallel import grid_sharded as j_gs
from probabilistic_point_clouds_registration_tpu.parallel import make_mesh as j_make_mesh
from probabilistic_point_clouds_registration_tpu.parallel import pool_sharded as j_ps
from probabilistic_point_clouds_registration_tpu_torch import RegistrationParams
from probabilistic_point_clouds_registration_tpu_torch import parallel as tp_
from probabilistic_point_clouds_registration_tpu_torch.models import em_lm as t_em
from probabilistic_point_clouds_registration_tpu_torch.models.registration import (
    ProbabilisticRegistration,
)
from probabilistic_point_clouds_registration_tpu_torch.ops import fused_pool as t_fp
from probabilistic_point_clouds_registration_tpu_torch.ops import grid as t_grid
from probabilistic_point_clouds_registration_tpu_torch.parallel import grid_sharded as t_gs
from probabilistic_point_clouds_registration_tpu_torch.parallel import mesh as t_mesh
from probabilistic_point_clouds_registration_tpu_torch.parallel import pool_sharded as t_ps

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_port_mesh_worker as W  # noqa: E402

P = jax.sharding.PartitionSpec


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


def _eq(got, want, msg=""):
    """Bit-equality of an array (or tensor) against the JAX side's."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{msg}: {got.shape} vs {want.shape}"
    if want.dtype.kind == "f":
        assert got.dtype == want.dtype, msg
        view = np.int32 if got.itemsize == 4 else np.int64
        np.testing.assert_array_equal(got.view(view), want.view(view), err_msg=msg)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=msg)


def _eq_tree(got, want, path="plan"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for key in want:
            _eq_tree(got[key], want[key], f"{path}[{key!r}]")
    elif isinstance(want, np.ndarray):
        _eq(got, want, path)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _eq_tree(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


def _targets():
    """Two targets: tests/test_distributed_align.py's slab and a sparser
    sheet with a hot blob (wide classes)."""
    slab = W.pair(4000, 4)[1]
    rng = np.random.default_rng(11)
    sheet = rng.uniform(0, 50, size=(8000, 3))
    sheet[:, 2] = rng.normal(scale=0.4, size=8000)
    sheet[:200] = rng.normal(scale=0.15, size=(200, 3)) + np.array([15.0, 15.0, 0.0])
    return {"slab": slab.astype(np.float64), "hot": sheet}


TARGETS = _targets()
RADIUS = 0.5


def _shard_grids(target, n_shards):
    rows_of = [np.arange(s, target.shape[0], n_shards) for s in range(n_shards)]
    jg = [j_grid.build_grid_host(target[r], RADIUS, buckets=False) for r in rows_of]
    tg = [t_grid.build_grid_host(target[r], RADIUS, buckets=False) for r in rows_of]
    return rows_of, jg, tg


# -- host plans -----------------------------------------------------------------


@pytest.mark.parametrize("widths", [[512, 128], [1024, 256, 128], [128]])
def test_ladder_ends_equal_jax(widths):
    rng = np.random.default_rng(len(widths))
    union = np.sort(rng.integers(1, 600, size=300))[::-1]
    _eq_tree(t_fp._ladder_ends(union, widths), j_fp._ladder_ends(union, widths), "ends")


@pytest.mark.parametrize("name", ["slab", "hot"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_plan_pool_host_group_and_force_equal_jax(name, n_shards):
    """The group plan (self-keyed plans, then ``force`` with the maxima)
    bit-equal to the JAX package's, every shard's plan tree."""
    rows_of, jg, tg = _shard_grids(TARGETS[name], n_shards)
    targets = [TARGETS[name][r] for r in rows_of]
    want = j_fp.plan_pool_host_group(jg, targets)
    got = t_fp.plan_pool_host_group(tg, targets, device="cpu")
    assert want is not None and got is not None
    for s, (g, w) in enumerate(zip(got, want)):
        _eq_tree(g, w, f"shard {s}")
    # A forced plan whose sizes do not cover the scan declines in both.
    force = dict(widths=tuple(want[0]["widths"]), pad_sizes=(1,) * len(want[0]["widths"]),
                 prod_d_pad=want[0]["prod_d_pad"], prod_e_pad=want[0]["prod_e_pad"],
                 u_pad=1 << 20, n_pad=1 << 20, ud_b=1 << 20)
    assert j_fp.plan_pool_host(jg[0], targets[0], force=force) is None
    assert t_fp.plan_pool_host(tg[0], targets[0], force=force, device="cpu") is None


def _group_of_six():
    """Six targets: the slab's three shards (ladders [16, 8] and
    [32, 16, 8]) and the hot sheet's three ([128, 64, 32, 16, 8])."""
    grids, targets = [], []
    for name in ("slab", "hot"):
        rows_of, _, tg = _shard_grids(TARGETS[name], 3)
        grids += tg
        targets += [TARGETS[name][r] for r in rows_of]
    return grids, targets


# Blocks of the six targets, as ranks of a batch hold them: in "halves"
# and "three" a block lacks width classes that another block has.
GROUP_SPLITS = {"halves": [[0, 1, 2], [3, 4, 5]], "three": [[0], [1, 2], [3, 4, 5]],
                "interleaved": [[0, 3], [1, 4], [2, 5]]}


@pytest.mark.parametrize("split", sorted(GROUP_SPLITS))
def test_merged_block_statics_give_the_group_plan(split):
    """The blocks' statics (``pool_group_statics``), merged, give the
    ``force`` the whole group's plan was made with (read back from its
    plans), and each block's forced plans equal the group's, array for
    array."""
    grids, targets = _group_of_six()
    whole = t_fp.plan_pool_host_group(grids, targets, device="cpu")
    p = whole[0]
    want = {"widths": tuple(p["widths"]), "pad_sizes": tuple(np.diff([0] + list(p["ends"]))),
            "prod_d_pad": p["prod_d_pad"], "prod_e_pad": p["prod_e_pad"],
            "u_pad": p["base_e"].shape[0], "n_pad": p["packed"].shape[0] - 1,
            "ud_b": p["row_vals"].shape[0]}
    blocks = GROUP_SPLITS[split]
    parts = [t_fp.pool_group_statics([grids[i] for i in b], [targets[i] for i in b],
                                     device="cpu") for b in blocks]
    force = t_fp.pool_group_force(t_fp.merge_pool_statics(parts))
    assert force == want
    alone = [t_fp.pool_group_force(part)["widths"] for part in parts]
    assert (alone != [force["widths"]] * len(blocks)) == (split != "interleaved")
    for b in blocks:
        got = t_fp.plan_pool_host_forced([grids[i] for i in b], [targets[i] for i in b], force,
                                         device="cpu")
        for i, plan in zip(b, got):
            _eq_tree(plan, whole[i], f"target {i}")


@pytest.mark.parametrize("stats", [(4000, 4000, 900, 4, 2), (131072, 131072, 52000, 8, 4),
                                   (35000, 35000, 3000, 4, 4), (2000, 9000, 40, 2, 2)])
@pytest.mark.parametrize("smw", [0, 64])
def test_choose_pool_shard_layout_equals_jax(stats, smw):
    want = j_ps.choose_pool_shard_layout(*stats, select_max_w=smw)
    assert t_ps.choose_pool_shard_layout(*stats, select_max_w=smw) == want


@pytest.mark.parametrize("name", ["slab", "hot"])
@pytest.mark.parametrize("n_shards, slices", [(2, False), (2, True), (4, True)])
def test_build_sharded_pool_host_equals_jax(name, n_shards, slices):
    target = TARGETS[name]
    source = target + np.array([0.1, -0.05, 0.02])
    src_slices = [source[:len(source) // 2], source[len(source) // 2:]] if slices else None
    want = j_ps.build_sharded_pool_host(target, RADIUS, n_shards, k=8,
                                        source_slices=src_slices)
    got = t_ps.build_sharded_pool_host(target, RADIUS, n_shards, k=8,
                                       source_slices=src_slices, device="cpu")
    assert want is not None and got is not None
    assert got._fields == want._fields
    for field in want._fields:
        _eq_tree(getattr(got, field), getattr(want, field), field)
    # The demand replay from the plan's own seeds (a prepared target).
    for with_classes in (False, True):
        _eq_tree(t_ps.estimate_sharded_demand_rows(got, [source], with_classes),
                 j_ps.estimate_sharded_demand_rows(want, [source], with_classes), "demand")


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_build_sharded_grid_host_equals_jax(n_shards):
    target = TARGETS["hot"]
    want = j_gs.build_sharded_grid_host(target, RADIUS, n_shards)
    got = t_gs.build_sharded_grid_host(target, RADIUS, n_shards)
    for field in want._fields:
        _eq_tree(getattr(got, field), getattr(want, field), field)


@pytest.mark.parametrize("shape, n_shards, multiple", [((1500, 3), 8, 8), ((4000, 3), 2, 256),
                                                       ((512, 3), 2, 256)])
def test_pad_for_mesh_equals_jax(shape, n_shards, multiple):
    pts = np.random.default_rng(0).normal(size=shape)
    (gp, gn), (wp, wn) = (tp_.pad_for_mesh(pts, n_shards, multiple),
                          j_dist.pad_for_mesh(pts, n_shards, multiple))
    assert gn == wn
    _eq(gp, wp)


# -- the mesh -------------------------------------------------------------------


@pytest.mark.parametrize("dp, tp", [(1, 2), (2, 1), (2, 2), (2, 4), (1, 8), (4, 2)])
def test_rank_layout_matches_jax_mesh(dp, tp):
    """Rank r sits at make_mesh(dp, tp).devices' position of device r, and
    shard_rows gives it the rows JAX places on that device."""
    jmesh = j_make_mesh(dp, tp)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    x = np.arange(dp * tp * 8 * 3, dtype=np.float64).reshape(dp * tp * 8, 3)
    for axis in ("points", "targets"):
        arr = jax.device_put(x, jax.sharding.NamedSharding(jmesh, P(axis)))
        placed = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
        for r in range(dp * tp):
            mesh = t_mesh.Mesh(dp, tp, rank=r, device="cpu")
            p, t = mesh.coords["points"], mesh.coords["targets"]
            assert ids[p, t] == r == mesh.devices[p, t]
            _eq(t_mesh.shard_rows(x, mesh, axis), placed[r], f"rank {r} {axis}")
            assert mesh.global_rank(axis, mesh.index(axis)) == r


def test_single_process_mesh_is_the_identity():
    mesh = tp_.make_mesh(device="cpu")
    assert mesh.shape == {"points": 1, "targets": 1} and mesh.backend is None
    x = torch.arange(6.0).reshape(2, 3)
    assert mesh.psum(x, ("points", "targets")) is x
    assert torch.equal(mesh.all_gather(x, "targets"), x[None])
    assert mesh.exchange(x, "targets", 0) is x
    assert mesh.broadcast_(x, "points") is x
    assert mesh.capturable(("points", "targets")) and not mesh.has_collectives("points")
    assert tp_.initialize_multihost() is False or torch.distributed.is_initialized()
    _eq(tp_.allgather_trajectory(np.eye(4)[None]), np.eye(4)[None])
    with pytest.raises(ValueError, match="needs a world of 4 ranks"):
        tp_.make_mesh(2, 2, device="cpu")


def test_backend_rule(monkeypatch):
    assert tp_.choose_backend("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tp_.choose_backend("cuda", local_world_size=1) == "nccl"
    assert tp_.choose_backend("cuda", local_world_size=4) == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert tp_.choose_backend("cuda") == "gloo"


@pytest.mark.parametrize("with_p", [False, True])
def test_merge_topk_stacked_equals_jax_with_ties(with_p):
    d, i, p = W.tied_lists(4, 96, 6, seed=3)
    want = j_gs.merge_topk(jnp.asarray(d), jnp.asarray(i), jnp.asarray(p) if with_p else None,
                           k=6)
    got = t_gs.merge_topk(torch.as_tensor(d), torch.as_tensor(i),
                          torch.as_tensor(p) if with_p else None, k=6)
    assert (np.diff(np.sort(d.reshape(-1)[np.isfinite(d.reshape(-1))])) == 0).any()
    for g, w in zip(got, want):
        _eq(g, np.asarray(w))


def test_lm_axis_needs_the_mesh():
    src = torch.zeros((8, 3))
    cfg = t_em.LMConfig(axis_name="points")
    with pytest.raises(ValueError, match="needs the Mesh"):
        t_em.em_lm_solve(src, src[:, None].expand(-1, 2, -1), torch.ones((8, 2), dtype=bool),
                         torch.tensor([1.0, 0, 0, 0]), torch.zeros(3), cfg)


def test_one_by_one_registration_equals_single_device():
    """DistributedRegistration on the 1x1 mesh is the single-device pooled
    align(), bit for bit (the merge of one shard keeps its order)."""
    src, tgt = W.pair(4000, 4)
    kw = W.params_kw()
    single = ProbabilisticRegistration(src, tgt, RegistrationParams(search_impl="pool", **kw),
                                       device="cpu")
    dist = tp_.DistributedRegistration(src, tgt, RegistrationParams(**kw),
                                       mesh=tp_.make_mesh(device="cpu"))
    np.testing.assert_array_equal(dist.align(), single.align())
    assert [r.csv() for r in dist.records] == [r.csv() for r in single.records]
    assert dist.engine == "pool" and dist.engine_fallbacks == 0


def test_sharded_pool_step_one_by_one_matches_jax():
    """make_sharded_pool_registration_step on a 1x1 mesh against the JAX
    package's (its Pallas classes in interpret mode) in float64."""
    src, tgt = W.pair(2000, 12)
    k, radius = 8, 0.5
    src_p, n_src = pad_cloud(src.astype(np.float64), 256, pad_value=0.0)
    sv = np.arange(src_p.shape[0]) < n_src
    jmesh = j_make_mesh(1, 1)
    jsp = j_ps.build_sharded_pool_host(tgt, radius, 1, k=k)
    jpools = j_ps.build_sharded_pools_device(jmesh, jsp, dtype=jnp.float64)
    jstep = j_ps.make_sharded_pool_registration_step(
        jmesh, jsp, k=k, radius=radius, lm_config=JLMConfig(dof=5.0),
        source_rows_per_shard=src_p.shape[0], interpret=True)
    q0, t0 = np.array([1.0, 0, 0, 0]), np.zeros(3)
    want = jstep(jnp.asarray(src_p), jnp.asarray(sv), jpools, q0, t0, q0, t0)
    mesh = tp_.make_mesh(device="cpu")
    tsp = t_ps.build_sharded_pool_host(tgt, radius, 1, k=k, device="cpu")
    tpools = t_ps.build_sharded_pools_device(mesh, tsp, dtype=np.float64)
    tstep = t_ps.make_sharded_pool_registration_step(
        mesh, tsp, k=k, radius=radius, lm_config=t_em.LMConfig(dof=5.0),
        source_rows_per_shard=src_p.shape[0])
    tq0, tt0 = torch.as_tensor(q0), torch.as_tensor(t0)
    got = tstep(torch.as_tensor(src_p), torch.as_tensor(sv), tpools, tq0, tt0, tq0, tt0)
    assert int(got.num_correspondences) == int(want.num_correspondences)
    assert int(got.overflow) == int(want.overflow) == 0
    np.testing.assert_allclose(got.result.q.numpy(), np.asarray(want.result.q), atol=1e-9)
    np.testing.assert_allclose(got.result.t.numpy(), np.asarray(want.result.t), atol=1e-9)
    np.testing.assert_allclose(float(got.result.final_cost), float(want.result.final_cost),
                               rtol=1e-9)


def test_odometry_cli_mesh_one_by_one_in_one_process(tmp_path, capsys):
    """``--mesh 1x1`` in one process registers every pair on the mesh path
    and agrees with the run without a mesh."""
    from probabilistic_point_clouds_registration_tpu_torch import cli_odometry

    scans = W.world_sequence(3)
    scan_dir = tmp_path / "scans"
    scan_dir.mkdir()
    for i, scan in enumerate(scans):
        rec = np.concatenate([scan.astype(np.float32), np.zeros((len(scan), 1), np.float32)], 1)
        rec.tofile(scan_dir / f"{i:06d}.bin")
    import json

    trajs = {}
    for mesh in (None, "1x1"):
        out = tmp_path / f"traj_{mesh}.json"
        argv = [str(scan_dir), "-o", str(out), "-r", "0.5", "-m", "8", "-i", "4",
                "--device", "cpu"] + (["--mesh", mesh] if mesh else [])
        assert cli_odometry.main(argv) == 0
        trajs[mesh] = np.array(json.loads(out.read_text())["poses"])
    assert "Trajectory written" in capsys.readouterr().out
    np.testing.assert_allclose(trajs["1x1"], trajs[None], atol=5e-6)
