"""The port's registration loop against the JAX package's, end to end.

Both run from the same numpy clouds, with the JAX side's dtype passed
explicitly (the test session enables x64). The JAX side runs its
one-iteration host loop (``outer_chunk=1``), the port its default chunks of
four, which reproduce it (tests/test_torch_registration_chunks.py).

Tolerances:
* float32 (the production dtype): per-iteration correspondence counts
  equal, costs at rtol 1e-5, the final 4x4 at 1e-5 absolute (float32 sums
  taken in another order).
* float64: counts equal, costs at rtol 1e-9, the final 4x4 at 1e-9.
"""
import json

import numpy as np
import pytest
import torch

import torch_port_fixture
from probabilistic_point_clouds_registration_tpu.core.params import (
    RegistrationParams as JParams,
)
from probabilistic_point_clouds_registration_tpu.models.registration import (
    register_pair as j_register_pair,
)
from probabilistic_point_clouds_registration_tpu_torch import (
    ProbabilisticRegistration,
    RegistrationParams,
    register_pair,
)
from probabilistic_point_clouds_registration_tpu_torch.io.synthetic import bunny_like
from probabilistic_point_clouds_registration_tpu_torch.models import registration as t_reg


def _clustered_pair(n_src=1500, n_tgt=2048, seed=0):
    """tests/test_fused_grid.py's pair, source shifted off the target."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 1.0, size=(40, 3))
    tgt = centers[rng.integers(0, 40, n_tgt)] + rng.normal(scale=0.025, size=(n_tgt, 3))
    src = centers[rng.integers(0, 40, n_src)] + rng.normal(scale=0.025, size=(n_src, 3))
    src = src + np.array([0.02, -0.015, 0.01])
    return src.astype(np.float32), tgt.astype(np.float32)


def _bunny_pair(n=6000):
    tgt = bunny_like(n, seed=1)
    c, s = np.cos(0.02), np.sin(0.02)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return tgt @ rot.T + np.array([0.02, -0.015, 0.01]), tgt


def _compare(src, tgt, *, jax_impl, port_impl, dtype="float32", **kw):
    cost_rtol, t_atol = (1e-5, 1e-5) if dtype == "float32" else (1e-9, 1e-9)
    kw = dict(dtype=dtype, cost_drop_thresh=-1.0, **kw)
    want_T, want = j_register_pair(
        src, tgt, JParams(search_impl=jax_impl, outer_chunk=1, **kw)
    )
    got_T, got = register_pair(
        src, tgt, RegistrationParams(search_impl=port_impl, **kw), device="cpu"
    )
    assert len(got.records) == len(want.records)
    for g, w in zip(got.records, want.records):
        assert g.num_correspondences == w.num_correspondences
        np.testing.assert_allclose(g.initial_cost, w.initial_cost, rtol=cost_rtol)
        np.testing.assert_allclose(g.final_cost, w.final_cost, rtol=cost_rtol)
    np.testing.assert_allclose(got_T, want_T, rtol=0, atol=t_atol)
    assert got.inner_cap_hits == want.inner_cap_hits
    return got


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_registration_matches_jax_fused_engine(dtype):
    src, tgt = _clustered_pair()
    got = _compare(src, tgt, jax_impl="fused", port_impl="fused", dtype=dtype,
                   max_neighbours=10, radius=0.12, n_iter=4, dof=5.0)
    assert got.engine == "fused" and got.engine_fallbacks == 0
    assert got.report().splitlines()[0] == t_reg.REPORT_HEADER
    assert len(got.report().splitlines()) == 5


def test_auto_takes_fused_engine_and_matches_jax():
    src, tgt = _bunny_pair()
    got = _compare(src, tgt, jax_impl="grid", port_impl="auto",
                   max_neighbours=20, radius=0.1, n_iter=3, dof=5.0,
                   pad_multiple=1024)
    assert got.engine == "fused"


@pytest.mark.parametrize(
    "dof,dtype", [(5.0, "float32"), (float("inf"), "float64")],
    ids=["t5-float32", "gaussian-float64"],
)
def test_brute_registration_matches_jax(dof, dtype):
    src, tgt = _clustered_pair(n_src=400, n_tgt=600, seed=2)
    got = _compare(src, tgt, jax_impl="brute", port_impl="brute", dtype=dtype,
                   max_neighbours=8, radius=0.1, n_iter=2, dof=dof)
    assert got.engine == "brute"


def test_group_overflow_falls_back_to_brute_visibly(capsys):
    """Scattered sources blow the fused engine's group budget: the pair
    moves to the grid engine (brute force, before the grid engine was
    ported), says so, counts it, and ends where the grid engine alone and
    the independent brute engine end."""
    xs = np.arange(8)
    pts = np.stack(np.meshgrid(xs, xs, np.arange(4)), -1).reshape(-1, 3)
    src = pts.astype(np.float32)
    tgt = (pts + 0.05).astype(np.float32)
    kw = dict(max_neighbours=4, radius=0.4, n_iter=3, cost_drop_thresh=-1.0,
              dtype="float32", verbose=True)
    fused_T, fused = register_pair(
        src, tgt, RegistrationParams(search_impl="fused", **kw), device="cpu"
    )
    assert fused.engine == "fused" and fused.engine_fallbacks == 1
    assert fused._prepack is None and fused._grid is not None
    assert "falling back to the grid engine" in capsys.readouterr().out
    for impl in ("grid", "brute"):
        other_T, other = register_pair(
            src, tgt, RegistrationParams(search_impl=impl, **kw), device="cpu"
        )
        assert other.engine == impl and other.engine_fallbacks == 0
        np.testing.assert_array_equal(fused_T, other_T)
        assert [r.num_correspondences for r in fused.records] == [
            r.num_correspondences for r in other.records
        ]


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, tgt = _clustered_pair(n_src=64, n_tgt=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProbabilisticRegistration(src, tgt, RegistrationParams(radius=0.12))


@pytest.mark.parametrize(
    "override", [dict(search_impl="no-such-engine")], ids=["unknown-engine"],
)
def test_unported_options_raise(override):
    src, tgt = _clustered_pair(n_src=64, n_tgt=128)
    with pytest.raises(NotImplementedError):
        ProbabilisticRegistration(
            src, tgt, RegistrationParams(radius=0.12, **override), device="cpu"
        )


def _hot_pair(n=2500, seed=11, hot=200):
    """tests/test_fused_pool.py:26-39's pair: a scattered sheet plus one hot
    blob, the source rotated and shifted."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, 30, size=(n, 3))
    tgt[:, 2] = rng.normal(scale=0.4, size=n)
    tgt[:hot] = rng.normal(scale=0.15, size=(hot, 3)) + np.array([15.0, 15.0, 0.0])
    c, s = np.cos(0.02), np.sin(0.02)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    src = tgt @ rot.T + np.array([0.3, 0.05, 0.01])
    return src.astype(np.float32), tgt.astype(np.float32)


def test_pool_registration_matches_jax_pool_engine():
    """tests/test_fused_pool.py:159's registration, both packages on the
    pooled engine (the JAX side's Pallas select in interpret mode)."""
    src, tgt = _hot_pair()
    got = _compare(src, tgt, jax_impl="pool", port_impl="pool", max_neighbours=8,
                   radius=0.5, n_iter=4, dof=5.0, grid_max_overflow=64)
    assert got.engine == "pool" and got.engine_fallbacks == 0
    assert got._pool_budget_boost == 0


def _lattice_pair(side, depth):
    """Every point alone in its cell: each source takes a group of its own."""
    pts = np.stack(np.meshgrid(np.arange(side), np.arange(side), np.arange(depth)),
                   -1).reshape(-1, 3)
    return pts.astype(np.float32), (pts + 0.05).astype(np.float32)


def _pool_run(src, tgt, *, starve, **kw):
    """A pooled registration; ``starve`` drops the ctor's demand-sized row
    budget to the source-row floor, so that the first search overflows."""
    params = RegistrationParams(search_impl="pool", max_neighbours=4, radius=0.4,
                                dtype="float32", verbose=True, **kw)
    reg = ProbabilisticRegistration(src, tgt, params, device="cpu")
    assert reg.engine == "pool"
    if starve:
        reg._pool_budget_base = 0
    return reg.align(), reg


def test_pool_budget_escalation_recovers_with_the_stall_counter(capsys):
    """8,000 rows of demand against a 6,144-row budget: the iteration is
    redone at twice the budget, and the stall counter the discarded check
    moved is restored (every iteration is unuseful at cost_drop_thresh 2,
    so a lost restore would end the pair one iteration early)."""
    src, tgt = _lattice_pair(10, 10)
    kw = dict(n_iter=6, cost_drop_thresh=2.0, n_cost_drop_it=1)
    want_T, want = _pool_run(src, tgt, starve=False, **kw)
    assert "budget overflow" not in capsys.readouterr().out
    got_T, got = _pool_run(src, tgt, starve=True, **kw)
    assert "retrying with a 2x row budget" in capsys.readouterr().out
    assert got._pool_budget_boost == 1 and got.engine_fallbacks == 0
    assert len(got.records) == len(want.records) == 2
    np.testing.assert_array_equal(got_T, want_T)


def test_pool_overflow_past_the_cap_falls_back_visibly(capsys):
    """65,536 rows of demand overflow even the 4x budget: the pair moves to
    the grid engine, whose bucket tensors are uploaded only then, says so,
    counts it, and ends where the grid engine alone and the independent
    brute engine end."""
    src, tgt = _lattice_pair(32, 8)
    kw = dict(n_iter=2, cost_drop_thresh=-1.0)
    pool_T, pool = _pool_run(src, tgt, starve=True, **kw)
    out = capsys.readouterr().out
    assert "retrying with a 4x row budget" in out
    assert "falling back to the grid engine" in out
    assert out.index("retrying with a 4x") < out.index("Target grid:")  # lazy upload
    assert pool.engine_fallbacks == 1 and pool._pool is None and pool._grid is not None
    for impl in ("grid", "brute"):
        other_T, other = register_pair(
            src, tgt, RegistrationParams(search_impl=impl, max_neighbours=4, radius=0.4,
                                         dtype="float32", **kw), device="cpu"
        )
        assert other.engine == impl
        np.testing.assert_array_equal(pool_T, other_T)
        assert [r.num_correspondences for r in pool.records] == [
            r.num_correspondences for r in other.records
        ]


def test_auto_plans_the_pool_only_for_a_cuda_device(monkeypatch):
    """prepare_target is host-only: on a CUDA device ``auto`` plans the
    pool and skips the bucket tensors; on the CPU it keeps the buckets and
    makes no plan; a declined plan is recorded and adds the buckets."""
    rng = np.random.default_rng(4)
    tgt = rng.uniform(0, 30, size=(4000, 3))
    tgt[:, 2] = rng.normal(scale=0.4, size=4000)  # sparse: the grid is kept
    params = RegistrationParams(radius=0.5, max_neighbours=8)
    on_cuda = ProbabilisticRegistration.prepare_target(tgt, params, device="cuda")
    assert isinstance(on_cuda["pool_plan"], dict)
    assert "bucket_idx" not in on_cuda["grid"]
    assert on_cuda["pool_plan"]["widths"][-1] == 128  # planned for cutoff 0
    on_cpu = ProbabilisticRegistration.prepare_target(tgt, params, device="cpu")
    assert on_cpu["pool_plan"] is None and "bucket_idx" in on_cpu["grid"]
    monkeypatch.setattr(t_reg._fp, "plan_pool_host", lambda *a, **kw: None)
    declined = ProbabilisticRegistration.prepare_target(tgt, params, device="cuda")
    assert declined["pool_plan"] is False and "bucket_idx" in declined["grid"]


def _sheet_pair(hot=0):
    """A sparse sheet (the grid is kept); ``hot`` points packed into one
    cell give the grid a hot-cell overflow set at ``grid_max_overflow`` 64."""
    rng = np.random.default_rng(4)
    tgt = rng.uniform(0, 30, size=(4000, 3))
    tgt[:, 2] = rng.normal(scale=0.4, size=4000)
    tgt[:hot] = rng.uniform(0, 0.4, size=(hot, 3)) + np.array([15.05, 15.05, 0.05])
    return tgt + np.array([0.2, 0.05, 0.01]), tgt


@pytest.mark.parametrize("hot,engine", [(0, "fused"), (60, "fused")])
def test_target_prepared_for_cuda_runs_on_the_cpu(hot, engine):
    """A target prepared for the pool (the default device) and handed to a
    CPU ``auto`` run gets its bucket tensors and overflow split (the fused
    engine merges the hot-cell overflow set), and the run equals one that
    prepared its own target."""
    src, tgt = _sheet_pair(hot)
    params = RegistrationParams(radius=0.5, max_neighbours=8, n_iter=2,
                                cost_drop_thresh=-1.0, grid_max_overflow=64)
    prepared = ProbabilisticRegistration.prepare_target(tgt, params)
    assert isinstance(prepared["pool_plan"], dict) and "bucket_idx" not in prepared["grid"]
    got = ProbabilisticRegistration(src, tgt, params, prepared_target=prepared, device="cpu")
    want = ProbabilisticRegistration(src, tgt, params, device="cpu")
    assert got.engine == want.engine == engine
    assert ("overflow_pts" in prepared["grid"]) == (hot > 0)
    np.testing.assert_array_equal(got.align(), want.align())


def test_pool_plan_for_another_cutoff_is_made_again():
    """A pool plan made for a CUDA device (cutoff 0) is not reused by a CPU
    run, whose cutoff is 64: the run plans again and equals one that
    prepared its own target."""
    src, tgt = _sheet_pair()
    params = RegistrationParams(search_impl="pool", radius=0.5, max_neighbours=8,
                                n_iter=2, cost_drop_thresh=-1.0)
    prepared = ProbabilisticRegistration.prepare_target(tgt, params, device="cuda")
    assert prepared["pool_cutoff"] == 0 and min(prepared["pool_plan"]["widths"]) == 128
    got = ProbabilisticRegistration(src, tgt, params, prepared_target=prepared, device="cpu")
    want = ProbabilisticRegistration(src, tgt, params, device="cpu")
    assert got._pool.select_max_w == want._pool.select_max_w == 64
    assert got._pool.class_widths == want._pool.class_widths
    np.testing.assert_array_equal(got.align(), want.align())


def test_kitti_fixture_plan_facts():
    """The LiDAR fixture's target, rebuilt with the port's generator and
    host code: capacity 128 with a 3,123-point hot-cell overflow set (the
    dense engine cannot take it), five pool classes when every class runs a
    kernel."""
    from probabilistic_point_clouds_registration_tpu_torch.core.types import pad_cloud
    from probabilistic_point_clouds_registration_tpu_torch.io import synthetic
    from probabilistic_point_clouds_registration_tpu_torch.ops import fused_pool, grid

    fixture = json.loads(torch_port_fixture.fixture_path("kitti131k").read_text())
    spec = torch_port_fixture.PAIRS["kitti131k"]
    assert fixture["pair"] == spec["pair"]
    p = spec["params"]
    _, tgt = torch_port_fixture.make_pair(spec["pair"], synthetic)
    tg, n_tgt = pad_cloud(tgt, p["pad_multiple"], pad_value=0.0)
    g = grid.build_grid_host(tg, p["radius"], num_valid=n_tgt,
                             max_overflow=p["grid_max_overflow"])
    plan = fused_pool.plan_pool_host(g, tg, select_max_w=0)
    assert fixture["plan"] == {
        "capacity": g["capacity"],
        "overflow_points": int((g["overflow_idx"] >= 0).sum()),
        "class_widths_cutoff0": plan["widths"],
    }
    assert fixture["plan"]["overflow_points"] == 3123
    assert len(fixture["iterations"]) == p["n_iter"] == 10


def test_bench_fixture_still_matches_jax():
    """The GPU smoke run is held against tests/data/torch_port_bunny35k_ref.json;
    its first two iterations must still be what the JAX package computes."""
    fixture = json.loads(torch_port_fixture.FIXTURE.read_text())
    _, records = torch_port_fixture.reference_run(n_iter=2)
    for rec, want in zip(records, fixture["iterations"][:2]):
        assert rec.num_correspondences == want["correspondences"]
        np.testing.assert_allclose(rec.initial_cost, want["initial_cost"], rtol=1e-6)
        np.testing.assert_allclose(rec.final_cost, want["final_cost"], rtol=1e-6)


# -- the grid engine, the KNN-kernel brute engine, and what falls back to them --


@pytest.mark.parametrize(
    "dtype,select",
    [("float32", "auto"), ("float32", "pallas"), ("float32", "hier"),
     ("float32", "approx"), ("float64", "topk")],
)
def test_grid_registration_matches_jax_grid_engine(dtype, select):
    """``search_impl="grid"`` on the hot-blob pair (capacity 8, a hot-cell
    overflow set that the merge brings back) against the JAX package's grid
    engine. The port's select modes all return "topk"'s slots; the JAX side
    runs "topk" for "approx" (its approximate top-k promises recall 0.99
    only) and its Pallas kernel in interpret mode for "pallas"."""
    src, tgt = _hot_pair()
    j_select = {"pallas": "pallas_interpret", "approx": "topk"}.get(select, select)
    cost_rtol, t_atol = (1e-5, 1e-5) if dtype == "float32" else (1e-9, 1e-9)
    kw = dict(dtype=dtype, cost_drop_thresh=-1.0, max_neighbours=8, radius=0.5,
              n_iter=4, dof=5.0, grid_max_overflow=64)
    want_T, want = j_register_pair(
        src, tgt, JParams(search_impl="grid", search_select=j_select, outer_chunk=1, **kw)
    )
    got_T, got = register_pair(
        src, tgt, RegistrationParams(search_impl="grid", search_select=select, **kw),
        device="cpu",
    )
    assert got.engine == "grid" and got.engine_fallbacks == 0
    assert got._grid.overflow_pts is not None and got._prepack is None
    assert len(got.records) == len(want.records) == 4
    for g, w in zip(got.records, want.records):
        assert g.num_correspondences == w.num_correspondences
        np.testing.assert_allclose(g.initial_cost, w.initial_cost, rtol=cost_rtol)
        np.testing.assert_allclose(g.final_cost, w.final_cost, rtol=cost_rtol)
    np.testing.assert_allclose(got_T, want_T, rtol=0, atol=t_atol)


def test_grid_registration_on_the_bunny_pair_matches_jax():
    src, tgt = _bunny_pair()
    got = _compare(src, tgt, jax_impl="grid", port_impl="grid", max_neighbours=20,
                   radius=0.1, n_iter=3, dof=5.0, pad_multiple=1024)
    assert got.engine == "grid"


@pytest.mark.parametrize(
    "dof,dtype", [(5.0, "float32"), (float("inf"), "float64")],
    ids=["t5-float32", "gaussian-float64"],
)
def test_pallas_registration_matches_jax_brute_engine(dof, dtype):
    """``search_impl="pallas"``: the JAX package takes its KNN kernel only on
    its accelerator and runs its XLA brute engine elsewhere, so on the CPU
    the other side of this test is the JAX brute engine, and the port's side
    is the CUDA kernel's plain twin. No grid is built."""
    src, tgt = _clustered_pair(n_src=400, n_tgt=600, seed=2)
    got = _compare(src, tgt, jax_impl="pallas", port_impl="pallas", dtype=dtype,
                   max_neighbours=8, radius=0.1, n_iter=2, dof=dof)
    assert got.engine == "pallas" and got._grid_host is None and got._grid is None


def test_pallas_registration_on_the_bunny_pair_matches_jax():
    src, tgt = _bunny_pair(3000)
    got = _compare(src, tgt, jax_impl="pallas", port_impl="pallas", max_neighbours=20,
                   radius=0.1, n_iter=2, dof=5.0, pad_multiple=1024)
    assert got.engine == "pallas"


def _hot_cluster_pair(n_src=3000, n_tgt=4096, n_clusters=80, hot=700, seed=0):
    """Clusters dense enough for the fused engine's group budget, plus one
    blob hot enough that the grid caps its capacity (128) and strands 158
    points in the overflow set at ``grid_max_overflow`` 200."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 1.6, size=(n_clusters, 3))
    tgt = centers[rng.integers(0, n_clusters, n_tgt)] + rng.normal(scale=0.025, size=(n_tgt, 3))
    tgt[:hot] = centers[0] + rng.normal(scale=0.01, size=(hot, 3))
    src = centers[rng.integers(0, n_clusters, n_src)] + rng.normal(scale=0.025, size=(n_src, 3))
    src[:200] = centers[0] + rng.normal(scale=0.02, size=(200, 3))
    src = src + np.array([0.02, -0.015, 0.01])
    return src.astype(np.float32), tgt.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_registration_merges_the_overflow_set_like_jax(dtype):
    """``search_impl="fused"`` on a grid with a hot-cell overflow set: the
    dense engine merges the set after its search and gathers again, as the
    JAX fused engine does (its select kernel in interpret mode)."""
    src, tgt = _hot_cluster_pair()
    got = _compare(src, tgt, jax_impl="fused", port_impl="fused", dtype=dtype,
                   max_neighbours=10, radius=0.12, n_iter=3, dof=5.0,
                   grid_max_overflow=200)
    assert got.engine == "fused" and got.engine_fallbacks == 0
    assert int((got._grid.overflow_idx >= 0).sum()) == 158
    # The overflow points are somebody's neighbours: without the merge the
    # counts would differ from the grid engine's.
    grid_T, grid = register_pair(
        src, tgt, RegistrationParams(search_impl="grid", dtype=dtype, cost_drop_thresh=-1.0,
                                     max_neighbours=10, radius=0.12, n_iter=3, dof=5.0,
                                     grid_max_overflow=200), device="cpu")
    assert [r.num_correspondences for r in got.records] == [
        r.num_correspondences for r in grid.records]


def test_pool_that_declines_runs_the_grid_engine(monkeypatch):
    """A declined pool plan leaves the grid engine, not brute force (the
    engine ``auto`` on a CUDA device ends on too when the fused engine's
    fit estimate fails)."""
    monkeypatch.setattr(t_reg._fp, "plan_pool_host", lambda *a, **kw: None)
    src, tgt = _sheet_pair(60)
    params = RegistrationParams(search_impl="pool", radius=0.5, max_neighbours=8,
                                n_iter=2, cost_drop_thresh=-1.0, grid_max_overflow=64)
    pool_T, pool = register_pair(src, tgt, params, device="cpu")
    assert pool.engine == "grid" and pool._pool is None
    grid_T, _ = register_pair(
        src, tgt, RegistrationParams(**{**params.__dict__, "search_impl": "grid"}),
        device="cpu",
    )
    np.testing.assert_array_equal(pool_T, grid_T)


def test_auto_on_a_dense_cloud_keeps_brute_force():
    """``auto``'s density check drops the grid (27 * capacity * 8 > M): the
    only place left where brute force runs without being asked for."""
    src, tgt = _clustered_pair(n_src=400, n_tgt=600, seed=2)
    reg = ProbabilisticRegistration(
        src, tgt, RegistrationParams(radius=0.1, max_neighbours=8), device="cpu"
    )
    assert reg.engine == "brute" and reg._grid_host is None
    forced = ProbabilisticRegistration(
        src, tgt, RegistrationParams(radius=0.1, max_neighbours=8, search_impl="grid"),
        device="cpu",
    )
    assert forced.engine == "grid"
