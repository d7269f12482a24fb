"""Parity of the port's batched odometry (``parallel/batch.py``) with the JAX
package's, on tests/test_batch.py's 4-scan wave-grid sequence (k = 10,
``pad_multiple`` 128, 6 outer iterations).

Each test feeds the same numpy scans to both packages' ``run_odometry_batched``;
each JAX run is made once per module. Tolerances: the brute and grid engines
in float64 at 1e-6 on the poses (the JAX test's limit against sequential
odometry) and 1e-6 relative on the costs, with equal correspondence counts;
the pooled engine in float32 (the port's twins against the JAX kernels in
interpret mode) at 1e-5; the stopping rule's iteration counts exactly. The
batched search and solve hold each pair to the same pair alone: the
flattened class pass, the grid block and the LU bit for bit; the batched LM
step (the single solve's E-step pair by pair, its O(1) math summed
elementwise where the single solve calls BLAS) with the integer state equal
and the rest at 1e-12 (float64) / 1e-6 (float32) relative, the quaternion
through its rotation, and bit for bit whatever batch the pair is in. The sharded batch (3 ``gloo`` processes, 4 pairs
padded to 6) is held to the port's unsharded run at the JAX test's limits,
1e-9 (float64 brute force) and 1e-6 (float32 pool), every rank equal.
"""
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from probabilistic_point_clouds_registration_tpu.models.em_lm import LMConfig as JConfig
from probabilistic_point_clouds_registration_tpu.ops import fused_pool as JFP
from probabilistic_point_clouds_registration_tpu.parallel import batch as JB
from probabilistic_point_clouds_registration_tpu_torch.core.se3 import quat_to_matrix
from probabilistic_point_clouds_registration_tpu_torch.core.types import pad_cloud
from probabilistic_point_clouds_registration_tpu_torch.models.em_lm import (
    LMConfig as TConfig,
    _solve_lu,
    lm_init,
    lm_step,
)
from probabilistic_point_clouds_registration_tpu_torch.ops import fused_pool as fp
from probabilistic_point_clouds_registration_tpu_torch.ops import grid as tgrid
from probabilistic_point_clouds_registration_tpu_torch.parallel import batch as TB

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_port_mesh_worker as W  # noqa: E402
from test_batch import _sequence  # noqa: E402

KW = dict(k=10, n_outer=6, pad_multiple=128)
DOFS = {"gaussian": math.inf, "t5": 5.0}
# tag -> (dof, run_odometry_batched keywords) of each JAX run.
RUNS = {
    **{f"brute_{dof}": (dof, dict(radius=1.0, dtype="float64", search_impl="brute"))
       for dof in DOFS.values()},
    "rule": (5.0, dict(radius=0.5, dtype="float64", search_impl="grid", n_outer=12,
                       cost_drop_thresh=0.01, n_cost_drop_it=3)),
    "grid": (5.0, dict(radius=0.5, dtype="float64", search_impl="grid")),
    "pool": (5.0, dict(radius=0.5, dtype="float32", search_impl="pool")),
    "redo": (5.0, dict(radius=0.5, dtype="float32", search_impl="pool")),
    "pool_kernel": (5.0, dict(radius=0.5, dtype="float32", search_impl="pool")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch work on one CPU thread (several test processes
    share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scans(n=4):
    return _sequence(n)[0]


def _jax_run(tag):
    dof, kw = RUNS[tag]
    return JB.run_odometry_batched(
        _scans(), lm_config=JConfig(dof=dof, max_iterations=25), **{**KW, **kw})


def _jax_rest():
    """The runs after the brute-force ones, in turn; last the starved redo,
    with the JAX package's ``_batched_pools_host`` wrapped while it runs,
    and the pool with a narrow-class cutoff of 0 (every class through its
    select kernel, in interpret mode, as on a TPU): only this thread builds
    pools."""
    out = {tag: _jax_run(tag) for tag in ("rule", "grid", "pool")}
    real = JB._batched_pools_host
    JB._batched_pools_host = W.starved_pools(real)
    try:
        out["redo"] = _jax_run("redo")
    finally:
        JB._batched_pools_host = real
    cutoff = JFP._select_max_w
    JFP._select_max_w = lambda: 0
    try:
        out["pool_kernel"] = _jax_run("pool_kernel")
    finally:
        JFP._select_max_w = cutoff
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX run of the module, made once: the two brute-force runs
    (most of the module's time, XLA's CPU brute force at 4,096 x 2,048
    tiles) in threads of their own beside the rest."""
    with ThreadPoolExecutor(3) as pool:
        brute = {tag: pool.submit(_jax_run, tag) for tag in RUNS if tag.startswith("brute")}
        rest = pool.submit(_jax_rest)
        out = {tag: f.result() for tag, f in brute.items()}
        out.update(rest.result())
    return out


def _port_run(tag):
    dof, kw = RUNS[tag]
    return _port(dof, **kw)


def _port(dof=5.0, **kw):
    stats = {}
    poses, res = TB.run_odometry_batched(
        _scans(), lm_config=TConfig(dof=dof, max_iterations=25), device="cpu", stats=stats,
        **{**KW, **kw})
    return poses, res, stats


def _hold(j, t, atol, cost_rtol=None):
    (jp, jr), (tp, tr) = j, t
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b, a, atol=atol, rtol=0)
    np.testing.assert_array_equal(tr.num_correspondences.numpy(),
                                  np.asarray(jr.num_correspondences))
    np.testing.assert_array_equal(tr.num_iterations.numpy(), np.asarray(jr.num_iterations))
    if cost_rtol is not None:
        for name in ("initial_costs", "final_costs"):
            np.testing.assert_allclose(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)),
                                       rtol=cost_rtol)


@pytest.mark.parametrize("dof", list(DOFS.values()), ids=list(DOFS))
def test_brute_matches_jax(jax_runs, dof):
    poses, res, stats = _port_run(f"brute_{dof}")
    assert stats["engine"] == "brute" and res.initial_costs.shape == (3, 6)
    _hold(jax_runs[f"brute_{dof}"], (poses, res), 1e-6, cost_rtol=1e-6)


def test_stopping_rule_iterations_match_jax(jax_runs):
    poses, res, stats = _port_run("rule")
    want = jax_runs["rule"]
    np.testing.assert_array_equal(res.num_iterations.numpy(), np.asarray(want[1].num_iterations))
    assert (res.num_iterations < 12).all(), "the sequence must stop early for this to bite"
    assert stats["outer_loops"] == int(res.num_iterations.max())
    _hold(want, (poses, res), 1e-6, cost_rtol=1e-6)


def test_grid_matches_jax(jax_runs):
    poses, res, stats = _port_run("grid")
    assert stats["engine"] == "grid"
    _hold(jax_runs["grid"], (poses, res), 1e-6, cost_rtol=1e-6)
    # auto on the CPU is the grid engine (the JAX package's off a TPU).
    auto = _port(radius=0.5, dtype="float64")
    assert auto[2]["engine"] == "grid"
    for a, b in zip(auto[0], poses):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tag", ["pool", "pool_kernel"])
def test_pool_matches_jax(jax_runs, tag, monkeypatch):
    """The CPU's narrow-class cutoff (64: every class of this sequence on
    the plain select, both packages), and a cutoff of 0 (every class on a
    select kernel: the port's B4 / B1 twins against the JAX kernels in
    interpret mode)."""
    if tag == "pool_kernel":
        monkeypatch.setattr(fp, "_select_max_w", lambda device: 0)
    poses, res, stats = _port_run(tag)
    assert stats["engine"] == "pool" and stats["redone"] == []
    assert int(res.overflow.sum()) == 0
    j = jax_runs[tag]
    assert int(np.sum(np.asarray(j[1].overflow))) == 0
    _hold(j, (poses, res), 1e-5)


def test_pool_overflow_redo_matches_jax(jax_runs, monkeypatch):
    monkeypatch.setattr(TB, "_batched_pools_host", W.starved_pools(TB._batched_pools_host))
    poses, res, stats = _port_run("redo")
    jp, jr = jax_runs["redo"]
    flagged = np.asarray(jr.overflow) > 0
    assert flagged.any(), "the starved budgets must trigger the redo"
    np.testing.assert_array_equal(res.overflow.numpy() > 0, flagged)
    assert stats["redone"] == [int(i) for i in np.flatnonzero(flagged)]
    for a, b in zip(jp, poses):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(res.num_correspondences.numpy(),
                                  np.asarray(jr.num_correspondences))


def _pool_batch(n_pairs=3, radius=0.5, k=10):
    """The pooled engine's batched state for the first ``n_pairs`` pairs
    (float32, the CPU's narrow-class cutoff) and the stacked sources."""
    scans = _scans(n_pairs + 1)
    padded = [pad_cloud(np.asarray(s, np.float64), 128, pad_value=0.0) for s in scans]
    stack = np.stack([p for p, _ in padded])
    counts = np.array([n for _, n in padded])
    idx_tgt, idx_src = np.arange(n_pairs), np.arange(n_pairs) + 1
    pools = TB._batched_pools_host(stack, counts, idx_tgt, radius, k, np.float32,
                                   idx_src=idx_src, device="cpu")
    src = torch.as_tensor(stack[idx_src].astype(np.float32))
    sv = torch.arange(stack.shape[1])[None, :] < torch.as_tensor(counts[idx_src])[:, None]
    search = dict(radius=radius, class_widths=pools["class_widths"],
                  class_ends=pools["class_ends"], class_budgets=pools["class_budgets"],
                  budget_rows=pools["budget_rows"], small_unions=pools["small_unions"],
                  select_max_w=pools["select_max_w"])
    tables = (pools["select_xyz"], pools["pool_idx"], pools["class_width_luts"],
              pools["lut_d"], pools["origin_d"], pools["dims_d"])
    return src, sv, tables, search


def _pair(tables, b):
    return tuple(tuple(x[b] for x in t) if isinstance(t, tuple) else t[b] for t in tables)


def test_flattened_class_passes_equal_per_pair_passes():
    """One select per class across the batch (flattened pools, shifted
    rows) gives each pair exactly its own class pass. Every class takes
    the kernel route, as on a CUDA device (cutoff 0: B4's wrapper, whose
    CPU branch is the twin)."""
    src, sv, tables, search = _pool_batch()
    search["select_max_w"] = 0
    k, n_pairs = 10, src.shape[0]
    passes, _, _, overflow = fp.batched_class_passes(src, sv, *tables, **search)
    assert overflow.tolist() == [0] * n_pairs
    per_pair = [fp.class_passes(src[b], sv[b], *_pair(tables, b), **search)[0]
                for b in range(n_pairs)]
    routes = set()
    for c, (w_c, b_c, args) in enumerate(passes):
        n_c = tables[0][c].shape[1]
        assert args[1].shape == (n_pairs * n_c, 3, w_c) and args[0].shape[0] == n_pairs * b_c * 8
        # Every pair's groups point into its own block of the flat pool.
        rows = args[3].view(n_pairs, -1)
        for b in range(n_pairs):
            assert ((rows[b] >= b * n_c) & (rows[b] < (b + 1) * n_c)).all()
        select = fp.class_select(w_c, k, 0)
        routes.add(select.__name__)
        flat = select(*args, k=k, radius=search["radius"])
        alone = [select(*p[c][2], k=k, radius=search["radius"]) for p in per_pair]
        for got, want in zip(flat[:2] + flat[2], zip(*[a[:2] + a[2] for a in alone])):
            assert torch.equal(got, torch.cat(want)), f"class {w_c}"
    assert "select_bitonic" in routes, routes

    # The whole batched search against each pair's own fused_pool_search.
    corr, ovf, pts = fp.batched_fused_pool_search(src, sv, *tables, k=k, **search)
    for b in range(n_pairs):
        c1, o1, p1 = fp.fused_pool_search(src[b], sv[b], *_pair(tables, b), k=k, **search)
        for a, w in ((corr.indices[b], c1.indices), (corr.mask[b], c1.mask),
                     (corr.sq_dists[b], c1.sq_dists), (pts[b], p1), (ovf[b], o1)):
            assert torch.equal(a, w)


def test_batched_grid_block_equals_per_pair_search():
    """The batched grid search (one k-selection per block over the pairs'
    stacked candidate rows) gives each pair its own grid search."""
    scans = _scans(4)
    padded = [pad_cloud(np.asarray(s, np.float64), 128, pad_value=0.0) for s in scans]
    stack = np.stack([p for p, _ in padded])
    counts = np.array([n for _, n in padded])
    bp, bi, luts, origins, dims, cap = TB._batched_grids_host(stack, counts, np.arange(3), 0.5)
    tables = (torch.as_tensor(bp), torch.as_tensor(bi), torch.as_tensor(luts),
              torch.as_tensor(origins), torch.as_tensor(dims))
    src = torch.as_tensor(stack[1:])
    sv = torch.arange(stack.shape[1])[None, :] < torch.as_tensor(counts[1:])[:, None]
    corr, pts = tgrid.batched_grid_radius_search(
        src, *tables, k=10, radius=0.5, capacity=cap, source_valid=sv, source_tile=512,
        return_points=True)
    for b in range(3):
        c1, p1 = tgrid.grid_radius_search(
            src[b], tables[0][b], tables[1][b], torch.zeros(bp.shape[1], dtype=torch.int32),
            tables[3][b], tables[4][b], tables[2][b], k=10, radius=0.5, capacity=cap,
            source_valid=sv[b], source_tile=512, return_points=True)
        for a, w in ((corr.indices[b], c1.indices), (corr.mask[b], c1.mask),
                     (corr.sq_dists[b], c1.sq_dists), (pts[b], p1)):
            assert torch.equal(a, w)
    assert tgrid.pick_source_tile(512, pairs=2) == tgrid.pick_source_tile(1024)


def test_batched_lu_equals_per_matrix():
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.normal(size=(5, 7, 7)), dtype=torch.float64)
    a[2, :, 0] = 0.0  # a zero pivot column: that matrix's x is not finite
    b = torch.as_tensor(rng.normal(size=(5, 7)), dtype=torch.float64)
    x = _solve_lu(a, b)
    for i in (0, 1, 3, 4):
        assert torch.equal(x[i], _solve_lu(a[i], b[i]))
    assert not torch.isfinite(x[2]).all() and not torch.isfinite(_solve_lu(a[2], b[2])).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_step_matches_per_pair_and_ignores_the_batch(dtype):
    """The batched LM step against each pair stepped alone: the same
    integer state and counts; translation, costs and rotation at 1e-6
    (float32) / 1e-12 (float64) relative. The quaternion itself is held
    through its rotation: the cost does not depend on its scale, so the
    solve amplifies last-bit differences along q (the batched O(1) math
    sums elementwise where the single solve calls BLAS; its E-step is the
    single solve's, pair by pair). A pair's state does not depend on the
    batch it is in: bit-equal in a batch of 5 and in a batch of 3."""
    rng = np.random.default_rng(3)
    n_pairs, n, k = 5, 300, 6
    src = torch.as_tensor(rng.normal(size=(n_pairs, n, 3)), dtype=dtype)
    tgt = src[:, :, None, :] + 0.3 + torch.as_tensor(
        rng.normal(scale=0.05, size=(n_pairs, n, k, 3)), dtype=dtype)
    mask = torch.as_tensor(rng.random((n_pairs, n, k)) > 0.3)
    q0 = torch.tensor([1.0, 0, 0, 0], dtype=dtype)
    t0 = torch.zeros(3, dtype=dtype)
    cfg = TConfig(max_iterations=20, trace=True)
    frozen = torch.tensor([False, True, False, False, False])

    def run(rows):
        state, _ = lm_init(src[rows], tgt[rows], mask[rows], q0.expand(len(rows), 4),
                           t0.expand(len(rows), 3), cfg, frozen[rows])
        for _ in range(12):
            state = lm_step(state, src[rows], tgt[rows], mask[rows], cfg)
        return state

    state = run([0, 1, 2, 3, 4])
    other = run([3, 4, 0])
    for name, got in state._asdict().items():
        assert torch.equal(got[[3, 4, 0]], getattr(other, name)), name
    alone = []
    for i in range(n_pairs):
        s, _ = lm_init(src[i], tgt[i], mask[i], q0, t0, cfg, frozen[i])
        for _ in range(12):
            s = lm_step(s, src[i], tgt[i], mask[i], cfg)
        alone.append(s)
    rtol = 1e-12 if dtype == torch.float64 else 1e-6
    for name, got in state._asdict().items():
        want = torch.stack([getattr(s, name) for s in alone])
        if not got.dtype.is_floating_point:
            assert torch.equal(got, want), name
        elif name in ("t", "cost", "minimum_cost", "reference_cost", "candidate_cost"):
            torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * want.abs().max().item())
    torch.testing.assert_close(quat_to_matrix(state.q), quat_to_matrix(torch.stack(
        [s.q for s in alone])), rtol=0, atol=10 * rtol)
    assert int(state.iteration[1]) == 0 and bool(state.done.all())


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """One group of 3 gloo processes: 5 scans (4 pairs, padded to 6); the
    pooled batch also on the hot sequence, and with its budgets starved,
    so that the grid engine redoes pairs of every rank's block on every
    rank."""
    cfg = TConfig(dof=5.0, max_iterations=25)
    pool = dict(dp=3, radius=0.5, dtype="float32", search_impl="pool", lm_config=cfg)
    cases = [
        ("batch_odometry", dict(dp=3, scans=5, radius=1.0, dtype="float64",
                                search_impl="brute", lm_config=cfg, tag="brute", **KW)),
        ("batch_odometry", dict(**pool, scans=5, tag="pool", **KW)),
        ("batch_odometry", dict(**pool, scans=W.hot_sequence(), tag="hot", **KW)),
        ("batch_odometry", dict(**pool, scans=5, tag="redo", starved=True, **KW)),
    ]
    return W.run_group(3, cases, tmp_path_factory.mktemp("batch3"), timeout=300)


def _unsharded_pool(monkeypatch, scans, starved=False):
    """The sharded fixture's pooled batch on one device, no mesh."""
    if starved:
        monkeypatch.setattr(TB, "_batched_pools_host",
                            W.starved_pools(TB._batched_pools_host))
    stats = {}
    poses, res = TB.run_odometry_batched(
        scans, lm_config=TConfig(dof=5.0, max_iterations=25), search_impl="pool",
        device="cpu", radius=0.5, dtype="float32", stats=stats, **KW)
    return poses, res, stats


@pytest.mark.parametrize("impl,atol", [("brute", 1e-9), ("pool", 1e-6)])
def test_sharded_batch_matches_unsharded(sharded, impl, atol):
    scans = _sequence(5)[0]
    for a, b in zip(W.wave_sequence(5), scans):
        np.testing.assert_array_equal(a, b)
    kw = dict(radius=1.0, dtype="float64") if impl == "brute" else dict(radius=0.5,
                                                                         dtype="float32")
    poses, res = TB.run_odometry_batched(
        scans, lm_config=TConfig(dof=5.0, max_iterations=25), search_impl=impl, device="cpu",
        **kw, **KW)
    runs = [r[impl] for r in sharded]
    for r in runs:
        np.testing.assert_array_equal(r["poses"], runs[0]["poses"])
        for name, x in r["result"].items():
            np.testing.assert_array_equal(x, runs[0]["result"][name])
    assert len(runs[0]["poses"]) == 5
    assert runs[0]["result"]["q"].shape == (6, 4)
    for a, b in zip(runs[0]["poses"], poses):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)
    np.testing.assert_array_equal(runs[0]["result"]["num_correspondences"][:4],
                                  res.num_correspondences.numpy())
    assert not any(r["_jax_loaded"] for r in sharded)


@pytest.mark.parametrize("tag", ["pool", "hot"])
def test_sharded_ranks_plan_only_their_blocks_and_agree_the_geometry(sharded, monkeypatch, tag):
    """Each rank plans its block's distinct targets (the count
    ``batch_targets``: pairs 0-1, 2-3 and the two padded pairs, whose
    target is the last scan), and every rank runs the geometry of the
    whole batch's plan: on the hot sequence the first two ranks take the
    last block's wider classes. Every rank's answer is the unsharded
    one's."""
    scans = _sequence(5)[0] if tag == "pool" else W.hot_sequence()
    poses, res, stats = _unsharded_pool(monkeypatch, scans)
    if tag == "hot":
        assert stats["class_widths"][0] == 64
    idx_tgt = np.minimum(np.arange(6), 4)
    for rank, r in enumerate(sharded):
        block = idx_tgt[2 * rank:2 * rank + 2]
        assert r[tag]["counts"]["batch_targets"] == len(set(block.tolist()))
        for key in ("class_widths", "class_ends", "class_budgets", "budget_rows",
                    "pool_shapes"):
            assert r[tag]["stats"][key] == stats[key], (rank, key)
        for name, x in r[tag]["result"].items():
            np.testing.assert_array_equal(x, sharded[0][tag]["result"][name])
    assert [r[tag]["counts"]["batch_targets"] for r in sharded] == [2, 2, 1]
    for a, b in zip(sharded[0][tag]["poses"], poses):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(sharded[0][tag]["result"]["num_correspondences"][:4],
                                  res.num_correspondences.numpy())


def test_sharded_starved_redo_matches_unsharded(sharded, monkeypatch):
    """The grid engine's redo on the mesh reads pairs outside each rank's
    block; every rank redoes the same pairs and is held to the unsharded
    starved run at the pool's limit."""
    poses, res, stats = _unsharded_pool(monkeypatch, _sequence(5)[0], starved=True)
    assert stats["redone"], "the starved budgets must trigger the redo"
    runs = [r["redo"] for r in sharded]
    for r in runs:
        np.testing.assert_array_equal(r["poses"], runs[0]["poses"])
        for name, x in r["result"].items():
            np.testing.assert_array_equal(x, runs[0]["result"][name])
        assert r["stats"]["redone"] == runs[0]["stats"]["redone"]
    redone = runs[0]["stats"]["redone"]
    assert [i for i in redone if i < 4] == stats["redone"]
    assert len({i // 2 for i in redone}) > 1, "redone pairs of more than one block"
    for a, b in zip(runs[0]["poses"], poses):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(runs[0]["result"]["num_correspondences"][:4],
                                  res.num_correspondences.numpy())
    np.testing.assert_array_equal(runs[0]["result"]["overflow"][:4] > 0,
                                  res.overflow.numpy() > 0)
