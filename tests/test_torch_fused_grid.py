"""Parity of the port's fused grouped engine (ops/grid.py host build,
ops/fused_grid.py, ops/fused_pool.py pieces) with the JAX package's.

* Host tables, the prepack and the grouping are integer or copied float
  data: they must be bit-equal.
* The select kernel's plain twin is held against the JAX package's Pallas
  kernel run in interpret mode on the same windows: ids, point planes and
  slot order must be equal; distances at rtol 3e-7, because XLA may
  contract the d2 expression into FMAs (tests/test_fused_grid.py).
* ``fused_grid_search`` end to end, including the overflow flag on
  scattered sources: masks and indices equal, distances and points at
  rtol 3e-7 for the same reason.
* The CUDA kernel's one-pass walk (csrc/window_select.cuh) cannot run here;
  a numpy model of its scheme (a stale threshold, one vote per load slot,
  a 32-key staging buffer, a merge when it is full) is held bit for bit
  against the twin on the inputs ``chip_smoke.py`` holds the kernel on.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilistic_point_clouds_registration_tpu.core.types import (
    pad_cloud,
    valid_mask,
)
from probabilistic_point_clouds_registration_tpu.ops import fused_grid as j_fg
from probabilistic_point_clouds_registration_tpu.ops import grid as j_grid
from probabilistic_point_clouds_registration_tpu_torch.ops import fused_grid as t_fg
from probabilistic_point_clouds_registration_tpu_torch.ops import grid as t_grid
from test_torch_core import REPO, _script


def _smoke_script():
    """``chip_smoke.py`` as a module (its ``main`` is not run): the edge
    cases of the select kernels are made there, once, with numpy."""
    return _script(REPO / "chip_smoke.py")


def _make_pair(n_src=1500, n_tgt=2048, seed=0):
    """Clustered clouds (tests/test_fused_grid.py's pair): multi-point cells."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 1.0, size=(40, 3))
    tgt = centers[rng.integers(0, 40, n_tgt)] + rng.normal(scale=0.025, size=(n_tgt, 3))
    src = centers[rng.integers(0, 40, n_src)] + rng.normal(scale=0.025, size=(n_src, 3))
    return src.astype(np.float32), tgt.astype(np.float32)


def _lattice_pair(n=256):
    """Every point alone in its cell: the 2N group budget overflows."""
    xs = np.arange(8)
    pts = np.stack(np.meshgrid(xs, xs, np.arange(4)), -1).reshape(-1, 3)
    return pts[:n].astype(np.float32), (pts[:n] + 0.05).astype(np.float32)


def _grids(tgt, radius):
    tgt_p, n_tgt = pad_cloud(tgt, 128, pad_value=0.0)
    jh = j_grid.build_grid_host(tgt_p, radius, num_valid=n_tgt)
    th = t_grid.build_grid_host(tgt_p, radius, num_valid=n_tgt)
    jgrid = j_grid.build_grid(tgt_p, radius, num_valid=n_tgt)
    jgrid = jgrid._replace(
        bucket_pts=jnp.asarray(jgrid.bucket_pts, jnp.float32),
        origin=jnp.asarray(jgrid.origin, jnp.float32),
    )
    return jh, th, jgrid


def _prepacks(tgt, radius, k=10):
    jh, th, jgrid = _grids(tgt, radius)
    jpre = j_fg.build_prepack(jh, jgrid, k=k)
    tpre = t_fg.build_prepack(
        th,
        torch.as_tensor(th["bucket_pts"].astype(np.float32)),
        torch.as_tensor(th["bucket_idx"]),
        k=k,
    )
    return jpre, tpre


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    if want.dtype.kind == "f":
        np.testing.assert_array_equal(got.view(np.int32 if got.itemsize == 4 else np.int64),
                                      want.astype(got.dtype).view(
                                          np.int32 if got.itemsize == 4 else np.int64),
                                      err_msg=msg)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=msg)


@pytest.mark.parametrize("radius,max_overflow", [(0.12, 0), (0.05, 0), (0.12, 64)])
def test_build_grid_host_equals_jax(radius, max_overflow):
    _, tgt = _make_pair()
    tgt_p, n_tgt = pad_cloud(tgt, 128, pad_value=0.0)
    want = j_grid.build_grid_host(tgt_p, radius, num_valid=n_tgt, max_overflow=max_overflow)
    got = t_grid.build_grid_host(tgt_p, radius, num_valid=n_tgt, max_overflow=max_overflow)
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            _eq(got[key], value, key)
        else:
            assert got[key] == value, key


def test_dilate_cells_host_equals_jax():
    _, tgt = _make_pair()
    jh, th, _ = _grids(tgt, 0.12)
    want = j_fg.dilate_cells_host(jh, dense_lut=False)
    got = t_fg.dilate_cells_host(th)
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            _eq(got[key], value, key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("radius", [0.12, 0.05])
def test_build_prepack_equals_jax(radius):
    _, tgt = _make_pair()
    jpre, tpre = _prepacks(tgt, radius)
    for name in ("cand_xyz", "cand_idx", "lut_d", "width_lut", "union_lut",
                 "origin_d", "dims_d"):
        _eq(getattr(tpre, name), getattr(jpre, name), name)
    for name in ("n_lanes", "n_dilated", "cell_size", "small_unions"):
        assert getattr(tpre, name) == getattr(jpre, name), name


def test_group_by_window_equals_jax():
    src, tgt = _make_pair()
    src[:50] += 100.0  # sources far outside the grid: no window
    jpre, tpre = _prepacks(tgt, 0.12)
    src_p, n_src = pad_cloud(src, 128, pad_value=0.0)
    ud = jpre.cand_idx.shape[0] - 1
    s_pad = 2 * src_p.shape[0]
    want = j_fg._group_by_window(
        jnp.asarray(src_p), valid_mask(src_p.shape[0], n_src), jpre.lut_d,
        jpre.origin_d, jpre.dims_d, ud, 0.12, s_pad, n_lanes=jpre.n_lanes,
    )
    got = t_fg._group_by_window(
        torch.as_tensor(src_p), torch.arange(src_p.shape[0]) < n_src, tpre.lut_d,
        tpre.origin_d, tpre.dims_d, ud, 0.12, s_pad, n_lanes=tpre.n_lanes,
    )
    for name, g, w in zip(("padded", "step_rows", "order", "dst", "overflow"), got, want):
        _eq(g, w, name)


def _windows(seed, lattice, n_win=24, n_lanes=256, n_groups=32):
    """Random windows + grouped sources with segment bounds, dead groups,
    invalid rows and (on the lattice) exact distance ties."""
    rng = np.random.default_rng(seed)
    union = rng.integers(0, n_lanes + 1, n_win)
    union[-1] = 0  # the dead window
    if lattice:
        xyz = rng.integers(0, 5, size=(n_win, 3, n_lanes)).astype(np.float32)
    else:
        xyz = rng.uniform(0, 4, size=(n_win, 3, n_lanes)).astype(np.float32)
    idx = rng.integers(0, 10_000, size=(n_win, n_lanes)).astype(np.int32)
    lane = np.arange(n_lanes)[None, :]
    dead = (lane >= union[:, None]) | (rng.random((n_win, n_lanes)) < 0.1)
    idx[dead] = -1
    xyz[np.broadcast_to(dead[:, None, :], xyz.shape)] = 1e30
    width = np.where(union > 0, np.ceil(np.maximum(union, 1) / 128) * 128, 0).astype(np.int32)
    step_rows = rng.integers(0, n_win, n_groups).astype(np.int32)
    step_rows[rng.random(n_groups) < 0.15] = n_win - 1
    s = n_groups * 8
    if lattice:
        src = rng.integers(0, 5, size=(s, 3)).astype(np.float32)
        src[::3] += 0.5
    else:
        src = rng.uniform(0, 4, size=(s, 3)).astype(np.float32)
    valid = rng.random(s) > 0.1
    lo = 16 * rng.integers(0, 8, s)
    hi = lo + 16 * rng.integers(1, 12, s)
    full = rng.random(s) < 0.5
    lo[full], hi[full] = 0, n_lanes
    meta = j_fg.pack_row_meta(valid, lo, hi).astype(np.float32)
    padded = np.concatenate([src, meta[:, None]], axis=1)
    return padded, xyz, idx, width, step_rows


def _jax_select(padded, xyz, idx, width, step_rows, k, radius):
    bg = j_fg.BLOCK_GROUPS
    ng = step_rows.shape[0]
    w_blk = width[step_rows].reshape(ng // bg, bg).max(axis=1)
    union = np.where(idx >= 0, 1, 0).sum(axis=1)  # upper bound of live lanes
    u_blk = union[step_rows].reshape(ng // bg, bg).max(axis=1)
    return j_fg._run_select(
        jnp.asarray(padded), jnp.asarray(xyz[step_rows]), jnp.asarray(idx[step_rows]),
        jnp.asarray(w_blk), jnp.asarray(u_blk.astype(np.int32)), k=k,
        n_lanes=xyz.shape[2], radius=radius, interpret=True, return_points=True,
    )


@pytest.mark.parametrize(
    "lattice,k,radius",
    [(True, 20, 1.6), (True, 1, 1.6), (True, 32, 2.1), (False, 20, 0.9), (False, 8, 0.5)],
    ids=["ties-k20", "ties-k1", "ties-k32", "random-k20", "random-k8"],
)
def test_select_twin_matches_pallas_kernel(lattice, k, radius):
    padded, xyz, idx, width, step_rows = _windows(k, lattice)
    want_d, want_i, want_p = _jax_select(padded, xyz, idx, width, step_rows, k, radius)
    before = t_fg.select_windows.launches
    got_d, got_i, got_p = t_fg.select_windows(
        torch.as_tensor(padded), torch.as_tensor(xyz), torch.as_tensor(idx),
        torch.as_tensor(step_rows), torch.as_tensor(width), k=k, radius=radius,
    )
    assert t_fg.select_windows.launches == before  # CPU tensors: the twin, no launch
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    for g, w in zip(got_p, want_p):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=3e-7, atol=0)
    live = got_i.numpy() >= 0
    assert live.any() and not live.all()
    if lattice and k > 1:  # the fixture really has ties at selected slots
        d = got_d.numpy()
        assert np.any((d[:, 1:] == d[:, :-1]) & live[:, 1:])


@pytest.mark.parametrize("k", [1, 12, 20, 32, 40])
@pytest.mark.parametrize("n_lanes", [256, 384])
def test_select_twin_matches_pallas_kernel_on_walker_cases(n_lanes, k):
    """The inputs a one-pass walk could get wrong (segments off a multiple
    of 128, exactly k live lanes at a segment's end, more than 32 survivors
    in a step, runs of equal distances, an empty segment beside full ones):
    the twin against the JAX package's kernel in interpret mode. k = 40 takes
    128 output slots."""
    case = _smoke_script()._walker_cases(t_fg.pack_row_meta, n_lanes=n_lanes, seed=n_lanes,
                                         n_groups=48)
    radius = case.pop("radius")
    want_d, want_i, want_p = _jax_select(
        case["padded"], case["cand_xyz"], case["cand_idx"], case["width_lut"],
        case["step_rows"], k, radius)
    before = t_fg.select_windows.launches
    got_d, got_i, got_p = t_fg.select_windows(
        **{key: torch.as_tensor(value) for key, value in case.items()}, k=k, radius=radius)
    assert t_fg.select_windows.launches == before  # CPU tensors: the twin, no launch
    assert got_i.shape == (case["padded"].shape[0], 32 if k <= 32 else 128)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    for g, w in zip(got_p, want_p):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=3e-7, atol=0)
    found = (got_i.numpy() >= 0).sum(axis=1).reshape(-1, 8)  # per group and row turn
    window = case["step_rows"]
    assert np.all(found[window == 2][:, [0, 1, 4, 7]] == min(k, 12))  # the 12 near lanes
    assert not found[:, 2].any() and not found[:, 3].any()  # empty segment, invalid row
    assert np.all(found[window == 4][:, 0] == k) and not found[window == 5].any()
    d = got_d.numpy()[np.repeat(window == 1, 8)]
    if k > 1:  # the lattice rows' slots really hold ties
        assert np.any(d[:, 1:k] == d[:, : k - 1])


def _walk_row_model(d2, ids, lo, end, k, r2, *, step=128, stage=32):
    """numpy model of the CUDA walk for one row (csrc/window_select.cuh).
    Keys are (d2 bits, lane). A step covers ``step`` lanes; thread t holds
    lanes base + 4 t + c, c = 0..3, and the warp votes once per c on
    ``d2 <= thr and id >= 0`` with the threshold of the step's start. A
    slot's survivors are appended to the staging buffer; where they do not
    fit, the buffer is merged first and they are tested again against the
    fresh threshold. The threshold is the k-th key's d2 once k are held,
    min(r2, the largest float below 3e38) before. Returns the k best keys
    and the number of merges."""
    bits = d2.view(np.uint32)
    below_empty = np.nextafter(np.float32(3e38), np.float32(0))
    thr = below_empty if r2 >= below_empty else np.float32(r2)
    run, staged, merges = [], [], 0

    def merge():
        nonlocal run, staged, thr, merges
        run = sorted(run + staged)[:32]
        staged = []
        merges += 1
        if len(run) >= k:
            thr = np.array(run[k - 1][0], np.uint32).view(np.float32)

    for base in range(lo, end, step):
        at_start = thr
        for c in range(4):
            lanes = [j for j in range(base + c, min(end, base + step), 4)
                     if d2[j] <= at_start and ids[j] >= 0]
            if not lanes:
                continue
            if len(staged) + len(lanes) > stage:
                merge()
                lanes = [j for j in lanes if d2[j] <= thr]
            staged += [(int(bits[j]), j) for j in lanes]
            if len(staged) == stage:
                merge()
    if staged:
        merge()
    return run[:k], merges


@pytest.mark.parametrize("k", [1, 12, 20, 32])
@pytest.mark.parametrize("n_lanes,odd_widths", [(128, False), (384, False), (384, True),
                                                (202, True), (1024, False)])
def test_walk_model_equals_twin(n_lanes, odd_widths, k):
    case = _smoke_script()._walker_cases(t_fg.pack_row_meta, n_lanes=n_lanes, seed=n_lanes,
                                         odd_widths=odd_widths, n_groups=12)
    radius = case.pop("radius")
    r2 = float(np.float32(radius) ** 2)
    want_d, want_i, _ = t_fg.select_windows(
        **{key: torch.as_tensor(value) for key, value in case.items()}, k=k, radius=radius)
    want_d, want_i = want_d.numpy(), want_i.numpy()
    padded = torch.as_tensor(case["padded"])
    valid, lo, hi = (x.numpy()[:, 0] for x in t_fg._unpack_row_meta(padded[:, 3:4]))
    most_merges = 0
    for row in range(padded.shape[0]):
        win = case["step_rows"][row // 8]
        xyz = torch.as_tensor(case["cand_xyz"][win])
        dx, dy, dz = (xyz[a] - padded[row, a] for a in range(3))
        d2 = (dx * dx + dy * dy + dz * dz).numpy()  # the twin's rounding
        end = min(int(case["width_lut"][win]), int(hi[row]), n_lanes)
        keys, merges = ([], 0) if not valid[row] or lo[row] >= end else _walk_row_model(
            d2, case["cand_idx"][win], int(lo[row]), end, k, r2)
        most_merges = max(most_merges, merges)
        got_bits = np.array([b for b, _ in keys], np.uint32)
        got_ids = np.array([case["cand_idx"][win][j] for _, j in keys], np.int32)
        np.testing.assert_array_equal(got_bits, want_d[row, : len(keys)].view(np.uint32))
        np.testing.assert_array_equal(got_ids, want_i[row, : len(keys)])
        assert np.all(want_i[row, len(keys):] == -1)
    assert most_merges > 1  # some row filled its staging buffer


def test_select_windows_rejects_k_below_one():
    padded, xyz, idx, width, step_rows = _windows(0, False)
    before = t_fg.select_windows.launches
    with pytest.raises(ValueError, match="k >= 1"):
        t_fg.select_windows(
            torch.as_tensor(padded), torch.as_tensor(xyz), torch.as_tensor(idx),
            torch.as_tensor(step_rows), torch.as_tensor(width), k=0, radius=0.9,
        )
    assert t_fg.select_windows.launches == before


def test_select_twin_on_cpu_counts_no_launch():
    padded, xyz, idx, width, step_rows = _windows(0, False)
    before = t_fg.select_windows.launches
    outd, outi, planes = t_fg.select_windows(
        torch.as_tensor(padded), torch.as_tensor(xyz), torch.as_tensor(idx),
        torch.as_tensor(step_rows), torch.as_tensor(width), k=20, radius=0.9,
    )
    assert t_fg.select_windows.launches == before
    assert outd.shape == outi.shape == (padded.shape[0], 32)
    assert all(p.shape == outd.shape for p in planes)
    empty = outi.numpy() < 0
    assert np.all(outd.numpy()[empty] == np.float32(3e38))
    assert np.all(np.stack([p.numpy() for p in planes])[:, empty] == 0.0)


def _search_both(src, tgt, radius, k):
    jpre, tpre = _prepacks(tgt, radius, k)
    src_p, n_src = pad_cloud(src, 128, pad_value=0.0)
    want, want_ovf, want_pts = j_fg.fused_grid_search(
        jnp.asarray(src_p, jnp.float32), valid_mask(src_p.shape[0], n_src),
        jpre.cand_xyz, jpre.cand_idx, jpre.width_lut, jpre.union_lut, jpre.lut_d,
        jpre.origin_d, jpre.dims_d, k=k, radius=radius, n_lanes=jpre.n_lanes,
        interpret=True, return_points=True,
    )
    got, got_ovf, got_pts = t_fg.fused_grid_search(
        torch.as_tensor(src_p), torch.arange(src_p.shape[0]) < n_src,
        tpre.cand_xyz, tpre.cand_idx, tpre.width_lut, tpre.lut_d,
        tpre.origin_d, tpre.dims_d, k=k, radius=radius, n_lanes=tpre.n_lanes,
    )
    assert int(got_ovf) == int(want_ovf)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.sq_dists.numpy(), np.asarray(want.sq_dists), rtol=3e-7)
    np.testing.assert_allclose(got_pts.numpy(), np.asarray(want_pts), rtol=3e-7)
    return got, int(got_ovf), n_src


def test_fused_grid_search_matches_jax():
    src, tgt = _make_pair()
    src[:50] += 100.0
    got, overflow, n = _search_both(src, tgt, 0.12, 10)
    assert overflow == 0
    assert not got.mask.numpy()[:50].any()
    assert got.mask.numpy()[50:n].any()


def test_fused_grid_search_overflow_flag_matches_jax():
    src, tgt = _lattice_pair()
    got, overflow, _ = _search_both(src, tgt, 0.4, 4)
    assert overflow > 0
