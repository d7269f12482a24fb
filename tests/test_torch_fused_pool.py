"""Parity of the port's pooled engine (ops/fused_pool.py) with the JAX
package's.

The same numpy clouds go to both packages; the JAX side is given float32
explicitly (the test session enables x64).

* The host plan, the demand replay and the budgets are numpy copied from
  the JAX package: equal field by field.
* The device pool build and the grouping move integer or copied float data
  only: bit-equal, including the target index that travels as float bits
  (index 0, small ids and the -1 of the dead row are denormal or NaN
  patterns as floats).
* ``fused_pool_search`` against the JAX package's, whose Pallas select runs
  in interpret mode: masks, ids and points equal; distances at rtol 3e-7,
  because XLA may contract the d2 expression into FMAs
  (tests/test_fused_grid.py). The overflow count is equal. On the CPU
  every select route (B4, B1, the plain narrow-class path) runs the plain
  twin; which route a class takes is checked on its own.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilistic_point_clouds_registration_tpu.core.types import pad_cloud, valid_mask
from probabilistic_point_clouds_registration_tpu.io.synthetic import kitti_like
from probabilistic_point_clouds_registration_tpu.ops import fused_pool as j_fp
from probabilistic_point_clouds_registration_tpu.ops import grid as j_grid
from probabilistic_point_clouds_registration_tpu_torch.core.types import round_up
from probabilistic_point_clouds_registration_tpu_torch.ops import fused_pool as t_fp
from probabilistic_point_clouds_registration_tpu_torch.ops import grid as t_grid
from probabilistic_point_clouds_registration_tpu_torch.ops.fused_grid import (
    BLOCK_GROUPS,
    GROUP,
    select_windows,
)
from probabilistic_point_clouds_registration_tpu_torch.ops.select_bitonic import (
    select_bitonic,
)


def _segment_pair(n=2500, seed=2):
    """tests/test_segment_pack.py's pair: a sparse sheet whose plan packs
    narrow windows F > 1 to a pool row."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, 25, size=(n, 3))
    tgt[:, 2] = rng.normal(scale=0.3, size=n)
    src = tgt + np.array([0.2, 0.05, 0.01])
    return src.astype(np.float32), tgt.astype(np.float32)


def _hot_pair(n=2500, seed=11, hot=200):
    """tests/test_fused_pool.py's pair: a scattered sheet plus one hot blob
    (wide classes, long same-window runs beside runs of one source)."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, 30, size=(n, 3))
    tgt[:, 2] = rng.normal(scale=0.4, size=n)
    tgt[:hot] = rng.normal(scale=0.15, size=(hot, 3)) + np.array([15.0, 15.0, 0.0])
    c, s = np.cos(0.02), np.sin(0.02)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    src = tgt @ rot.T + np.array([0.3, 0.05, 0.01])
    return src.astype(np.float32), tgt.astype(np.float32)


_PAIRS = {"segment": (_segment_pair, 0.5), "hot": (_hot_pair, 0.5)}


@functools.lru_cache(maxsize=None)
def _grids(name):
    """(target padded, JAX host grid, port host grid) of a pair."""
    if name == "kitti":
        tgt = kitti_like(131_072)
        tg, n_tgt = pad_cloud(tgt, 4096, pad_value=0.0)
        radius, max_overflow = 0.5, 4096
    else:
        make, radius = _PAIRS[name]
        tg, n_tgt = pad_cloud(make()[1], 128, pad_value=0.0)
        max_overflow = 64
    jh = j_grid.build_grid_host(tg, radius, num_valid=n_tgt, max_overflow=max_overflow)
    th = t_grid.build_grid_host(tg, radius, num_valid=n_tgt, max_overflow=max_overflow,
                                buckets=False)
    return tg, jh, th


@functools.lru_cache(maxsize=None)
def _prepacks(name, smw, k=8, dtype=np.float32):
    tg, jh, th = _grids(name)
    jpre = j_fp.build_pool_prepack(jh, tg, dtype=dtype, k=k, select_max_w=smw)
    tpre = t_fp.build_pool_prepack(th, tg, dtype=dtype, k=k, select_max_w=smw,
                                   device="cpu")
    assert jpre is not None and tpre is not None
    return jpre, tpre


def _eq(got, want, msg=""):
    """Bit-equality of a tensor / array against the JAX value."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{msg}: {got.shape} vs {want.shape}"
    if want.dtype.kind == "f":
        assert got.dtype == want.dtype, msg
        view = np.int32 if got.itemsize == 4 else np.int64
        np.testing.assert_array_equal(got.view(view), want.view(view), err_msg=msg)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64),
                                      err_msg=msg)


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


# -- host half ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["segment", "kitti"])
@pytest.mark.parametrize("smw", [0, 64])
def test_plan_pool_host_equals_jax(name, smw):
    tg, jh, th = _grids(name)
    want = j_fp.plan_pool_host(jh, tg, select_max_w=smw)
    got = t_fp.plan_pool_host(th, tg, select_max_w=smw)
    assert want is not None
    _eq_tree(got, want)
    if smw == 0:
        # Every class runs a kernel: the split stops at 128 lanes, and the
        # narrow class packs several windows to a pool row.
        assert min(got["widths"]) == 128
        assert any(f > 1 for bands in got["bands"] for _, f, _ in bands)
    if name == "kitti" and smw == 0:
        assert got["widths"] == [2048, 1024, 512, 256, 128]


def test_plan_cutoff_follows_the_device():
    _, _, th = _grids("segment")
    tg = _grids("segment")[0]
    assert t_fp._select_max_w("cuda") == 0
    assert t_fp._select_max_w(torch.device("cpu")) == t_fp.XLA_SELECT_MAX_W == 64
    on_cuda = t_fp.plan_pool_host(th, tg, device="cuda")
    _eq_tree(on_cuda, t_fp.plan_pool_host(th, tg, select_max_w=0))
    _eq_tree(t_fp.plan_pool_host(th, tg, device="cpu"),
             t_fp.plan_pool_host(th, tg, select_max_w=64))
    # An explicit cutoff overrides the device.
    _eq_tree(t_fp.plan_pool_host(th, tg, select_max_w=64, device="cuda"),
             t_fp.plan_pool_host(th, tg, select_max_w=64))


@pytest.mark.parametrize(
    "union,center,widths,ends",
    [
        (np.full(8, 12), np.full(8, 4), [128], [8]),
        (np.full(8, 12), np.ones(8, np.int64), [128], [8]),
        (np.array([120, 100]), np.array([60, 50]), [128], [2]),
        (np.array([900, 600, 400, 200, 130, 90, 40, 10, 3, 1, 1]),
         np.array([9, 8, 7, 5, 4, 3, 3, 1, 1, 0, 2]), [1024, 512, 128], [2, 5, 11]),
    ],
)
def test_plan_helpers_equal_jax(union, center, widths, ends):
    assert t_fp._plan_classes(union) == j_fp._plan_classes(union)
    assert t_fp._plan_segment_bands(union, center, widths, ends) == \
        j_fp._plan_segment_bands(union, center, widths, ends)
    for f in (1, 2, 4, 8):
        assert t_fp._rows_for(center, f) == j_fp._rows_for(center, f)


@pytest.mark.parametrize("name", ["segment", "hot"])
def test_demand_replay_and_class_budgets_equal_jax(name):
    make, _ = _PAIRS[name]
    src = make()[0]
    tg, jh, th = _grids(name)
    jplan = j_fp.plan_pool_host(jh, tg, select_max_w=0)
    tplan = t_fp.plan_pool_host(th, tg, select_max_w=0)
    assert t_fp.estimate_pool_demand_rows(tplan, src) == \
        j_fp.estimate_pool_demand_rows(jplan, src)
    ends = tuple(tplan["row_ends"])
    total, cum = t_fp.estimate_pool_demand_rows(tplan, src, class_row_ends=ends)
    assert (total, cum) == j_fp.estimate_pool_demand_rows(jplan, src, class_row_ends=ends)
    assert total > 0 and len(cum) == len(ends)
    for boost in (0, 1, 2):
        for cap in (None, 1024):
            assert t_fp.demand_class_budgets(cum, 4096, boost=boost, cap=cap) == \
                j_fp.demand_class_budgets(cum, 4096, boost=boost, cap=cap)
    _eq_tree(t_fp.pool_seed_host(tplan), j_fp.pool_seed_host(jplan, np.float32))


# -- device half --------------------------------------------------------------


@pytest.mark.parametrize(
    "name,smw,dtype",
    [("segment", 0, np.float32), ("segment", 64, np.float32), ("hot", 0, np.float32),
     ("hot", 64, np.float32), ("segment", 0, np.float64)],
)
def test_build_pool_prepack_equals_jax(name, smw, dtype):
    jpre, tpre = _prepacks(name, smw, dtype=dtype)
    assert len(tpre.pool_xyz) == len(jpre.pool_xyz) == len(tpre.class_widths)
    for c in range(len(jpre.pool_xyz)):
        _eq(tpre.pool_xyz[c], jpre.pool_xyz[c], f"pool_xyz[{c}]")
        _eq(tpre.pool_idx[c], jpre.pool_idx[c], f"pool_idx[{c}]")
    for field in ("lut_d", "width_lut", "union_lut", "origin_d", "dims_d"):
        _eq(getattr(tpre, field), getattr(jpre, field), field)
    # What the select kernels read, built once: float32 pools and the
    # class-local width tables (the class's rows of width_lut + a dead 0).
    assert tpre.width_lut.shape[0] - 1 == tpre.class_ends[-1]
    prev = 0
    for c, end in enumerate(tpre.class_ends):
        _eq(tpre.select_xyz[c], np.asarray(jpre.pool_xyz[c]).astype(np.float32),
            f"select_xyz[{c}]")
        _eq(tpre.class_width_luts[c], np.append(np.asarray(jpre.width_lut)[prev:end], 0),
            f"class_width_luts[{c}]")
        prev = end
    for field in ("class_widths", "class_ends", "class_budgets", "budget_rows",
                  "n_dilated", "cell_size", "small_unions", "select_max_w"):
        assert getattr(tpre, field) == getattr(jpre, field), field
    # The bitcast index lane: every target id, 0 and the small (denormal as
    # float bits) ones included, and the all -1 dead row.
    ids = torch.cat([p.flatten() for p in tpre.pool_idx])
    n_tgt = _grids(name)[1]["num_valid"]
    assert torch.equal(torch.unique(ids[ids >= 0]), torch.arange(n_tgt, dtype=torch.int32))
    for p in tpre.pool_idx:
        assert bool((p[-1] == -1).all())


@pytest.mark.parametrize("name", ["segment", "hot"])
@pytest.mark.parametrize("budget", ["ample", "tight"])
def test_group_by_row_equals_jax(name, budget):
    jpre, tpre = _prepacks(name, 0)
    src = _PAIRS[name][0]()[0]
    src[:40] += 500.0  # far outside the grid: no window, no row
    src_p, n_src = pad_cloud(src, 128, pad_value=0.0)
    s_pad = 8 * src_p.shape[0] if budget == "ample" else 2 * BLOCK_GROUPS * GROUP
    n_rows = tpre.width_lut.shape[0] - 1
    want = j_fp._group_by_row(
        jnp.asarray(src_p, jnp.float32), valid_mask(src_p.shape[0], n_src),
        jpre.lut_d, jpre.origin_d, jpre.dims_d, n_rows, 0.5, s_pad,
    )
    got = t_fp._group_by_row(
        torch.as_tensor(src_p), torch.arange(src_p.shape[0]) < n_src,
        tpre.lut_d, tpre.origin_d, tpre.dims_d, n_rows, 0.5, s_pad,
    )
    for field, g, w in zip(("padded", "step_rows", "order", "dst", "overflow"), got, want):
        _eq(g, w, field)
    overflow = int(got[4])
    assert (overflow == 0) if budget == "ample" else (overflow > 0)
    if budget == "ample":
        # Segment-packed rows (lo > 0) and both run lengths were exercised.
        lo = ((got[0][:, 3].to(torch.int32) >> 1) & 511) << 4
        assert bool((lo > 0).any())
        dst = got[3][got[3] < s_pad]
        per_group = torch.bincount((dst // GROUP).long())
        assert int(per_group.max()) == GROUP and int(per_group[per_group > 0].min()) == 1


def _search_both(name, smw, *, budget_rows=None, class_budgets=None, k=8):
    jpre, tpre = _prepacks(name, smw, k)
    src = _PAIRS[name][0]()[0]
    src[:40] += 500.0
    src_p, n_src = pad_cloud(src, 128, pad_value=0.0)
    if budget_rows is None:
        budget_rows = round_up(max(jpre.budget_rows, 8 * src_p.shape[0]), 512)
    budgets = class_budgets or jpre.class_budgets
    want = j_fp.fused_pool_search(
        jnp.asarray(src_p, jnp.float32), valid_mask(src_p.shape[0], n_src),
        jpre.pool_xyz, jpre.pool_idx, jpre.width_lut, jpre.union_lut, jpre.lut_d,
        jpre.origin_d, jpre.dims_d, k=k, radius=0.5,
        class_widths=jpre.class_widths, class_ends=jpre.class_ends,
        class_budgets=budgets, budget_rows=budget_rows, interpret=True,
        return_points=True, dyn_rounds=jpre.small_unions, select_max_w=smw,
    )
    got = t_fp.fused_pool_search(
        torch.as_tensor(src_p), torch.arange(src_p.shape[0]) < n_src,
        tpre.select_xyz, tpre.pool_idx, tpre.class_width_luts, tpre.lut_d,
        tpre.origin_d, tpre.dims_d, k=k, radius=0.5,
        class_widths=tpre.class_widths, class_ends=tpre.class_ends,
        class_budgets=budgets, budget_rows=budget_rows,
        small_unions=tpre.small_unions, select_max_w=smw,
    )
    return got, want, n_src


@pytest.mark.parametrize(
    "name,smw,k",
    [("segment", 0, 8), ("segment", 64, 8), ("hot", 0, 8), ("hot", 64, 8),
     ("hot", 0, 40)],
)
def test_fused_pool_search_equals_jax(name, smw, k):
    """k = 8 routes every kernel class to B4, k = 40 to B1."""
    before = (select_windows.launches, select_bitonic.launches)
    (got, got_ovf, got_pts), (want, want_ovf, want_pts), n = _search_both(name, smw, k=k)
    assert (select_windows.launches, select_bitonic.launches) == before  # CPU: twins
    assert int(got_ovf) == int(want_ovf) == 0
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got_pts.numpy(), np.asarray(want_pts))
    np.testing.assert_allclose(got.sq_dists.numpy(), np.asarray(want.sq_dists),
                               rtol=3e-7, atol=0)
    mask = got.mask.numpy()
    assert not mask[:40].any() and mask[40:n].any()


@pytest.mark.parametrize("which", ["rows", "class"])
def test_fused_pool_search_overflow_equals_jax(which):
    """A row budget (tests/test_fused_pool.py:128-145) or a class-prefix
    budget too small for the pair raises the same overflow count."""
    jpre, _ = _prepacks("hot", 64)
    assert len(jpre.class_widths) >= 3
    if which == "rows":
        kw = dict(budget_rows=256)
    else:
        kw = dict(class_budgets=(BLOCK_GROUPS,) * (len(jpre.class_widths) - 1)
                  + (jpre.class_budgets[-1],))
    (_, got_ovf, _), (_, want_ovf, _), _ = _search_both("hot", 64, **kw)
    assert int(got_ovf) == int(want_ovf) > 0


@pytest.mark.parametrize(
    "w_c,k,smw,want",
    [(128, 20, 0, select_bitonic), (2048, 32, 0, select_bitonic),
     (64, 20, 64, t_fp._xla_class_select), (128, 40, 0, select_windows),
     (384, 20, 0, select_windows)],
)
def test_class_select_takes_b4_where_it_applies(w_c, k, smw, want):
    """The plain path at or below the cutoff; B4 for pow2 widths at k <= 32
    (the JAX package's bitonic rule); B1 otherwise."""
    assert t_fp.class_select(w_c, k, smw) is want
