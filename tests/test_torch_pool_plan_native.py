"""The pooled engine's host plan as one native pass (``native/pool_plan.cpp``)
against the numpy body of ``ops/fused_pool.py::plan_pool_host``.

Every plan is made twice: through the native pass, then with
``native.plan_pool`` patched away so that the numpy body runs; the two plan
trees must be equal bit for bit (``_eq_tree``), declines included. The
pass's box-sum dilation is held to the library's other dilation
(``native.dilate_cells``) on its own. The JAX package's plan is the
reference of ``tests/test_torch_fused_pool.py``.
"""
import threading
import time

import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu_torch import native
from probabilistic_point_clouds_registration_tpu_torch.core.types import pad_cloud
from probabilistic_point_clouds_registration_tpu_torch.io.synthetic import bunny_like, kitti_like
from probabilistic_point_clouds_registration_tpu_torch.ops import fused_pool as t_fp
from probabilistic_point_clouds_registration_tpu_torch.ops.grid import build_grid_host
from probabilistic_point_clouds_registration_tpu_torch.utils import spans
from test_torch_fused_pool import _eq_tree, _hot_pair, _segment_pair


@pytest.fixture(autouse=True)
def _built():
    assert native.available(), "g++ builds the native library here"


def _cloud(name):
    """(points, radius, max_overflow) of a named target cloud."""
    rng = np.random.default_rng(5)
    if name == "kitti":
        return kitti_like(131_072), 0.5, 4096
    if name == "segment":
        return _segment_pair()[1], 0.5, 64
    if name == "hot":
        return _hot_pair()[1], 0.5, 64
    if name == "one_cell":  # every point in one cell: one occupied cell
        return rng.uniform(0.0, 0.4, size=(1000, 3)), 0.5, 4096
    if name == "bunny":  # tests/test_torch_native.py's dilation clouds
        return bunny_like(5000, seed=0), 0.06, 0
    if name == "sheet":
        rng = np.random.default_rng(3)
        tgt = rng.uniform(0, 12, size=(2000, 3))
        tgt[:, 2] = rng.normal(scale=0.4, size=2000)
        return tgt, 0.35, 0
    if name == "corners":  # occupied cells on every face, edge and corner of the grid
        box = np.array(np.meshgrid(*[[0.0, 3.9]] * 3, indexing="ij")).reshape(3, -1).T
        return np.concatenate([box, rng.uniform(0.0, 3.9, size=(300, 3))]), 0.5, 0
    if name == "line":  # a grid one cell wide in y and z
        return np.stack([rng.uniform(0, 20, 4000), np.zeros(4000), np.zeros(4000)], 1), 0.5, 0
    raise KeyError(name)


def _grid(name):
    pts, radius, max_overflow = _cloud(name)
    tg, n = pad_cloud(np.asarray(pts, np.float64), 128, pad_value=0.0)
    grid = build_grid_host(tg, radius, num_valid=n, max_overflow=max_overflow, buckets=False)
    assert grid is not None
    return grid, tg


def _plan_counts(make):
    """(what ``make()`` returns, the ``plan_native`` counts it recorded on
    this thread)."""
    t0 = time.perf_counter_ns()
    got = make()
    me = threading.get_ident()
    counts = [r for r in spans.records()[0]
              if r.start_ns >= t0 and r.thread == me and r.name == "plan_native"]
    return got, counts


def _both(monkeypatch, make):
    """``make()`` through the native pass and through the numpy body: (native
    result, its ``plan_native`` counts, numpy result)."""
    got, counts = _plan_counts(make)
    with monkeypatch.context() as m:
        m.setattr(native, "plan_pool", lambda *a, **k: None)
        want, none = _plan_counts(make)
    assert none == []  # the numpy body counts nothing
    return got, counts, want


@pytest.mark.parametrize("smw", [0, 64])
@pytest.mark.parametrize("name", ["kitti", "segment", "hot", "one_cell"])
def test_native_plan_equals_the_numpy_body(name, smw, monkeypatch):
    grid, tg = _grid(name)
    with spans.span("pool_plan") as outer:
        got, counts, want = _both(
            monkeypatch, lambda: t_fp.plan_pool_host(grid, tg, select_max_w=smw))
    assert want is not None
    _eq_tree(got, want)
    assert [(c.count, c.parent) for c in counts] == [(1, outer.id)]
    if name == "one_cell":
        assert grid["num_cells"] == 1 and got["dil"]["n_dilated"] == 27
    if name == "kitti" and smw == 0:
        assert got["widths"] == [2048, 1024, 512, 256, 128]
        assert any(f > 1 for bands in got["bands"] for _, f, _ in bands)


def test_native_group_plans_equal_the_numpy_body(monkeypatch):
    """``plan_pool_host_group``: self-keyed plans, then the forced ladder,
    both through the one pass."""
    grids = [_grid("segment"), _grid("hot")]
    got, counts, want = _both(monkeypatch, lambda: t_fp.plan_pool_host_group(
        [g for g, _ in grids], [t for _, t in grids], select_max_w=0))
    assert want is not None and len(want) == 2
    _eq_tree(got, want)
    assert len(counts) == 4  # two self-keyed plans, two forced
    assert got[0]["widths"] == got[1]["widths"]


def _grid_n(plan):
    """The plan's real target points (the packed rows before the dead one)."""
    return int(np.flatnonzero(plan["packed"][:, 3].view(np.int32) == -1)[0])


def _force(plan):
    """The forced statics that reproduce ``plan``'s own layout."""
    return {
        "widths": tuple(plan["widths"]),
        "pad_sizes": tuple(np.diff([0] + plan["ends"]).tolist()),
        "prod_d_pad": plan["prod_d_pad"], "prod_e_pad": plan["prod_e_pad"],
        "u_pad": plan["base_e"].shape[0], "n_pad": plan["packed"].shape[0] - 1,
        "ud_b": plan["row_vals"].shape[0],
    }


@pytest.mark.parametrize("field,change", [
    ("pad_sizes", lambda v, plan: (plan["sizes_real"][0] - 1,) + v[1:]),
    ("prod_e_pad", lambda v, plan: plan["dil"]["prod_e"] - 1),
    ("prod_d_pad", lambda v, plan: plan["dil"]["prod_d"] - 1),
    ("u_pad", lambda v, plan: plan["dil"]["base_e"].shape[0] - 1),
    ("n_pad", lambda v, plan: _grid_n(plan) - 1),
    ("ud_b", lambda v, plan: plan["dil"]["n_dilated"] - 1),
    ("widths", lambda v, plan: tuple(w // 2 for w in v)),
])
def test_forced_sizes_too_small_decline_on_both_paths(field, change, monkeypatch):
    grid, tg = _grid("hot")
    plan = t_fp.plan_pool_host(grid, tg, select_max_w=64)
    force = _force(plan)
    same, counts, want = _both(
        monkeypatch, lambda: t_fp.plan_pool_host(grid, tg, force=force, select_max_w=64))
    _eq_tree(same, want)  # the layout forced to its own sizes
    assert len(counts) == 1
    force[field] = change(force[field], plan)
    got, counts, want = _both(
        monkeypatch, lambda: t_fp.plan_pool_host(grid, tg, force=force, select_max_w=64))
    assert got is None and want is None and counts == []


@pytest.mark.parametrize("limit,value", [("MAX_CLASS_LANES", 128), ("MAX_POOL_BYTES", 1 << 20)])
def test_limits_decline_on_both_paths(limit, value, monkeypatch):
    grid, tg = _grid("hot")
    assert t_fp.plan_pool_host(grid, tg, select_max_w=0) is not None
    monkeypatch.setattr(t_fp, limit, value)
    got, counts, want = _both(monkeypatch, lambda: t_fp.plan_pool_host(grid, tg, select_max_w=0))
    assert got is None and want is None and counts == []


def test_a_union_past_the_widest_class_declines_on_both_paths(monkeypatch):
    """5,000 points in a 0.3 m blob: a window wider than MAX_CLASS_LANES."""
    rng = np.random.default_rng(7)
    pts = np.concatenate([rng.uniform(0, 40, size=(40_000, 3)) * [1, 1, 0.05],
                          rng.uniform(20.0, 20.3, size=(5000, 3))])
    tg, n = pad_cloud(pts, 128, pad_value=0.0)
    grid = build_grid_host(tg, 0.5, num_valid=n, max_overflow=8192, buckets=False)
    u = grid["num_cells"]
    union = native.dilate_cells(grid["cell_ids"][:u], grid["dims"].astype(np.int64),
                                grid["cell_count"][:u])[2]
    assert int(union.max()) > t_fp.MAX_CLASS_LANES
    got, counts, want = _both(monkeypatch, lambda: t_fp.plan_pool_host(grid, tg))
    assert got is None and want is None and counts == []


def test_a_search_grid_past_two_to_the_25_cells_declines(monkeypatch):
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 3000, size=(1000, 3)) * [1, 1, 0]
    tg, n = pad_cloud(pts, 128, pad_value=0.0)
    grid = build_grid_host(tg, 0.5, num_valid=n, buckets=False)
    assert int(np.prod(grid["dims"].astype(np.int64) + 2)) > 1 << 25
    got, counts, want = _both(monkeypatch, lambda: t_fp.plan_pool_host(grid, tg))
    assert got is None and want is None and counts == []


@pytest.mark.parametrize("name", ["bunny", "sheet", "corners", "line", "one_cell"])
def test_box_sum_dilation_equals_the_native_dilation(name):
    """The pass's dilation (a separable 3x3x3 box sum over the
    double-extended grid) against ``native.dilate_cells`` (27 lookups a
    window): the same windows in the same order, rows and unions; on the
    grid's faces too, where the border ring keeps every box in bounds."""
    grid, tg = _grid(name)
    u = grid["num_cells"]
    counts = grid["cell_count"].astype(np.int64)
    dil = t_fp.plan_pool_host(grid, tg, select_max_w=64)["dil"]
    d_cells_e, nrows, union = native.dilate_cells(
        grid["cell_ids"][:u], grid["dims"].astype(np.int64), counts[:u])
    np.testing.assert_array_equal(dil["d_cells_e"], d_cells_e)
    np.testing.assert_array_equal(dil["nrows"], nrows)
    np.testing.assert_array_equal(dil["union"], union)
    assert dil["max_union"] == int(union.max())
    x = d_cells_e % dil["e_dims"][0]
    y = d_cells_e // dil["e_dims"][0] % dil["e_dims"][1]
    z = d_cells_e // (dil["e_dims"][0] * dil["e_dims"][1])
    dims = grid["dims"]
    assert x.min() == 1 and x.max() == dims[0] + 2  # windows reach the border ring
    assert y.min() == 1 and y.max() == dims[1] + 2
    assert z.min() == 1 and z.max() == dims[2] + 2


def test_load_checks_the_pass_layout_against_this_module(monkeypatch):
    """A buffer table out of step with pool_plan.cpp's is refused at load."""
    monkeypatch.setattr(native, "_PLAN_BUFFERS", native._PLAN_BUFFERS[:-1])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    with pytest.raises(RuntimeError, match="layout"):
        native.load()
