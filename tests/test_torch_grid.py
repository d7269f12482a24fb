"""Parity of the port's hash-grid engine (ops/grid.py, device half) with the
JAX package's, slot for slot.

The same numpy clouds go through both; each side builds its own host grid
and uploads it in the dtype under test (passed explicitly on the JAX side:
the test session enables x64). The JAX side's Pallas selection runs in
interpret mode (``select_impl="pallas_interpret"``); the port's "pallas" takes
the CUDA kernel's plain twin on the CPU.

Tolerance: indices and mask are equal in every slot (the same candidates,
the same tie rule). The float32 squared distances are held to 2 ulp, not to
the bit: XLA's CPU backend contracts the sum of squares into FMAs
(``fma(dz, dz, fma(dy, dy, dx*dx))``, found by trying the orders), while the
port rounds each operation, as its CUDA kernels and their twins do; 2 ulp is
the largest difference that contraction makes on these inputs. Within the
port, every select mode is bit-equal to "topk". float64 distances at rtol
1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilistic_point_clouds_registration_tpu.core.types import (
    Correspondences as JCorr,
)
from probabilistic_point_clouds_registration_tpu.ops import grid as j_grid
from probabilistic_point_clouds_registration_tpu_torch.core.types import (
    Correspondences,
    pad_cloud,
)
from probabilistic_point_clouds_registration_tpu_torch.ops import grid as t_grid

RADIUS, K = 0.1, 10


def _hotspot_pair(seed=0):
    """tests/test_grid_overflow.py's pair: one ~300-point hot cell plus a
    diffuse background; a few sources are moved outside the target's bbox."""
    rng = np.random.default_rng(seed)
    hot = rng.normal(scale=0.02, size=(300, 3)) + 0.55
    bg = rng.uniform(0, 1.2, size=(3000, 3))
    tgt = np.concatenate([hot, bg]).astype(np.float32)
    src = (tgt + rng.normal(scale=0.01, size=tgt.shape)).astype(np.float32)
    src[:5] += 3.0  # outside the bbox: no neighbours
    src[5:10] -= 0.15  # some of these straddle the bbox's low faces
    return src, tgt


def _setup(dtype="float32", lut=True, seed=0):
    src, tgt = _hotspot_pair(seed)
    src_p, n_src = pad_cloud(src, 128, 0.0)
    tgt_p, n_tgt = pad_cloud(tgt, 128, 0.0)
    sv = np.arange(src_p.shape[0]) < n_src
    np_dtype = np.dtype(dtype)
    gj = j_grid.build_grid_host(tgt_p, RADIUS, num_valid=n_tgt, max_overflow=512)
    gt = t_grid.build_grid_host(tgt_p, RADIUS, num_valid=n_tgt, max_overflow=512)
    assert "overflow_pts" in gt and 0 < int((gt["overflow_idx"] >= 0).sum()) <= 512
    hg = t_grid.grid_to_device(gt, np_dtype, "cpu")
    jg = j_grid.HashGrid(
        bucket_pts=jnp.asarray(gj["bucket_pts"], np_dtype),
        bucket_idx=jnp.asarray(gj["bucket_idx"]),
        cell_ids=jnp.asarray(gj["cell_ids"]),
        capacity=gj["capacity"],
        origin=jnp.asarray(gj["origin"], np_dtype),
        dims=jnp.asarray(gj["dims"]),
        cell_size=gj["cell_size"],
        num_valid=gj["num_valid"],
        lut=jnp.asarray(gj["lut"]),
        overflow_pts=jnp.asarray(gj["overflow_pts"], np_dtype),
        overflow_idx=jnp.asarray(gj["overflow_idx"]),
    )
    if not lut:
        hg = hg._replace(lut=None)
        jg = jg._replace(lut=None)
    return src_p.astype(np_dtype), sv, hg, jg


def _assert_corr_equal(got, want, dtype="float32"):
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    if dtype == "float32":
        assert got.sq_dists.dtype == torch.float32
        ulps = np.abs(
            got.sq_dists.numpy().view(np.int32).astype(np.int64)
            - np.asarray(want.sq_dists).view(np.int32)
        )
        assert ulps.max() <= 2, f"{ulps.max()} ulp"
    else:
        np.testing.assert_allclose(
            got.sq_dists.numpy(), np.asarray(want.sq_dists), rtol=1e-12, atol=0
        )


def _search(src, sv, hg, jg, *, t_select, j_select, tile=256, return_points=False):
    got = t_grid.grid_radius_search(
        torch.as_tensor(src), hg.bucket_pts, hg.bucket_idx, hg.cell_ids, hg.origin,
        hg.dims, hg.lut, k=K, radius=RADIUS, capacity=hg.capacity,
        source_valid=torch.as_tensor(sv), source_tile=tile, select_impl=t_select,
        return_points=return_points,
    )
    want = j_grid.grid_radius_search(
        jnp.asarray(src), jg.bucket_pts, jg.bucket_idx, jg.cell_ids, jg.origin,
        jg.dims, jg.lut, k=K, radius=RADIUS, capacity=jg.capacity,
        source_valid=jnp.asarray(sv), source_tile=tile, select_impl=j_select,
        return_points=return_points,
    )
    return got, want


@pytest.mark.parametrize("lut", [True, False], ids=["lut", "searchsorted"])
@pytest.mark.parametrize(
    "t_select,j_select",
    [("topk", "topk"), ("hier", "hier"), ("pallas", "pallas_interpret"), ("auto", "auto")],
    ids=["topk", "hier", "pallas", "auto"],
)
def test_grid_radius_search_matches_jax_slot_for_slot(t_select, j_select, lut):
    src, sv, hg, jg = _setup(lut=lut)
    got, want = _search(src, sv, hg, jg, t_select=t_select, j_select=j_select)
    _assert_corr_equal(got, want)
    assert got.mask.any() and not got.mask[:5].any()  # the far sources find nothing


@pytest.mark.parametrize("select", ["topk", "hier"])
def test_grid_radius_search_matches_jax_float64(select):
    src, sv, hg, jg = _setup(dtype="float64")
    got, want = _search(src, sv, hg, jg, t_select=select, j_select=select)
    _assert_corr_equal(got, want, dtype="float64")


def test_grid_radius_search_returns_the_selected_points():
    src, sv, hg, jg = _setup()
    (got, got_pts), (want, want_pts) = _search(
        src, sv, hg, jg, t_select="pallas", j_select="pallas_interpret",
        return_points=True,
    )
    _assert_corr_equal(got, want)
    np.testing.assert_array_equal(got_pts.numpy(), np.asarray(want_pts))  # copies: exact
    assert got_pts.shape == (src.shape[0], K, 3)


@pytest.mark.parametrize("select", ["hier", "pallas", "approx", "auto", "no-such-mode"])
def test_every_select_mode_returns_topk_slots(select):
    """Every mode is exact with the same tie rule, and an unknown one
    selects as "topk" (as in the JAX package)."""
    src, sv, hg, _ = _setup(seed=3)
    args = (torch.as_tensor(src), hg.bucket_pts, hg.bucket_idx, hg.cell_ids,
            hg.origin, hg.dims, hg.lut)
    kw = dict(k=K, radius=RADIUS, capacity=hg.capacity,
              source_valid=torch.as_tensor(sv), source_tile=512)
    want = t_grid.grid_radius_search(*args, select_impl="topk", **kw)
    got = t_grid.grid_radius_search(*args, select_impl=select, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tile", [64, 1000, 4096])
def test_source_tile_changes_no_output(tile):
    src, sv, hg, _ = _setup()
    args = (torch.as_tensor(src), hg.bucket_pts, hg.bucket_idx, hg.cell_ids,
            hg.origin, hg.dims, hg.lut)
    kw = dict(k=K, radius=RADIUS, capacity=hg.capacity,
              source_valid=torch.as_tensor(sv), select_impl="pallas")
    want = t_grid.grid_radius_search(*args, source_tile=256, **kw)
    got = t_grid.grid_radius_search(*args, source_tile=tile, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_merge_overflow_matches_jax(dtype):
    src, sv, hg, jg = _setup(dtype=dtype)
    got, want = _search(src, sv, hg, jg, t_select="topk", j_select="topk")
    got_m = t_grid.merge_overflow(
        got, torch.as_tensor(src), hg.overflow_pts, hg.overflow_idx, k=K,
        radius=RADIUS, source_valid=torch.as_tensor(sv),
    )
    want_m = j_grid.merge_overflow(
        want, jnp.asarray(src), jg.overflow_pts, jg.overflow_idx, k=K,
        radius=RADIUS, source_valid=jnp.asarray(sv),
    )
    _assert_corr_equal(got_m, want_m, dtype=dtype)
    # The merge found neighbours the buckets do not hold.
    assert int(got_m.mask.sum()) > int(got.mask.sum())


def test_merge_overflow_keeps_the_grid_entry_on_a_tie():
    """Two targets at the same distance, one in the buckets and one in the
    overflow set, k = 1: the grid's entry stays (a stable merge)."""
    corr = Correspondences(
        indices=torch.tensor([[7]], dtype=torch.int32),
        sq_dists=torch.tensor([[0.25]]),
        mask=torch.tensor([[True]]),
    )
    src = torch.zeros((1, 3))
    ov_pts = torch.tensor([[0.5, 0.0, 0.0], [0.0, 0.0, 0.0]])
    ov_idx = torch.tensor([3, -1], dtype=torch.int32)
    got = t_grid.merge_overflow(corr, src, ov_pts, ov_idx, k=1, radius=1.0,
                                source_valid=torch.tensor([True]))
    want = j_grid.merge_overflow(
        JCorr(jnp.asarray([[7]], jnp.int32), jnp.asarray([[0.25]], jnp.float32),
              jnp.asarray([[True]])),
        jnp.zeros((1, 3), jnp.float32), jnp.asarray(ov_pts.numpy()),
        jnp.asarray(ov_idx.numpy()), k=1, radius=1.0, source_valid=jnp.asarray([True]),
    )
    assert got.indices.tolist() == np.asarray(want.indices).tolist() == [[7]]


def test_grid_search_with_overflow_matches_jax_and_brute_sets():
    from probabilistic_point_clouds_registration_tpu_torch.ops.neighbors import (
        radius_search,
    )

    src, sv, hg, jg = _setup()
    got = t_grid.grid_search(hg, torch.as_tensor(src), k=K, radius=RADIUS,
                             source_valid=torch.as_tensor(sv))
    want = j_grid.grid_search(jg, jnp.asarray(src), k=K, radius=RADIUS,
                              source_valid=jnp.asarray(sv))
    _assert_corr_equal(got, want)
    _, tgt = _hotspot_pair()
    tgt_p, n_tgt = pad_cloud(tgt, 128, 0.0)
    brute = radius_search(
        torch.as_tensor(src), torch.as_tensor(tgt_p), k=K, radius=RADIUS,
        source_valid=torch.as_tensor(sv),
        target_valid=torch.arange(tgt_p.shape[0]) < n_tgt,
    )
    assert torch.equal(got.mask.sum(1), brute.mask.sum(1))
    with pytest.raises(ValueError, match="cell_size"):
        t_grid.grid_search(hg, torch.as_tensor(src), k=K, radius=2 * RADIUS,
                           source_valid=torch.as_tensor(sv))


@pytest.mark.parametrize("capacity", [8, 16, 64, 128, 512])
def test_pick_source_tile_equals_jax(capacity):
    """The same function of (capacity, budget); only the default budget is
    the port's own (chosen on the card, where the JAX package's is a TPU
    figure)."""
    for budget in (1 << 24, 192 << 20, t_grid.SOURCE_TILE_BUDGET_BYTES):
        assert t_grid.pick_source_tile(capacity, budget) == j_grid.pick_source_tile(
            capacity, budget
        )
    assert t_grid.pick_source_tile(capacity) == j_grid.pick_source_tile(
        capacity, t_grid.SOURCE_TILE_BUDGET_BYTES
    )


def test_build_grid_uploads_the_host_tables():
    _, tgt = _hotspot_pair()
    tgt_p, n_tgt = pad_cloud(tgt, 128, 0.0)
    got = t_grid.build_grid(tgt_p, RADIUS, num_valid=n_tgt, max_overflow=512, device="cpu")
    want = j_grid.build_grid(tgt_p, RADIUS, num_valid=n_tgt, max_overflow=512)
    assert got.bucket_pts.dtype == torch.float32
    assert (got.capacity, got.num_valid, got.cell_size) == (
        want.capacity, want.num_valid, want.cell_size)
    for name in ("bucket_pts", "bucket_idx", "cell_ids", "origin", "dims", "lut",
                 "overflow_pts", "overflow_idx"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)).astype(
                getattr(got, name).numpy().dtype), err_msg=name)
    assert t_grid.build_grid(tgt_p, 0.0, num_valid=n_tgt, device="cpu") is None
