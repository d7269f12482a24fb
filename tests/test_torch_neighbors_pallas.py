"""Parity of the port's KNN-kernel brute search (ops/neighbors_pallas.py)
with the JAX package's Pallas kernel B3, run in interpret mode on the CPU.

The same numpy clouds go through both. On the CPU the port's wrapper takes
the CUDA kernel's plain twin, which the GPU smoke run holds against the
kernel. The JAX kernel leaves each row's k in slot-arrival order and both
wrappers then sort by exact distance, so rows are compared after ordering
both sides by (exact distance, index).

Tolerance: masks equal; per row the same index set, and the float32 exact
distances within 2 ulp (XLA's CPU backend contracts the sum of squares into
FMAs, the port rounds each operation). The selecting distance is the
matmul expansion, which ``jnp.dot`` may round differently from the port's
fixed elementwise order: a row whose sets differ is allowed only if the two
candidates that swapped differ by <= 4 ulp in the port's expansion distance.
On these fixtures no row differs (asserted), so that allowance is unused.

The CUDA kernel's selection scheme (filter by the distance before the clamp
against a stale threshold, stage up to 32 survivors per row, merge when the
buffer fills) is modelled in numpy below and held equal to the twin in every
slot, and the plain version of the kernel's target packing is held against
the distances the twin computes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilistic_point_clouds_registration_tpu.io.synthetic import bunny_like, wave_grid
from probabilistic_point_clouds_registration_tpu.ops.neighbors_pallas import (
    pallas_radius_search as j_search,
)
from probabilistic_point_clouds_registration_tpu_torch.core.types import pad_cloud
from probabilistic_point_clouds_registration_tpu_torch.ops import neighbors as t_nb
from probabilistic_point_clouds_registration_tpu_torch.ops import neighbors_pallas as t_np


def _ordered(idx, d2, mask):
    """Rows ordered by (exact distance, index); masked slots last."""
    key_d = np.where(mask, d2, np.inf)
    key_i = np.where(mask, idx, np.iinfo(np.int32).max)
    order = np.lexsort((key_i, key_d), axis=1)
    return (np.take_along_axis(idx, order, 1), np.take_along_axis(d2, order, 1),
            np.take_along_axis(mask, order, 1))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


def _run_both(src, tgt, sv, tv, *, k, radius):
    want = j_search(
        jnp.asarray(src, jnp.float32), jnp.asarray(tgt, jnp.float32), k=k,
        radius=radius, source_valid=jnp.asarray(sv), target_valid=jnp.asarray(tv),
        source_tile=256, target_tile=256, interpret=True,
    )
    got = t_np.pallas_radius_search(
        torch.as_tensor(src), torch.as_tensor(tgt), k=k, radius=radius,
        source_valid=torch.as_tensor(sv), target_valid=torch.as_tensor(tv),
        target_tile=256,
    )
    return got, want


def _assert_parity(src, tgt, sv, tv, *, k, radius):
    got, want = _run_both(src, tgt, sv, tv, k=k, radius=radius)
    g_mask, w_mask = got.mask.numpy(), np.asarray(want.mask)
    np.testing.assert_array_equal(g_mask.sum(1), w_mask.sum(1))
    # Both wrappers put found slots first, nearest first.
    np.testing.assert_array_equal(g_mask, w_mask)
    nearest_first = np.where(g_mask, got.sq_dists.numpy(), np.inf)
    np.testing.assert_array_equal(nearest_first, np.sort(nearest_first, axis=1))
    gi, gd, gm = _ordered(got.indices.numpy(), got.sq_dists.numpy(), g_mask)
    wi, wd, wm = _ordered(np.asarray(want.indices), np.asarray(want.sq_dists), w_mask)
    differing = np.flatnonzero(np.any((gi != wi) & gm, axis=1))
    center = t_nb.bbox_center(torch.as_tensor(tgt), torch.as_tensor(tv))
    for row in differing:  # a near-tie swap at the k-th boundary, or a fault
        only_g = sorted(set(gi[row][gm[row]]) - set(wi[row][wm[row]]))
        only_w = sorted(set(wi[row][wm[row]]) - set(gi[row][gm[row]]))
        assert len(only_g) == len(only_w) == 1, (row, only_g, only_w)
        d = t_np._expansion_d2(
            torch.as_tensor(src[row:row + 1]) - center,
            torch.as_tensor(tgt[[only_g[0], only_w[0]]]) - center,
        ).numpy()
        assert _ulps(d[0, :1], d[0, 1:])[0] <= 4, (row, d)
    assert differing.size == 0  # what was found on these fixtures
    same = gm & (gi == wi)
    assert _ulps(gd, wd)[same].max(initial=0) <= 2
    assert np.all(got.sq_dists.numpy()[~g_mask] == 0.0)
    assert got.indices.dtype == torch.int32 and got.sq_dists.dtype == torch.float32
    return got


def _padded(src, tgt, multiple=64):
    src_p, n_src = pad_cloud(src.astype(np.float32), multiple, pad_value=0.0)
    tgt_p, n_tgt = pad_cloud(tgt.astype(np.float32), multiple, pad_value=0.0)
    return (src_p, tgt_p, np.arange(src_p.shape[0]) < n_src,
            np.arange(tgt_p.shape[0]) < n_tgt)


def test_matches_jax_kernel_wave():
    """tests/test_pallas.py's wave pair."""
    src = wave_grid()
    tgt = src + np.random.default_rng(0).normal(scale=0.05, size=src.shape)
    got = _assert_parity(*_padded(src, tgt), k=8, radius=0.7)
    assert got.mask.any()


def test_matches_jax_kernel_bunny():
    """tests/test_pallas.py's bunny pair."""
    got = _assert_parity(*_padded(bunny_like(1500, seed=3), bunny_like(2000)),
                         k=10, radius=0.15)
    assert got.mask.any() and not got.mask.all()


def test_matches_jax_kernel_no_neighbors():
    """tests/test_pallas.py's disjoint pair."""
    rng = np.random.default_rng(1)
    src = rng.random((200, 3))
    tgt = rng.random((300, 3)) + 50.0
    got = _assert_parity(*_padded(src, tgt), k=5, radius=0.5)
    assert not got.mask.any()


@pytest.mark.parametrize("k", [1, 20, 40], ids=["k1", "k20", "k40"])
def test_matches_jax_kernel_far_from_origin_with_invalid_rows(k):
    """Targets 200 m from the origin (the centring matters), a tenth of the
    source rows and of the targets invalid, scattered."""
    rng = np.random.default_rng(7)
    tgt = rng.uniform(0, 2, size=(700, 3)) + 200.0
    src = tgt[rng.integers(0, 700, 320)] + rng.normal(scale=0.05, size=(320, 3))
    src_p, tgt_p, sv, tv = _padded(src, tgt)
    sv &= rng.random(src_p.shape[0]) > 0.1
    tv &= rng.random(tgt_p.shape[0]) > 0.1  # the padding rows at 0 stay invalid
    got = _assert_parity(src_p, tgt_p, sv, tv, k=k, radius=0.4)
    assert not got.mask[~sv].any()
    assert tv[got.indices.numpy()[got.mask.numpy()]].all()


def test_fewer_than_k_valid_targets_and_none():
    rng = np.random.default_rng(3)
    src = rng.random((64, 3)).astype(np.float32)
    tgt = rng.random((128, 3)).astype(np.float32)
    sv = np.ones(64, bool)
    tv = np.zeros(128, bool)
    tv[[5, 17, 90]] = True
    got = _assert_parity(src, tgt, sv, tv, k=8, radius=5.0)
    assert (got.mask.sum(1) == 3).all()
    # A target of all padding: the centre falls back to 0, nothing is found.
    got = _assert_parity(src, tgt, sv, np.zeros(128, bool), k=8, radius=5.0)
    assert not got.mask.any()


def test_twin_orders_ties_by_lowest_index():
    """Lattice ties: the twin's rows are in (expansion distance, index)
    order and the selected set keeps the lowest indices of a tie class."""
    pts = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3)
    src = torch.as_tensor(pts[:8].astype(np.float32))
    tgt = torch.as_tensor(np.concatenate([pts, pts]).astype(np.float32))  # every point twice
    idx, d2 = t_np.brute_knn(src, tgt, torch.ones(128, dtype=torch.bool), k=5,
                             target_tile=32)
    full = t_np._expansion_d2(src, tgt)
    order = np.lexsort((np.broadcast_to(np.arange(128), (8, 128)), full.numpy()), axis=1)
    np.testing.assert_array_equal(idx.numpy(), order[:, :5])
    np.testing.assert_array_equal(d2.numpy(), np.take_along_axis(full.numpy(), order[:, :5], 1))
    assert (idx[:, 0] < 64).all() and (idx[:, 1] == idx[:, 0] + 64).all()


def test_brute_knn_checks_its_inputs():
    src = torch.zeros((4, 3))
    tgt = torch.zeros((8, 3))
    tv = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="k >= 1"):
        t_np.brute_knn(src, tgt, tv, k=0)
    with pytest.raises(ValueError, match="float32"):
        t_np.brute_knn(src.double(), tgt, tv, k=1)
    with pytest.raises(ValueError, match="shape"):
        t_np.brute_knn(src, tgt, tv[:4], k=1)
    before = t_np.brute_knn.launches
    t_np.brute_knn(src, tgt, tv, k=2)
    assert t_np.brute_knn.launches == before  # the CPU twin launches nothing


def _raw_expansion(src, tgt):
    """The expansion distance before the clamp, in the twin's order."""
    sx, sy, sz = (src[:, c:c + 1] for c in range(3))
    tx, ty, tz = (tgt[None, :, c] for c in range(3))
    cross = sx * tx + sy * ty + sz * tz
    return (sx * sx + sy * sy + sz * sz) + (tx * tx + ty * ty + tz * tz) - 2.0 * cross


def _staged_knn(raw_row, valid, k, *, stage=32):
    """numpy model of the CUDA kernel's scheme for one source row. Targets
    arrive in groups of 32 in ascending index. A target survives when its
    distance before the clamp is below the threshold, the clamped distance
    of the k-th key at the last merge (stale, so only looser; +inf at the
    start; an invalid target's +inf never survives). Survivors are staged as
    keys (bits of the clamped distance, index); the buffer of ``stage`` keys
    is merged into the running top 32 when a group does not fit (the group
    is then tested again against the fresh threshold) and when it is full."""
    m = raw_row.size
    raw = np.where(valid, raw_row, np.float32(np.inf))
    run, staged, thr = [], [], np.float32(np.inf)

    def merge():
        nonlocal run, staged, thr
        run = sorted(run + staged)[:32]
        staged = []
        thr = (np.array([run[k - 1][0]], np.uint32).view(np.float32)[0]
               if len(run) >= k else np.float32(np.inf))

    for c0 in range(0, m, 32):
        group = range(c0, min(m, c0 + 32))
        live = [j for j in group if raw[j] < thr]
        if len(staged) + len(live) > stage:
            merge()
            live = [j for j in group if raw[j] < thr]
        staged += [(int(np.maximum(raw[j], np.float32(0)).view(np.uint32)), j) for j in live]
        if len(staged) == stage:
            merge()
    merge()
    picked = run[:k] + [(0x7F800000, m)] * (k - len(run[:k]))
    return (np.array([j for _, j in picked], np.int32),
            np.array([b for b, _ in picked], np.uint32).view(np.float32))


def _knn_case(case):
    rng = np.random.default_rng(17)
    if case == "random":
        tgt = rng.uniform(-1, 1, size=(300, 3))
        src = tgt[rng.integers(0, 300, 12)] + rng.normal(scale=0.05, size=(12, 3))
        valid = rng.random(300) > 0.1
    elif case == "lattice":  # exact ties: every lattice point twice
        pts = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"), -1).reshape(-1, 3)
        tgt = np.concatenate([pts, pts]) - 2.0
        src = pts[::11] - 2.0
        valid = np.ones(len(tgt), bool)
    elif case == "few_valid":
        tgt = rng.uniform(-1, 1, size=(200, 3))
        src = rng.uniform(-1, 1, size=(8, 3))
        valid = np.zeros(200, bool)
        valid[[3, 64, 65, 199]] = True
    else:  # no valid target: every distance is +inf
        tgt = rng.uniform(-1, 1, size=(70, 3))
        src = rng.uniform(-1, 1, size=(5, 3))
        valid = np.zeros(70, bool)
    return src.astype(np.float32), tgt.astype(np.float32), valid


@pytest.mark.parametrize("k", [1, 20, 32])
@pytest.mark.parametrize("case", ["random", "lattice", "few_valid", "all_inf"])
def test_staged_selection_model_equals_twin(case, k):
    src, tgt, valid = _knn_case(case)
    want_i, want_d = t_np._brute_knn_plain(
        torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(valid), k=k,
        target_tile=64)
    raw = _raw_expansion(torch.as_tensor(src), torch.as_tensor(tgt)).numpy()
    for r in range(src.shape[0]):
        got_i, got_d = _staged_knn(raw[r], valid, k)
        np.testing.assert_array_equal(got_i, want_i[r].numpy())
        np.testing.assert_array_equal(got_d.view(np.uint32), want_d[r].numpy().view(np.uint32))


@pytest.mark.parametrize("m", [17, 512, 1300])
def test_target_packing_matches_the_twins_distances(m):
    """(x, y, z, t2 | +inf), padded to whole tiles: the expansion distance
    built from a packed row is bit for bit the twin's, masked targets and
    the padding come out +inf."""
    rng = np.random.default_rng(m)
    tgt = torch.as_tensor(rng.uniform(-3, 3, size=(m, 3)).astype(np.float32))
    src = torch.as_tensor(rng.uniform(-3, 3, size=(9, 3)).astype(np.float32))
    valid = torch.as_tensor(rng.random(m) > 0.2)
    packed = t_np._pack_targets_plain(tgt, valid)
    assert packed.dtype == torch.float32 and packed.shape[1] == 4
    assert packed.shape[0] % t_np.PACK_TILE == 0
    assert 0 <= packed.shape[0] - m < t_np.PACK_TILE
    empty = torch.tensor([0.0, 0.0, 0.0, np.inf])
    assert (packed[m:] == empty).all() and (packed[:m][~valid] == empty).all()
    np.testing.assert_array_equal(packed[:m, :3][valid].numpy(), tgt[valid].numpy())
    sx, sy, sz = (src[:, c:c + 1] for c in range(3))
    px, py, pz, t2 = (packed[None, :, c] for c in range(4))
    from_packed = torch.clamp_min(
        (sx * sx + sy * sy + sz * sz) + t2 - 2.0 * (sx * px + sy * py + sz * pz), 0.0)
    want = torch.where(valid[None, :], t_np._expansion_d2(src, tgt), np.inf)
    np.testing.assert_array_equal(from_packed[:, :m].numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))
    assert torch.isinf(from_packed[:, m:]).all()


def test_brute_knn_rejects_what_the_kernel_does_not_take():
    """Neither the CPU nor a CUDA device: no twin, no kernel, no fallback;
    and every operand must lie where ``src`` lies."""
    src = torch.zeros((4, 3), device="meta")
    tgt = torch.zeros((8, 3), device="meta")
    tv = torch.ones(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_np.brute_knn(src, tgt, tv, k=2)
    with pytest.raises(ValueError, match="is on"):
        t_np.brute_knn(torch.zeros((4, 3)), tgt, tv, k=2)
    with pytest.raises(ValueError, match="bool"):
        t_np.brute_knn(torch.zeros((4, 3)), torch.zeros((8, 3)),
                       torch.ones(8, dtype=torch.uint8), k=2)
