"""Parity of the port's brute-force search (ops/neighbors.py) with the JAX
package's, slot for slot.

Both run in float64 from the same numpy clouds. Indices, masks and slot
order must be equal; the exactly recomputed distances are compared at
1e-12 (the same differences summed in the same order). ``exact=True`` (the
direct-difference selection of the overflow merge) also runs in float32,
the dtype that merge sees: indices and masks equal, distances within 2 ulp
(XLA's CPU backend contracts the sum of squares into FMAs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilistic_point_clouds_registration_tpu.ops import neighbors as j_nb
from probabilistic_point_clouds_registration_tpu_torch.ops import neighbors as t_nb


def _clouds(seed, n=300, m=700, offset=0.0):
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, 2, size=(m, 3)) + offset
    src = tgt[rng.integers(0, m, n)] + rng.normal(scale=0.05, size=(n, 3))
    src_valid = rng.random(n) > 0.1
    tgt_valid = rng.random(m) > 0.1
    return src, tgt, src_valid, tgt_valid


@pytest.mark.parametrize(
    "seed,k,radius,offset",
    [(0, 8, 0.2, 0.0), (1, 20, 0.35, 0.0), (2, 5, 0.15, 1000.0)],
    ids=["k8", "k20", "far-from-origin"],
)
def test_radius_search_matches_jax_slot_for_slot(seed, k, radius, offset):
    src, tgt, sv, tv = _clouds(seed, offset=offset)
    # Small tiles so the streaming merge runs over several tiles each way.
    kw = dict(k=k, radius=radius, source_tile=128, target_tile=256)
    want = j_nb.radius_search(
        jnp.asarray(src), jnp.asarray(tgt), source_valid=jnp.asarray(sv),
        target_valid=jnp.asarray(tv), **kw,
    )
    got = t_nb.radius_search(
        torch.as_tensor(src), torch.as_tensor(tgt), source_valid=torch.as_tensor(sv),
        target_valid=torch.as_tensor(tv), **kw,
    )
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(
        got.sq_dists.numpy(), np.asarray(want.sq_dists), rtol=1e-12, atol=0
    )
    assert got.mask.any() and not got.mask.all()


@pytest.mark.parametrize(
    "seed,k,offset,dtype",
    [(4, 8, 0.0, "float64"), (5, 20, 75.0, "float64"), (6, 20, 75.0, "float32"),
     (7, 1, 0.0, "float32")],
    ids=["k8-f64", "lidar-scale-f64", "lidar-scale-f32", "k1-f32"],
)
def test_topk_neighbors_exact_matches_jax_slot_for_slot(seed, k, offset, dtype):
    src, tgt, sv, tv = (a.astype(dtype) if a.dtype.kind == "f" else a
                        for a in _clouds(seed, offset=offset))
    kw = dict(k=k, source_tile=128, target_tile=256, exact=True)
    wi, wd, wf = j_nb.topk_neighbors(
        jnp.asarray(src), jnp.asarray(tgt), source_valid=jnp.asarray(sv),
        target_valid=jnp.asarray(tv), **kw,
    )
    gi, gd, gf = t_nb.topk_neighbors(
        torch.as_tensor(src), torch.as_tensor(tgt), source_valid=torch.as_tensor(sv),
        target_valid=torch.as_tensor(tv), **kw,
    )
    assert str(gd.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    found = gf.numpy()
    if dtype == "float64":
        np.testing.assert_allclose(gd.numpy()[found], np.asarray(wd)[found], rtol=1e-12)
    else:
        ulps = np.abs(gd.numpy().view(np.int32).astype(np.int64)
                      - np.asarray(wd).view(np.int32))
        assert ulps[found].max() <= 2
    # No re-sort: the selection order is already ascending.
    assert np.all(np.diff(gd.numpy()[found.all(1)], axis=1) >= 0)


def test_nearest_neighbor_matches_jax():
    src, tgt, _, _ = _clouds(3)
    gi, gd, gf = t_nb.nearest_neighbor(torch.as_tensor(src), torch.as_tensor(tgt))
    wi, wd, wf = j_nb.nearest_neighbor(jnp.asarray(src), jnp.asarray(tgt))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-12)
