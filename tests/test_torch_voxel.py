"""The port's voxel filter against the JAX package's, and registrations
with ``source_filter_size`` / ``target_filter_size`` against the JAX
package's.

The five cases of tests/test_voxel.py, each on the native library's path
and on the numpy body (the native entry point forced to decline), held bit
for bit to the JAX package's ``voxel_downsample``. Registrations: records
and the final 4x4 at float64 tolerances (1e-9), counts equal.
"""
import json

import numpy as np
import pytest

import torch_port_fixture
from probabilistic_point_clouds_registration_tpu.core.params import (
    RegistrationParams as JParams,
)
from probabilistic_point_clouds_registration_tpu.models.registration import (
    register_pair as j_register_pair,
)
from probabilistic_point_clouds_registration_tpu.ops.voxel import (
    voxel_downsample as j_voxel_downsample,
)
from probabilistic_point_clouds_registration_tpu_torch import (
    ProbabilisticRegistration,
    RegistrationParams,
    native,
    register_pair,
)
from probabilistic_point_clouds_registration_tpu_torch.ops.voxel import voxel_downsample


def _cases():
    rng = np.random.default_rng(1)
    return {
        "centroid-per-voxel": (np.array([[0.1, 0.1, 0.1], [0.3, 0.2, 0.4], [1.5, 0.0, 0.0]]),
                               1.0),
        "nonpositive-leaf": (np.random.default_rng(0).random((10, 3)), 0.0),
        "negative-coordinates": (np.array([[-0.5, -0.5, -0.5], [-0.6, -0.4, -0.3],
                                           [0.5, 0.5, 0.5]]), 1.0),
        "dense-cloud": (rng.random((5000, 3)), 0.25),
        "empty-cloud": (np.zeros((0, 3)), 1.0),
    }


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    if request.param == "native":
        assert native.available(), "g++ builds the native library here"
    else:
        monkeypatch.setattr(native, "voxel_downsample", lambda *a, **k: None)
    return request.param


@pytest.mark.parametrize("case", list(_cases()))
def test_voxel_downsample_equals_jax(case, path):
    pts, leaf = _cases()[case]
    got = voxel_downsample(pts, leaf)
    want = j_voxel_downsample(pts, leaf)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case == "centroid-per-voxel":
        assert got.shape == (2, 3)
        np.testing.assert_allclose(got[0], pts[:2].mean(axis=0))
    if case == "nonpositive-leaf":
        np.testing.assert_array_equal(voxel_downsample(pts, -1.0), pts)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_filtered_registration_matches_jax(dtype, capsys):
    """Both filters on: the search and solve run on the filtered clouds, the
    MSE columns on the unfiltered source, as in the JAX package; the ctor
    prints the reference's filter lines; the caller's clouds are not
    mutated."""
    rng = np.random.default_rng(2)
    tgt = rng.uniform(0, 20, size=(3000, 3))
    tgt[:, 2] = rng.normal(scale=0.3, size=3000)
    src = tgt + np.array([0.1, -0.05, 0.02])
    src_copy, tgt_copy = src.copy(), tgt.copy()
    kw = dict(max_neighbours=8, radius=0.7, n_iter=3, cost_drop_thresh=-1.0, dof=5.0,
              dtype=dtype, source_filter_size=0.6, target_filter_size=0.5, summary=True,
              pad_multiple=128, verbose=True, search_impl="grid")
    want_T, want = j_register_pair(src, tgt, JParams(**kw))
    j_out = capsys.readouterr().out
    got_T, got = register_pair(src, tgt, RegistrationParams(**kw), device="cpu")
    out = capsys.readouterr().out
    for line in ("Filtering source point cloud with leaf of size 0.6\n",
                 "Filtering target point cloud with leaf of size 0.5\n"):
        assert line in out and line in j_out
    assert got.filtered_source.shape == want.filtered_source.shape
    assert got.filtered_source.shape[0] < src.shape[0]
    assert got.target_cloud.shape == want.target_cloud.shape
    np.testing.assert_array_equal(got.filtered_source, want.filtered_source)
    np.testing.assert_array_equal(got.target_cloud, want.target_cloud)
    np.testing.assert_array_equal(src, src_copy)
    np.testing.assert_array_equal(tgt, tgt_copy)
    tol = 1e-5 if dtype == "float32" else 1e-9
    assert len(got.records) == len(want.records) == 3
    for g, w in zip(got.records, want.records):
        assert g.num_correspondences == w.num_correspondences
        np.testing.assert_allclose(g.initial_cost, w.initial_cost, rtol=tol)
        np.testing.assert_allclose(g.final_cost, w.final_cost, rtol=tol)
        np.testing.assert_allclose(g.mse_prev_iter, w.mse_prev_iter, rtol=tol, atol=tol)
    np.testing.assert_allclose(got_T, np.asarray(want_T), rtol=0, atol=tol)


def test_prepare_target_filters_before_padding():
    tgt = np.random.default_rng(3).uniform(0, 5, size=(2000, 3))
    p = RegistrationParams(radius=0.5, target_filter_size=0.5, pad_multiple=256)
    prepared = ProbabilisticRegistration.prepare_target(tgt, p, device="cpu")
    np.testing.assert_array_equal(prepared["target_cloud"], j_voxel_downsample(tgt, 0.5))
    assert prepared["n_tgt"] == prepared["target_cloud"].shape[0] < 2000
    assert prepared["tg"].shape[0] % 256 == 0


def test_voxel_fixture_still_matches_jax():
    """The GPU smoke run holds its voxel-filtered bunny pair against
    tests/data/torch_port_bunny35k_voxel_ref.json; its first two iterations
    must still be what the JAX package computes."""
    fixture = json.loads(torch_port_fixture.fixture_path("bunny35k_voxel").read_text())
    spec = torch_port_fixture.PAIRS["bunny35k_voxel"]
    assert fixture["pair"] == spec["pair"]
    assert fixture["params"]["source_filter_size"] == spec["params"]["source_filter_size"] > 0
    assert fixture["params"]["target_filter_size"] == spec["params"]["target_filter_size"] > 0
    _, records = torch_port_fixture.reference_run("bunny35k_voxel", n_iter=2)
    for rec, want in zip(records, fixture["iterations"][:2]):
        assert rec.num_correspondences == want["correspondences"]
        np.testing.assert_allclose(rec.initial_cost, want["initial_cost"], rtol=1e-6)
        np.testing.assert_allclose(rec.final_cost, want["final_cost"], rtol=1e-6)
