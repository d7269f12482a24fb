"""The port's registration loop against the JAX package's, end to end.

Both run from the same numpy clouds, with the JAX side's dtype passed
explicitly (the test session enables x64). The JAX side runs its
one-iteration host loop (``outer_chunk=1``), the loop the port runs.

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
    moves to the brute engine, says so, counts it, and ends where the brute
    engine alone ends."""
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
    assert "falling back to the brute-force engine" in capsys.readouterr().out
    brute_T, brute = register_pair(
        src, tgt, RegistrationParams(search_impl="brute", **kw), device="cpu"
    )
    np.testing.assert_array_equal(fused_T, brute_T)
    assert [r.num_correspondences for r in fused.records] == [
        r.num_correspondences for r in brute.records
    ]


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, tgt = _clustered_pair(n_src=64, n_tgt=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProbabilisticRegistration(src, tgt, RegistrationParams(radius=0.12))


@pytest.mark.parametrize(
    "override",
    [dict(search_impl="pool"), dict(search_impl="grid"), dict(search_impl="pallas"),
     dict(source_filter_size=0.1), dict(target_filter_size=0.1),
     dict(trace_inner=True)],
    ids=["pool", "grid", "pallas", "source-filter", "target-filter", "trace-inner"],
)
def test_unported_options_raise(override):
    src, tgt = _clustered_pair(n_src=64, n_tgt=128)
    with pytest.raises(NotImplementedError):
        ProbabilisticRegistration(
            src, tgt, RegistrationParams(radius=0.12, **override), device="cpu"
        )


def test_bench_fixture_still_matches_jax():
    """The GPU smoke run is held against tests/data/torch_port_bunny35k_ref.json;
    its first two iterations must still be what the JAX package computes."""
    fixture = json.loads(torch_port_fixture.FIXTURE.read_text())
    _, records = torch_port_fixture.reference_run(n_iter=2)
    for rec, want in zip(records, fixture["iterations"][:2]):
        assert rec.num_correspondences == want["correspondences"]
        np.testing.assert_allclose(rec.initial_cost, want["initial_cost"], rtol=1e-6)
        np.testing.assert_allclose(rec.final_cost, want["final_cost"], rtol=1e-6)
