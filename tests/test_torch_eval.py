"""The port's evaluation metrics (``utils/eval.py``) against the JAX
package's, in float64 within 1e-12, with the reference's quirks kept: the
"MSE" is a mean distance, the median is one past the textbook one (clamped
for n <= 2), and the robust metrics' DBL_MAX sentinel."""
import math

import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.utils import eval as j_ev
from probabilistic_point_clouds_registration_tpu_torch.utils import eval as t_ev

SEARCHING = [
    "average_closest_distance",
    "sum_squared_error",
    "robust_sum_squared_error",
    "robust_averaged_sum_squared_error",
    "median_closest_distance",
    "robust_median_closest_distance",
]


def _clouds(seed, n=300, m=400):
    rng = np.random.default_rng(seed)
    target = rng.random((m, 3)) * 5.0
    source = target[rng.integers(0, m, n)] + rng.normal(scale=0.05, size=(n, 3))
    return source, target


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", SEARCHING)
def test_searching_metrics_match_jax(name, seed):
    a, b = _clouds(seed)
    got = getattr(t_ev, name)(a, b, device="cpu")
    want = getattr(j_ev, name)(a, b)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-300)


def test_nn_sq_dists_match_jax():
    a, b = _clouds(2, n=1000, m=3000)
    np.testing.assert_allclose(t_ev._nn_sq_dists(a, b, device="cpu"), j_ev._nn_sq_dists(a, b),
                               rtol=1e-12, atol=0)


def test_robust_sentinel_and_band():
    a = np.random.default_rng(0).random((5, 3))
    for name in ("robust_sum_squared_error", "robust_averaged_sum_squared_error"):
        assert getattr(t_ev, name)(a, a, device="cpu") == np.finfo(np.float64).max
        assert getattr(j_ev, name)(a, a) == np.finfo(np.float64).max
    base = np.random.default_rng(1).random((50, 3))
    near = base + 0.01
    assert t_ev.robust_sum_squared_error(near, base, factor=2.0, device="cpu") == \
        pytest.approx(j_ev.robust_sum_squared_error(near, base, factor=2.0), rel=1e-12)


@pytest.mark.parametrize(
    "values",
    [[], [5.0], [1.0, 3.0], [1.0, 2.0, 3.0], [4.0, 1.0, 3.0, 2.0], [5.0, 1.0, 4.0, 2.0, 3.0],
     list(np.random.default_rng(3).random(101)), list(np.random.default_rng(4).random(100))],
    ids=["n0", "n1", "n2", "n3", "n4", "n5", "n101", "n100"],
)
def test_reference_median_quirk(values):
    got, want = t_ev._reference_median(values), j_ev._reference_median(values)
    if not values:
        assert math.isnan(got) and math.isnan(want)
        return
    assert got == want
    v = np.sort(values)
    n = len(v)
    expected = v[min((n + 1) // 2, n - 1)] if n % 2 else (v[n // 2] + v[min(n // 2 + 1, n - 1)]) / 2
    assert got == expected


def test_table_metrics_match_jax():
    rng = np.random.default_rng(5)
    sq = rng.random((40, 8))
    mask = rng.random((40, 8)) > 0.3
    assert t_ev.median_distance(sq, mask) == j_ev.median_distance(sq, mask)
    assert t_ev.median_distance(sq) == j_ev.median_distance(sq)
    a, b = rng.normal(size=(30, 3)), rng.normal(size=(30, 3))
    assert t_ev.calculate_mse(a, b) == j_ev.calculate_mse(a, b)
    ta = [np.eye(4) for _ in range(4)]
    tb = []
    for d in rng.normal(size=(4, 3)):
        m = np.eye(4)
        m[:3, 3] = d
        tb.append(m)
    assert t_ev.ate_rmse(ta, tb) == j_ev.ate_rmse(ta, tb)
    with pytest.raises(ValueError):
        t_ev.ate_rmse(ta, tb[:2])


def test_searching_metrics_refuse_a_missing_card():
    """``device`` defaults to CUDA; without a card that is an error, not a
    quiet move to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a, b = _clouds(0, n=10, m=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ev.average_closest_distance(a, b)
