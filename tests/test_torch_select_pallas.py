"""Parity of the port's row top-k (ops/select_pallas.py) with the JAX
package's Pallas kernel B2, run in interpret mode on the CPU.

Inputs come from numpy seeds and go through both. On the CPU the port's
wrapper takes the kernel's plain twin (a stable sort), which the GPU smoke
run holds bit for bit against the CUDA kernel. Tolerance: values and indices
equal (atol 0) wherever the value is finite; the JAX kernel leaves the index
of a +inf slot unspecified, the port returns the row's lowest masked
columns there (checked against numpy's stable argsort).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilistic_point_clouds_registration_tpu.ops.select_pallas import (
    pallas_row_topk as j_row_topk,
)
from probabilistic_point_clouds_registration_tpu_torch.ops import select_pallas as t_sp


def _matrix(case, seed):
    rng = np.random.default_rng(seed)
    if case == "random":
        x = rng.random((37, 300)).astype(np.float32)
    elif case == "masked":  # the grid search's shape: most entries +inf
        x = rng.random((64, 216)).astype(np.float32)
        x[rng.random(x.shape) < 0.9] = np.inf
        x[3] = np.inf  # an empty row
    elif case == "lattice":  # exact ties
        x = rng.integers(0, 4, size=(40, 130)).astype(np.float32)
        x[rng.random(x.shape) < 0.3] = np.inf
    else:  # wide
        x = rng.random((9, 1728)).astype(np.float32)
        x[rng.random(x.shape) < 0.97] = np.inf
    return x


@pytest.mark.parametrize("k", [1, 20, 32, 50])
@pytest.mark.parametrize("case", ["random", "masked", "lattice", "wide"])
def test_row_topk_matches_jax_kernel(case, k):
    x = _matrix(case, seed=k)
    want_v, want_i = j_row_topk(jnp.asarray(x), k=k, interpret=True)
    got_v, got_i = t_sp.pallas_row_topk(torch.as_tensor(x), k=k)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    finite = np.isfinite(want_v)
    np.testing.assert_array_equal(got_i.numpy()[finite], want_i[finite])
    # Every slot, +inf ones included, is numpy's stable order.
    np.testing.assert_array_equal(
        got_i.numpy(), np.argsort(x, axis=1, kind="stable")[:, :k]
    )
    if case == "masked":
        assert not finite.all()  # the empty row, at every k


def test_row_topk_float64_compares_in_float32_like_jax():
    rng = np.random.default_rng(5)
    x = rng.random((16, 100)) * (1 + 1e-9 * rng.random((16, 100)))
    want_v, want_i = j_row_topk(jnp.asarray(x), k=6, interpret=True)
    got_v, got_i = t_sp.pallas_row_topk(torch.as_tensor(x), k=6)
    assert got_v.dtype == torch.float64
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("k,shape", [(0, (4, 8)), (9, (4, 8))], ids=["k0", "k>W"])
def test_row_topk_rejects_k_out_of_range(k, shape):
    with pytest.raises(ValueError, match="1 <= k <= W"):
        t_sp.pallas_row_topk(torch.zeros(shape), k=k)


def test_row_topk_wrapper_counts_only_kernel_launches():
    before = t_sp.pallas_row_topk.launches
    t_sp.pallas_row_topk(torch.zeros((4, 8)), k=2)
    assert t_sp.pallas_row_topk.launches == before  # the CPU twin launches nothing
