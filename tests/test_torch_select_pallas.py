"""Parity of the port's row top-k (ops/select_pallas.py) with the JAX
package's Pallas kernel B2, run in interpret mode on the CPU.

Inputs come from numpy seeds and go through both. On the CPU the port's
wrapper takes the kernel's plain twin (a stable sort), which the GPU smoke
run holds bit for bit against the CUDA kernel. Tolerance: values and indices
equal (atol 0) wherever the value is finite; the JAX kernel leaves the index
of a +inf slot unspecified, the port returns the row's lowest masked
columns there (checked against numpy's stable argsort).

The CUDA kernel's selection scheme (filter against a stale threshold, stage
up to 32 survivors, merge when the buffer fills, +inf columns filled in at
the end) is modelled in numpy below and held equal to the twin in every
slot: the scheme is exact whatever the batch size, i.e. however stale the
threshold.
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


_INF_BITS = 0x7F800000


def _staged_row_topk(row, k, *, batch, stage=32):
    """numpy model of the CUDA kernel's scheme for one row. Keys are
    (value bits, column). A batch of columns is tested against the value of
    the k-th key as it stood before the batch (bits < threshold: the
    batch's columns lie above the list's, so strict is exact) and, after a
    merge inside the batch, also ``<=`` the fresh one; survivors go to a
    staging buffer of ``stage`` keys that is merged into the running top 32
    when it is full. Until k finite
    keys are held the threshold is +inf, so no +inf entry is ever staged;
    the row's lowest +inf columns fill the slots left at the end."""
    bits = row.view(np.uint32)
    run, staged, thr = [], [], _INF_BITS

    def merge():
        nonlocal run, staged, thr
        run = sorted(run + staged)[:32]
        staged = []
        thr = run[k - 1][0] if len(run) >= k else _INF_BITS

    for c0 in range(0, row.size, batch):
        before = thr
        for c in range(c0, min(row.size, c0 + batch)):
            if bits[c] < before and bits[c] <= thr:
                if len(staged) == stage:
                    merge()
                staged.append((int(bits[c]), c))
        if len(staged) == stage:
            merge()
    merge()
    picked = run[:k]
    masked = (c for c in range(row.size) if bits[c] == _INF_BITS)
    while len(picked) < k:
        picked.append((_INF_BITS, next(masked)))
    vals = np.array([b for b, _ in picked], np.uint32).view(np.float32)
    return vals, np.array([c for _, c in picked], np.int32)


def _model_matrix(case):
    rng = np.random.default_rng(11)
    if case == "random":
        return rng.random((6, 700)).astype(np.float32)
    if case == "lattice":  # exact ties, among them at the k-th value
        x = rng.integers(0, 3, size=(6, 700)).astype(np.float32)
        x[rng.random(x.shape) < 0.4] = np.inf
        return x
    if case == "few_finite":  # fewer than k finite entries, some at the far end
        x = np.full((6, 333), np.inf, np.float32)
        x[:, -3:] = rng.random((6, 3))
        x[2, 5] = 0.25
        return x
    if case == "all_inf":
        return np.full((3, 130), np.inf, np.float32)
    x = np.full((4, 700), np.inf, np.float32)  # 33 equal values: the buffer fills on a tie
    for r in range(4):
        x[r, rng.choice(700, 33, replace=False)] = 0.5
    return x


@pytest.mark.parametrize("k", [1, 20, 32])
@pytest.mark.parametrize("case", ["random", "lattice", "few_finite", "all_inf", "tied33"])
def test_staged_selection_model_equals_twin(case, k):
    x = _model_matrix(case)
    want_v, want_i = t_sp._row_topk_plain(torch.as_tensor(x), k=k)
    for batch in (32, 128, 512):  # the staler the threshold, the more is staged
        for r, row in enumerate(x):
            got_v, got_i = _staged_row_topk(row, k, batch=batch)
            np.testing.assert_array_equal(got_v.view(np.uint32),
                                          want_v[r].numpy().view(np.uint32))
            np.testing.assert_array_equal(got_i, want_i[r].numpy())


def test_row_topk_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match=r"\(N, W\) matrix"):
        t_sp.pallas_row_topk(torch.zeros(8), k=2)
    with pytest.raises(ValueError, match=r"\(N, W\) matrix"):
        t_sp.pallas_row_topk(torch.zeros((2, 4, 8)), k=2)
    # Neither the CPU nor a CUDA device: no twin, no kernel, no fallback.
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_sp.pallas_row_topk(torch.zeros((4, 8), device="meta"), k=2)


def test_row_topk_takes_a_view_off_a_16_byte_boundary():
    """The kernel reads 16 bytes a lane from the first 16-byte boundary of
    each row on; the wrapper hands it any contiguous float32 matrix, also a
    view that starts 4 bytes into its storage (the GPU smoke run holds that
    case against the twin on the card)."""
    flat = torch.arange(1 + 6 * 10, dtype=torch.float32)
    view = flat[1:].view(6, 10)
    assert view.is_contiguous() and view.storage_offset() == 1
    vals, cols = t_sp.pallas_row_topk(view, k=3)
    np.testing.assert_array_equal(cols.numpy(), np.tile(np.arange(3, dtype=np.int32), (6, 1)))
    np.testing.assert_array_equal(vals.numpy(), view.numpy()[:, :3])
