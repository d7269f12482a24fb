"""The bitonic select B4 (ops/select_bitonic.py) against the JAX package's.

On the CPU the wrapper runs its plain twin; the JAX side runs its Pallas
kernel ``run_select_bitonic`` in interpret mode, on
tests/test_select_bitonic.py's cases (128 and 512 lanes, with and without
segments, k 20 and 32, exact distance ties, one all-dead block). Ids and
points must be equal; distances at rtol 3e-7, because XLA may contract the
d2 expression into FMAs (tests/test_fused_grid.py). The CUDA kernel is held
bit for bit against the same twin on the card by ``chip_smoke.py``, on these
cases and on the ones made by its ``_walker_cases``, which go through the JAX
kernel here too (tests/test_torch_fused_grid.py holds a numpy model of the
kernel's walk against the twin on them).
"""
import numpy as np
import pytest
import torch

from probabilistic_point_clouds_registration_tpu.ops.select_bitonic import (
    run_select_bitonic,
)
from probabilistic_point_clouds_registration_tpu_torch.ops import select_bitonic as t_sb
from probabilistic_point_clouds_registration_tpu_torch.ops.fused_grid import pack_row_meta
from test_select_bitonic import _block_fixture
from test_torch_fused_grid import _smoke_script


def _port_inputs(padded, win_xyz, win_idx, w_blk, bg):
    """The JAX kernel's per-group windows as the port's window table: one
    window per group plus the dead window, which the groups of a dead block
    (w_blk == 0) point at."""
    win_xyz = np.asarray(win_xyz)
    win_idx = np.asarray(win_idx)
    ng = win_idx.shape[0]
    union = (win_idx >= 0).sum(axis=1)
    width = np.where(union > 0, np.minimum(np.ceil(union / 128) * 128, win_idx.shape[1]), 0)
    step_rows = np.arange(ng, dtype=np.int32)
    step_rows[np.repeat(np.asarray(w_blk) == 0, bg)] = ng
    xyz = np.concatenate([win_xyz, np.full_like(win_xyz[:1], 1e30)])
    idx = np.concatenate([win_idx, np.full_like(win_idx[:1], -1)])
    return (torch.as_tensor(np.array(padded)), torch.as_tensor(xyz), torch.as_tensor(idx),
            torch.as_tensor(step_rows), torch.as_tensor(np.append(width, 0).astype(np.int32)))


@pytest.mark.parametrize("n_lanes", [128, 512])
@pytest.mark.parametrize("with_segments", [False, True])
@pytest.mark.parametrize("k", [20, 32])
def test_twin_matches_pallas_bitonic_kernel(n_lanes, with_segments, k):
    bg, ng, radius = 2, 8, 0.9
    padded, win_xyz, win_idx, w_blk, u_blk = _block_fixture(
        seed=n_lanes + k, n_lanes=n_lanes, ng=ng, bg=bg, radius=radius,
        with_segments=with_segments, with_ties=True,
    )
    want_d, want_i, want_p = run_select_bitonic(
        padded, win_xyz, win_idx, w_blk, u_blk, k=k, n_lanes=n_lanes, radius=radius,
        block_groups=bg, interpret=True, return_points=True,
    )
    before = t_sb.select_bitonic.launches
    got_d, got_i, got_p = t_sb.select_bitonic(
        *_port_inputs(padded, win_xyz, win_idx, w_blk, bg), k=k, radius=radius
    )
    assert t_sb.select_bitonic.launches == before  # CPU tensors: the twin, no launch
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    for g, w in zip(got_p, want_p):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=3e-7, atol=0)
    live = got_i.numpy() >= 0
    assert live.any() and not live[-bg * 8:].any()  # the dead block found nothing


@pytest.mark.parametrize("k", [1, 12, 20, 32])
@pytest.mark.parametrize("n_lanes", [128, 512])
def test_twin_matches_pallas_bitonic_kernel_on_walker_cases(n_lanes, k):
    """The inputs a one-pass walk could get wrong (segments off a multiple
    of 128, exactly k live lanes at a segment's end, more than 32 survivors
    in a step, runs of equal distances, an empty segment beside full ones)
    through the twin and the JAX package's bitonic kernel in interpret mode."""
    bg = 2
    case = _smoke_script()._walker_cases(pack_row_meta, n_lanes=n_lanes, seed=n_lanes)
    radius = case.pop("radius")
    step_rows, width = case["step_rows"], case["width_lut"]
    union = (case["cand_idx"] >= 0).sum(axis=1).astype(np.int32)
    want_d, want_i, want_p = run_select_bitonic(
        case["padded"], case["cand_xyz"][step_rows], case["cand_idx"][step_rows],
        width[step_rows].reshape(-1, bg).max(axis=1),
        union[step_rows].reshape(-1, bg).max(axis=1),
        k=k, n_lanes=n_lanes, radius=radius, block_groups=bg, interpret=True,
        return_points=True,
    )
    before = t_sb.select_bitonic.launches
    got_d, got_i, got_p = t_sb.select_bitonic(
        **{key: torch.as_tensor(value) for key, value in case.items()}, k=k, radius=radius)
    assert t_sb.select_bitonic.launches == before  # CPU tensors: the twin, no launch
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    for g, w in zip(got_p, want_p):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=3e-7, atol=0)
    found = (got_i.numpy() >= 0).sum(axis=1).reshape(-1, 8)  # per group and row turn
    assert np.all(found[step_rows == 2][:, [0, 1, 4, 7]] == min(k, 12))
    assert np.all(found[step_rows == 4][:, 0] == k) and not found[:, 2:4].any()


@pytest.mark.parametrize(
    "n_lanes,k,match",
    [(384, 20, "power-of-two"), (128, 33, "k <= 32"), (128, 0, "k <= 32")],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(n_lanes, k, match):
    padded = torch.zeros((8, 4))
    with pytest.raises(ValueError, match=match):
        t_sb.select_bitonic(
            padded, torch.zeros((2, 3, n_lanes)), torch.zeros((2, n_lanes), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
            k=k, radius=0.5,
        )


def test_wrapper_refuses_other_devices():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_sb.select_bitonic(
            torch.zeros((8, 4), **meta), torch.zeros((2, 3, 128), **meta),
            torch.zeros((2, 128), dtype=torch.int32, **meta),
            torch.zeros(1, dtype=torch.int32, **meta), torch.zeros(2, dtype=torch.int32, **meta),
            k=20, radius=0.5,
        )
