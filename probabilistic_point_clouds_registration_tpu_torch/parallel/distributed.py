"""The sharded outer-iteration step with brute-force search (port of the
JAX package's ``parallel/distributed.py``).

One outer iteration over a ("points", "targets") mesh: source rows sharded
over ``"points"`` (data-parallel; replaces the reference's OpenMP-threaded
Ceres residual evaluation, src/prob_point_cloud_registration.cc:98), target
rows over ``"targets"`` (the search of ``parallel/search.py``, whose merge
carries the neighbors' coordinates), and the EM-LM solve reducing its
moments over ``"points"``, so every rank steps the same iterate. Either
axis may have size 1.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.se3 import quat_rotate_points
from ..core.types import round_up
from ..models.em_lm import LMConfig, LMResult, em_lm_solve
from .mesh import POINTS_AXIS, Mesh
from .search import local_topk_merge


class ShardedStepResult(NamedTuple):
    result: LMResult
    num_correspondences: torch.Tensor


def pad_for_mesh(points: np.ndarray, n_shards: int, multiple: int = 256):
    """Pad an (n, 3) cloud so its row count divides evenly over ``n_shards``.

    Padding rows are zeros (masked out downstream via the returned count).
    Returns (padded (n_pad, 3), n_valid).
    """
    points = np.asarray(points)
    n = points.shape[0]
    n_pad = round_up(max(n, 1), multiple * n_shards)
    if n_pad == n:
        return points, n
    padded = np.zeros((n_pad, points.shape[1]), dtype=points.dtype)
    padded[:n] = points
    return padded, n


def make_sharded_registration_step(
    mesh: Mesh,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    source_tile: int = 4096,
    target_tile: int = 2048,
):
    """The distributed outer-iteration step on this rank:

      step(fs, tgt, sv, tv, q_cum, t_cum, q0, t0) -> ShardedStepResult

    ``fs`` / ``sv`` are this rank's block of the source rows and their
    validity (the rows divide the "points" axis), ``tgt`` / ``tv`` its
    block of the target rows (the rows divide the "targets" axis). The
    result is the same on every rank.
    """
    cfg = lm_config._replace(axis_name=POINTS_AXIS)
    r2 = radius * radius

    def step(fs, tgt, sv, tv, q_cum, t_cum, q0, t0):
        moved = quat_rotate_points(q_cum, fs) + t_cum
        _, sq, found, neighbor_pts = local_topk_merge(
            moved,
            tgt,
            k=k,
            source_valid=sv,
            target_valid_shard=tv,
            mesh=mesh,
            source_tile=source_tile,
            target_tile=target_tile,
            gather_points=True,
        )
        in_radius = found & (sq <= torch.tensor(r2, dtype=sq.dtype, device=sq.device))
        result = em_lm_solve(moved, neighbor_pts, in_radius, q0, t0, cfg, mesh=mesh)
        n_corr = mesh.psum(in_radius.sum(), POINTS_AXIS)
        return ShardedStepResult(result=result, num_correspondences=n_corr)

    return step
