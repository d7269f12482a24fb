"""Target-sharded brute-force search (port of the JAX package's
``parallel/search.py``).

Each rank of the ``"targets"`` axis holds a contiguous block of the target
rows and takes a local top-k of the (replicated or points-sharded) source
against it; the global top-k is the merge of the gathered (N, k) lists
(``grid_sharded.merge_topk``), so only O(N * D * k) values move, never the
(N, M) distances. Plain torch, as the JAX package's is plain XLA.

Replaces the reference's single-threaded FLANN kd-tree radius search
(reference: src/prob_point_cloud_registration.cc:66-81) at target sizes a
kd-tree cannot reach per iteration.
"""
from __future__ import annotations

import math

import torch

from ..core.types import Correspondences
from ..ops.neighbors import topk_neighbors
from .grid_sharded import merge_topk
from .mesh import TARGETS_AXIS, Mesh


def local_topk_merge(
    source,
    target_shard,
    *,
    k: int,
    source_valid,
    target_valid_shard,
    mesh: Mesh,
    axis_name: str = TARGETS_AXIS,
    source_tile: int = 4096,
    target_tile: int = 2048,
    gather_points: bool = False,
):
    """Local top-k over this rank's target block, then the global merge.

    ``target_shard`` is block ``mesh.index(axis_name)`` of the target rows
    (all blocks the same size). Returns globally indexed (indices,
    sq_dists, found[, points]), each (N, k[, 3]), the same on every rank of
    ``axis_name``. With ``gather_points`` the selected neighbors'
    coordinates come too: each rank gathers its own candidates' xyz before
    the merge, so no rank needs the whole target.
    """
    m_local = target_shard.shape[0]
    idx, sq, found = topk_neighbors(
        source,
        target_shard,
        k=k,
        source_valid=source_valid,
        target_valid=target_valid_shard,
        source_tile=source_tile,
        target_tile=min(target_tile, m_local),
    )
    gidx = idx + mesh.index(axis_name) * m_local  # globalize block-local ids
    all_d = mesh.all_gather(torch.where(found, sq, math.inf), axis_name)  # (D, N, k)
    all_i = mesh.all_gather(gidx, axis_name)
    all_p = None
    if gather_points:
        all_p = mesh.all_gather(target_shard[idx.long()], axis_name)  # (D, N, k, 3)
    return merge_topk(all_d, all_i, all_p, k=k)


def make_target_sharded_search(
    mesh: Mesh,
    *,
    k: int,
    radius: float,
    source_tile: int = 4096,
    target_tile: int = 2048,
):
    """A target-sharded radius search on this rank.

    The returned ``search(source, target_shard, source_valid,
    target_valid_shard)`` has the contract of ``ops.neighbors.radius_search``
    for the whole target, from this rank's block of it (the target row
    count must divide the ``"targets"`` axis); the result is the same on
    every rank of that axis.
    """

    def search(source, target_shard, source_valid, target_valid_shard):
        idx, sq, found = local_topk_merge(
            source,
            target_shard,
            k=k,
            source_valid=source_valid,
            target_valid_shard=target_valid_shard,
            mesh=mesh,
            source_tile=source_tile,
            target_tile=target_tile,
        )
        in_radius = found & (sq <= torch.tensor(radius, dtype=sq.dtype, device=sq.device) ** 2)
        return Correspondences(
            indices=idx, sq_dists=torch.where(in_radius, sq, 0.0), mask=in_radius
        )

    return search
