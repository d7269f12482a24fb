"""Radius-bounded K-nearest-neighbor search, brute force (port of the JAX
package's ``ops/neighbors.py``).

Replaces the reference's per-point FLANN kd-tree radius search
(src/prob_point_cloud_registration.cc:66-81): up to K nearest targets within
the radius per source point, sorted by distance.

The (N_src x M_tgt) squared-distance problem is tiled: the cross term is a
matmul, and a streaming top-K merge keeps the full distance matrix out of
memory. It is the engine the registration takes when it keeps no grid, and
the oracle for the fused engine.

Selection order equals the JAX package's slot for slot: each merge is a
stable sort of [best so far, tile], which keeps the lowest target index
among equal distances exactly as ``lax.top_k`` does, and the final k are
re-sorted (stably) by exactly recomputed distances. Both clouds are
centred on the valid targets' bbox midpoint before the matmul expansion,
which shrinks its cancellation error from eps*|coords|^2 to eps*extent^2/4.
``exact=True`` selects by direct-difference distances instead (no centring,
no re-sort): the hot-cell overflow merge of the grid engines uses it.
"""
from __future__ import annotations

import math

import torch

from ..core.types import Correspondences, round_up


def _pairwise_sq_dists(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """(S, T) squared distances via the matmul expansion."""
    cross = src @ tgt.T
    s2 = torch.sum(src * src, dim=-1, keepdim=True)
    t2 = torch.sum(tgt * tgt, dim=-1)[None, :]
    return torch.clamp_min(s2 + t2 - 2.0 * cross, 0.0)


def bbox_center(target: torch.Tensor, target_valid: torch.Tensor) -> torch.Tensor:
    """(3,) midpoint of the valid targets' bounding box; 0 on an axis with
    no finite extent (a target of all padding)."""
    tv3 = target_valid.bool()[:, None]
    lo = torch.amin(torch.where(tv3, target, math.inf), dim=0)
    hi = torch.amax(torch.where(tv3, target, -math.inf), dim=0)
    return torch.where(
        torch.isfinite(lo) & torch.isfinite(hi), (lo + hi) * 0.5, 0.0
    )


def topk_neighbors(
    source: torch.Tensor,
    target: torch.Tensor,
    *,
    k: int,
    source_valid: torch.Tensor,
    target_valid: torch.Tensor,
    source_tile: int = 4096,
    target_tile: int = 2048,
    exact: bool = False,
):
    """K nearest target points per source point (unbounded radius).

    ``exact`` computes the tile distances in the direct (s - t)^2 form
    instead of the matmul expansion, whose float32 error (~eps * coordinate
    magnitude squared) corrupts the selection at LiDAR coordinate scales.
    Meant for small target sets (the hot-cell overflow merge).

    Returns (indices (N, k) int32, sq_dists (N, k), found (N, k) bool),
    sorted ascending by exactly recomputed squared distance (with ``exact``:
    in selection order, which is that order already); ``found`` is False for
    slots beyond the number of valid targets and for invalid source rows.
    """
    n = source.shape[0]
    m = target.shape[0]
    dtype = source.dtype
    dev = source.device
    inf = math.inf

    m_pad = round_up(m, target_tile)
    tgt = torch.nn.functional.pad(target, (0, 0, 0, m_pad - m))
    tgt_valid = torch.nn.functional.pad(target_valid.bool(), (0, m_pad - m))
    src = source
    if not exact:
        center = bbox_center(tgt, tgt_valid)
        src = source - center
        tgt = tgt - center

    best_d_all, best_i_all = [], []
    for s0 in range(0, n, source_tile):
        src_blk = src[s0:s0 + source_tile]
        s = src_blk.shape[0]
        best_d = torch.full((s, k), inf, dtype=dtype, device=dev)
        best_i = torch.full((s, k), m, dtype=torch.int32, device=dev)
        for start in range(0, m_pad, target_tile):
            tile = tgt[start:start + target_tile]
            if exact:
                diff = src_blk[:, None, :] - tile[None, :, :]
                d2 = torch.sum(diff * diff, dim=-1)
            else:
                d2 = _pairwise_sq_dists(src_blk, tile)
            d2 = torch.where(tgt_valid[start:start + target_tile][None, :], d2, inf)
            tile_ids = torch.arange(
                start, start + target_tile, dtype=torch.int32, device=dev
            ).expand(s, -1)
            cand_d = torch.cat([best_d, d2], dim=1)
            cand_i = torch.cat([best_i, tile_ids], dim=1)
            best_d, args = torch.sort(cand_d, dim=1, stable=True)
            best_d = best_d[:, :k]
            best_i = torch.gather(cand_i, 1, args[:, :k])
        best_d_all.append(best_d)
        best_i_all.append(best_i)
    best_d = torch.cat(best_d_all)
    best_i = torch.cat(best_i_all)

    found = (best_i < m) & torch.isfinite(best_d) & source_valid.bool()[:, None]
    safe_i = torch.where(found, best_i, 0)
    # Recompute the selected distances exactly and re-sort by them: within
    # the expansion's error band, selection order can invert.
    diff = source[:, None, :] - target[safe_i.long()]
    exact_d = torch.sum(diff * diff, dim=-1)
    sq_dists = torch.where(found, exact_d, inf)
    if not exact:
        sq_dists, order = torch.sort(sq_dists, dim=1, stable=True)
        safe_i = torch.gather(safe_i, 1, order)
        found = torch.gather(found, 1, order)
    return safe_i, sq_dists, found


def radius_search(
    source: torch.Tensor,
    target: torch.Tensor,
    *,
    k: int,
    radius: float,
    source_valid: torch.Tensor,
    target_valid: torch.Tensor,
    source_tile: int = 4096,
    target_tile: int = 2048,
) -> Correspondences:
    """Radius-bounded capped KNN: ``kdtree.radiusSearch(pt, radius, k)`` per
    source point (src/prob_point_cloud_registration.cc:72-81)."""
    idx, sq, found = topk_neighbors(
        source,
        target,
        k=k,
        source_valid=source_valid,
        target_valid=target_valid,
        source_tile=source_tile,
        target_tile=target_tile,
    )
    r2 = torch.tensor(radius, dtype=sq.dtype, device=sq.device) ** 2
    in_radius = found & (sq <= r2)
    return Correspondences(
        indices=idx, sq_dists=torch.where(in_radius, sq, 0.0), mask=in_radius
    )


def nearest_neighbor(source, target, *, source_valid=None, target_valid=None):
    """1-NN distances + indices (the eval-utility primitive,
    utilities.hpp:28-63)."""
    n = source.shape[0]
    m = target.shape[0]
    if source_valid is None:
        source_valid = torch.ones(n, dtype=torch.bool, device=source.device)
    if target_valid is None:
        target_valid = torch.ones(m, dtype=torch.bool, device=target.device)
    idx, sq, found = topk_neighbors(
        source,
        target,
        k=1,
        source_valid=source_valid,
        target_valid=target_valid,
        source_tile=min(4096, round_up(n, 8)),
        target_tile=min(2048, round_up(m, 8)),
    )
    return idx[:, 0], sq[:, 0], found[:, 0]
