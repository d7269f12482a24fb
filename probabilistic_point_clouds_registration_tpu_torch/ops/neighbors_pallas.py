"""Brute-force radius search through a hand-written KNN kernel (port of the
JAX package's ``ops/neighbors_pallas.py``; the module keeps its
counterpart's name).

The streaming engine in ops/neighbors.py expresses the K-selection as a
stable sort per target tile. The JAX package replaces it on its accelerator
by a TPU kernel (B3, ``_kernel``) that keeps a running best-k per source row
while the whole target streams past; here that is a CUDA kernel
(csrc/brute_knn.cu) designed from the same contract.

Selection semantics match ``ops.neighbors.topk_neighbors``: top-k by the
float32 matmul-expansion distance over valid targets, on coordinates centred
on the valid targets' bbox midpoint (no radius bound in the selection), ties
to the lowest target index; then the wrapper recomputes exact gathered
distances, applies the radius mask and sorts nearest-first. The expansion is
evaluated elementwise in one fixed order (see :func:`_expansion_d2`), not
through a matrix product, so that kernel and twin select bit-equal sets.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import kernels
from ..core.types import Correspondences
from .neighbors import bbox_center


def _expansion_d2(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """(S, T) float32 expansion distances in the kernel's order, one
    rounded operation at a time: max((s2 + t2) - 2 * cross, 0) with
    cross = (sx*tx + sy*ty) + sz*tz and s2, t2 summed x, y, z likewise."""
    sx, sy, sz = (src[:, c:c + 1] for c in range(3))
    tx, ty, tz = (tgt[None, :, c] for c in range(3))
    cross = sx * tx + sy * ty + sz * tz
    s2 = sx * sx + sy * sy + sz * sz
    t2 = tx * tx + ty * ty + tz * tz
    return torch.clamp_min(s2 + t2 - 2.0 * cross, 0.0)


def _brute_knn_plain(src, tgt, target_valid, *, k: int,
                     source_tile: int = 4096, target_tile: int = 2048):
    """Plain PyTorch twin of the KNN kernel (same contract): the target
    streams past in tiles, each merged into the best k so far by a stable
    sort of [best, tile], which keeps the earlier (lower) index among equal
    distances; an invalid target's infinite distance sorts behind the (inf,
    m) slots of the empty list and is never taken. Returns (indices (N, k)
    int32 with m = none, d2 (N, k))."""
    n, m = src.shape[0], tgt.shape[0]
    dev = src.device
    idx_all, d_all = [], []
    for s0 in range(0, max(n, 1), source_tile):
        blk = src[s0:s0 + source_tile]
        s = blk.shape[0]
        best_d = torch.full((s, k), math.inf, dtype=torch.float32, device=dev)
        best_i = torch.full((s, k), m, dtype=torch.int32, device=dev)
        for t0 in range(0, m, target_tile):
            tile = tgt[t0:t0 + target_tile]
            d2 = _expansion_d2(blk, tile)
            d2 = torch.where(target_valid[t0:t0 + target_tile][None, :], d2, math.inf)
            ids = torch.arange(t0, t0 + tile.shape[0], dtype=torch.int32, device=dev)
            cand_d = torch.cat([best_d, d2], dim=1)
            cand_i = torch.cat([best_i, ids.expand(s, -1)], dim=1)
            best_d, args = torch.sort(cand_d, dim=1, stable=True)
            best_d = best_d[:, :k]
            best_i = torch.gather(cand_i, 1, args[:, :k])
        idx_all.append(best_i)
        d_all.append(best_d)
    return torch.cat(idx_all), torch.cat(d_all)


# Targets per tile of the kernel's packed target (csrc/brute_knn.cu, kTile).
PACK_TILE = 512


def _pack_targets_plain(tgt, target_valid, *, tile: int = PACK_TILE):
    """Plain PyTorch version of the kernel's target packing: (M', 4) float32
    rows (x, y, z, t2) with t2 = (x*x + y*y) + z*z, an invalid target as
    (0, 0, 0, +inf), padded with such rows to M' = M rounded up to a whole
    ``tile``. A +inf t2 makes the expansion distance +inf, which no row
    takes."""
    m = tgt.shape[0]
    x, y, z = (tgt[:, c] for c in range(3))
    t2 = x * x + y * y + z * z
    rows = torch.cat([tgt, t2[:, None]], dim=1)
    empty = torch.tensor([0.0, 0.0, 0.0, math.inf], dtype=tgt.dtype, device=tgt.device)
    rows = torch.where(target_valid[:, None], rows, empty)
    return torch.cat([rows, empty.expand(-m % tile, 4)])


def brute_knn(src, tgt, target_valid, *, k: int, target_tile: int = 2048):
    """Per row of ``src`` (N, 3) float32, the k valid targets of ``tgt``
    (M, 3) float32 of smallest expansion distance, in ascending (distance,
    target index) order (B3, the TPU kernel
    ``ops/neighbors_pallas.py::_kernel`` of the JAX package).

    Returns (indices (N, k) int32, d2 (N, k) float32); a row with fewer than
    k valid targets fills up with (M, inf). Coordinates must be finite (NaN
    is outside the contract).

    A CPU tensor goes to the plain twin, which streams the target in tiles
    of ``target_tile`` points (the kernel needs no tile size); a CUDA tensor
    launches the CUDA kernel (csrc/brute_knn.cu: one call packs the target
    into scratch allocated here, see :func:`_pack_targets_plain`, and runs
    the search) or raises. ``brute_knn.launches`` counts those calls, one
    per search.
    """
    if k < 1:
        raise ValueError(f"brute_knn needs k >= 1, got {k}")
    dev = src.device
    n, m = src.shape[0], tgt.shape[0]
    for arg, t, dtype, shape in (
        ("src", src, torch.float32, (n, 3)),
        ("tgt", tgt, torch.float32, (m, 3)),
        ("target_valid", target_valid, torch.bool, (m,)),
    ):
        if t.device != dev:
            raise ValueError(f"{arg} is on {t.device}, src on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{arg} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{arg} must have shape {shape}, got {tuple(t.shape)}")
    if dev.type == "cpu":
        return _brute_knn_plain(src, tgt, target_valid, k=k, target_tile=target_tile)
    if dev.type != "cuda":
        raise ValueError(f"brute_knn runs on cpu or cuda tensors, not {dev}")
    src, tgt = src.contiguous(), tgt.contiguous()
    valid = target_valid.contiguous().view(torch.uint8)
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    if n == 0:
        return out_i, out_d
    # Scratch for the pre-kernel's packed target, whole tiles.
    packed = torch.empty((m + -m % PACK_TILE, 4), dtype=torch.float32, device=dev)
    launch = kernels.load("brute_knn")
    with torch.cuda.device(dev):
        err = launch(
            src.data_ptr(), tgt.data_ptr(), valid.data_ptr(), packed.data_ptr(),
            packed.shape[0], out_i.data_ptr(), out_d.data_ptr(), n, m, k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"brute_knn kernel launch failed: CUDA error {err}")
    brute_knn.launches += 1
    return out_i, out_d


brute_knn.launches = 0


def pallas_radius_search(
    source: torch.Tensor,
    target: torch.Tensor,
    *,
    k: int,
    radius: float,
    source_valid: torch.Tensor,
    target_valid: torch.Tensor,
    target_tile: int = 2048,
) -> Correspondences:
    """Radius-capped KNN via the KNN kernel (contract of
    ``ops.neighbors.radius_search``; ``sq_dists`` is float32 as in the JAX
    package).

    The JAX package's kernel leaves each row's k in slot-arrival order
    before the final sort; here they arrive in (expansion distance, index)
    order and the final sort by exact distance is stable, so equal exact
    distances come out in that order.
    """
    m = target.shape[0]
    source_valid = source_valid.bool()
    target_valid = target_valid.bool()
    # Centre on the valid targets' bbox midpoint before the expansion: its
    # f32 cancellation error is ~eps * |coords|^2, which at LiDAR coordinate
    # scales otherwise swamps mm-scale distance gaps (the exact recompute
    # below uses the ORIGINAL coordinates). Invalid source rows select
    # nothing that is kept; zeroed, they stay finite.
    center = bbox_center(target, target_valid).to(source.dtype)
    src = torch.where(source_valid[:, None], source - center, 0.0).float()
    tgt = (target - center).float()
    idx, _ = brute_knn(src, tgt, target_valid, k=k, target_tile=target_tile)

    found = (idx < m) & source_valid[:, None]
    idx = torch.where(found, idx, 0)
    # Exact gathered distances + radius mask, as in the streaming engine.
    diff = source[:, None, :] - target[idx.long()]
    d2 = torch.sum(diff * diff, dim=-1).float()
    r2 = float(np.float32(radius) ** 2)
    in_radius = found & (d2 <= r2)
    # Nearest first.
    order = torch.sort(torch.where(in_radius, d2, math.inf), dim=1, stable=True).indices
    idx = torch.gather(idx, 1, order)
    d2 = torch.gather(d2, 1, order)
    in_radius = torch.gather(in_radius, 1, order)
    return Correspondences(
        indices=idx.to(torch.int32),
        sq_dists=torch.where(in_radius, d2, 0.0),
        mask=in_radius,
    )
