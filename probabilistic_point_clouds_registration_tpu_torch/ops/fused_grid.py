"""Fused grouped grid search: cell-shared candidate windows + a hand-written
window-select kernel (port of the JAX package's ``ops/fused_grid.py``).

All sources in one grid cell share the same 27-cell candidate neighborhood,
so:

  1. ONCE per pair: prepack, for every cell in the dilated occupied set (any
     cell adjacent to an occupied target cell — a source anywhere else
     provably has zero in-radius neighbors), the 27-neighborhood candidate
     window as contiguous (3, L) coordinate + (L,) index rows.
  2. Per iteration: map the moved sources to their window, and sort
     same-window sources into GROUP=8-row groups (`_group_by_window`).
  3. Run the window-select kernel (`select_windows`): per source row, the k
     nearest live candidates of its group's window, read straight from the
     prepacked window table.

Selection semantics equal the JAX engines': k smallest f32 distances within
``radius``, ascending, ties broken by candidate lane (the shared
(neighbor-offset, bucket-slot) enumeration).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..core.types import (
    Correspondences,
    bucket_rows as _bucket_rows,
    pow2 as _pow2,
    round_up,
)

# Sources per cell-pure group; all rows of a group share one window.
GROUP = 8
# The JAX package's kernel block, in groups. Padded source rows are a
# multiple of BLOCK_GROUPS * GROUP, which keeps every intermediate the same
# shape there and here, so the two compare array for array.
BLOCK_GROUPS = 16
_ROW_ALIGN = BLOCK_GROUPS * GROUP
# Dead-candidate coordinate sentinel: squared distances overflow any radius.
_BIG = 1e30
# outd value of an empty slot.
_EMPTY_D = 3e38
# Row-meta encoding for column 3 of the padded source rows: a FLOAT-exact
# integer packing the valid flag and the row's segment lane bounds in
# 16-lane units:
#   meta = valid | (lo/16) << 1 | (hi/16) << 10      (lo % 16 == 0;
#                                                      hi rounded UP to 16)
META_UNIT = 16


def pack_row_meta(valid, lo, hi):
    """Pack (valid, lo, hi) into the float-integer row meta (see META_UNIT).

    ``lo`` must be a multiple of META_UNIT; ``hi`` is rounded up to one.
    Works on numpy arrays, torch tensors or Python ints (-> numpy).
    """
    if isinstance(valid, torch.Tensor):
        hi16 = -(-torch.as_tensor(hi) // META_UNIT)
        return (
            valid.to(torch.int32)
            + ((torch.as_tensor(lo) // META_UNIT) << 1)
            + (hi16 << 10)
        )
    hi16 = -(-np.asarray(hi) // META_UNIT)
    return (
        np.asarray(valid).astype(np.int32)
        + ((np.asarray(lo) // META_UNIT) << 1)
        + (hi16 << 10)
    )


def _unpack_row_meta(v: torch.Tensor):
    """Inverse of :func:`pack_row_meta` (float column -> ints)."""
    vi = v.to(torch.int32)
    valid = (vi & 1) > 0
    lo = ((vi >> 1) & 511) << 4
    hi = (vi >> 10) << 4
    return valid, lo, hi


class PrepackedGrid(NamedTuple):
    """Per-pair fused-search state (tensors on the run's device).

    Attributes:
      cand_xyz: (UD+1, 3, L) candidate window coordinates per dilated cell;
        the last row is the dead window (all slots empty).
      cand_idx: (UD+1, L) original target index per slot; -1 = empty.
      width_lut: (UD+1,) int32 lanes the select kernel scans per window
        (a multiple of 128, at most L; 0 for dead rows).
      union_lut: (UD+1,) int32 real candidate union per window.
      lut_d: (prod(dims+2),) extended-grid linear cell id -> dilated row,
        -1 where a source has provably no neighbors.
      origin_d: (3,) extended grid origin (origin - cell_size).
      dims_d: (3,) int32 extended grid dims (dims + 2).
      n_lanes: L.
      n_dilated: UD (real dilated windows; rows up to UD+1 are padding).
      cell_size: float.
      small_unions: True when many windows hold fewer than k candidates
        (the JAX package's extraction-loop hint; kept for parity).
    """

    cand_xyz: torch.Tensor
    cand_idx: torch.Tensor
    width_lut: torch.Tensor
    union_lut: torch.Tensor
    lut_d: torch.Tensor
    origin_d: torch.Tensor
    dims_d: torch.Tensor
    n_lanes: int
    n_dilated: int
    cell_size: float
    small_unions: bool = False


def dilate_cells_host(grid_host: dict, counts: np.ndarray | None = None) -> dict | None:
    """Host-side dilation tables for :func:`build_prepack` and the pool
    plan (host only).

    The JAX package's function with ``dense_lut=False``: the native C++
    dilation (``native.dilate_cells``) when the library loads, else its
    numpy body, bit for bit the same tables. Takes the dict from
    ops.grid.build_grid_host. Returns None when the extended LUT would be
    too large to materialize. The dense (prod_d,) cell->window LUT is not
    built here: the result holds the seeds the device rebuilds it from
    ("d_cells", "prod_d", "d_cells_e", "base_e", "prod_e", "e_dims",
    "off_e").

    ``counts`` overrides the per-cell candidate counts behind the window
    unions: the dense engine packs from the capacity-capped buckets (the
    default, live bucket slots), the capacity-free pooled engine passes the
    full ``cell_count`` so that hot-cell points stay in their windows.
    """
    dims = grid_host["dims"].astype(np.int64)
    dims_d = dims + 2
    prod_d = int(dims_d.prod())
    if prod_d > (1 << 25):
        return None
    # Only the real occupied cells: the grid pads its arrays to a row
    # bucket with sentinel ids that must not be decoded.
    u = grid_host.get("num_cells", grid_host["cell_ids"].shape[0])
    cell_ids = grid_host["cell_ids"][:u].astype(np.int64)
    x = (cell_ids % dims[0]).astype(np.int32)
    rest = cell_ids // dims[0]
    y = (rest % dims[1]).astype(np.int32)
    z = (rest // dims[1]).astype(np.int32)
    # All neighbor math runs in a DOUBLE-extended (+4) grid: occupied cells
    # sit at coords+2, so dilated cells land in [1, dims+2] and every
    # neighbor-of-a-dilated-cell in [0, dims+3] — always in bounds.
    e0, e1 = int(dims[0] + 4), int(dims[1] + 4)
    prod_e = e0 * e1 * int(dims[2] + 4)
    # Offset enumeration order (x slowest, z fastest) is the tie order shared
    # by every engine — keep it exactly.
    ox, oy, oz = np.meshgrid(*([np.arange(-1, 2, dtype=np.int32)] * 3), indexing="ij")
    off_e = (ox + e0 * (oy + e1 * oz)).reshape(27)
    base_e = (x + 2) + np.int32(e0) * ((y + 2) + np.int32(e1) * (z + 2))
    if counts is None:
        counts = (grid_host["bucket_idx"] >= 0).sum(axis=1)

    # The native dilation when the library loads (as the JAX package does,
    # ops/fused_grid.py:176-187 there); the numpy body below is its
    # fallback and the oracle tests hold it to.
    from .. import native as _native

    nat = _native.dilate_cells(cell_ids, dims, counts[:u])
    if nat is not None:
        d_cells_e, nrows, union = nat
        ud = d_cells_e.shape[0]
    else:
        dil_e = (base_e[:, None] + off_e[None, :]).reshape(-1)
        # Dense-flag unique: O(prod_e + 27u) beats sorting 27u linear ids.
        flags = np.zeros((prod_e,), dtype=bool)
        flags[dil_e] = True
        d_cells_e = np.flatnonzero(flags).astype(np.int32)
        ud = d_cells_e.shape[0]

        # Original-grid row of each of the 27 neighbors of each dilated cell.
        lut_e = np.full((prod_e,), -1, dtype=np.int32)
        lut_e[base_e] = np.arange(u, dtype=np.int32)
        nrows = lut_e[d_cells_e[:, None] + off_e[None, :]]

        # Real candidate union per window.
        counts_pad = np.concatenate([counts[:u], [0]]).astype(np.int32)
        union = counts_pad[np.where(nrows >= 0, nrows, u)].sum(axis=1, dtype=np.int32)

        # Renumber dilated rows by DESCENDING union width (stable), as the
        # JAX package does: its kernel blocks then run near their own width.
        perm = np.argsort(-union, kind="stable").astype(np.int32)
        nrows = nrows[perm]
        union = union[perm]
        d_cells_e = d_cells_e[perm]
    # The largest union is the packed lane width.
    max_union = int(union.max()) if union.size else 0
    xe = d_cells_e % e0
    re_ = d_cells_e // e0
    ye = re_ % e1
    ze = re_ // e1
    d0, d1 = int(dims_d[0]), int(dims_d[1])
    d_cells = (xe - 1) + np.int32(d0) * ((ye - 1) + np.int32(d1) * (ze - 1))
    # Per-row kernel width (lanes, multiple of 128); the dead row appended
    # by the prepack gets width 0.
    width_lut = np.concatenate(
        [
            (np.ceil(np.maximum(union, 1) / 128.0) * 128).astype(np.int32),
            np.zeros((1,), np.int32),
        ]
    )
    return {
        "nrows": nrows,  # (UD, 27) int32
        "dims_d": dims_d.astype(np.int32),
        "origin_d": grid_host["origin"] - grid_host["cell_size"],
        "n_dilated": ud,
        "max_union": max_union,
        "union": union,  # (UD,) descending real candidate counts
        "width_lut": width_lut,  # (UD+1,) int32
        "union_lut": np.concatenate([union.astype(np.int32), np.zeros((1,), np.int32)]),
        "d_cells": d_cells,
        "prod_d": prod_d,
        "d_cells_e": d_cells_e,
        "base_e": base_e,
        "prod_e": prod_e,
        "e_dims": (e0, e1),
        # The 27 linear neighbor offsets in the double-extended grid — the
        # engines' shared tie-break contract.
        "off_e": off_e.astype(np.int32),
    }


def _assemble_prepack(bucket_pts, bucket_idx, nrows, *, capacity: int, n_lanes: int):
    """Assemble the candidate windows from the bucket tensors.

    When ``n_lanes`` is below the raw 27*capacity width, each window is
    COMPACTED: live slots move to the front in (neighbor-offset,
    bucket-slot) order and the dead tail past the largest real union is cut.
    Within each bucket the live slots are contiguous from slot 0, so packed
    position p of a window maps to (neighbor j, slot p - start_j), where
    start_j is the exclusive cumsum of live counts.
    """
    ud = nrows.shape[0]
    dev = bucket_pts.device
    l_full = 27 * capacity
    safe = nrows.clamp_min(0).long()  # (UD, 27)
    if n_lanes < l_full:
        cnt_cell = torch.sum(bucket_idx >= 0, dim=1).to(torch.int32)  # (U,)
        cnt = torch.where(nrows >= 0, cnt_cell[safe], 0)  # (UD, 27)
        starts = torch.cumsum(cnt, dim=1) - cnt  # exclusive prefix
        total = torch.sum(cnt, dim=1)  # (UD,)
        p = torch.arange(n_lanes, dtype=torch.int64, device=dev)
        # Last neighbor whose start <= p (starts is non-decreasing).
        owner = torch.searchsorted(
            starts.to(torch.int64).contiguous(),
            p.expand(ud, -1).contiguous(),
            right=True,
        ) - 1
        owner = owner.clamp(0, 26)
        slot = p[None, :] - torch.gather(starts.to(torch.int64), 1, owner)
        rel = owner * capacity + slot
        live = p[None, :] < total[:, None]
        rel = torch.where(live, rel, 0)
        pts = bucket_pts[safe]  # (UD, 27, cap, 3) contiguous bucket rows
        idx = torch.where(nrows[..., None] < 0, -1, bucket_idx[safe])
        flat_idx = torch.where(
            live, torch.gather(idx.reshape(ud, l_full), 1, rel), -1
        )
        flat_pts = torch.gather(
            pts.reshape(ud, l_full, 3), 1, rel[..., None].expand(-1, -1, 3)
        )
        width = n_lanes
    else:
        flat_pts = bucket_pts[safe].reshape(ud, l_full, 3)
        flat_idx = torch.where(nrows[..., None] < 0, -1, bucket_idx[safe]).reshape(ud, l_full)
        width = l_full
    flat_pts = torch.where((flat_idx < 0)[..., None], _BIG, flat_pts)
    cand_xyz = torch.full((ud + 1, 3, n_lanes), _BIG, dtype=bucket_pts.dtype, device=dev)
    cand_xyz[:ud, :, :width] = flat_pts.permute(0, 2, 1)
    cand_idx = torch.full((ud + 1, n_lanes), -1, dtype=torch.int32, device=dev)
    cand_idx[:ud, :width] = flat_idx.to(torch.int32)
    return cand_xyz, cand_idx


def build_prepack(grid_host: dict, bucket_pts: torch.Tensor,
                  bucket_idx: torch.Tensor, k: int = 20) -> PrepackedGrid | None:
    """Build the per-pair fused-search state.

    Args:
      grid_host: dict from ops.grid.build_grid_host (numpy arrays).
      bucket_pts / bucket_idx: the grid's bucket tensors on the run's device
        (``bucket_pts`` in the run's dtype).
      k: expected neighbour count (only sets ``small_unions``).
    """
    from .fused_pool import _neighbor_rows, _scatter_lut

    dil = dilate_cells_host(grid_host)
    if dil is None:
        return None
    dev = bucket_pts.device
    capacity = grid_host["capacity"]
    # Packed lane width: the largest real candidate union, never more than
    # the raw 27*capacity window, bucketed at ~12.5% (128-lane floor) like
    # the JAX package so the windows compare equal.
    n_lanes = min(
        round_up(27 * capacity, 128),
        _bucket_rows(max(dil["max_union"], 128), 128),
    )
    ud = dil["n_dilated"]
    ud_pad = _bucket_rows(ud)

    def pad1(a, length, value):
        out = np.full((length,), value, np.int32)
        out[: a.shape[0]] = a
        return torch.as_tensor(out, device=dev)

    prod_d_pad = _pow2(dil["prod_d"])
    prod_e_pad = _pow2(dil["prod_e"])
    width_lut = np.zeros((ud_pad + 1,), np.int32)
    width_lut[:ud] = np.minimum(dil["width_lut"][:ud], n_lanes)
    union_lut = np.zeros((ud_pad + 1,), np.int32)
    union_lut[:ud] = dil["union_lut"][:ud]

    lut_d = _scatter_lut(
        pad1(dil["d_cells"], ud_pad, prod_d_pad),
        pad1(np.arange(ud, dtype=np.int32), ud_pad, ud_pad),
        prod_d=prod_d_pad,
    )
    nrows_real = _neighbor_rows(
        pad1(dil["base_e"], _bucket_rows(dil["base_e"].shape[0]), prod_e_pad),
        torch.as_tensor(dil["d_cells_e"].astype(np.int32), device=dev),
        torch.as_tensor(dil["off_e"], device=dev),
        prod_e=prod_e_pad,
    )
    # Window rows [UD, ud_pad) are dead padding.
    nrows = torch.full((ud_pad, 27), -1, dtype=torch.int32, device=dev)
    nrows[:ud] = nrows_real
    cand_xyz, cand_idx = _assemble_prepack(
        bucket_pts, bucket_idx, nrows, capacity=capacity, n_lanes=n_lanes
    )
    return PrepackedGrid(
        cand_xyz=cand_xyz,
        cand_idx=cand_idx,
        width_lut=torch.as_tensor(width_lut, device=dev),
        union_lut=torch.as_tensor(union_lut, device=dev),
        lut_d=lut_d,
        origin_d=torch.as_tensor(dil["origin_d"], dtype=bucket_pts.dtype, device=dev),
        dims_d=torch.as_tensor(dil["dims_d"], device=dev),
        n_lanes=n_lanes,
        n_dilated=ud,
        cell_size=grid_host["cell_size"],
        small_unions=_small_unions(dil["union"], k),
    )


def small_unions_of(part, k: int) -> bool:
    """The small-unions hint from ``part`` = [sum of min(union, k),
    windows], which adds over the windows of several targets: True when
    that mean is below 0.75 k."""
    total, windows = (int(x) for x in part)
    return bool(windows and total / windows < 0.75 * k)


def _small_unions(union: np.ndarray, k: int) -> bool:
    """:func:`small_unions_of` one plan's windows."""
    return small_unions_of((np.minimum(union, k).sum(), union.size), k)


def _group_by_window(source, source_valid, lut_d, origin_d, dims_d, ud,
                     radius, s_pad: int, n_lanes: int):
    """Map each source to its window row and sort same-window sources into
    cell-pure GROUP-row groups.

    Returns (padded, step_rows, order, dst, overflow):
      padded: (s_pad, 4) sorted sources + the packed row meta in column 3
        (valid flag + full-width segment bounds [0, n_lanes)); unfilled
        rows are zero (invalid meta).
      step_rows: (s_pad // GROUP,) int32 window row per group (ud = dead).
      order / dst: the sort permutation and each sorted source's padded-row
        slot (s_pad = none).
      overflow: 0-d count of sources past the ``s_pad`` row budget (the
        caller must redo the iteration with another engine when nonzero).
    Sources with no window (provably no neighbors) get no row at all.
    """
    n = source.shape[0]
    dtype = source.dtype
    dev = source.device
    ng = s_pad // GROUP
    cell = torch.tensor(radius, dtype=dtype, device=dev)

    # 1. source cell -> dilated-window row (ud = dead window). The clamp
    # before the cast keeps far-away sources out of range, not wrapped.
    ijk = torch.floor((source - origin_d.to(dtype)) / cell)
    ijk = ijk.clamp(-(2**30), 2**30).to(torch.int32)
    inb = torch.all((ijk >= 0) & (ijk < dims_d[None, :]), dim=-1) & source_valid
    safe = torch.minimum(ijk.clamp_min(0), dims_d[None, :] - 1)
    lin = safe[:, 0] + dims_d[0] * (safe[:, 1] + dims_d[1] * safe[:, 2])
    row = torch.where(inb, lut_d[lin.long()], -1)
    row = torch.where(row < 0, ud, row)

    # 2. group same-cell sources into cell-pure GROUP-row groups; dead-window
    # sources sort to the tail and take no group.
    rs, order = torch.sort(row, stable=True)
    dead = rs == ud
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    starts = torch.ones(n, dtype=torch.bool, device=dev)
    starts[1:] = rs[1:] != rs[:-1]
    start_pos = torch.cummax(torch.where(starts, pos, -1), dim=0).values
    local = pos - start_pos
    gstart = (starts | (local % GROUP == 0)) & ~dead
    gid = torch.cumsum(gstart.to(torch.int32), dim=0, dtype=torch.int32) - 1
    dst = torch.where(dead, s_pad, gid * GROUP + local % GROUP).to(torch.int32)
    overflow = torch.sum(dst >= s_pad) - torch.sum(dead)

    meta = float(pack_row_meta(1, 0, n_lanes))
    src5 = torch.zeros((n + 1, 4), dtype=dtype, device=dev)
    src5[:n, :3] = source[order]
    src5[:n, 3] = meta
    # Inverse map + gather; unfilled slots gather the zero row.
    slot2src = torch.full((s_pad,), n, dtype=torch.int64, device=dev)
    keep = dst < s_pad
    slot2src[dst[keep].long()] = pos[keep].long()
    padded = src5[slot2src]
    step_rows = torch.full((ng,), ud, dtype=torch.int32, device=dev)
    gid_keep = ~dead & (gid < ng)
    step_rows[gid[gid_keep].long()] = rs[gid_keep].to(torch.int32)
    return padded, step_rows, order, dst, overflow


def _select_windows_plain(padded, cand_xyz, cand_idx, step_rows, width_lut,
                          *, k: int, kp: int, r2: float):
    """Plain PyTorch twin of the select kernel (same contract).

    Computes every row's window d2 with the kernel's rounding (one rounded
    op at a time: no FMA), masks dead lanes to 3e38, and stable-sorts along
    lanes, which yields exactly the (d2, lane) order.
    """
    s = padded.shape[0]
    n_lanes = cand_idx.shape[1]
    rows = step_rows.long().repeat_interleave(GROUP)  # (S,)
    cx = cand_xyz[rows, 0]  # (S, L)
    cy = cand_xyz[rows, 1]
    cz = cand_xyz[rows, 2]
    ci = cand_idx[rows]
    valid, lo, hi = _unpack_row_meta(padded[:, 3:4])
    dx = cx - padded[:, 0:1]
    dy = cy - padded[:, 1:2]
    dz = cz - padded[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    lane = torch.arange(n_lanes, device=padded.device)[None, :]
    live = (
        (ci >= 0) & valid & (d2 <= r2) & (d2 < _EMPTY_D)
        & (lane >= lo) & (lane < hi) & (lane < width_lut[rows][:, None])
    )
    d2 = torch.where(live, d2, _EMPTY_D)
    take = min(k, n_lanes)
    sd, lane_order = torch.sort(d2, dim=1, stable=True)
    sd, lane_order = sd[:, :take], lane_order[:, :take]
    hit = sd < _EMPTY_D

    def slots(src, empty):
        out = torch.full((s, kp), empty, dtype=src.dtype, device=src.device)
        out[:, :take] = torch.where(hit, torch.gather(src, 1, lane_order), empty)
        return out

    return slots(d2, _EMPTY_D), slots(ci, -1), tuple(slots(c, 0.0) for c in (cx, cy, cz))


def select_windows(padded, cand_xyz, cand_idx, step_rows, width_lut, *,
                   k: int, radius: float):
    """Per source row of ``padded``, the k nearest live candidates of its
    group's window (B1, the TPU kernel ``ops/fused_grid.py::_select_kernel``
    of the JAX package).

    Args:
      padded: (S, 4) float32 grouped sources; column 3 is the row meta.
      cand_xyz: (UD+1, 3, L) float32 window coordinates.
      cand_idx: (UD+1, L) int32 target ids; -1 marks a dead lane.
      step_rows: (S / GROUP,) int32 window row of each group.
      width_lut: (UD+1,) int32 lanes to scan per window.

    A lane is live when its id is >= 0, the row is valid, d2 <= r^2 and the
    lane lies in the row's segment [lo, hi). Returns (outd (S, kp) float32
    — 3e38 when empty, outi (S, kp) int32 — -1 when empty, (x, y, z)
    planes (S, kp) float32 — 0 when empty), slots in ascending (d2, lane)
    order; kp = 32 for k <= 32.

    A CPU tensor goes to the plain twin; a CUDA tensor launches the CUDA
    kernel (csrc/select_windows.cu: for k <= 32 the one-pass walk of
    csrc/window_select.cuh, which B4 runs too; for k > 32 a kernel of k
    rounds) or raises. ``select_windows.launches`` counts kernel launches.
    """
    if k < 1:
        raise ValueError(f"select_windows needs k >= 1, got {k}")
    kp = 32 if k <= 32 else round_up(k, 128)
    r2 = float(np.float32(radius) ** 2)
    dev = padded.device
    if dev.type == "cpu":
        return _select_windows_plain(
            padded, cand_xyz, cand_idx, step_rows, width_lut, k=k, kp=kp, r2=r2
        )
    s = padded.shape[0]
    n_lanes = cand_idx.shape[1]
    outd, outi, planes = _select_outputs(
        "select_windows", padded, cand_xyz, cand_idx, step_rows, width_lut, kp
    )
    if s == 0:
        return outd, outi, planes
    launch = kernels.load("select_windows")
    with torch.cuda.device(dev):
        err = launch(
            padded.data_ptr(), cand_xyz.data_ptr(), cand_idx.data_ptr(),
            step_rows.data_ptr(), width_lut.data_ptr(), outd.data_ptr(),
            outi.data_ptr(), *(p.data_ptr() for p in planes),
            s // GROUP, n_lanes, k, kp, ctypes.c_float(r2),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"select_windows kernel launch failed: CUDA error {err}")
    select_windows.launches += 1
    return outd, outi, planes


select_windows.launches = 0


def _select_outputs(name, padded, cand_xyz, cand_idx, step_rows, width_lut, kp):
    """Check a CUDA select launch's inputs (device, dtype, shape,
    contiguity; rows in whole groups) and allocate its (S, kp) outputs:
    (outd, outi, (x, y, z) planes). Raises ValueError on what the kernels
    do not take."""
    dev = padded.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {dev}")
    s = padded.shape[0]
    n_lanes = cand_idx.shape[1]
    n_win = cand_idx.shape[0]
    for arg, t, dtype, shape in (
        ("padded", padded, torch.float32, (s, 4)),
        ("cand_xyz", cand_xyz, torch.float32, (n_win, 3, n_lanes)),
        ("cand_idx", cand_idx, torch.int32, (n_win, n_lanes)),
        ("step_rows", step_rows, torch.int32, (s // GROUP,)),
        ("width_lut", width_lut, torch.int32, (n_win,)),
    ):
        if t.device != dev:
            raise ValueError(f"{arg} is on {t.device}, padded on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{arg} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{arg} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    if s % GROUP:
        raise ValueError(f"need rows % {GROUP} == 0 (rows={s})")
    outd = torch.empty((s, kp), dtype=torch.float32, device=dev)
    outi = torch.empty((s, kp), dtype=torch.int32, device=dev)
    planes = tuple(torch.empty((s, kp), dtype=torch.float32, device=dev) for _ in range(3))
    return outd, outi, planes


def _unsort_results(outd, outi, outp, order, dst, *, k, n, dtype):
    """Map select outputs (padded-row order) back to original source order.

    Returns (Correspondences, points (n, k, 3))."""
    s_pad = outd.shape[0]
    inv = torch.full((n,), s_pad, dtype=torch.int64, device=outd.device)
    inv[order] = torch.where(dst < s_pad, dst, s_pad).long()
    in_range = inv < s_pad
    inv_safe = torch.clamp_max(inv, s_pad - 1)
    d_rows = outd[inv_safe][:, :k]
    i_rows = outi[inv_safe][:, :k]
    found = (i_rows >= 0) & in_range[:, None]
    corr = Correspondences(
        indices=torch.where(found, i_rows, 0),
        sq_dists=torch.where(found, d_rows.to(dtype), 0.0),
        mask=found,
    )
    p_rows = torch.stack([o[inv_safe][:, :k] for o in outp], dim=-1)  # (n, k, 3)
    pts = torch.where(found[..., None], p_rows.to(dtype), 0.0)
    return corr, pts


def fused_grid_search(
    source,
    source_valid,
    cand_xyz,
    cand_idx,
    width_lut,
    lut_d,
    origin_d,
    dims_d,
    *,
    k: int,
    radius: float,
    n_lanes: int,
):
    """Radius-capped KNN via cell-grouped windows + the select kernel.

    Returns (Correspondences, overflow, points): ``overflow`` (0-d tensor)
    > 0 means the group-row budget (2N rows) overflowed and the caller must
    redo the iteration with another engine; ``points`` (N, k, 3) are the
    selected neighbors' coordinates, emitted by the select step so the
    caller needs no ``target[indices]`` gather.
    """
    n = source.shape[0]
    ud = cand_idx.shape[0] - 1  # last row is the dead window
    s_pad = round_up(2 * n, _ROW_ALIGN)
    padded, step_rows, order, dst, overflow = _group_by_window(
        source, source_valid, lut_d, origin_d, dims_d, ud, radius, s_pad,
        n_lanes=n_lanes,
    )
    outd, outi, outp = select_windows(
        padded.float(), cand_xyz.float(), cand_idx, step_rows, width_lut,
        k=k, radius=radius,
    )
    corr, pts = _unsort_results(
        outd, outi, outp, order, dst, k=k, n=n, dtype=source.dtype
    )
    return corr, overflow, pts
