"""Capacity-free pooled fused search: the sparse-scan (LiDAR) engine (port of
the JAX package's ``ops/fused_pool.py``).

The dense fused engine (ops/fused_grid.py) prepacks every dilated cell's
27-cell candidate window as one row of a single (UD, 3, L) table, L the
largest window. On sparse outdoor scans (131k points, mean cell occupancy
~2.5, near-sensor cells with 100+ returns) the largest union is ~10x the
typical one, and capacity-capped buckets leave a hot-cell overflow set.
This engine stores the windows in a few WIDTH-CLASS pools sized to each
window's real candidate union instead:

  1. windows are sorted by descending real union (the dilation's order),
     so each pow2 width band is a contiguous row range and becomes its own
     class;
  2. class c gets its own (n_c + 1, 3, W_c) pool, packed on the device
     from contiguous [start, start + count) ranges of the CELL-SORTED
     target: no bucket capacity, so hot-cell points stay inline and no
     overflow set exists. A pool row of a narrow class may pack F windows
     side by side (segment bands), each owning W_c / F lanes;
  3. per iteration, sources group into cell-pure 8-row blocks
     (:func:`_group_by_row`); pass c covers the first B_c groups only.
     Groups are sorted by pool row == descending width, so every class-c
     group lies in that prefix; a per-class budget with a coverage flag
     replaces dynamic shapes. Classes wider than the narrow-class cutoff
     (:func:`_select_max_w`: 0 on a CUDA device, so every class runs a
     kernel there) run a select kernel: B4 (``select_bitonic``) where it
     applies (pow2 width, k <= 32), else B1 (``select_windows``); narrower
     classes run the plain :func:`_xla_class_select`.

Neighbor sets equal the other engines'. Ties at the k-th slot follow the
engines' shared (d2, candidate lane) order.

The host half (``_plan_classes`` to ``pool_seed_host``) is the JAX
package's numpy, copied; :func:`plan_pool_host` runs it as one native pass
(``native/pool_plan.cpp``) when the library loads, with the numpy body as
its fallback and oracle. The device half is the JAX package's XLA code in
torch. JAX's ``.at[].set(..., mode="drop")`` drops out-of-range indices;
torch has no such mode, so :func:`_scatter_drop` sends them to a spare row.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.types import Correspondences, bucket_rows as _bucket_rows, pow2 as _pow2, round_up
from ..utils import spans
from .fused_grid import (
    BLOCK_GROUPS,
    GROUP,
    _BIG,
    _select_windows_plain,
    small_unions_of,
    _unsort_results,
    dilate_cells_host,
    pack_row_meta,
    select_windows,
)
from .select_bitonic import select_bitonic

# Widest pool class allowed. A window wider than this (a >4096-point union
# inside one 3x3x3 neighborhood) means the scan is locally dense, and the
# plan declines.
MAX_CLASS_LANES = 4096
# Total pool budget; beyond it the plan declines.
MAX_POOL_BYTES = 2 << 30
# Narrow-class cutoff on the CPU (see _select_max_w): classes at or below
# this lane count skip the kernel for a plain stable sort of their w-wide
# rows.
XLA_SELECT_MAX_W = 64
# Dead-window sort key for the packed (pool row << 9 | seg meta) keys.
_QMETA_DEAD = 0x7FFFFFFF
# The dead-lane coordinate: the JAX package's float32 1e30, also in a float64
# pool (it pads with ``jnp.asarray(np.float32(1e30), dtype)``).
_BIG_F32 = float(np.float32(_BIG))


def _select_max_w(device) -> int:
    """Narrow-class cutoff for the plain class select, by the run's device.

    Every class pass covers the group PREFIX [0, B_c). A kernel skips the
    out-of-class groups (their window has width 0) for almost nothing; the
    plain path pays its distance and sort work over the whole prefix. So a
    CUDA device runs every class through a kernel (0), and the CPU, where
    the "kernel" is the plain twin anyway, splits off the narrow classes
    (XLA_SELECT_MAX_W).
    """
    return 0 if torch.device(device).type == "cuda" else XLA_SELECT_MAX_W


class PoolPrepack(NamedTuple):
    """Per-pair pooled fused-search state (tensors on the run's device).

    Attributes:
      pool_xyz / pool_idx: per width class c, (R_c + 1, 3, W_c) candidate
        coordinates and (R_c + 1, W_c) int32 original target indices (-1 =
        empty); row R_c is the dead row. A pool row packs F consecutive
        windows side by side (F from the plan's segment bands), each owning
        a W_c // F-lane segment.
      select_xyz: ``pool_xyz`` as the select kernels read it, float32 (the
        same tensors in a float32 build).
      class_width_luts: per class c, (R_c + 1,) int32 class-local kernel
        widths (``width_lut`` over the class's rows, then the dead row's 0).
      class_widths: per-class lane widths, descending.
      class_ends: exclusive end POOL-ROW id of each class in the global
        width-sorted row numbering.
      class_budgets: per-class GROUP budgets (groups [0, B_c) are covered
        by pass c; the last class always covers every group).
      width_lut / union_lut: (R + 1,) int32 per-pool-row kernel width
        (lanes; dead row = 0) and largest real union over the row's windows.
      lut_d / origin_d / dims_d: extended-grid cell -> packed
        (pool row << 9 | segment meta) grouping key (-1 = no window).
      budget_rows: padded source-row budget for _group_by_row.
      n_dilated: UD.
      cell_size: float.
      small_unions: the JAX package's extraction-loop hint; here it only
        sets the narrow classes' block rounding in fused_pool_search.
      select_max_w: the narrow-class cutoff the plan was made with.
    """

    pool_xyz: tuple
    pool_idx: tuple
    select_xyz: tuple
    class_width_luts: tuple
    class_widths: tuple
    class_ends: tuple
    class_budgets: tuple
    width_lut: torch.Tensor
    union_lut: torch.Tensor
    lut_d: torch.Tensor
    origin_d: torch.Tensor
    dims_d: torch.Tensor
    budget_rows: int
    n_dilated: int
    cell_size: float
    small_unions: bool = False
    select_max_w: int | None = None


# -- host half (numpy, copied from the JAX package) --------------------------


def _plan_classes(union: np.ndarray) -> tuple[list[int], list[int]]:
    """Split width-sorted windows into <=3 width classes.

    ``union`` is the per-window real candidate count, DESCENDING. Returns
    (widths, ends): per-class lane widths and exclusive end rows.
    """
    ud = union.shape[0]
    w = (np.ceil(np.maximum(union, 1) / 128.0) * 128).astype(np.int64)
    l_max = _pow2(w[0]) if ud else 128
    widths = [l_max]
    if l_max > 512:
        widths.append(512)
    if l_max > 128:
        widths.append(128)
    ends = []
    for c, wc in enumerate(widths):
        nxt = widths[c + 1] if c + 1 < len(widths) else 0
        # Last window whose width exceeds the NEXT class's capacity belongs
        # to this class; w is non-increasing.
        ends.append(ud - int(np.searchsorted(w[::-1], nxt + 1, side="left")))
    ends[-1] = ud
    widths_out, ends_out, prev = [], [], 0
    for wc, e in zip(widths, ends):
        if e > prev:
            widths_out.append(int(wc))
            ends_out.append(int(e))
            prev = e
    return widths_out, ends_out


def _rows_for(cnt: np.ndarray, f: int) -> int:
    """Predicted padded SOURCE rows for packing windows with per-window
    source-count proxy ``cnt`` at segment factor ``f``: a pool row with
    per-segment counts n_0..n_{f-1} costs GROUP * max_i ceil(n_i / (GROUP//f))
    source rows."""
    gseg = GROUP // f
    pad = (-len(cnt)) % f
    c = np.concatenate([cnt, np.zeros(pad, cnt.dtype)]).reshape(-1, f)
    return int(GROUP * (-(-c // gseg)).max(axis=1).sum())


def _plan_segment_bands(
    union: np.ndarray, center: np.ndarray, widths: list[int], ends: list[int]
) -> list[list[tuple[int, int, int]]]:
    """Partition each width class's windows into SEGMENT bands.

    A band with segment factor F packs F consecutive windows side by side
    in each pool row of the class's lane width W, and the grouping gives
    each window GROUP//F source-row slots per group. F is chosen per run of
    equal F_max (W // pow2ceil(union), capped at GROUP and at W / 16) by
    minimizing the predicted source rows from the windows' center-cell
    target counts; ties prefer larger F.

    Returns, per class, a list of (w_assemble, F, n_real_windows) bands;
    w_assemble <= W//F is the real pow2 width the pool build gathers at.
    """
    out = []
    prev = 0
    for w_cls, e in zip(widths, ends):
        u = union[prev:e]
        cnt = center[prev:e]
        n = e - prev
        w_need = np.maximum(
            1, 1 << np.ceil(np.log2(np.maximum(u, 1))).astype(np.int64)
        )
        f_max = np.minimum(
            min(GROUP, max(w_cls // 16, 1)),
            w_cls // np.minimum(w_need, w_cls),
        )
        bands: list[tuple[int, int, int]] = []
        s0 = 0
        while s0 < n:
            fm = int(f_max[s0])
            s1 = int(np.searchsorted(f_max, fm, side="right"))
            # Windows in a band are re-sorted by descending count before
            # packing (plan_pool_host); evaluate on those counts.
            cnt_run = -np.sort(-cnt[s0:s1])
            best_f, best_rows = 1, None
            f = 1
            while f <= fm:
                r = _rows_for(cnt_run, f)
                if best_rows is None or r <= best_rows:
                    best_f, best_rows = f, r
                f *= 2
            wa = int(min(w_cls // best_f, _pow2(max(int(u[s0]), 1))))
            if bands and bands[-1][1] == best_f:
                pw, pf, pn = bands[-1]
                bands[-1] = (max(pw, wa), pf, pn + (s1 - s0))
            else:
                bands.append((wa, best_f, s1 - s0))
            s0 = s1
        if not bands:
            bands.append((w_cls, 1, 0))
        out.append(bands)
        prev = e
    return out


def _ladder_ends(union: np.ndarray, widths: list[int]) -> list[int] | None:
    """Bin width-sorted windows into a GIVEN descending pow2 width ladder.

    Window width = pow2(union) clipped up to the ladder's narrowest class.
    Returns the exclusive end rows (one per ladder class; empty classes
    keep a zero-size band, so that every shard shares the ladder), or None
    when some window is wider than the ladder's top class.
    """
    ud = union.shape[0]
    w = np.maximum(
        widths[-1],
        1 << np.ceil(np.log2(np.maximum(union, 1))).astype(np.int64),
    )
    if ud and int(w[0]) > widths[0]:
        return None
    ends = []
    for c in range(len(widths)):
        nxt = widths[c + 1] if c + 1 < len(widths) else 0
        ends.append(ud - int(np.searchsorted(w[::-1], nxt + 1, side="left")))
    ends[-1] = ud
    return ends


def plan_pool_host(
    grid_host: dict,
    target: np.ndarray,
    *,
    force: dict | None = None,
    select_max_w: int | None = None,
    device="cuda",
) -> dict | None:
    """Host-only half of the pool prepack.

    ``target`` is the (padded) target cloud the grid was built over (only
    its first ``num_valid`` rows are read). Returns None when the scan does
    not fit the engine: extended LUT too large, a window union beyond
    MAX_CLASS_LANES, or pools past MAX_POOL_BYTES.

    The plan is one native pass (:func:`_plan_pool_native`) when the
    library loads; the numpy body below is its fallback and the oracle it
    is held equal to.

    The narrow-class cutoff the class split derives from is
    ``select_max_w`` when given, else the one of ``device``
    (:func:`_select_max_w`).

    ``force`` sets every static dimension of the plan to given values, so
    that several plans share one layout (the target shards of
    ``parallel/pool_sharded.py``): ``widths`` (the class ladder; windows are
    then binned by pow2(union) clipped into it, :func:`_ladder_ends`),
    ``pad_sizes`` (padded rows per class, one F=1 band each),
    ``prod_d_pad``, ``prod_e_pad``, ``u_pad``, ``n_pad``, ``ud_b``. Each
    must cover this scan's own size (else None).
    """
    smw_plan = _select_max_w(device) if select_max_w is None else select_max_w
    plan = _plan_pool_native(grid_host, target, force, smw_plan)
    if plan is not None:
        return plan or None
    counts_full = grid_host["cell_count"].astype(np.int64)
    dil = dilate_cells_host(grid_host, counts=counts_full)
    if dil is None:
        return None
    nrows = dil["nrows"]  # (UD, 27), width-sorted
    union = dil["union"]
    if force is None:
        widths, ends = _plan_classes(union)
        if widths and widths[0] > MAX_CLASS_LANES:
            return None
    else:
        widths = list(force["widths"])
        if union.size and int(union.max()) > MAX_CLASS_LANES:
            return None

    n = grid_host["num_valid"]
    order = grid_host["sort_order"]
    # Cell-sorted target with the original index BITCAST into column 3.
    packed = np.empty((n + 1, 4), np.float32)
    packed[:n, :3] = np.asarray(target[:n])[order].astype(np.float32)
    packed[:n, 3] = order.astype(np.int32).view(np.float32)
    packed[n, :3] = _BIG
    packed[n, 3] = np.int32(-1).view(np.float32)

    # Pow2 sub-width classes. The split floor follows the cutoff: with a
    # plain narrow-class path (cutoff 64) narrow classes pay only their
    # real width; when every class runs a kernel (cutoff 0), a window of at
    # most 128 lanes costs the kernel one 128-lane pass anyway, so the
    # split stops at 128.
    if force is None:
        w_floor = 128 if smw_plan == 0 else 8
        w_pow2 = np.maximum(
            w_floor,
            1 << np.ceil(np.log2(np.maximum(union, 1))).astype(np.int64),
        )
        widths2, ends2 = [], []
        prev = 0
        for w_c, e_c in zip(widths, ends):
            cls_w = np.minimum(w_pow2[prev:e_c], w_c)
            s0 = 0
            while s0 < e_c - prev:
                sw = int(cls_w[s0])
                s1 = int(np.searchsorted(-cls_w, -sw, side="right"))
                widths2.append(sw)
                ends2.append(prev + s1)
                s0 = s1
            prev = e_c
        widths, ends = widths2, ends2
    else:
        # A forced ladder: pure pow2 binning; empty classes keep a zero-size
        # band so that every shard shares the class structure.
        ends = _ladder_ends(union, widths)
        if ends is None:
            return None

    # Segment bands, with band sizes bucketed (~25%) so the shapes repeat
    # across similar scans.
    ud = int(union.shape[0])
    sizes = np.diff([0] + ends).tolist()
    # Center-cell target count per window: the source-density proxy (offset
    # 13 of the (x slowest, z fastest) enumeration is (0, 0, 0)).
    counts_pad = np.concatenate([counts_full, [0]])
    center = np.where(
        nrows[:, 13] >= 0, counts_pad[np.maximum(nrows[:, 13], 0)], 0
    )
    if force is None:
        bands_real = _plan_segment_bands(union, center, widths, ends)
        band_layout = []  # per class: [(w_assemble, F, n_real, n_pad)]
        for bands_c in bands_real:
            layout = []
            for wa, f, nb in bands_c:
                floor = max(64, (1 << 20) // (16 * max(wa, 1)))
                layout.append((wa, f, nb, _bucket_rows(nb, floor, 3)))
            band_layout.append(layout)
        pad_sizes = [sum(b[3] for b in layout) for layout in band_layout]
    else:
        # One F=1 band per class at the forced size: the band structure
        # depends on the scan, and the shards must share one layout.
        pad_sizes = list(force["pad_sizes"])
        if any(p < s for p, s in zip(pad_sizes, sizes)):
            return None
        band_layout = [
            [(w, 1, s, p)] for w, s, p in zip(widths, sizes, pad_sizes)
        ]
    ends_pad = np.cumsum(pad_sizes).tolist()
    ud_pad = int(ends_pad[-1]) if ends_pad else 0
    pool_bytes = sum(
        (sum(b[3] // b[1] for b in layout) + 1) * w * 16
        for layout, w in zip(band_layout, widths)
    )
    if pool_bytes > MAX_POOL_BYTES:
        return None

    # Padded window numbering, pool-row numbering and per-window segment
    # meta: seg_lut packs (f, log2(GROUP//F), log2(W//F)) into one int32.
    row_vals = np.empty((ud,), np.int32)
    q_lut = np.zeros((ud_pad + 1,), np.int32)
    seg_lut = np.zeros((ud_pad + 1,), np.int32)
    row_width_parts, row_union_parts = [], []
    est_groups_total = 0
    cls_groups = []  # per class: estimated groups (floored counts)
    class_row_ends = []
    prev_real = 0
    pad_cursor = 0
    row_cursor = 0
    for w_cls, layout in zip(widths, band_layout):
        cls_g = 0
        for wa, f, nb, npad in layout:
            gseg = GROUP // f
            ws = w_cls // f
            # Descending count proxy inside an F > 1 band (balanced
            # F-tuples), width order otherwise.
            band_idx = np.arange(prev_real, prev_real + nb)
            if f > 1 and nb:
                band_idx = band_idx[
                    np.argsort(-center[band_idx], kind="stable")
                ]
            row_vals[band_idx] = pad_cursor + np.arange(nb, dtype=np.int32)
            p_local = np.arange(npad, dtype=np.int32)
            q_lut[pad_cursor : pad_cursor + npad] = row_cursor + p_local // f
            seg_lut[pad_cursor : pad_cursor + npad] = (
                (p_local % f)
                | (int(np.log2(gseg)) << 3)
                | (int(np.log2(ws)) << 5)
            )
            nr = npad // f
            u_band = np.zeros((npad,), np.int64)
            u_band[:nb] = union[band_idx]
            u_mat = u_band.reshape(nr, f)
            row_union_parts.append(u_mat.max(axis=1).astype(np.int32))
            # Per-row kernel width: lanes up to the highest live candidate
            # over the row's segments, rounded to 128 (dead rows -> 0).
            lane_off = (np.arange(f, dtype=np.int64) * ws)[None, :]
            top = np.where(u_mat > 0, lane_off + np.minimum(u_mat, ws), 0)
            row_width_parts.append(
                np.minimum(
                    (np.ceil(top.max(axis=1) / 128.0) * 128).astype(np.int32),
                    w_cls,
                )
            )
            # Group estimates from the center-count proxy: budgets floor
            # real windows at 1 (stray sources), the row budget does not.
            c_raw = np.zeros((npad,), np.int64)
            c_raw[:nb] = center[band_idx]
            est_groups_total += int(
                (-(-c_raw.reshape(nr, f) // gseg)).max(axis=1).sum()
            )
            c_fl = np.zeros((npad,), np.int64)
            c_fl[:nb] = np.maximum(center[band_idx], 1)
            cls_g += int((-(-c_fl.reshape(nr, f) // gseg)).max(axis=1).sum())
            prev_real += nb
            pad_cursor += npad
            row_cursor += nr
        cls_groups.append(cls_g)
        class_row_ends.append(row_cursor)
    n_rows_pad = row_cursor
    if n_rows_pad >= (1 << 22):
        return None  # packed (row << 9 | meta) keys need row ids < 2^22
    row_width_lut = np.concatenate(
        row_width_parts + [np.zeros((1,), np.int32)]
    )
    row_union_lut = np.concatenate(
        row_union_parts + [np.zeros((1,), np.int32)]
    )
    qmeta_vals = (q_lut[row_vals] << 9) | seg_lut[row_vals]

    # Row budget: 1.3x over the occupancy-predicted row count (the runtime
    # overflow flag guards drift).
    est_rows = GROUP * est_groups_total
    budget_rows = round_up(
        _bucket_rows(max(int(1.3 * est_rows), n), step_bits=3),
        2 * BLOCK_GROUPS * GROUP,
    )
    ng = budget_rows // GROUP

    # Per-class group budgets, 2x margin + floor; the last class spans every
    # group.
    budgets = []
    cum_groups = 0
    for c in range(len(widths)):
        cum_groups += cls_groups[c]
        if c == len(widths) - 1:
            budgets.append(ng)
        else:
            b = round_up(
                _bucket_rows(2 * cum_groups + 4 * BLOCK_GROUPS, 1024, 3),
                BLOCK_GROUPS,
            )
            budgets.append(min(ng, b))

    off_e = dil["off_e"]

    # Bucket-padded upload arrays. Sentinels: indices one past the pow2
    # scatter-table sizes (dropped), dead packed rows, and row_vals = ud_pad.
    u = int(dil["base_e"].shape[0])
    if force is None:
        prod_e_pad = _pow2(dil["prod_e"])
        prod_d_pad = _pow2(dil["prod_d"])
        u_pad = _bucket_rows(u, step_bits=3)
        n_pad = _bucket_rows(n + 1, step_bits=3)
        ud_b = _bucket_rows(ud, step_bits=3)
    else:
        prod_e_pad = force["prod_e_pad"]
        prod_d_pad = force["prod_d_pad"]
        u_pad = force["u_pad"]
        n_pad = force["n_pad"]
        ud_b = force["ud_b"]
        if (
            prod_e_pad < dil["prod_e"]
            or prod_d_pad < dil["prod_d"]
            or u_pad < u
            or n_pad < n + 1
            or ud_b < ud
        ):
            return None
    packed_pad = np.empty((n_pad + 1, 4), np.float32)
    packed_pad[: n + 1] = packed
    packed_pad[n + 1 :, :3] = _BIG
    packed_pad[n + 1 :, 3] = np.int32(-1).view(np.float32)

    def pad1(a, length, value):
        out = np.full((length,), value, a.dtype)
        out[: a.shape[0]] = a
        return out

    return {
        "dil": dil,
        "widths": widths,
        "ends": ends_pad,
        # Per-class band tuples (w_assemble, F, n_pad): the pool-row layout.
        "bands": tuple(
            tuple((wa, f, npad) for wa, f, _, npad in layout)
            for layout in band_layout
        ),
        "row_ends": class_row_ends,  # global pool-row ends per class
        "sizes_real": sizes,
        "packed": packed_pad,
        "row_vals": pad1(row_vals, ud_b, ud_pad),
        "d_cells": pad1(dil["d_cells"].astype(np.int32), ud_b, prod_d_pad),
        "d_cells_e": pad1(dil["d_cells_e"].astype(np.int32), ud_b, 0),
        "base_e": pad1(dil["base_e"].astype(np.int32), u_pad, prod_e_pad),
        "cell_start": pad1(
            grid_host["cell_start"].astype(np.int32), u_pad, n
        ),
        "cell_count": pad1(
            grid_host["cell_count"].astype(np.int32), u_pad, 0
        ),
        # POOL-ROW-indexed kernel width / union bounds.
        "width_lut": row_width_lut,
        "union_lut": row_union_lut,
        # Per real window: packed (pool row << 9 | seg meta) lut_d values.
        "qmeta_vals": pad1(qmeta_vals.astype(np.int32), ud_b, -1),
        "ud_pad": ud_pad,
        "n_rows_pad": n_rows_pad,
        "prod_d_pad": prod_d_pad,
        "prod_e_pad": prod_e_pad,
        "budgets": budgets,
        "budget_rows": budget_rows,
        "off_e": off_e,
        "cell_size": grid_host["cell_size"],
    }


def _plan_pool_native(grid_host: dict, target: np.ndarray, force: dict | None,
                      select_max_w: int) -> dict | bool | None:
    """:func:`plan_pool_host` as one native pass (``native.plan_pool``): the
    numpy body's plan bit for bit, False where it returns None, and None
    when the library is unavailable. Counts ``plan_native`` once per plan."""
    from .. import native as _native

    dims = grid_host["dims"].astype(np.int64)
    u = grid_host.get("num_cells", grid_host["cell_ids"].shape[0])
    n = grid_host["num_valid"]
    prod_d = int((dims + 2).prod())
    prod_e = int((dims + 4).prod())
    if force is None:
        pads = (_pow2(prod_e), _pow2(prod_d), _bucket_rows(u, step_bits=3),
                _bucket_rows(n + 1, step_bits=3))
        forced = None
    else:
        pads = (force["prod_e_pad"], force["prod_d_pad"], force["u_pad"], force["n_pad"])
        forced = (force["widths"], force["pad_sizes"], force["ud_b"])
    res = _native.plan_pool(
        grid_host["cell_ids"][:u], grid_host["cell_count"][:u], grid_host["cell_start"][:u],
        grid_host["sort_order"], np.asarray(target[:n]), dims, select_max_w=select_max_w,
        pads=pads, force=forced,
        consts=(GROUP, BLOCK_GROUPS, MAX_CLASS_LANES, MAX_POOL_BYTES, _BIG),
    )
    if not res:
        return res
    spans.count("plan_native")
    ud = res["ud"]
    dil = {
        "nrows": res["nrows"],
        "dims_d": (dims + 2).astype(np.int32),
        "origin_d": grid_host["origin"] - grid_host["cell_size"],
        "n_dilated": ud,
        "max_union": res["max_union"],
        "union": res["union_lut"][:ud],
        "width_lut": res["dil_width_lut"],
        "union_lut": res["union_lut"],
        "d_cells": res["d_cells"][:ud],
        "prod_d": prod_d,
        "d_cells_e": res["d_cells_e"][:ud],
        "base_e": res["base_e"][:u],
        "prod_e": prod_e,
        "e_dims": (int(dims[0] + 4), int(dims[1] + 4)),
        "off_e": res["off_e"],
    }
    return {
        "dil": dil,
        "widths": res["widths"],
        "ends": res["ends_pad"],
        "bands": res["bands"],
        "row_ends": res["row_ends"],
        "sizes_real": res["sizes_real"],
        "packed": res["packed"],
        "row_vals": res["row_vals"],
        "d_cells": res["d_cells"],
        "d_cells_e": res["d_cells_e"],
        "base_e": res["base_e"],
        "cell_start": res["cell_start"],
        "cell_count": res["cell_count"],
        "width_lut": res["width_lut"],
        "union_lut": res["row_union_lut"],
        "qmeta_vals": res["qmeta_vals"],
        "ud_pad": res["ud_pad"],
        "n_rows_pad": res["n_rows_pad"],
        "prod_d_pad": pads[1],
        "prod_e_pad": pads[0],
        "budgets": res["budgets"],
        "budget_rows": res["budget_rows"],
        "off_e": res["off_e"],
        "cell_size": grid_host["cell_size"],
    }


# Lane-width bins of a window, 2**0 .. MAX_CLASS_LANES lanes: a group's
# statics count each plan's windows by the exponent of pow2(union).
WIDTH_BINS = MAX_CLASS_LANES.bit_length()
# PoolStatics.sizes, in order: each a maximum over the group's plans.
STATIC_SIZES = ("prod_d_pad", "prod_e_pad", "u_pad", "n_pad", "ud_b")


class PoolStatics(NamedTuple):
    """What one shared layout (``plan_pool_host(force=)``) needs from a
    group's self-keyed plans, in a form that merges across groups
    (:func:`merge_pool_statics`) to the statics of their union.

    Attributes:
      widths: (WIDTH_BINS,) int64, 1 at log2 of every class width a plan
        uses: the ladder is their union.
      hist: (n_plans, WIDTH_BINS) int64, each plan's windows counted by
        the exponent of pow2(union): the ladder's per-class counts.
      sizes: (len(STATIC_SIZES),) int64, the padded sizes' maxima.
    """

    widths: np.ndarray
    hist: np.ndarray
    sizes: np.ndarray


def pool_group_statics(grids: list, targets: list, *, select_max_w: int | None = None,
                       device="cuda") -> PoolStatics | None:
    """The first half of :func:`plan_pool_host_group`: each scan's
    self-keyed plan, reduced to its statics. None when any member declines
    the pooled engine. The cutoff is ``select_max_w``, else ``device``'s."""
    widths = np.zeros(WIDTH_BINS, np.int64)
    hist = np.zeros((len(grids), WIDTH_BINS), np.int64)
    sizes = np.zeros(len(STATIC_SIZES), np.int64)
    for i, (g, t) in enumerate(zip(grids, targets)):
        p = plan_pool_host(g, t, select_max_w=select_max_w, device=device)
        if p is None:
            return None
        dil = p["dil"]
        for w in p["widths"]:
            widths[int(w).bit_length() - 1] = 1
        # The exponent _ladder_ends bins a window by (before its clip).
        e = np.ceil(np.log2(np.maximum(dil["union"], 1))).astype(np.int64)
        hist[i] = np.bincount(e, minlength=WIDTH_BINS)
        sizes = np.maximum(sizes, [
            _pow2(dil["prod_d"]), _pow2(dil["prod_e"]),
            _bucket_rows(int(dil["base_e"].shape[0])), p["packed"].shape[0] - 1,
            p["row_vals"].shape[0],
        ])
    return PoolStatics(widths, hist, sizes)


def merge_pool_statics(parts: list) -> PoolStatics:
    """The statics of several groups as one group's: the widths' union,
    every plan's counts, the sizes' maxima."""
    return PoolStatics(np.max([p.widths for p in parts], axis=0),
                       np.concatenate([p.hist for p in parts]),
                       np.max([p.sizes for p in parts], axis=0))


def pool_group_force(statics: PoolStatics) -> dict | None:
    """``plan_pool_host``'s ``force`` for a group: the ladder of every
    width its plans use, each class padded to the most real windows any
    plan bins into it (:func:`_ladder_ends`'s binning), the sizes' maxima.
    None when a window is wider than the ladder's top class."""
    exps = np.flatnonzero(statics.widths)[::-1]
    ladder = [1 << int(e) for e in exps]
    hist = statics.hist
    if exps.size and hist[:, exps[0] + 1:].any():
        return None
    # Class c holds the windows of exponents in (e_{c+1}, e_c]; the last
    # class also every narrower window (clipped up into it).
    below = np.cumsum(hist, axis=1)[:, exps]
    real = below - np.concatenate([below[:, 1:], np.zeros((len(hist), 1), np.int64)], axis=1)
    force = {
        "widths": tuple(ladder),
        "pad_sizes": tuple(
            int(_bucket_rows(int(real[:, c].max()), max(64, (1 << 20) // (16 * w))))
            for c, w in enumerate(ladder)
        ),
    }
    force.update((key, int(v)) for key, v in zip(STATIC_SIZES, statics.sizes))
    return force


def plan_pool_host_forced(grids: list, targets: list, force: dict, *,
                          select_max_w: int | None = None, device="cuda") -> list | None:
    """The second half of :func:`plan_pool_host_group`: every scan planned
    with ``force``. None when a member declines (the forced sizes do not
    cover it)."""
    out = []
    for g, t in zip(grids, targets):
        p = plan_pool_host(g, t, force=force, select_max_w=select_max_w, device=device)
        if p is None:
            return None
        out.append(p)
    return out


def plan_pool_host_group(grids: list, targets: list, *, select_max_w: int | None = None,
                         device="cuda") -> list | None:
    """Plan several scans with ONE shared static layout (the target shards
    of ``parallel/pool_sharded.py``): self-keyed plans first, then every
    scan again with ``force`` statics taken as maxima over the group.
    Returns the aligned plans, or None when any member declines the pooled
    engine. The cutoff is ``select_max_w``, else ``device``'s.

    The two halves (:func:`pool_group_statics`, then
    :func:`pool_group_force` and :func:`plan_pool_host_forced`) can run on
    parts of a group: the parts' merged statics give the whole group's
    ``force`` (``parallel/batch.py`` on a mesh).
    """
    kw = dict(select_max_w=select_max_w, device=device)
    statics = pool_group_statics(grids, targets, **kw)
    force = None if statics is None else pool_group_force(statics)
    return None if force is None else plan_pool_host_forced(grids, targets, force, **kw)


# -- sizing: the budgets of every pooled search (pair, batch, sharded) -------

# Margin over a replay's measured demand, rows and class groups alike.
DEMAND_MARGIN = 1.25
# The row budget's floor above the source's own rows.
SOURCE_ROW_SLACK = 4096
# The floor, per source row, of a row budget that no replay sized: target
# sharding thins per-window source occupancy toward 1, and a window holding
# s sources costs at most s + 7 rows.
UNDEMANDED_ROWS_PER_SOURCE = 8


class ReplayKeys(NamedTuple):
    """What :func:`pool_demand` reads of a plan (:meth:`of`) or of a shard's
    seeds; padded tails (cell id ``prod_d_pad``, key -1) drop out."""

    d_cells: np.ndarray
    qmeta_vals: np.ndarray
    prod_d_pad: int
    dims_d: np.ndarray
    origin_d: np.ndarray
    cell_size: float

    @classmethod
    def of(cls, plan: dict) -> "ReplayKeys":
        dil = plan["dil"]
        return cls(plan["d_cells"], plan["qmeta_vals"], plan["prod_d_pad"], dil["dims_d"],
                   dil["origin_d"], plan["cell_size"])


def pool_demand(pairs, class_row_ends=()) -> tuple[int, list]:
    """EXACT padded-row demand of ``_group_by_row`` over several
    ``(ReplayKeys, source)`` pairs: the most rows any pair demands, and per
    class c (``class_row_ends``: the pool-row ends per class) the most
    groups any pair has in classes <= c.

    A plan's row budget assumes sources land like targets; moved sources
    also fall in dilated shell cells whose center-count proxy is 0. This
    replays the grouping arithmetic in numpy: per (pool row, segment)
    source counts -> per row ``GROUP * max_i ceil(c_i / gseg)``.
    """
    rows, cum = 0, [0] * len(class_row_ends)
    for key, source in pairs:
        pts = np.asarray(source, dtype=np.float64)
        dims_d = np.asarray(key.dims_d, dtype=np.int64)
        ijk = np.floor((pts - np.asarray(key.origin_d)) / float(key.cell_size)).astype(np.int64)
        inb = np.all((ijk >= 0) & (ijk < dims_d), axis=1)
        lin = ijk[inb, 0] + dims_d[0] * (ijk[inb, 1] + dims_d[1] * ijk[inb, 2])
        lut = np.full(int(key.prod_d_pad) + 1, -1, np.int64)
        lut[key.d_cells] = key.qmeta_vals
        q = lut[lin]
        q = q[q >= 0]
        if q.size == 0:
            continue
        # Rows are the high bits, so unique's sorted output is row-contiguous.
        keys, counts = np.unique(q, return_counts=True)
        contrib = -(-counts // (1 << ((keys >> 3) & 3)))
        pool_rows = keys >> 9
        starts = np.flatnonzero(np.diff(pool_rows, prepend=pool_rows[0] - 1))
        per_row_max = np.maximum.reduceat(contrib, starts)
        rows = max(rows, int(GROUP * per_row_max.sum()))
        row_ids = pool_rows[starts]
        cum = [max(c, int(per_row_max[row_ids < int(e)].sum()))
               for c, e in zip(cum, class_row_ends)]
    return rows, cum


def estimate_pool_demand_rows(plan: dict, source: np.ndarray,
                              num_valid: int | None = None,
                              class_row_ends: tuple | None = None):
    """:func:`pool_demand` of one plan and the first ``num_valid`` rows of
    ``source``: the rows, or ``(rows, cum_groups)`` with ``class_row_ends``
    (the prepack's pool-row ends per class)."""
    n = num_valid if num_valid is not None else source.shape[0]
    rows, cum = pool_demand([(ReplayKeys.of(plan), source[:n])],
                            () if class_row_ends is None else class_row_ends)
    return rows if class_row_ends is None else (rows, cum)


def demand_row_budget(plan_rows: int, demand_rows: int) -> int:
    """The row budget at rung 0: the plans' own ``plan_rows``, raised to
    the replayed demand with its margin in ~25% buckets (per-pair demand
    jitters, and the budget is a static of the search)."""
    return max(int(plan_rows), _bucket_rows(int(DEMAND_MARGIN * demand_rows), step_bits=3))


def demand_class_budgets(
    cum_groups, last_budget: int, *, boost: int = 0, cap: int | None = None
) -> tuple:
    """Class-PREFIX budgets from a grouping replay's per-class cumulative
    group counts: the demand margin, ~25% buckets with a 1024-group floor,
    rounded to the block multiple and ``boost``-shifted so the overflow
    escalation raises the class budgets too. ``cap`` bounds each entry; the
    last class always gets ``last_budget``."""
    out = []
    for c in cum_groups[:-1]:
        b = round_up(
            _bucket_rows((int(DEMAND_MARGIN * c) << boost) + 4 * BLOCK_GROUPS, 1024, 3),
            BLOCK_GROUPS,
        )
        out.append(min(cap, b) if cap is not None else b)
    return tuple(out) + (last_budget,)


def plan_budgets(plans: list) -> tuple[int, tuple]:
    """Plans of one shared layout: their own row budget and class-prefix
    budgets, each the maximum over the plans."""
    return (max(int(p["budget_rows"]) for p in plans),
            tuple(int(b) for b in np.max([p["budgets"] for p in plans], axis=0)))


def small_unions_part(plan: dict, k: int, select_max_w: int) -> np.ndarray:
    """One plan's part of the small-unions hint, [sum of min(union, k),
    windows] over its kernel-class windows (union > ``select_max_w``):
    parts of distinct targets add, and ``fused_grid.small_unions_of``
    reads their sum."""
    u = plan["dil"]["union"]
    u = u[u > select_max_w]
    return np.array([np.minimum(u, k).sum(), u.size], np.int64)


def search_budgets(base_rows: int, source_rows: int, *, class_budgets: tuple | None = None,
                   cum_groups=None, boost: int = 0, row_step: int = 2 * BLOCK_GROUPS * GROUP,
                   demand_sized: bool = True, inflate: bool = False) -> tuple[int, tuple]:
    """The pooled search's ``(budget_rows, class_budgets)`` at rung ``boost``.

    Rows: ``base_rows`` floored at ``source_rows`` + SOURCE_ROW_SLACK (at
    UNDEMANDED_ROWS_PER_SOURCE x ``source_rows`` when no replay sized
    ``base_rows``), doubled per rung with the floor (the floor may
    dominate), rounded up to ``row_step``. Classes: the last spans every
    group; the others are a replay's ``cum_groups`` margined at the rung,
    or the rung-0 ``class_budgets``, grown with the rows over ``base_rows``
    when ``inflate``; none exceeds the last.
    """
    floor = (source_rows + SOURCE_ROW_SLACK if demand_sized
             else UNDEMANDED_ROWS_PER_SOURCE * source_rows)
    budget = round_up(max(base_rows, floor) << boost, row_step)
    ng = round_up(budget, 2 * BLOCK_GROUPS * GROUP) // GROUP
    if cum_groups is not None:
        return budget, demand_class_budgets(cum_groups, ng, boost=boost, cap=ng)
    scale = max(1, -(-budget // max(base_rows, 1))) if inflate else 1
    return budget, tuple(
        min(ng, round_up(b * scale, BLOCK_GROUPS)) for b in class_budgets[:-1]) + (ng,)


def pool_seed_host(plan: dict, dtype=np.float32) -> dict:
    """The pool prepack's upload dict (host numpy): what
    :func:`_build_pools` derives the rest from."""
    dil = plan["dil"]
    return {
        "packed": plan["packed"],
        "cell_start": plan["cell_start"],
        "cell_count": plan["cell_count"],
        "base_e": plan["base_e"],
        "d_cells_e": plan["d_cells_e"],
        "off_e": plan["off_e"],
        "row_vals": plan["row_vals"],
        "dims_d": dil["dims_d"],
        "origin_d": dil["origin_d"].astype(dtype),
    }


# -- device half --------------------------------------------------------------


def _scatter_drop(index: torch.Tensor, values: torch.Tensor, size: int, fill=-1):
    """``full((size, *values.shape[1:]), fill).at[index].set(values,
    mode="drop")``: entries whose index is outside [0, size) are dropped.

    They land in a spare row past the end instead of being masked out, so
    that no output shape depends on the data (a boolean mask would cost a
    host sync on a card)."""
    out = torch.full(
        (size + 1,) + tuple(values.shape[1:]), fill, dtype=values.dtype,
        device=values.device,
    )
    keep = (index >= 0) & (index < size)
    out[torch.where(keep, index, size).long()] = values
    return out[:size]


def _scatter_lut(d_cells: torch.Tensor, row_vals: torch.Tensor, *, prod_d: int):
    """Dense extended-grid cell -> window key; pad entries carry
    out-of-range cell ids and are dropped."""
    return _scatter_drop(d_cells, row_vals.to(torch.int32), prod_d)


def _neighbor_rows(base_e, d_cells_e, off_e, *, prod_e: int):
    """Device rebuild of the (UD, 27) neighbor-row table.

    ``base_e`` are the occupied cells' double-extended linear ids,
    ``d_cells_e`` the width-sorted dilated cells' ids in the same space, and
    ``off_e`` the 27 linear neighbor offsets (x slowest, z fastest — the
    shared engine tie order). The double-extended border ring makes every
    ``d_cells_e + off_e`` in bounds by construction.
    """
    u = base_e.shape[0]
    occ = _scatter_drop(
        base_e, torch.arange(u, dtype=torch.int32, device=base_e.device), prod_e
    )
    return occ[(d_cells_e[:, None] + off_e[None, :]).long()]


def _pool_block(n_rows: int, w_c: int) -> int:
    """Rows per chunk of the pool assembly (bounds its (B, W) transients)."""
    return max(1, min(n_rows, (1 << 22) // max(w_c, 1)))


def _assemble_pool_class(packed_i, cell_start, cell_count, nrows_c, *, w_c: int):
    """Pack one band's candidate windows from the cell-sorted target.

    ``packed_i`` is the (Np + 1, 4) cell-sorted target viewed as int32: xyz
    float bits in columns 0-2, the original index in column 3, row Np the
    dead sentinel. Only integer gathers touch it, so the index column
    (whose bits are denormal or NaN as floats) is never float arithmetic.
    Window slots follow (neighbor-offset, within-cell) order, the tie order
    of every engine.

    Returns ``nrows_c.shape[0]`` window rows at lane width ``w_c``, built in
    chunks of :func:`_pool_block` rows.
    """
    npts = packed_i.shape[0] - 1
    n_c = nrows_c.shape[0]
    dev = packed_i.device
    block = _pool_block(n_c, w_c)
    p = torch.arange(w_c, dtype=torch.int32, device=dev)[None, :]
    xyz_parts, idx_parts = [], []
    for b0 in range(0, n_c, block):
        nrows_blk = nrows_c[b0 : b0 + block]
        safe = nrows_blk.clamp_min(0).long()
        cnt = torch.where(nrows_blk >= 0, cell_count[safe], 0)  # (B, 27)
        starts = torch.cumsum(cnt, dim=1, dtype=torch.int32) - cnt
        total = torch.sum(cnt, dim=1, dtype=torch.int32)
        base = cell_start[safe]  # (B, 27)
        # Packed slot p belongs to the LAST neighbor j with start_j <= p
        # (empty cells never own a slot: the next neighbor shares their
        # start).
        ssel = torch.zeros((nrows_blk.shape[0], w_c), dtype=torch.int32, device=dev)
        bsel = torch.zeros_like(ssel)
        for j in range(27):
            upd = starts[:, j : j + 1] <= p
            ssel = torch.where(upd, starts[:, j : j + 1], ssel)
            bsel = torch.where(upd, base[:, j : j + 1], bsel)
        live = p < total[:, None]
        pos = torch.where(live, bsel + (p - ssel), npts)
        raw = packed_i[pos.long()]  # (B, W, 4) int32
        xyz_parts.append(raw[..., :3].permute(0, 2, 1).contiguous().view(torch.float32))
        idx_parts.append(raw[..., 3])
    if not xyz_parts:
        return (
            torch.empty((0, 3, w_c), dtype=torch.float32, device=dev),
            torch.empty((0, w_c), dtype=torch.int32, device=dev),
        )
    return torch.cat(xyz_parts), torch.cat(idx_parts)


def _build_pools(dev: dict, plan: dict, dtype: torch.dtype):
    """The device half of the pool prepack.

    ``dev`` is :func:`pool_seed_host` on the device (``packed`` as int32
    bits). The search-grid cell ids, the packed (pool row << 9 | seg meta)
    grouping keys and the per-pool-row width / union bounds are derived
    here from the seeds, as the JAX package's ``_build_pools`` does; the
    host plan keeps its own copies. Returns (pool_xyz tuple, pool_idx
    tuple, lut_d, width_lut, union_lut).
    """
    widths, ends = plan["widths"], plan["ends"]
    prod_d, prod_e = plan["prod_d_pad"], plan["prod_e_pad"]
    build_bands = plan["bands"]
    device = dev["packed"].device
    ud_pad = ends[-1] if ends else 0
    i32 = dict(dtype=torch.int32, device=device)

    # d_cells (the (+2)-extended search grid's ids) from the double-extended
    # ids; the 0-padded tail maps to the dropped sentinel prod_d.
    dims_d = [int(v) for v in plan["dil"]["dims_d"]]
    e0, e1 = dims_d[0] + 2, dims_d[1] + 2
    d_cells_e = dev["d_cells_e"]
    xe = d_cells_e % e0
    re_ = d_cells_e // e0
    ye = re_ % e1
    ze = re_ // e1
    d_cells = torch.where(
        d_cells_e > 0,
        (xe - 1) + dims_d[0] * ((ye - 1) + dims_d[1] * (ze - 1)),
        prod_d,
    )

    # Per-pad-position q_lut / seg_lut from the band layout, gathered with
    # row_vals into the packed grouping keys.
    q_parts, s_parts = [], []
    row_cursor = 0
    for w_cls, layout in zip(widths, build_bands):
        for _wa, f, npad in layout:
            gseg = GROUP // f
            ws = w_cls // f
            p_local = torch.arange(npad, **i32)
            q_parts.append(row_cursor + p_local // f)
            s_parts.append(
                (p_local % f)
                | (int(np.log2(gseg)) << 3)
                | (int(np.log2(ws)) << 5)
            )
            row_cursor += npad // f
    zero1 = torch.zeros((1,), **i32)
    q_lut = torch.cat(q_parts + [zero1])
    seg_lut = torch.cat(s_parts + [zero1])
    row_vals = dev["row_vals"].long()
    qmeta_vals = (q_lut[row_vals] << 9) | seg_lut[row_vals]
    lut_d = _scatter_lut(d_cells, qmeta_vals, prod_d=prod_d)

    nrows_real = _neighbor_rows(dev["base_e"], d_cells_e, dev["off_e"], prod_e=prod_e)
    nrows_dev = _scatter_drop(dev["row_vals"], nrows_real, ud_pad)

    # Per-pool-row kernel width / union bounds from the real unions (sum of
    # the 27 neighbor cells' counts; band tails are dead rows).
    cell_count = dev["cell_count"]
    u_padded = torch.sum(
        torch.where(nrows_dev >= 0, cell_count[nrows_dev.clamp_min(0).long()], 0),
        dim=1, dtype=torch.int32,
    )
    w_parts, u_parts = [], []
    pad_cursor = 0
    for w_cls, layout in zip(widths, build_bands):
        for _wa, f, npad in layout:
            ws = w_cls // f
            u_mat = u_padded[pad_cursor : pad_cursor + npad].reshape(npad // f, f)
            u_parts.append(u_mat.max(dim=1).values)
            lane_off = (torch.arange(f, **i32) * ws)[None, :]
            top = torch.where(u_mat > 0, lane_off + torch.clamp_max(u_mat, ws), 0)
            w_parts.append(
                torch.clamp_max((top.max(dim=1).values + 127) // 128 * 128, w_cls)
            )
            pad_cursor += npad
    width_lut = torch.cat(w_parts + [zero1])
    union_lut = torch.cat(u_parts + [zero1])

    pool_xyz, pool_idx = [], []
    prev = 0
    for c, w_c in enumerate(widths):
        parts_xyz, parts_idx = [], []
        off = 0
        for w_b, f, nb in build_bands[c]:
            xyz, idx = _assemble_pool_class(
                dev["packed"], dev["cell_start"], cell_count,
                nrows_dev[prev + off : prev + off + nb], w_c=w_b,
            )
            # Pad lanes up to the segment width, then pack F windows per
            # pool row (window i of a row owns lanes [i*W/F, (i+1)*W/F)).
            ws = w_c // f
            xyz = torch.nn.functional.pad(xyz.to(dtype), (0, ws - w_b), value=_BIG_F32)
            idx = torch.nn.functional.pad(idx, (0, ws - w_b), value=-1)
            if f > 1:
                nr = nb // f
                xyz = xyz.reshape(nr, f, 3, ws).permute(0, 2, 1, 3).reshape(nr, 3, w_c)
                idx = idx.reshape(nr, w_c)
            parts_xyz.append(xyz)
            parts_idx.append(idx)
            off += nb
        # The dead pool row.
        parts_xyz.append(torch.full((1, 3, w_c), _BIG_F32, dtype=dtype, device=device))
        parts_idx.append(torch.full((1, w_c), -1, **i32))
        pool_xyz.append(torch.cat(parts_xyz).contiguous())
        pool_idx.append(torch.cat(parts_idx).contiguous())
        prev = ends[c]
    return tuple(pool_xyz), tuple(pool_idx), lut_d, width_lut, union_lut


def build_pool_prepack(
    grid_host: dict,
    target: np.ndarray,
    dtype=np.float32,
    plan: dict | None = None,
    k: int = 20,
    select_max_w: int | None = None,
    device="cuda",
) -> PoolPrepack | None:
    """Build the pooled fused-search state (host plan + device packing) on
    ``device``. Pass a precomputed ``plan`` (:func:`plan_pool_host`) to skip
    the host half; it must have been made for the same cutoff."""
    if plan is None:
        plan = plan_pool_host(
            grid_host, target, select_max_w=select_max_w, device=device
        )
    if plan is None:
        return None
    dil = plan["dil"]
    smw = _select_max_w(device) if select_max_w is None else select_max_w
    seeds = pool_seed_host(plan, dtype)
    dev = {
        key: torch.as_tensor(np.ascontiguousarray(val), device=device)
        for key, val in seeds.items()
        if key != "packed"
    }
    # The packed target travels as int32 bits: its index column must never
    # pass through float conversion.
    dev["packed"] = torch.as_tensor(seeds["packed"].view(np.int32), device=device)
    torch_dtype = getattr(torch, np.dtype(dtype).name)
    pool_xyz, pool_idx, lut_d, width_lut, union_lut = _build_pools(
        dev, plan, torch_dtype
    )
    return PoolPrepack(
        pool_xyz=pool_xyz,
        pool_idx=pool_idx,
        class_widths=tuple(plan["widths"]),
        class_ends=tuple(plan["row_ends"]),
        class_budgets=tuple(plan["budgets"]),
        width_lut=width_lut,
        union_lut=union_lut,
        lut_d=lut_d,
        origin_d=dev["origin_d"],
        dims_d=dev["dims_d"],
        budget_rows=plan["budget_rows"],
        n_dilated=dil["n_dilated"],
        cell_size=plan["cell_size"],
        small_unions=small_unions_of(small_unions_part(plan, k, smw), k),
        select_max_w=smw,
        select_xyz=tuple(p.float().contiguous() for p in pool_xyz),
        class_width_luts=tuple(
            torch.cat([width_lut[lo:hi], width_lut.new_zeros(1)])
            for lo, hi in zip((0,) + tuple(plan["row_ends"][:-1]), plan["row_ends"])
        ),
    )


def _group_by_row(source, source_valid, lut_d, origin_d, dims_d,
                  n_rows, radius, s_pad: int):
    """Segment-aware grouping: map each source to its window's POOL ROW and
    sort same-row sources into GROUP-row blocks with per-window slot ranges.

    A pool row packs F windows; window f of a row owns GROUP//F row slots
    per group, and the row's group count is the max over its windows of
    ceil(n_sources / (GROUP//F)). ``lut_d`` values are packed
    (pool row << 9) | (f | log2(GROUP//F) << 3 | log2(W//F) << 5), so they
    sort pool-row-major and the windows of one row stay distinct runs.

    Returns (padded, step_rows, order, dst, overflow):
      padded: (s_pad, 4) sorted sources, xyz + the packed row meta in
        column 3 (valid flag + segment lane bounds, fused_grid.pack_row_meta).
      step_rows: (s_pad // GROUP,) int32 POOL ROW per group (n_rows = dead).
      order / dst: sort permutation and padded-row slots (for unsorting).
      overflow: 0-d count of sources past the ``s_pad`` budget.
    """
    n = source.shape[0]
    dtype = source.dtype
    dev = source.device
    ng = s_pad // GROUP
    cell = torch.tensor(radius, dtype=dtype, device=dev)

    # 1. source cell -> packed (pool row, segment meta). The clamp before
    # the cast keeps far-away sources out of range, not wrapped.
    ijk = torch.floor((source - origin_d.to(dtype)) / cell)
    ijk = ijk.clamp(-(2**30), 2**30).to(torch.int32)
    inb = torch.all((ijk >= 0) & (ijk < dims_d[None, :]), dim=-1) & source_valid
    safe = torch.minimum(ijk.clamp_min(0), dims_d[None, :] - 1)
    lin = safe[:, 0] + dims_d[0] * (safe[:, 1] + dims_d[1] * safe[:, 2])
    qmeta = torch.where(inb, lut_d[lin.long()], -1)
    qmeta = torch.where(qmeta < 0, _QMETA_DEAD, qmeta)

    # 2. one stable sort gives the permutation and the sorted keys;
    # dead-window sources sort to the tail and take no row.
    rs, order = torch.sort(qmeta, stable=True)
    dead = rs == _QMETA_DEAD
    qs = torch.where(dead, n_rows, rs >> 9)
    meta = rs & 511
    f = meta & 7
    lgseg = (meta >> 3) & 3
    lws = meta >> 5
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    starts = torch.ones(n, dtype=torch.bool, device=dev)
    starts[1:] = rs[1:] != rs[:-1]
    start_pos = torch.cummax(torch.where(starts, pos, -1), dim=0).values
    local = pos - start_pos  # position within the window's run
    gw = local >> lgseg  # group index within the pool row
    one = torch.ones_like(meta)

    # 3. groups per pool row = max over its windows of gw + 1, reached at
    # the row's last source: a running max segmented by pool row. The
    # segment id in the high bits makes one cummax do it (gw + 1 < 2^30,
    # segments in sorted order). Each row's group base is the exclusive
    # cumsum of those counts, so group ids stay ordered by pool row.
    row_starts = torch.ones(n, dtype=torch.bool, device=dev)
    row_starts[1:] = qs[1:] != qs[:-1]
    seg_id = torch.cumsum(row_starts, dim=0) - 1
    run = torch.cummax((seg_id << 30) | (gw + 1).to(torch.int64), dim=0).values
    row_run_max = (run & ((1 << 30) - 1)).to(torch.int32)
    row_ends = torch.ones(n, dtype=torch.bool, device=dev)
    row_ends[:-1] = qs[1:] != qs[:-1]
    contrib = torch.where(row_ends, row_run_max, 0)
    gid = (torch.cumsum(contrib, dim=0, dtype=torch.int32) - contrib) + gw
    slot = (f << lgseg) + (local & ((one << lgseg) - 1))
    dst = torch.where(dead, s_pad, gid * GROUP + slot)
    overflow = torch.sum(dst >= s_pad) - torch.sum(dead)

    lo = f << lws
    rmeta = pack_row_meta(one, lo, lo + (one << lws)).to(dtype)
    src5 = torch.zeros((n + 1, 4), dtype=dtype, device=dev)
    src5[:n, :3] = source[order]
    src5[:n, 3] = rmeta
    # Inverse map + gather; unfilled slots gather row n = zeros (invalid).
    slot2src = _scatter_drop(dst, pos, s_pad, fill=n)
    padded = src5[slot2src.long()]
    step_rows = _scatter_drop(torch.where(dead, ng, gid), qs, ng, fill=n_rows)
    return padded, step_rows, order, dst, overflow


def _xla_class_select(padded, pool_xyz, pool_idx, rows, width_lut, *, k, radius):
    """The narrow-class select in plain PyTorch (the JAX package's
    ``_xla_class_select``, XLA distances + a stable ``lax.top_k``).

    Same contract as the select kernels and the same (d2, lane) slot order,
    reading the class's windows through ``rows``; for w <= k no selection
    happens at all (every in-radius candidate is a neighbor).
    """
    kp = 32 if k <= 32 else round_up(k, 128)
    r2 = float(np.float32(radius) ** 2)
    return _select_windows_plain(
        padded, pool_xyz, pool_idx, rows, width_lut, k=k, kp=kp, r2=r2
    )


def fused_pool_search(
    source,
    source_valid,
    select_xyz,
    pool_idx,
    class_width_luts,
    lut_d,
    origin_d,
    dims_d,
    *,
    k: int,
    radius: float,
    class_widths: tuple,
    class_ends: tuple,
    class_budgets: tuple,
    budget_rows: int,
    small_unions: bool = False,
    select_max_w: int | None = None,
):
    """Radius-capped KNN via width-class pools + the select kernels.

    Returns (Correspondences, overflow, points (N, k, 3)); ``overflow``
    (0-d tensor) > 0 when the row budget or a class-prefix budget was
    exceeded, and the caller must redo the iteration. ``select_xyz``,
    ``pool_idx`` and ``class_width_luts`` are the prepack's per-class
    float32 pools, ids and class-local width tables; ``class_ends`` is in
    the POOL-ROW numbering and ``lut_d`` holds the packed grouping keys
    (the JAX package's ``union_lut`` argument only bounds its kernel's loop
    and is not taken). ``select_max_w`` is the prepack's narrow-class
    cutoff (None: the source's device decides). ``small_unions`` is the
    prepack's hint, which sets the block rounding of the narrow kernel
    classes' budgets as in the JAX package.

    Each class pass takes :func:`class_select`'s select; every route gives
    the same slots.
    """
    smw = _select_max_w(source.device) if select_max_w is None else select_max_w
    passes, order, dst, overflow = class_passes(
        source, source_valid, select_xyz, pool_idx, class_width_luts, lut_d,
        origin_d, dims_d, radius=radius, class_widths=class_widths,
        class_ends=class_ends, class_budgets=class_budgets,
        budget_rows=budget_rows, small_unions=small_unions, select_max_w=smw,
    )
    class_results = [
        (b_c, class_select(w_c, k, smw)(*args, k=k, radius=radius))
        for w_c, b_c, args in passes
    ]
    corr, pts = overlay_classes(class_results, order, dst, k=k, n=source.shape[0],
                                dtype=source.dtype)
    return corr, overflow, pts


def class_select(w_c: int, k: int, select_max_w: int):
    """The select of a width-``w_c`` class pass: the plain
    :func:`_xla_class_select` at or below the cutoff; above it B4
    (``select_bitonic``) where it applies (pow2 width, k <= 32, the JAX
    package's ``select_impl="bitonic"`` rule), else B1
    (``select_windows``)."""
    if w_c <= select_max_w:
        return _xla_class_select
    if k <= 32 and w_c & (w_c - 1) == 0:
        return select_bitonic
    return select_windows


def overlay_classes(class_results, order, dst, *, k: int, n: int, dtype):
    """Combine the class passes' select outputs and map them back to source
    order: (Correspondences, points (n, k, 3)).

    ``class_results`` is [(B_c, (outd, outi, (outx, outy, outz)))] in class
    order. The last class spans the whole budget, and every select emits
    exactly (3e38, -1, 0) on rows outside its class, so the classes'
    disjoint rows combine with an elementwise min / max / add.
    """
    b_last, (outd, outi, outp) = class_results[-1]
    assert b_last * GROUP == outd.shape[0]
    for b_c, (rd, ri, rp) in class_results[:-1]:
        n_r = b_c * GROUP
        outd[:n_r] = torch.minimum(outd[:n_r], rd)
        outi[:n_r] = torch.maximum(outi[:n_r], ri)
        for o, r in zip(outp, rp):
            o[:n_r] += r
    return _unsort_results(outd, outi, outp, order, dst, k=k, n=n, dtype=dtype)


def class_passes(source, source_valid, select_xyz, pool_idx, class_width_luts,
                 lut_d, origin_d, dims_d, *, radius: float, class_widths: tuple,
                 class_ends: tuple, class_budgets: tuple, budget_rows: int,
                 small_unions: bool = False, select_max_w: int):
    """The grouping and the class passes of :func:`fused_pool_search`.

    Returns (passes, order, dst, overflow): ``passes[c]`` is (W_c, B_c,
    select inputs), the inputs being the padded rows of groups [0, B_c),
    class c's float32 pool and ids, each group's class-local pool row and
    the class-local width table (the argument order of ``select_windows``);
    ``overflow`` counts the sources past the row budget plus one for each
    class whose budget misses a group of its own.
    """
    n_rows = class_ends[-1]
    s_pad = round_up(budget_rows, 2 * BLOCK_GROUPS * GROUP)
    ng = s_pad // GROUP
    padded, step_rows, order, dst, overflow = _group_by_row(
        source, source_valid, lut_d, origin_d, dims_d, n_rows, radius, s_pad
    )
    padded = padded.float()
    passes = []
    prev_end = 0
    for c, (w_c, e_c, b_c) in enumerate(zip(class_widths, class_ends, class_budgets)):
        # Narrow kernel classes of a small-union pool round their budget to
        # 32-group blocks in the JAX package; the rounding decides the
        # coverage flag below, so it is kept.
        bg = (
            2 * BLOCK_GROUPS
            if small_unions and select_max_w < w_c <= 256
            else BLOCK_GROUPS
        )
        # The last class always covers every group.
        if c == len(class_widths) - 1:
            b_c = ng
        b_c = min(round_up(b_c, bg), ng)
        # Each group's class-local pool row; n_c, the class's dead row,
        # for groups of other classes.
        rows_c = step_rows[:b_c]
        in_class = (rows_c >= prev_end) & (rows_c < e_c)
        local = torch.where(in_class, rows_c - prev_end, e_c - prev_end).to(torch.int32)
        passes.append((w_c, b_c, (
            padded[: b_c * GROUP], select_xyz[c], pool_idx[c], local,
            class_width_luts[c],
        )))
        # Coverage: groups are sorted by row (descending width), so a
        # class-<=c group past this class's budget means a missed group.
        if b_c < ng:
            overflow = overflow + (step_rows[b_c] < e_c).to(overflow.dtype)
        prev_end = e_c
    return passes, order, dst, overflow


# -- a batch of pairs (parallel/batch.py) -------------------------------------


def batched_class_passes(sources, source_valid, select_xyz, pool_idx, class_width_luts,
                         lut_d, origin_d, dims_d, *, radius: float, class_widths: tuple,
                         class_ends: tuple, class_budgets: tuple, budget_rows: int,
                         small_unions: bool = False, select_max_w: int):
    """:func:`class_passes` for B pairs whose pools share one static layout
    (:func:`plan_pool_host_group`): every pair has the same class widths,
    class ends and budgets, so its class pass c has the same row count.

    ``sources`` (B, N, 3), ``source_valid`` (B, N); per class c,
    ``select_xyz[c]`` (B, R_c + 1, 3, W_c), ``pool_idx[c]`` (B, R_c + 1, W_c)
    and ``class_width_luts[c]`` (B, R_c + 1), contiguous; ``lut_d`` (B, P),
    ``origin_d`` / ``dims_d`` (B, 3).

    The grouping and the coverage flag run per pair. Class pass c of the
    batch is then ONE set of select inputs, the JAX package's ``vmap`` of
    the class select written out: the pairs' pools and width tables viewed
    as one table of B (R_c + 1) rows (pair b's rows from b (R_c + 1), its
    dead row included), the pairs' padded rows stacked, and each group's
    class-local row shifted by its pair's offset. The selected ids stay
    pair-local: each pair's ``pool_idx`` holds its own target's ids.

    Returns (passes, orders, dsts, overflow): ``passes[c]`` is (W_c, B_c,
    select inputs over B * B_c groups), ``orders`` / ``dsts`` each pair's
    unsort maps, ``overflow`` (B,) each pair's count.
    """
    n_pairs = sources.shape[0]
    per_pair = [
        class_passes(
            sources[b], source_valid[b], [x[b] for x in select_xyz], [x[b] for x in pool_idx],
            [x[b] for x in class_width_luts], lut_d[b], origin_d[b], dims_d[b],
            radius=radius, class_widths=class_widths, class_ends=class_ends,
            class_budgets=class_budgets, budget_rows=budget_rows,
            small_unions=small_unions, select_max_w=select_max_w,
        )
        for b in range(n_pairs)
    ]
    passes = []
    for c, w_c in enumerate(class_widths):
        b_c = per_pair[0][0][c][1]
        n_c = select_xyz[c].shape[1]  # R_c + 1 rows a pair
        padded = torch.cat([p[0][c][2][0] for p in per_pair])
        rows = torch.cat([p[0][c][2][3] + b * n_c for b, p in enumerate(per_pair)])
        passes.append((w_c, b_c, (
            padded, select_xyz[c].view(n_pairs * n_c, 3, -1),
            pool_idx[c].view(n_pairs * n_c, -1), rows, class_width_luts[c].view(-1),
        )))
    overflow = torch.stack([p[3] for p in per_pair])
    return passes, [p[1] for p in per_pair], [p[2] for p in per_pair], overflow


def batched_fused_pool_search(sources, source_valid, select_xyz, pool_idx, class_width_luts,
                              lut_d, origin_d, dims_d, *, k: int, radius: float,
                              class_widths: tuple, class_ends: tuple, class_budgets: tuple,
                              budget_rows: int, small_unions: bool = False,
                              select_max_w: int | None = None):
    """:func:`fused_pool_search` over B pairs (arguments as
    :func:`batched_class_passes`): each class pass is one select launch
    across every pair of the batch.

    Returns (Correspondences (B, N, k), overflow (B,), points (B, N, k, 3)).
    """
    smw = _select_max_w(sources.device) if select_max_w is None else select_max_w
    n_pairs, n = sources.shape[:2]
    passes, orders, dsts, overflow = batched_class_passes(
        sources, source_valid, select_xyz, pool_idx, class_width_luts, lut_d, origin_d,
        dims_d, radius=radius, class_widths=class_widths, class_ends=class_ends,
        class_budgets=class_budgets, budget_rows=budget_rows, small_unions=small_unions,
        select_max_w=smw,
    )
    outs = [(b_c, class_select(w_c, k, smw)(*args, k=k, radius=radius))
            for w_c, b_c, args in passes]
    results = []
    for b in range(n_pairs):
        # Pair b's rows of each pass's outputs (views: the overlay writes
        # into the last class's rows of this pair only).
        mine = [(b_c, tuple(x.view(n_pairs, -1, x.shape[-1])[b] for x in (outd, outi))
                 + (tuple(p.view(n_pairs, -1, p.shape[-1])[b] for p in planes),))
                for b_c, (outd, outi, planes) in outs]
        results.append(overlay_classes(mine, orders[b], dsts[b], k=k, n=n, dtype=sources.dtype))
    corr = Correspondences(*(torch.stack(f) for f in zip(*(c for c, _ in results))))
    return corr, overflow, torch.stack([p for _, p in results])
