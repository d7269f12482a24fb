"""Pieces of the JAX package's pooled engine (``ops/fused_pool.py``) that
the dense prepack uses: the window LUT scatter and the neighbor-row
rebuild. The pooled engine itself is not ported yet.

JAX's ``.at[].set(..., mode="drop")`` drops out-of-range indices; torch has
no such mode, so the indices are masked first. Padding entries carry
out-of-range ids by construction and vanish the same way.
"""
from __future__ import annotations

import torch


def _scatter_drop(size: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``full(size, -1).at[index].set(values, mode="drop")`` for int32."""
    out = torch.full((size,), -1, dtype=torch.int32, device=index.device)
    keep = (index >= 0) & (index < size)
    out[index[keep].long()] = values[keep].to(torch.int32)
    return out


def _scatter_lut(d_cells: torch.Tensor, row_vals: torch.Tensor, *, prod_d: int):
    """Dense extended-grid cell -> PADDED window row; pad entries carry
    out-of-range cell ids and are dropped."""
    return _scatter_drop(prod_d, d_cells, row_vals)


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
        prod_e, base_e, torch.arange(u, dtype=torch.int32, device=base_e.device)
    )
    return occ[(d_cells_e[:, None] + off_e[None, :]).long()]
