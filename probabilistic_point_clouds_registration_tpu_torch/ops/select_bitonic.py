"""Bitonic k-select for the pooled search (port of the JAX package's
``ops/select_bitonic.py``).

Same contract as the window-select kernel B1 (``fused_grid.select_windows``):
per source row, the k smallest squared distances within ``radius`` among
the live lanes of its group's window, ascending, ties broken by lane, i.e.
ascending (d2, lane); slots [k, 32) empty (3e38, -1, 0). On the TPU it is
computed differently from B1, by a bitonic sort of each 32-lane chunk merged
into a running top 32. On the card both entry points run one walk
(csrc/window_select.cuh): a filter against the k-th distance, a staging
buffer, and a merge into the running top 32 that ends on the bitonic merge
network. This one keeps the TPU kernel's limits, pow2 window widths and
k <= 32; ``fused_pool.class_select`` sends the pooled search's kernel
classes here where they fit, and to B1 otherwise.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from .fused_grid import GROUP, _select_outputs, _select_windows_plain

_KP = 32  # output slots: one 32-lane run holds the result


def select_bitonic(padded, cand_xyz, cand_idx, step_rows, width_lut, *,
                   k: int, radius: float):
    """Per source row of ``padded``, the k nearest live candidates of its
    group's window (B4, the TPU kernel
    ``ops/select_bitonic.py::_bitonic_select_kernel`` of the JAX package).

    Arguments and outputs as :func:`..fused_grid.select_windows`, with
    kp = 32; the window width must be a power of two and k <= 32.

    A CPU tensor goes to the plain twin (B4 computes B1's function, so the
    twin is B1's stable-sort twin); a CUDA tensor launches the CUDA kernel
    (csrc/select_bitonic.cu) or raises. ``select_bitonic.launches`` counts
    kernel launches.
    """
    n_lanes = cand_idx.shape[1]
    if n_lanes < 1 or n_lanes & (n_lanes - 1):
        raise ValueError(f"select_bitonic needs a power-of-two window width, got {n_lanes}")
    if not 1 <= k <= _KP:
        raise ValueError(f"select_bitonic needs 1 <= k <= {_KP}, got {k}")
    r2 = float(np.float32(radius) ** 2)
    dev = padded.device
    if dev.type == "cpu":
        return _select_windows_plain(
            padded, cand_xyz, cand_idx, step_rows, width_lut, k=k, kp=_KP, r2=r2
        )
    s = padded.shape[0]
    outd, outi, planes = _select_outputs(
        "select_bitonic", padded, cand_xyz, cand_idx, step_rows, width_lut, _KP
    )
    if s == 0:
        return outd, outi, planes
    launch = kernels.load("select_bitonic")
    with torch.cuda.device(dev):
        err = launch(
            padded.data_ptr(), cand_xyz.data_ptr(), cand_idx.data_ptr(),
            step_rows.data_ptr(), width_lut.data_ptr(), outd.data_ptr(),
            outi.data_ptr(), *(p.data_ptr() for p in planes),
            s // GROUP, n_lanes, k, ctypes.c_float(r2),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"select_bitonic kernel launch failed: CUDA error {err}")
    select_bitonic.launches += 1
    return outd, outi, planes


select_bitonic.launches = 0
