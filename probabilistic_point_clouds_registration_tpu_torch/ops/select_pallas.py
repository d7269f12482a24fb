"""Row-wise top-k-smallest selection (port of the JAX package's
``ops/select_pallas.py``; the module keeps its counterpart's name).

The grid search (ops/grid.py) ends in "the k nearest of a (rows, 27 *
capacity) candidate matrix, most of it masked to +inf". The JAX package has
a TPU kernel for it (B2, ``_select_kernel``); here it is a CUDA kernel
(csrc/row_topk.cu) designed from the same contract: exact, ascending, ties
broken by the lowest column index, like a stable sort of each row.
"""
from __future__ import annotations

import torch

from .. import kernels


def _row_topk_plain(d2: torch.Tensor, *, k: int):
    """Plain PyTorch twin of the row top-k kernel: a stable sort of each
    row, then the first k columns. (``torch.topk`` leaves the order of equal
    values unspecified, so it is not the twin.)"""
    vals, cols = torch.sort(d2.float(), dim=1, stable=True)
    return vals[:, :k].to(d2.dtype), cols[:, :k].to(torch.int32)


def pallas_row_topk(d2: torch.Tensor, *, k: int):
    """k smallest entries per row of ``d2`` (masked entries = +inf).

    ``d2`` is an (N, W) matrix of values >= 0 or +inf, compared in float32
    as in the JAX package; NaN is outside the contract. Returns (values
    (N, k) in ``d2``'s dtype, indices (N, k) int32), ascending per row, ties
    broken by the lowest column index; 1 <= k <= W. Slots beyond a row's
    finite entries hold +inf and the row's lowest masked columns (the JAX
    package leaves that index unspecified): callers mask by
    ``isfinite(values)``, as the grid engine does, never by index.

    A CPU tensor goes to the plain twin; a CUDA tensor launches the CUDA
    kernel (B2, csrc/row_topk.cu) or raises. ``pallas_row_topk.launches``
    counts kernel launches.
    """
    if d2.dim() != 2:
        raise ValueError(f"pallas_row_topk needs an (N, W) matrix, got {tuple(d2.shape)}")
    n, w = d2.shape
    if not 1 <= k <= w:
        raise ValueError(f"pallas_row_topk needs 1 <= k <= W (k={k}, W={w})")
    dev = d2.device
    if dev.type == "cpu":
        return _row_topk_plain(d2, k=k)
    if dev.type != "cuda":
        raise ValueError(f"pallas_row_topk runs on cpu or cuda tensors, not {dev}")
    if not d2.dtype.is_floating_point:
        raise ValueError(f"pallas_row_topk needs a floating-point matrix, got {d2.dtype}")
    x = d2.to(torch.float32).contiguous()
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    cols = torch.empty((n, k), dtype=torch.int32, device=dev)
    if n == 0:
        return vals.to(d2.dtype), cols
    launch = kernels.load("row_topk")
    with torch.cuda.device(dev):
        err = launch(
            x.data_ptr(), vals.data_ptr(), cols.data_ptr(), n, w, k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"row_topk kernel launch failed: CUDA error {err}")
    pallas_row_topk.launches += 1
    return vals.to(d2.dtype), cols


pallas_row_topk.launches = 0
