"""Native C++ host functions (ctypes bindings with numpy fallbacks).

A copy of the JAX package's ``native/__init__.py`` (which imports no JAX)
over a copy of its ``pcr_native.cpp``: an LZF codec for PCD
``binary_compressed`` bodies, a hash-grid voxel downsample and the grid
engines' occupied-cell dilation. The reference's host runtime is C++
throughout (PCL's PCD codec and VoxelGrid,
src/prob_point_cloud_registration_ex.cc:111-136,
prob_point_cloud_registration.cc:24-41). Beside it, ``pool_plan.cpp``
(the port's own): the pooled engine's whole host plan in one pass.

The library is compiled with ``g++`` at first use, both sources in one
call, into ``native/`` under the package's build root
(``kernels.build_root()``: ``build/`` beside the package, or
``$PCR_TORCH_BUILD_DIR``), under a name keyed by a hash of the sources and
the flags, and loaded with ctypes. Every entry point returns None when the
library is unavailable (no compiler, or ``PCR_TORCH_DISABLE_NATIVE`` set),
and its callers (ops/voxel.py, ops/fused_grid.py, ops/fused_pool.py) then
take their numpy bodies, which are the oracles the native code is held
equal to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..kernels import build_root

_SRC = Path(__file__).with_name("pcr_native.cpp")
_SOURCES = (_SRC, _SRC.with_name("pool_plan.cpp"))
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_I64 = ctypes.c_int64
_P32 = ctypes.POINTER(ctypes.c_int32)
_P64 = ctypes.POINTER(ctypes.c_int64)
# pool_plan.cpp's kMaxClasses and kMaxBands; load() checks them and the
# buffer count and struct sizes against pcr_plan_layout.
_MAX_CLASSES = 32
_MAX_BANDS = 4
# pool_plan.cpp's PcrPlanAlloc: (entries per buffer, their addresses) -> 0 or not.
_PLAN_ALLOC = ctypes.CFUNCTYPE(_I64, _P64, ctypes.POINTER(ctypes.c_void_p))
# The pass's output buffers in pool_plan.cpp's PcrPlanBuffer order:
# (name, dtype, columns; 0 for a vector).
_PLAN_BUFFERS = (
    ("off_e", np.int32, 0), ("nrows", np.int32, 27), ("union_lut", np.int32, 0),
    ("dil_width_lut", np.int32, 0), ("d_cells", np.int32, 0), ("d_cells_e", np.int32, 0),
    ("row_vals", np.int32, 0), ("qmeta_vals", np.int32, 0), ("base_e", np.int32, 0),
    ("cell_start", np.int32, 0), ("cell_count", np.int32, 0), ("packed", np.float32, 4),
    ("width_lut", np.int32, 0), ("row_union_lut", np.int32, 0),
)
_PLAN_SCALARS = ("ud", "max_union", "ud_pad", "n_rows_pad", "budget_rows", "n_classes")
_PLAN_CLASS_TABLES = ("widths", "ends_pad", "row_ends", "sizes_real", "budgets", "n_bands")


class _PlanIn(ctypes.Structure):
    """``PcrPlanIn`` of pool_plan.cpp."""

    _fields_ = [
        ("cell_ids", _P64), ("cell_count", _P32), ("cell_start", _P32),
        ("sort_order", _P32), ("target", ctypes.POINTER(ctypes.c_double)),
        ("u", _I64), ("n", _I64), ("dims", _I64 * 3), ("select_max_w", _I64),
        ("group", _I64), ("block_groups", _I64), ("max_class_lanes", _I64),
        ("max_pool_bytes", _I64), ("big", ctypes.c_double),
        ("prod_e_pad", _I64), ("prod_d_pad", _I64), ("u_pad", _I64), ("n_pad", _I64),
        ("n_forced", _I64), ("forced_widths", _P64), ("forced_pad_sizes", _P64),
        ("forced_ud_b", _I64), ("alloc", _PLAN_ALLOC),
    ]


class _PlanOut(ctypes.Structure):
    """``PcrPlanOut`` of pool_plan.cpp: the plan's scalars and class tables."""

    _fields_ = (
        [(name, _I64) for name in _PLAN_SCALARS]
        + [(name, _I64 * _MAX_CLASSES) for name in _PLAN_CLASS_TABLES]
        + [("bands", (_I64 * 3) * _MAX_BANDS * _MAX_CLASSES)]
    )


def library_path() -> Path:
    """Where the build of the sources lives, keyed by a hash of the
    sources and the flags."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        digest.update(b"\0" + src.read_bytes())
    return build_root() / "native" / f"libpcr_native_{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *_FLAGS, *map(str, _SOURCES), "-o", str(tmp)],
                             capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if res.returncode != 0 or not tmp.exists():
        return False
    os.replace(tmp, so)  # atomic: concurrent builds never load a torn file
    return True


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on the first call; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PCR_TORCH_DISABLE_NATIVE"):
            return None
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.pcr_lzf_decompress.restype = ctypes.c_int
        lib.pcr_lzf_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ]
        lib.pcr_lzf_compress.restype = ctypes.c_uint64
        lib.pcr_lzf_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ]
        lib.pcr_voxel_downsample.restype = ctypes.c_int64
        lib.pcr_voxel_downsample.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pcr_dilate_cells.restype = ctypes.c_int64
        lib.pcr_dilate_cells.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pcr_plan_pool.restype = ctypes.c_int64
        lib.pcr_plan_pool.argtypes = [ctypes.POINTER(_PlanIn), ctypes.POINTER(_PlanOut)]
        lib.pcr_plan_layout.restype = None
        lib.pcr_plan_layout.argtypes = [_P64]
        layout = (_I64 * 5)()
        lib.pcr_plan_layout(layout)
        mine = (len(_PLAN_BUFFERS), _MAX_CLASSES, _MAX_BANDS, ctypes.sizeof(_PlanIn),
                ctypes.sizeof(_PlanOut))
        if tuple(layout) != mine:
            raise RuntimeError(f"pool_plan.cpp's layout (buffers, classes, bands, struct "
                               f"bytes) {tuple(layout)} differs from this module's {mine}")
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def lzf_decompress(data: bytes, expected_size: int) -> Optional[bytes]:
    """Native LZF decompress; None if the library is unavailable.

    Raises ValueError on a corrupt stream.
    """
    lib = load()
    if lib is None:
        return None
    out = np.empty(expected_size, dtype=np.uint8)
    rc = lib.pcr_lzf_decompress(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), expected_size,
    )
    if rc != 0:
        raise ValueError(f"corrupt LZF stream (native rc={rc})")
    return out.tobytes()


def lzf_compress(data: bytes) -> Optional[bytes]:
    """Native LZF compress; None if unavailable or incompressible."""
    lib = load()
    if lib is None or len(data) == 0:
        return None
    cap = len(data) + len(data) // 16 + 64
    out = np.empty(cap, dtype=np.uint8)
    size = lib.pcr_lzf_compress(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap
    )
    if size == 0:
        return None
    return out[:size].tobytes()


def dilate_cells(
    cell_ids: np.ndarray, dims: np.ndarray, counts: np.ndarray
) -> Optional[tuple]:
    """Native occupied-cell dilation: (d_cells_e, nrows, union) in stable
    descending-union order, byte-identical to the numpy body of
    ops.fused_grid.dilate_cells_host, or None when the library is
    unavailable or the grid exceeds the int32 id space."""
    lib = load()
    if lib is None:
        return None
    ids = np.ascontiguousarray(cell_ids, dtype=np.int64)
    dims64 = np.ascontiguousarray(dims, dtype=np.int64)
    cnt = np.ascontiguousarray(counts, dtype=np.int32)
    u = ids.shape[0]
    prod_e = int((dims64 + 4).prod())
    ud_cap = min(27 * u, prod_e)
    # np.empty is virtual until touched; only the rows written get pages.
    d_cells_e = np.empty(ud_cap, dtype=np.int32)
    nrows = np.empty((ud_cap, 27), dtype=np.int32)
    union = np.empty(ud_cap, dtype=np.int32)
    p32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
    ud = lib.pcr_dilate_cells(
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), u,
        dims64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), p32(cnt),
        ud_cap, p32(d_cells_e), p32(nrows), p32(union),
    )
    if ud < 0:
        return None
    return d_cells_e[:ud].copy(), nrows[:ud].copy(), union[:ud].copy()


def plan_pool(cell_ids, counts, starts, order, target, dims, *, select_max_w: int,
              pads: tuple, force: tuple | None, consts: tuple):
    """The pooled engine's host plan in one native pass
    (``pool_plan.cpp::pcr_plan_pool``), single-threaded, with the
    interpreter lock released but for one call back that allocates the
    outputs once the plan is made, each at its size.

    Takes the grid's ``num_cells`` occupied cells (linear ids, counts,
    starts), its ``sort_order``, the target's ``num_valid`` points, the
    grid's dims, the narrow-class cutoff, the padded sizes known before the
    pass ``pads`` = (prod_e_pad, prod_d_pad, u_pad, n_pad), ``force`` =
    (widths, pad_sizes, ud_b) or None, and ``consts`` = (GROUP,
    BLOCK_GROUPS, MAX_CLASS_LANES, MAX_POOL_BYTES, the dead lanes'
    coordinate). Returns a dict of the pass's arrays and scalars, from
    which ops/fused_pool.py assembles the plan; False when the scan does
    not fit the engine; None when the library is unavailable or the pass
    cannot run this scan (more classes than its table holds). Raises
    MemoryError when the outputs cannot be allocated.
    """
    lib = load()
    if lib is None:
        return None
    ids = np.ascontiguousarray(cell_ids, dtype=np.int64)
    cnt = np.ascontiguousarray(counts, dtype=np.int32)
    st = np.ascontiguousarray(starts, dtype=np.int32)
    od = np.ascontiguousarray(order, dtype=np.int32)
    tg = np.ascontiguousarray(target, dtype=np.float64)
    u, n = ids.shape[0], od.shape[0]
    if cnt.shape != (u,) or st.shape != (u,) or tg.shape != (n, 3):
        raise ValueError(f"plan_pool: {u} cells with counts {cnt.shape}, starts "
                         f"{st.shape}; {n} sorted points of a target {tg.shape}")
    group, block_groups, lanes, pool_bytes, big = consts
    prod_e_pad, prod_d_pad, u_pad, n_pad = pads
    args = _PlanIn(
        cell_ids=ids.ctypes.data_as(_P64), cell_count=cnt.ctypes.data_as(_P32),
        cell_start=st.ctypes.data_as(_P32), sort_order=od.ctypes.data_as(_P32),
        target=tg.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), u=u, n=n,
        dims=(_I64 * 3)(*(int(d) for d in dims)), select_max_w=select_max_w, group=group,
        block_groups=block_groups, max_class_lanes=lanes, max_pool_bytes=pool_bytes,
        big=big, prod_e_pad=prod_e_pad, prod_d_pad=prod_d_pad, u_pad=u_pad, n_pad=n_pad,
    )
    if force is not None:
        widths = np.ascontiguousarray(force[0], dtype=np.int64)
        pad_sizes = np.ascontiguousarray(force[1], dtype=np.int64)
        if widths.shape[0] == 0 or pad_sizes.shape != widths.shape:
            return None
        args.n_forced = widths.shape[0]
        args.forced_widths = widths.ctypes.data_as(_P64)
        args.forced_pad_sizes = pad_sizes.ctypes.data_as(_P64)
        args.forced_ud_b = force[2]

    res = {}

    def alloc(sizes, ptrs):
        try:
            for i, (name, dtype, cols) in enumerate(_PLAN_BUFFERS):
                shape = (sizes[i] // cols, cols) if cols else sizes[i]
                res[name] = np.empty(shape, dtype)
                ptrs[i] = res[name].ctypes.data
        except MemoryError:
            return 1
        return 0

    args.alloc = _PLAN_ALLOC(alloc)
    out = _PlanOut()
    rc = lib.pcr_plan_pool(ctypes.byref(args), ctypes.byref(out))
    if rc == 1:
        return False
    if rc == -3:
        raise MemoryError("plan_pool: the plan's outputs could not be allocated")
    if rc != 0:
        return None
    res.update((name, getattr(out, name)) for name in _PLAN_SCALARS)
    nc = out.n_classes
    for name in _PLAN_CLASS_TABLES:
        res[name] = list(getattr(out, name)[:nc])
    res["bands"] = tuple(
        tuple(tuple(out.bands[c][k]) for k in range(res["n_bands"][c])) for c in range(nc)
    )
    return res


def voxel_downsample(points: np.ndarray, leaf_size: float) -> Optional[np.ndarray]:
    """Native hash-grid centroid downsample; None if unavailable. Output
    matches ops/voxel.py: centroids by ascending linear voxel index."""
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n = pts.shape[0]
    out = np.empty((n, 3), dtype=np.float64)
    keys = np.empty(n, dtype=np.int64)
    m = lib.pcr_voxel_downsample(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, float(leaf_size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if m < 0:
        return None
    order = np.argsort(keys[:m], kind="stable")
    return out[:m][order].astype(points.dtype)
