"""Native C++ host functions (ctypes bindings with numpy fallbacks).

A copy of the JAX package's ``native/__init__.py`` (which imports no JAX)
over a copy of its ``pcr_native.cpp``: an LZF codec for PCD
``binary_compressed`` bodies, a hash-grid voxel downsample and the grid
engines' occupied-cell dilation. The reference's host runtime is C++
throughout (PCL's PCD codec and VoxelGrid,
src/prob_point_cloud_registration_ex.cc:111-136,
prob_point_cloud_registration.cc:24-41).

The library is compiled with ``g++`` at first use into ``native/`` under
the package's build root (``kernels.build_root()``: ``build/`` beside the
package, or ``$PCR_TORCH_BUILD_DIR``), under a name keyed by a hash of the
source and the flags, and loaded with ctypes. Every entry point returns
None when the library is unavailable (no compiler, or
``PCR_TORCH_DISABLE_NATIVE`` set), and its callers (ops/voxel.py,
ops/fused_grid.py) then take their numpy bodies, which are the oracles the
native code is held equal to.
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
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the build of ``pcr_native.cpp`` lives, keyed by a hash of the
    source and the flags."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode() + b"\0" + _SRC.read_bytes())
    return build_root() / "native" / f"libpcr_native_{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
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
