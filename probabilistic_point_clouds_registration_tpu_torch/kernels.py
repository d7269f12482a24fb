"""Build and load the package's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point that
launches on the stream it is given and returns the ``cudaError_t`` of the
launch; what kernels share is in ``csrc/*.cuh``. At first use the file is
compiled with ``nvcc`` for Hopper (``sm_90a``) into :func:`build_dir`, under
a name keyed by a hash of the source, of every header it could include and
of the flags, and loaded with ctypes. Nothing is compiled when this module
is imported.

Builds go under ``build/`` beside the package (git-ignored in a checkout),
or under ``$PCR_TORCH_BUILD_DIR`` when that is set: an installed package
keeps its builds out of ``site-packages`` with it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR_ENV = "PCR_TORCH_BUILD_DIR"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> (C entry point, argtypes). Pointers and the stream are c_void_p so
# ctypes passes them as 64-bit values.
_ENTRY_POINTS = {
    "select_windows": (
        "select_windows_launch",
        [_P] * 10 + [_I] * 4 + [ctypes.c_float, _P],
    ),
    "select_bitonic": (
        "select_bitonic_launch",
        [_P] * 10 + [_I] * 3 + [ctypes.c_float, _P],
    ),
    "row_topk": ("row_topk_launch", [_P] * 3 + [_I] * 3 + [_P]),
    "brute_knn": ("brute_knn_launch", [_P] * 4 + [_I] + [_P] * 2 + [_I] * 3 + [_P]),
}

_loaded: dict[str, ctypes._CFuncPtr] = {}


def build_root() -> Path:
    """The directory the package builds into: ``$PCR_TORCH_BUILD_DIR``, or
    ``build/`` beside the package."""
    env = os.environ.get(BUILD_DIR_ENV)
    return Path(env) if env else Path(__file__).resolve().parent.parent / "build"


def build_dir() -> Path:
    """Where the kernels' builds live."""
    return build_root() / "kernels"


def _nvcc() -> str:
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    nvcc = cuda_home / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives: keyed by a hash of the
    source, of every ``csrc/*.cuh`` (a header the source may include) and of
    the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return build_dir() / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its build exists; returns the .so.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``.log``.
    """
    so = library_path(name)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(_CSRC / f"{name}.cu")],
        capture_output=True,
        text=True,
    )
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load(name: str):
    """The C entry point of kernel ``name``, built at first use."""
    fn = _loaded.get(name)
    if fn is None:
        symbol, argtypes = _ENTRY_POINTS[name]
        fn = getattr(ctypes.CDLL(str(build(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
