"""PCD (Point Cloud Data) file reader/writer (a copy of the JAX package's
``io/pcd.py``, which imports no JAX; its LZF codec goes through this
package's ``native/``).

Covers the I/O surface the reference gets from ``pcl::io::loadPCDFile`` /
``savePCDFile`` (src/prob_point_cloud_registration_ex.cc:111-136,161-164):
ASCII, binary, and binary_compressed (LZF) encodings, extracting the x/y/z
fields of arbitrary field layouts. Written from the PCD format spec; no PCL
code involved.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

_TYPE_MAP = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("I", 8): np.int64,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
    ("U", 8): np.uint64,
}


def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """Decompress an LZF-compressed block (the PCD binary_compressed codec).

    Dispatches to the native C++ codec (../native) when available — the
    Python loop below is the always-works fallback and the parity oracle.
    """
    from .. import native

    native_out = native.lzf_decompress(data, expected_size)
    if native_out is not None:
        return native_out
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected_size:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            run = ctrl + 1
            out += data[i : i + run]
            i += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            if ref < 0:
                raise ValueError("corrupt LZF stream: negative back-reference")
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    if len(out) != expected_size:
        raise ValueError(f"LZF stream decompressed to {len(out)} bytes, expected {expected_size}")
    return bytes(out)


def lzf_compress(data: bytes) -> bytes:
    """LZF-encode ``data`` (PCD binary_compressed bodies).

    Native C++ hash-chain encoder when available (real compression); the
    Python fallback emits literal runs only (~3% overhead) which is still a
    valid LZF stream for any decoder including PCL's.
    """
    from .. import native

    native_out = native.lzf_compress(data)
    if native_out is not None:
        return native_out
    out = bytearray()
    for i in range(0, len(data), 32):
        chunk = data[i : i + 32]
        out.append(len(chunk) - 1)
        out += chunk
    return bytes(out)


def _parse_header(raw: bytes) -> Tuple[Dict[str, List[str]], int]:
    header: Dict[str, List[str]] = {}
    offset = 0
    view = raw
    while True:
        nl = view.find(b"\n", offset)
        if nl < 0:
            raise ValueError("unterminated PCD header")
        line = view[offset:nl].decode("ascii", errors="replace").strip()
        offset = nl + 1
        if not line or line.startswith("#"):
            continue
        key, *vals = line.split()
        header[key.upper()] = vals
        if key.upper() == "DATA":
            return header, offset
        if offset > 10_000_000:
            raise ValueError("header too large; not a PCD file?")


def load_pcd(path) -> np.ndarray:
    """Load a PCD file, returning the (n, 3) xyz float32 array.

    Non-finite points are kept (PCL keeps them in unorganized clouds too);
    callers that need finite-only clouds can mask with np.isfinite.
    """
    raw = Path(path).read_bytes()
    header, data_start = _parse_header(raw)

    fields = header.get("FIELDS") or header.get("COLUMNS")
    if fields is None:
        raise ValueError("PCD missing FIELDS")
    sizes = [int(s) for s in header["SIZE"]]
    types = header["TYPE"]
    counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
    n_points = int(header["POINTS"][0]) if "POINTS" in header else int(
        header["WIDTH"][0]
    ) * int(header["HEIGHT"][0])
    mode = header["DATA"][0].lower()

    names = []
    formats = []
    for f, s, t, c in zip(fields, sizes, types, counts):
        base = _TYPE_MAP[(t.upper(), s)]
        for ci in range(c):
            names.append(f if c == 1 else f"{f}_{ci}")
            formats.append(base)
    rec_dtype = np.dtype({"names": names, "formats": formats})

    if mode == "ascii":
        text = raw[data_start:].decode("ascii", errors="replace")
        rows = np.loadtxt(text.strip().splitlines(), dtype=np.float64, ndmin=2)
        if rows.shape[0] < n_points:
            raise ValueError(f"PCD claims {n_points} points, found {rows.shape[0]}")
        cols = {name: rows[:n_points, i] for i, name in enumerate(names)}
        xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
        return xyz.astype(np.float32)

    if mode == "binary":
        body = raw[data_start : data_start + rec_dtype.itemsize * n_points]
    elif mode == "binary_compressed":
        comp_size, uncomp_size = struct.unpack_from("<II", raw, data_start)
        comp = raw[data_start + 8 : data_start + 8 + comp_size]
        body = lzf_decompress(comp, uncomp_size)
        # binary_compressed stores data field-major (SoA): all x, all y, ...
        arrs = {}
        off = 0
        for name, fmt in zip(names, formats):
            width = np.dtype(fmt).itemsize * n_points
            arrs[name] = np.frombuffer(body[off : off + width], dtype=fmt)
            off += width
        xyz = np.stack([arrs["x"], arrs["y"], arrs["z"]], axis=1)
        return xyz.astype(np.float32)
    else:
        raise ValueError(f"unsupported PCD DATA mode: {mode}")

    rec = np.frombuffer(body, dtype=rec_dtype, count=n_points)
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1)
    return np.ascontiguousarray(xyz).astype(np.float32)


def save_pcd(path, points: np.ndarray, *, mode: str = "binary") -> None:
    """Write an (n, 3) cloud as a PointXYZ PCD (ascii | binary | binary_compressed)."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {mode}\n"
    )
    path = Path(path)
    if mode == "ascii":
        with path.open("w") as f:
            f.write(header)
            np.savetxt(f, points, fmt="%.9g")
    elif mode == "binary":
        with path.open("wb") as f:
            f.write(header.encode("ascii"))
            f.write(np.ascontiguousarray(points).tobytes())
    elif mode == "binary_compressed":
        soa = np.concatenate([points[:, 0], points[:, 1], points[:, 2]]).astype(np.float32)
        body = soa.tobytes()
        comp = lzf_compress(body)
        with path.open("wb") as f:
            f.write(header.encode("ascii"))
            f.write(struct.pack("<II", len(comp), len(body)))
            f.write(comp)
    else:
        raise ValueError(f"unsupported PCD write mode: {mode}")
