"""ETH ASL "challenging data sets" CSV point-cloud ingestion (a copy of the
JAX package's ``io/eth_csv.py``, which imports no JAX).

The ETH ASL laser-registration datasets (BASELINE.json config #3:
apartment / stairs sequences) distribute each scan as a CSV table —
``timestamp, x, y, z, ...`` with a header row — unlike the PCD files the
reference consumed through PCL's generic loader
(src/prob_point_cloud_registration_ex.cc:111-136). This loader accepts:

  * a header row naming columns (any case; ``x``/``y``/``z`` are located by
    name, extra columns like timestamps/intensities/normals are ignored),
  * headerless numeric rows — 3 columns are taken as (x, y, z); 4+ columns
    as (timestamp, x, y, z, ...), the ETH layout.

Rows with non-finite coordinates are dropped (the scanners emit NaN returns
for no-echo beams).
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Union

import numpy as np


def load_eth_csv(path: Union[str, Path]) -> np.ndarray:
    """Load one ETH ASL CSV scan as an (n, 3) float64 array."""
    path = Path(path)
    with open(path, "r") as f:
        first = f.readline()
    if not first:
        return np.zeros((0, 3))

    tokens = [t.strip() for t in first.replace(";", ",").split(",")]

    def _is_number(tok: str) -> bool:
        try:
            float(tok)
            return True
        except ValueError:
            return False

    has_header = not all(_is_number(t) for t in tokens if t)
    delim = ";" if ";" in first else ","
    data = np.genfromtxt(
        path, delimiter=delim, skip_header=1 if has_header else 0, dtype=np.float64
    )
    if data.ndim == 1:
        data = data.reshape(1, -1) if data.size else np.zeros((0, 3))

    if has_header:
        names = [t.lower() for t in tokens]
        try:
            cols = [names.index(c) for c in ("x", "y", "z")]
        except ValueError:
            raise ValueError(
                f"{path}: CSV header {tokens!r} has no x/y/z columns"
            ) from None
    elif data.shape[1] >= 4:
        cols = [1, 2, 3]  # (timestamp, x, y, z, ...)
    elif data.shape[1] == 3:
        cols = [0, 1, 2]
    else:
        raise ValueError(f"{path}: expected >= 3 numeric columns, got {data.shape[1]}")

    pts = data[:, cols]
    return pts[np.all(np.isfinite(pts), axis=1)]


def list_eth_scans(directory: Union[str, Path]) -> List[Path]:
    """Sorted CSV scan files of an ETH ASL sequence directory."""
    directory = Path(directory)
    return sorted(p for p in directory.glob("*.csv"))
