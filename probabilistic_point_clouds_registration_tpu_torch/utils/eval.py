"""Evaluation utilities (port of the JAX package's ``utils/eval.py``; only
``calculate_mse`` so far, the registration loop's ground-truth metric)."""
from __future__ import annotations

import numpy as np


def calculate_mse(cloud1, cloud2) -> float:
    """Mean Euclidean (not squared) distance between index-aligned clouds —
    the reference's ``calculateMSE`` quirk (utilities.hpp:16-26)."""
    a = np.asarray(cloud1, dtype=np.float64)
    b = np.asarray(cloud2, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError("calculate_mse requires index-aligned clouds")
    return float(np.mean(np.linalg.norm(a - b, axis=1)))
