"""The comparison that decides ``correct``: the program's answers against
the plain reference's (``reference/registration.py``), number by number,
each against its limit (``limits/<cell>.json``).

Per compared pair:
  pose_gap   the largest entry of |T_program - T_reference| (4x4; metres
             in the translation column)
  cost_gap   the largest relative gap of an outer iteration's initial or
             final cost
  corr_gap   the largest relative gap of an outer iteration's
             correspondence count (where the program reports counts)
  iters_gap  the difference in outer iterations run (exact: limit 0)
  compose_gap  (sequences) the largest entry of |pose[i+1] - pose[i] @ T_rel[i]|
             over the program's own poses and relative transforms
A run's number is the largest over its compared pairs.
"""
from __future__ import annotations

import math
import sys

import numpy as np

NUMBERS = ("pose_gap", "cost_gap", "corr_gap", "iters_gap", "compose_gap")


def compare(transform, iterations, ref) -> dict:
    """Numbers of one pair: ``transform`` the program's 4x4,
    ``iterations`` its outer iterations as (initial cost, final cost,
    correspondences or None), ``ref`` a ``reference.registration.Result``."""
    out = {"pose_gap": float(np.max(np.abs(np.asarray(transform) - ref.transform))),
           "iters_gap": float(abs(len(iterations) - len(ref.iterations)))}
    cost, corr = 0.0, None
    for (ic, fc, n), r in zip(iterations, ref.iterations):
        cost = max(cost, abs(ic - r.initial_cost) / abs(r.initial_cost),
                   abs(fc - r.final_cost) / abs(r.final_cost))
        if n is not None:
            corr = max(corr or 0.0, abs(n - r.num_correspondences) / r.num_correspondences)
    out["cost_gap"] = cost
    if corr is not None:
        out["corr_gap"] = corr
    return out


def compose_gap(poses, relative) -> float:
    """How far the composed poses lie from pose[0] = I and
    pose[i+1] = pose[i] @ relative[i]."""
    gap = float(np.max(np.abs(np.asarray(poses[0]) - np.eye(4))))
    for i, rel in enumerate(relative):
        want = np.asarray(poses[i]) @ np.asarray(rel)
        gap = max(gap, float(np.max(np.abs(np.asarray(poses[i + 1]) - want))))
    return gap


def parse_report(report: str) -> list:
    """(initial cost, final cost, None) of each row of a pair's CSV report
    (``ProbabilisticRegistration.report()``: no correspondence counts)."""
    rows = [line.split(",") for line in report.strip().splitlines()[1:]]
    return [(float(r[2]), float(r[3]), None) for r in rows]


def worst(numbers: list) -> dict:
    """Each number's largest value over the compared pairs (NaN wins)."""
    out = {}
    for name in NUMBERS:
        vals = [n[name] for n in numbers if name in n]
        if vals:
            out[name] = max(vals, key=lambda v: math.inf if math.isnan(v) else v)
    return out


def judge(numbers: dict, limits: dict, failed: int):
    """(correct, {name: {"value", "limit"}}); a number with no limit, a
    missing number whose limit exists, a NaN or a failed unit fails."""
    checks = {}
    ok = failed == 0 and bool(numbers)
    for name in NUMBERS:
        if name not in limits and name not in numbers:
            continue
        value = numbers.get(name, math.nan)
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and not math.isnan(value) and value <= limit
    checks["failed_units"] = {"value": failed, "limit": 0}
    return ok, checks


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
