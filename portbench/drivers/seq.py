"""Sequence odometry as ``cli_odometry.py`` runs it: ``run_odometry`` over
KITTI ``.bin`` scans, with its prefetcher, prep thread and checkpoint.

At set-up a drive of ``scans`` scans is made from ``--seed`` by the
generator the traffic's ``sequence`` names (``gen/<module>.py``'s
function, given the configuration's points a scan and the rest of
``sequence`` as parameters) and written as KITTI ``.bin`` files under
``$TMPDIR``; a call over the first ``warmup_scans`` warms up. The window runs back-to-back
``run_odometry`` calls over all the scans, each from an empty checkpoint
(it pays its own pipeline fill, as a drive processed in checkpointed
segments does). Each pair's completion is timed by ``on_pair``; at the
window's end the call in progress is stopped by raising from ``on_pair``.

Traffic keys: ``scans``, ``sequence`` (``generator``: ``module.function``
under ``gen/``, and its parameters), ``warmup_scans``, ``stopping`` (``n_iter``,
``cost_drop_thresh``, ``outer_chunk``), ``traced_pairs``, ``checked_pairs``
(pairs of the completed calls compared with the reference, drawn from the
seed) and, for calibration only, ``max_calls`` (stop after that many
calls).
"""
from __future__ import annotations

import importlib
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from portbench.drivers.pair import input_seed
from portbench.harness.check import compare, compose_gap, parse_report
from portbench.reference.registration import register


class WindowClosed(Exception):
    """Raised from ``on_pair`` to stop the call in progress at the window's end."""


def make_scans(config: dict, traffic: dict, seed: int):
    """(scans, ground-truth poses) of a run with ``seed``: the traffic's
    ``sequence`` generator over its ``scans`` scans of the configuration's
    size."""
    params = dict(traffic["sequence"])
    module, function = params.pop("generator").split(".")
    make = getattr(importlib.import_module(f"portbench.gen.{module}"), function)
    return make(int(traffic["scans"]), int(config["cloud"]["n_points"]), input_seed(seed, 0),
                **params)


def write_scans(scans, directory: Path) -> list:
    """Each scan as a KITTI Velodyne ``.bin`` (float32 x, y, z, reflectance 0)."""
    paths = []
    for i, scan in enumerate(scans):
        rec = np.zeros((scan.shape[0], 4), dtype=np.float32)
        rec[:, :3] = scan
        path = directory / f"{i:06d}.bin"
        rec.tofile(path)
        paths.append(path)
    return paths


def read_scan(path) -> np.ndarray:
    """A ``.bin`` scan's xyz as float64, as the reference reads it."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3].astype(np.float64)


def setup(run):
    import probabilistic_point_clouds_registration_tpu_torch as port
    from probabilistic_point_clouds_registration_tpu_torch.models.odometry import run_odometry

    tr = run.traffic
    scans, truth = make_scans(run.config, tr, run.seed)
    tmp = Path(tempfile.mkdtemp(prefix="portbench_seq_"))
    state = SimpleNamespace(tmp=tmp, paths=write_scans(scans, tmp), run_odometry=run_odometry,
                            checkpoint=tmp / "checkpoint.json", truth=truth)
    state.params = port.RegistrationParams(**run.config["params"], **tr["stopping"])
    run_odometry(state.paths[:int(tr["warmup_scans"])], state.params,
                 checkpoint_path=state.checkpoint, device=run.device)
    return state


def _open(run) -> list:
    """Profiler ranges around one pair of a call: the unit, and the call
    the host is in (run_odometry) for labelling the device's idle gaps."""
    ranges = [run.tracer.range("unit"), run.tracer.range("run_odometry")]
    for r in ranges:
        r.__enter__()
    return ranges


def _close(ranges: list) -> None:
    for r in reversed(ranges):
        r.__exit__(None, None, None)
    ranges.clear()


def window(run, state, end: float) -> None:
    traced = int(run.traffic["traced_pairs"])
    calls = run.extras.setdefault("calls", [])
    max_calls = run.traffic.get("max_calls")
    while time.perf_counter() < end and (max_calls is None or len(calls) < max_calls):
        state.checkpoint.unlink(missing_ok=True)
        mark = {"t": time.perf_counter(), "ranges": _open(run)}

        def on_pair(i, pose):
            now = time.perf_counter()
            _close(mark["ranges"])
            run.units.append({"start": mark["t"], "end": now, "pairs": 1, "spans": {},
                              "ok": bool(np.all(np.isfinite(pose))),
                              "traced": run.tracer.active})
            if len(run.units) >= traced:
                run.tracer.stop()
            mark["t"] = now
            mark["ranges"] = _open(run)
            if now >= end:
                raise WindowClosed

        try:
            result = state.run_odometry(state.paths, state.params,
                                        checkpoint_path=state.checkpoint,
                                        on_pair=on_pair, device=run.device)
        except WindowClosed:
            break
        except Exception:  # a call that raises fails its next pair; the run goes on
            traceback.print_exc(file=sys.stderr)
            run.units.append({"start": mark["t"], "end": time.perf_counter(), "pairs": 0,
                              "spans": {}, "ok": False, "traced": False})
            continue
        finally:
            _close(mark["ranges"])
        if run.device == "cuda":
            torch.cuda.synchronize()
        calls.append({"poses": result.poses,
                      "relative_transforms": result.relative_transforms,
                      "reports": result.reports,
                      "prep_wait_seconds": result.prep_wait_seconds,
                      "inner_cap_hits": result.inner_cap_hits,
                      "engine_fallbacks": result.engine_fallbacks})


def release(run, state) -> None:
    state.run_odometry = None


def check(run, state) -> list:
    """Compare a sample of the completed calls' pairs with the reference,
    and each completed call's composed poses with its relative transforms."""
    calls = run.extras.get("calls", [])
    print(f"pairs {len(run.units)} calls {len(calls)} engine_fallbacks "
          f"{sum(c['engine_fallbacks'] for c in calls)} inner_cap_hits "
          f"{sum(c['inner_cap_hits'] for c in calls)}", file=sys.stderr)
    # What a pair handed the answer of the pair before it would read as its
    # pose_gap: the least gap between consecutive answers of a call.
    steps = [float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
             for c in calls for a, b in zip(c["relative_transforms"],
                                             c["relative_transforms"][1:])]
    if steps:
        print(f"consecutive answers differ by at least {min(steps):.6g}", file=sys.stderr)
    try:
        numbers = [{"compose_gap": compose_gap(c["poses"], c["relative_transforms"])}
                   for c in calls]
        done = [(c, i) for c in calls for i in range(len(c["relative_transforms"]))]
        rng = np.random.default_rng([run.seed, 1])
        picked = rng.choice(len(done), size=min(int(run.traffic["checked_pairs"]), len(done)),
                            replace=False) if done else []
        cfg = {**run.config["params"], **run.traffic["stopping"]}
        truth_gap = 0.0
        for j in sorted(picked):
            c, i = done[j]
            ref = register(read_scan(state.paths[i + 1]), read_scan(state.paths[i]), cfg,
                           device=run.device)
            numbers.append(compare(c["relative_transforms"][i], parse_report(c["reports"][i]),
                                   ref))
            true_rel = np.linalg.inv(state.truth[i]) @ state.truth[i + 1]
            truth_gap = max(truth_gap, float(np.max(np.abs(ref.transform - true_rel))))
        # Not compared: how far the reference itself lands from the drive's
        # true motion (registration error plus the scans' noise).
        print(f"checked pairs {len(picked)}: reference against the true motion, largest "
              f"entry gap {truth_gap:.6g}", file=sys.stderr)
        return numbers
    finally:
        shutil.rmtree(state.tmp, ignore_errors=True)
