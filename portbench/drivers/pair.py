"""Closed-loop pairs: one client registers one pair at a time.

Each pair is the program's whole pair path, as a user calls it:
``ProbabilisticRegistration.prepare_target`` (host planning), the ctor with
its ``prepared_target`` (uploads, pool build) and ``align()``, ending in a
synchronize. A set of distinct pairs is made at set-up, each target from
the configuration's generator at a seed drawn from ``--seed`` and the
pair's index, its source the target under the configuration's fixed
misalignment; the window cycles through them in order. The outer
iterations are fixed (``cost_drop_thresh`` -1, ``n_iter`` the
configuration's ``fixed_outer_iterations``, one chunk), so every pair does
the same work.

Traffic keys: ``distinct_pairs_per_second`` and ``min_distinct_pairs``
(the set holds about as many pairs as the window consumes, so that its mean
varies little from seed to seed), ``warmup_pairs``, ``traced_pairs`` (the
pairs of the window the profiler records with ``--trace 1``) and
``checked_pairs`` (the pairs compared with the reference, drawn from the
seed among those the window completed).
"""
from __future__ import annotations

import math
import sys
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from portbench import roofline
from portbench.gen import synthetic
from portbench.harness.check import compare
from portbench.reference.registration import in_radius_counts, register


def input_seed(seed: int, index: int) -> int:
    """The generator seed of input ``index`` of a run with ``seed``."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


def make_pair(config: dict, seed: int):
    """(source, target) of one pair: the generator's cloud and that cloud
    under the configuration's misalignment."""
    cloud = config["cloud"]
    target = getattr(synthetic, cloud["generator"])(cloud["n_points"], seed=seed)
    mis = config["misalignment"]
    rot = synthetic._rot_z(mis["theta_z"])[:3, :3]
    source = target @ rot.T + np.asarray(mis["translation"])
    return source, target


def stopping(config: dict) -> dict:
    n = int(config["fixed_outer_iterations"])
    return {"n_iter": n, "cost_drop_thresh": -1.0, "outer_chunk": n}


def setup(run):
    import probabilistic_point_clouds_registration_tpu_torch as port

    tr = run.traffic
    n = max(int(tr["min_distinct_pairs"]),
            math.ceil(run.seconds * float(tr["distinct_pairs_per_second"])))
    pairs = [make_pair(run.config, input_seed(run.seed, i)) for i in range(n)]
    params = port.RegistrationParams(**run.config["params"], **stopping(run.config))
    state = SimpleNamespace(port=port, pairs=pairs, params=params)
    for i in range(int(tr["warmup_pairs"])):
        unit = _pair(run, state, i)
        if not unit["ok"]:
            raise RuntimeError(f"warm-up pair {i} failed")
    return state


def _pair(run, state, i: int) -> dict:
    """One timed pair (input ``i`` of the cycle)."""
    reg_cls = state.port.ProbabilisticRegistration
    src, tgt = state.pairs[i % len(state.pairs)]
    unit = {"input": i % len(state.pairs), "pairs": 1, "spans": {},
            "traced": run.tracer.active, "ok": False}
    spans = unit["spans"]
    unit["start"] = time.perf_counter()
    try:
        with run.spans("unit", {}):
            with run.spans("prepare_target", spans):
                prepared = reg_cls.prepare_target(tgt, state.params, run.device)
            with run.spans("ctor", spans):
                reg = reg_cls(src, tgt, state.params, prepared_target=prepared,
                              device=run.device)
            with run.spans("align", spans):
                transform = reg.align()
                if run.device == "cuda":
                    torch.cuda.synchronize()
    except Exception:  # a pair that raises is a failed unit; the run goes on
        traceback.print_exc(file=sys.stderr)
        unit["end"] = time.perf_counter()
        return unit
    unit["end"] = time.perf_counter()
    unit["transform"] = np.asarray(transform, dtype=np.float64)
    unit["ok"] = bool(np.all(np.isfinite(unit["transform"])))
    unit["iters"] = [(r.initial_cost, r.final_cost, r.num_correspondences)
                     for r in reg.records]
    unit["counters"] = {
        "capture_s": float(reg._lm.capture_seconds),
        "inner_cap_hits": int(reg.inner_cap_hits),
        "engine_fallbacks": int(reg.engine_fallbacks),
        "outer_iterations": len(reg.records),
        "engine": reg.engine,
    }
    return unit


def window(run, state, end: float) -> None:
    traced = int(run.traffic["traced_pairs"])
    i = int(run.traffic["warmup_pairs"])
    while time.perf_counter() < end:
        run.units.append(_pair(run, state, i))
        i += 1
        if len(run.units) >= traced:
            run.tracer.stop()


def release(run, state) -> None:
    state.port = None


def check(run, state) -> list:
    """Compare a sample of the window's pairs with the reference; also
    count the search's least time over the traced pairs."""
    ok = [u for u in run.units if u["ok"]]
    fallbacks = sum(u["counters"]["engine_fallbacks"] for u in ok)
    caps = sum(u["counters"]["inner_cap_hits"] for u in ok)
    engines = sorted({u["counters"]["engine"] for u in ok})
    print(f"pairs {len(run.units)} ok {len(ok)} engines {engines} "
          f"engine_fallbacks {fallbacks} inner_cap_hits {caps}", file=sys.stderr)
    cfg = {**run.config["params"], **stopping(run.config)}
    rng = np.random.default_rng([run.seed, 1])
    picked = rng.choice(len(ok), size=min(int(run.traffic["checked_pairs"]), len(ok)),
                        replace=False) if ok else []
    refs, numbers = {}, []
    for j in sorted(picked):
        u = ok[j]
        if u["input"] not in refs:
            src, tgt = state.pairs[u["input"]]
            refs[u["input"]] = register(src, tgt, cfg, device=run.device)
        numbers.append(compare(u["transform"], u["iters"], refs[u["input"]]))
    traced = [u for u in ok if u["traced"]]
    if traced:
        least, k = 0.0, int(cfg["max_neighbours"])
        counts = {}
        for u in traced:
            if u["input"] not in counts:
                src, tgt = state.pairs[u["input"]]
                counts[u["input"]] = in_radius_counts(src, tgt, float(cfg["radius"]), run.device)
            nbytes, flops = roofline.search_work(counts[u["input"]], k)
            least += roofline.least_seconds(nbytes, flops) * u["counters"]["outer_iterations"]
        run.extras["select_least_s"] = least
    return numbers
