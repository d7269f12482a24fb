"""Offline odometry over a logged drive, in batches on a mesh of ranks:
``parallel/batch.py::run_odometry_batched(mesh=)``, each call one stretch
of the drive, its pairs sharded over the mesh's "points" axis in
contiguous blocks and the result gathered on every rank.

The run's own process is rank 0: it owns the host clock, the units, the
profiler and the check. Set-up starts ranks 1 .. R-1 (R: the
configuration's ``ranks``) as spawned processes, one card each, and joins
them to a process group (``mesh.choose_backend``: NCCL when every rank has
a card of its own, ``gloo`` on the CPU) through a ``TCPStore`` on
localhost that rank 0 opens; the rendezvous and every collective time out
after the traffic's ``collective_timeout_s``. Every rank runs with one
OpenMP / BLAS thread, as ``torchrun`` sets. Every rank makes the same
stretches from ``--seed`` (``distinct_calls``: the traffic's ``sequence``
generator over ``ranks x pairs_per_rank + 1`` scans, a stretch from the
seed and its index, cycled in order) and warms up on ``warmup_calls``
calls.

Before each call rank 0 broadcasts one number, the stretch's index or -1
to stop, so that every rank leaves the window at the same call (a host
branch on anything a rank reads alone would hang the others). A call is
one unit on rank 0, from the broadcast until the gathered result is back,
with the call's pairs. A call that raises on any rank fails its unit and
ends the run: a rank that raises reports on its pipe and exits at once,
which fails the collectives the others wait in. ``release`` tears the
group down and joins the ranks; a rank that reports an error, or left the
window at another call than rank 0, adds a failed unit.

Traffic keys: ``sequence`` (as ``seq.json``'s), ``distinct_calls_per_second``
and ``min_distinct_calls`` (the stretches made at set-up),
``warmup_calls``, ``stopping`` (``n_outer``, ``cost_drop_thresh``,
``n_cost_drop_it``), ``traced_calls``, ``checked_pairs`` (pairs of the
completed calls compared with the reference, drawn from the seed, one of
them from rank 0's block and one from the last rank's),
``collective_timeout_s``; for calibration and tests only, ``max_calls``
(stop after that many calls of the window) and ``raise_at`` ([rank,
call]: that rank raises at that call, counted from 0 at the first warm-up
call).
"""
from __future__ import annotations

import ctypes
import importlib
import math
import os
import sys
import time
import traceback
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from portbench.drivers.pair import input_seed
from portbench.harness import program_spans
from portbench.harness.check import compare, compose_gap
from portbench.reference.registration import register

THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
               "VECLIB_MAXIMUM_THREADS", "NUMEXPR_NUM_THREADS")
# The host phases of a call: their spans' sum is stats["host_seconds"].
HOST_SPANS = ("batch_grid", "batch_plan", "batch_build")


# --- inputs and parameters ---------------------------------------------------------


def scans_per_call(config: dict) -> int:
    return int(config["ranks"]) * int(config["pairs_per_rank"]) + 1


def stretch(config: dict, traffic: dict, seed: int, index: int):
    """(scans as float32 (n, 3) arrays, ground-truth poses) of stretch
    ``index`` of a run with ``seed``."""
    params = dict(traffic["sequence"])
    module, function = params.pop("generator").split(".")
    make = getattr(importlib.import_module(f"portbench.gen.{module}"), function)
    scans, truth = make(scans_per_call(config), int(config["cloud"]["n_points"]),
                        input_seed(seed, index + 1), **params)
    return [s.astype(np.float32) for s in scans], truth


def distinct_calls(traffic: dict, seconds: float) -> int:
    """The stretches a run makes: about as many as its window's calls,
    no more than the calls it may make."""
    n = max(int(traffic["min_distinct_calls"]),
            math.ceil(seconds * float(traffic["distinct_calls_per_second"])))
    if traffic.get("max_calls") is not None:
        n = min(n, int(traffic["warmup_calls"]) + int(traffic["max_calls"]))
    return n


def batch_kwargs(config: dict, traffic: dict) -> dict:
    """``run_odometry_batched``'s keywords but the scans and the mesh."""
    from probabilistic_point_clouds_registration_tpu_torch.models.em_lm import LMConfig

    p = dict(config["params"])
    return {**{k: v for k, v in p.items() if k != "lm"}, "lm_config": LMConfig(**p["lm"]),
            **traffic["stopping"]}


def reference_cfg(config: dict, traffic: dict) -> dict:
    """The parameters of ``reference.registration.register`` for the
    configuration's ``params`` and the traffic's stopping rule."""
    p, lm, stop = config["params"], config["params"]["lm"], traffic["stopping"]
    return {"max_neighbours": p["k"], "radius": p["radius"], "dof": lm["dof"],
            "function_tolerance": lm["function_tolerance"],
            "initial_trust_region_radius": lm["initial_radius"],
            "min_lm_diagonal": lm["min_lm_diagonal"], "max_lm_diagonal": lm["max_lm_diagonal"],
            "min_relative_decrease": lm["min_relative_decrease"],
            "use_nonmonotonic_steps": lm["use_nonmonotonic_steps"],
            "max_inner_iterations": lm["max_iterations"], "n_iter": stop["n_outer"],
            "cost_drop_thresh": stop["cost_drop_thresh"],
            "n_cost_drop_it": stop["n_cost_drop_it"]}


def _one_thread() -> None:
    """One OpenMP / BLAS thread in this process, and in the processes it
    starts after this call."""
    for var in THREAD_VARS:
        os.environ[var] = "1"
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # the BLAS libraries loaded already, by their own setter
        with open("/proc/self/maps") as f:
            libs = {line.split()[-1] for line in f if "openblas" in line.split()[-1].lower()}
        for path in sorted(libs):
            lib = ctypes.CDLL(path)
            for name in ("scipy_openblas_set_num_threads64_", "openblas_set_num_threads64_",
                         "openblas_set_num_threads"):
                setter = getattr(lib, name, None)
                if setter is not None:
                    setter(1)
                    break
        return
    threadpool_limits(1)


# --- one rank ----------------------------------------------------------------------


class Rank:
    """One rank's side of the run: its card, its mesh over the process
    group, its copy of the stretches, the calls it has run (warm-up
    included)."""

    def __init__(self, rank: int, world: int, port: int, device: str, config: dict,
                 traffic: dict, seed: int, n_stretches: int, store=None):
        from probabilistic_point_clouds_registration_tpu_torch.parallel.batch import (
            run_odometry_batched,
        )
        from probabilistic_point_clouds_registration_tpu_torch.parallel.mesh import (
            choose_backend,
            make_mesh,
        )

        self.rank = rank
        if device == "cuda":
            self.device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(self.device)
        else:
            self.device = torch.device("cpu")
        if world > 1:
            timeout = timedelta(seconds=float(traffic["collective_timeout_s"]))
            if store is None:
                store = dist.TCPStore("localhost", port, world, is_master=False,
                                      timeout=timeout)
            dist.init_process_group(choose_backend(self.device, local_world_size=world),
                                    store=store, rank=rank, world_size=world, timeout=timeout)
        self.mesh = make_mesh(world, 1, device=self.device)
        self.register = run_odometry_batched
        self.kwargs = batch_kwargs(config, traffic)
        self.stretches = [stretch(config, traffic, seed, i) for i in range(n_stretches)]
        self.calls = 0
        self.raise_at = traffic.get("raise_at")

    def go(self, index: int) -> int:
        """Rank 0's ``index`` (the stretch of the next call, -1: stop) on
        every rank."""
        x = torch.tensor([index], dtype=torch.int64, device=self.device)
        return int(self.mesh.broadcast_(x, "points", src=0).item())

    def call(self, index: int, stats: dict):
        """One call of the batch over stretch ``index`` (cycled)."""
        if self.raise_at is not None and list(self.raise_at) == [self.rank, self.calls]:
            raise RuntimeError(f"rank {self.rank} raises at call {self.calls}, as the "
                               "traffic asks")
        scans, _ = self.stretches[index % len(self.stretches)]
        out = self.register(scans, mesh=self.mesh, stats=stats, **self.kwargs)
        self.calls += 1
        return out

    def leave(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rank_main(rank, world, port, device, config, traffic, seed, n_stretches, conn) -> None:
    """A spawned rank: its calls, as rank 0 names them, until rank 0 says
    stop; then its count on ``conn`` and, at rank 0's word, it leaves the
    group. On an error: the traceback on ``conn``, and out at once."""
    me = None
    try:
        _one_thread()
        me = Rank(rank, world, port, device, config, traffic, seed, n_stretches)
        while (index := me.go(0)) >= 0:
            me.call(index, {})
        conn.send({"rank": rank, "calls": me.calls})
        if conn.poll(float(traffic["collective_timeout_s"]) * 10):
            conn.recv()
        me.leave()
    except BaseException:
        conn.send({"rank": rank, "calls": None if me is None else me.calls,
                   "error": traceback.format_exc()})
        conn.close()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)  # closes its sockets now: the collectives the others wait in fail
    conn.close()


# --- the harness's interface (rank 0) ------------------------------------------------


def setup(run):
    import torch.multiprocessing as mp

    cfg, tr = run.config, run.traffic
    world = int(cfg["ranks"])
    n = distinct_calls(tr, run.seconds)
    _one_thread()
    state = SimpleNamespace(world=world, procs=[], pipes=[], reports=[], broken=False,
                            answers=[], index=0, me=None, stretches=[])
    store, port = None, 0
    if world > 1:
        timeout = timedelta(seconds=float(tr["collective_timeout_s"]))
        store = dist.TCPStore("localhost", 0, world, is_master=True, timeout=timeout,
                              wait_for_workers=False)
        port = store.port
        ctx = mp.get_context("spawn")
        target = importlib.import_module("portbench.drivers.batch")._rank_main
        for r in range(1, world):
            here, there = ctx.Pipe()
            p = ctx.Process(target=target, args=(r, world, port, run.device, cfg, tr,
                                                 run.seed, n, there), daemon=True)
            p.start()
            there.close()
            state.procs.append(p)
            state.pipes.append(here)
    state.me = Rank(0, world, port, run.device, cfg, tr, run.seed, n, store=store)
    print(f"batch: {world} ranks, backend {dist.get_backend() if dist.is_initialized() else None}"
          f", {n} stretches of {scans_per_call(cfg)} scans, card "
          f"{state.me.device}", file=sys.stderr)
    for _ in range(int(tr["warmup_calls"])):
        state.me.go(state.index)
        state.me.call(state.index, {})
        state.index += 1
    return state


def window(run, state, end: float) -> None:
    traced = int(run.traffic["traced_calls"])
    max_calls = run.traffic.get("max_calls")
    me = state.me
    while time.perf_counter() < end and (max_calls is None or len(run.units) < max_calls):
        stats = {}
        unit = {"start": time.perf_counter(), "pairs": 0, "ok": False,
                "traced": run.tracer.active, "index": state.index, "stats": stats}
        try:
            with run.tracer.range("unit"), run.tracer.range("run_odometry_batched"):
                me.go(state.index)
                poses, result = me.call(state.index, stats)
        except Exception:  # a call that raises on any rank ends the run
            traceback.print_exc(file=sys.stderr)
            unit["end"] = time.perf_counter()
            run.units.append(unit)
            state.broken = True
            return
        unit["end"] = time.perf_counter()
        n_pairs = len(poses) - 1
        unit["pairs"] = n_pairs
        unit["ok"] = bool(np.all(np.isfinite(np.asarray(poses))))
        run.units.append(unit)
        state.answers.append({"index": state.index, "poses": poses, **{
            name: x[:n_pairs].cpu().numpy() for name, x in result._asdict().items()
            if x is not None}})
        state.index += 1
        if len(run.units) >= traced:
            run.tracer.stop()
    try:
        me.go(-1)
    except Exception:
        traceback.print_exc(file=sys.stderr)
        state.broken = True


def release(run, state) -> None:
    """Tear the group down, join the ranks, and fail a unit for a rank that
    reported an error or left the window at another call than rank 0."""
    for pipe in state.pipes:
        if pipe.poll(1.0 if state.broken else float(run.traffic["collective_timeout_s"])):
            try:
                state.reports.append(pipe.recv())
            except EOFError:
                pass
    if not state.broken:
        for pipe in state.pipes:
            try:
                pipe.send("leave")
            except OSError:
                pass
    try:
        if state.me is not None:
            state.me.leave()
    except Exception:
        traceback.print_exc(file=sys.stderr)
    for p in state.procs:
        p.join(30.0 if not state.broken else 5.0)
        if p.is_alive():
            p.kill()
            p.join(10.0)
    for pipe in state.pipes:
        pipe.close()
    calls = state.me.calls if state.me is not None else None
    reports = {r["rank"]: r for r in state.reports}
    bad = []
    for i, p in enumerate(state.procs, start=1):
        r = reports.get(i, {})
        if "error" in r:
            print(f"rank {i} failed:\n{r['error']}", file=sys.stderr)
        if "error" in r or r.get("calls") != calls or p.exitcode != 0:
            bad.append(i)
    print(f"ranks: {state.world}, calls on rank 0 {calls}, on the others "
          f"{[reports.get(i, {}).get('calls') for i in range(1, state.world)]}, exit codes "
          f"{[p.exitcode for p in state.procs]}", file=sys.stderr)
    run.extras["rank_calls"] = [calls] + [reports.get(i, {}).get("calls")
                                          for i in range(1, state.world)]
    if bad and not state.broken:
        t = run.units[-1]["end"] if run.units else time.perf_counter()
        run.units.append({"start": t, "end": t, "pairs": 0, "ok": False, "traced": False})
    if state.me is not None:
        state.stretches = state.me.stretches
    state.me = None


def _host_phases(run) -> list:
    """Per completed unit, (stats["host_seconds"], the seconds of rank 0's
    host-phase spans inside it); [] without the program's spans."""
    rec = program_spans.recorder()
    if rec is None:
        return []
    records, _ = rec.records()
    out = []
    for u in run.units:
        if "host_seconds" not in u.get("stats", {}):
            continue
        lo, hi = round(u["start"] * 1e9), round(u["end"] * 1e9)
        spans = sum(r.end_ns - r.start_ns for r in records
                    if r.count is None and r.name in HOST_SPANS and lo <= r.start_ns <= hi)
        out.append((u["stats"]["host_seconds"], spans * 1e-9, u["traced"]))
    return out


def check(run, state) -> list:
    """Compare pairs of the completed calls, drawn from the seed across the
    ranks' blocks, with the reference; and each call's chained poses with
    its relative transforms."""
    answers = state.answers
    per = (scans_per_call(run.config) - 1) // state.world
    units = [u for u in run.units if u.get("stats")]
    print(f"calls {len(answers)} pairs {sum(u['pairs'] for u in run.units)} engines "
          f"{sorted({u['stats'].get('engine') for u in units})} redone "
          f"{sum(len(u['stats'].get('redone', [])) for u in units)}", file=sys.stderr)
    for host_s, span_s, traced in _host_phases(run):
        print(f"host_seconds {host_s:.6f} s, host-phase spans {span_s:.6f} s"
              f"{' (traced call)' if traced else ''}", file=sys.stderr)
    rels = [_relative(a) for a in answers]
    # What a pair handed its neighbour's answer would read as its pose_gap:
    # the least gap between consecutive answers of a call.
    steps = [float(np.max(np.abs(a - b))) for r in rels for a, b in zip(r, r[1:])]
    if steps:
        print(f"consecutive answers differ by at least {min(steps):.6g}", file=sys.stderr)
    numbers = [{"compose_gap": compose_gap(a["poses"], r)} for a, r in zip(answers, rels)]
    picked = _pick(run, len(answers), per, state.world)
    cfg = reference_cfg(run.config, run.traffic)
    truth_gap = 0.0
    for c, i in picked:
        a = answers[c]
        scans, truth = state.stretches[a["index"] % len(state.stretches)]
        ref = register(scans[i + 1].astype(np.float64), scans[i].astype(np.float64), cfg,
                       device=run.device)
        n = int(a["num_iterations"][i])
        iters = [(float(a["initial_costs"][i, j]), float(a["final_costs"][i, j]),
                  int(a["num_correspondences"][i, j])) for j in range(n)]
        numbers.append(compare(rels[c][i], iters, ref))
        true_rel = np.linalg.inv(truth[i]) @ truth[i + 1]
        truth_gap = max(truth_gap, float(np.max(np.abs(ref.transform - true_rel))))
    # Not compared: how far the reference itself lands from the drive's true
    # motion (registration error plus the scans' noise).
    print(f"checked pairs {sorted(picked)} (call, pair): reference against the true "
          f"motion, largest entry gap {truth_gap:.6g}", file=sys.stderr)
    return numbers


def _relative(answer: dict) -> list:
    """A call's relative transforms (source scan i+1 onto scan i), from its
    gathered rotations and translations as ``run_odometry_batched``
    composes them."""
    from probabilistic_point_clouds_registration_tpu_torch.core.se3 import np_quat_to_matrix

    out = []
    for q, t in zip(answer["q"].astype(np.float64), answer["t"].astype(np.float64)):
        rel = np.eye(4)
        rel[:3, :3] = np_quat_to_matrix(q / np.linalg.norm(q))
        rel[:3, 3] = t
        out.append(rel)
    return out


def _pick(run, n_calls: int, per: int, world: int) -> list:
    """``checked_pairs`` distinct (call, pair) of the completed calls, drawn
    from the seed: the first from rank 0's block, the second from the last
    rank's, the rest from any."""
    if n_calls == 0:
        return []
    rng = np.random.default_rng([run.seed, 1])
    want = min(int(run.traffic["checked_pairs"]), n_calls * per * world)
    picked = []
    while len(picked) < want:
        j = len(picked)
        block = 0 if j == 0 else world - 1 if j == 1 else int(rng.integers(world))
        pick = (int(rng.integers(n_calls)), block * per + int(rng.integers(per)))
        if pick not in picked:
            picked.append(pick)
    return picked


def span_ms(run, names):
    """Milliseconds a call on rank 0 in the program's spans ``names``, over
    the untraced calls; None where those calls hold no ``batch`` span (a
    program without the batched path's spans)."""
    picked = program_spans.selected(run)
    if picked is None or not any(r.name == "batch" for r in picked[0]):
        return None
    return program_spans.mean_ms(run, names)


def count_per_call(run, name):
    """The program's count ``name`` a call on rank 0, as :func:`span_ms`."""
    picked = program_spans.selected(run)
    if picked is None or not any(r.name == "batch" for r in picked[0]):
        return None
    return program_spans.per_unit(run, name)
