"""Time and profile one pair of the PyTorch port on a CUDA device.

    python3 tools/profile_port.py --pair bunny35k --search-impl auto
    python3 tools/profile_port.py --pair kitti131k --trace build/kitti_trace.json
    python3 tools/profile_port.py --pair kitti131k --search-impl grid --grid-budget-mb 1024
    python3 tools/profile_port.py --pair bunny35k --search-impl pallas
    python3 tools/profile_port.py --pair bunny35k --lm-block 16 --outer-chunk 1

The pair and its parameters are a fixture's (tests/data/torch_port_<pair>_ref.json).
After one warm-up pair it times ``--reps`` warm pairs (ctor + ``align()``,
ending in a synchronize) and then traces one more warm ``align()`` with
``torch.profiler``. It prints one JSON line: the pair seconds (median and
each), the ctor / align split of the median pair, the median outer
iteration over all timed pairs, the select kernels' launches in one timed
pair, the LM iterations of each solve, and from the trace the device time
by kind, the device op count, the host's launch calls (kernel launches and
CUDA graph launches, each per outer iteration), the host syncs (blocking
device-to-host copies) and the device busy share (device time over the
traced ``align()``'s wall time).

``--search-impl`` takes any engine of the port (auto, pool, fused, grid,
pallas, brute) and ``--search-select`` the grid engine's k-selection.
``--grid-budget-mb`` sets the grid engine's candidate-buffer budget
(``ops.grid.SOURCE_TILE_BUDGET_BYTES``, which sizes its source blocks) for
this run. ``--lm-block`` sets the LM steps between two reads of ``done``
(``models.em_lm.LM_BLOCK``; 0 = ``max_inner_iterations``, one read a
solve) and ``--outer-chunk`` the outer iterations per chunk, for this run;
``--stop-rule`` runs the reference's default stopping rule in place of the
fixture's fixed iteration count. ``--port-root DIR`` imports the port from DIR instead of this
checkout, so that two trees are timed with the same script in one run.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
# Device-op kinds, by the first matching substring of the kernel's name.
KINDS = (
    ("select_windows", "B1"), ("select_bitonic", "B4"), ("row_topk", "B2"),
    ("brute_knn", "B3"), ("gemm", "gemm"),
    ("sort", "sort"), ("scan", "scan"), ("reduce", "reduce"),
    ("index", "gather/scatter"), ("gather", "gather/scatter"),
    ("scatter", "gather/scatter"), ("elementwise", "elementwise"),
    ("memcpy", "copy"), ("memset", "copy"),
)


# The host's launch calls, by the name of the CUDA API call.
HOST_LAUNCHES = {"cudaLaunchKernel": "kernel", "cudaLaunchKernelExC": "kernel",
                 "cuLaunchKernel": "kernel", "cuLaunchKernelEx": "kernel",
                 "cudaGraphLaunch": "graph", "cuGraphLaunch": "graph"}


def _kind(name: str) -> str:
    low = name.lower()
    return next((kind for key, kind in KINDS if key in low), "other")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", choices=("bunny35k", "kitti131k"), default="bunny35k")
    ap.add_argument("--search-impl", default="auto")
    ap.add_argument("--search-select", default="auto")
    ap.add_argument("--grid-budget-mb", type=int,
                    help="candidate-buffer budget of the grid engine's source blocks")
    ap.add_argument("--lm-block", type=int,
                    help="LM steps per block (0: max_inner_iterations)")
    ap.add_argument("--outer-chunk", type=int, help="outer iterations per chunk")
    ap.add_argument("--stop-rule", action="store_true",
                    help="the reference's default stopping rule (cost drop under 1%% for "
                         "more than 5 iterations) in place of the fixture's fixed count")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", help="write the profiler's Chrome trace here (tens of MB)")
    ap.add_argument("--port-root", type=Path, default=REPO)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_port: no CUDA device")
    sys.path.insert(0, str(args.port_root.resolve()))
    import probabilistic_point_clouds_registration_tpu_torch as port
    from probabilistic_point_clouds_registration_tpu_torch.io import synthetic
    from probabilistic_point_clouds_registration_tpu_torch.models import em_lm
    from probabilistic_point_clouds_registration_tpu_torch.ops import grid

    if args.grid_budget_mb:
        if not hasattr(grid, "SOURCE_TILE_BUDGET_BYTES"):
            raise SystemExit(f"profile_port: the port at {args.port_root} has no grid engine")
        grid.SOURCE_TILE_BUDGET_BYTES = args.grid_budget_mb << 20
    # The kernel wrappers this tree has (an older tree under --port-root
    # lacks the later ones).
    counters = []
    for module, fn in (("fused_grid", "select_windows"), ("select_bitonic", "select_bitonic"),
                       ("select_pallas", "pallas_row_topk"), ("neighbors_pallas", "brute_knn")):
        try:
            counters.append(getattr(importlib.import_module(f"{port.__name__}.ops.{module}"), fn))
        except ImportError:
            continue

    fixture = json.loads((REPO / "tests" / "data" / f"torch_port_{args.pair}_ref.json").read_text())
    pair = fixture["pair"]
    tgt = getattr(synthetic, pair["cloud"])(pair["n_points"], seed=pair["seed"])
    c, s = np.cos(pair["theta"]), np.sin(pair["theta"])
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    src = tgt @ rot.T + np.array(pair["shift"])
    kw = {k: v for k, v in fixture["params"].items() if k not in ("search_impl", "outer_chunk")}
    params = port.RegistrationParams(**kw, search_impl=args.search_impl,
                                     search_select=args.search_select)
    if args.outer_chunk is not None:
        params.outer_chunk = args.outer_chunk
    if args.stop_rule:
        defaults = port.RegistrationParams()
        params.n_iter = defaults.n_iter
        params.cost_drop_thresh = defaults.cost_drop_thresh
        params.n_cost_drop_it = defaults.n_cost_drop_it
    if args.lm_block is not None:
        if not hasattr(em_lm, "LM_BLOCK"):
            raise SystemExit(f"profile_port: the port at {args.port_root} has no LM blocks")
        em_lm.LM_BLOCK = args.lm_block or params.max_inner_iterations

    def one_pair():
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reg.align()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return reg, t2 - t0, t1 - t0, t2 - t1

    one_pair()  # warm-up: kernel builds, allocator, first-call costs
    runs = [one_pair() for _ in range(args.reps)]
    totals = [r[1] for r in runs]
    # median_low: one of the pairs that ran, also for an even --reps.
    reg, total, ctor, align = runs[totals.index(statistics.median_low(totals))]
    launches = {fn.__name__: fn.launches for fn in counters}

    traced = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
    lm = getattr(traced, "_lm", None)
    captured_before = getattr(lm, "capture_seconds", 0.0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        traced.align()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    by_kind, ops, host, syncs = Counter(), 0, Counter(), 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kind[_kind(evt.name)] += evt.time_range.elapsed_us() / 1e3
            ops += 1
            syncs += "DtoH" in evt.name
        elif evt.name in HOST_LAUNCHES:
            host[HOST_LAUNCHES[evt.name]] += 1
    device_ms = sum(by_kind.values())
    n_iter = len(traced.records)
    print(json.dumps({
        "pair": args.pair,
        "search_impl": args.search_impl,
        "search_select": args.search_select,
        "grid_budget_mb": getattr(grid, "SOURCE_TILE_BUDGET_BYTES", 0) >> 20,
        "port": str(Path(port.__file__).resolve().parent),
        "engine": reg.engine,
        "pair_s_median": total,
        "pair_s": totals,
        "ctor_s": ctor,
        "align_s": align,
        "iterations": len(reg.records),
        "iteration_ms_median": 1e3 * statistics.median(
            t for r in runs for t in r[0].iteration_times),
        "launches": launches,
        "lm_block": getattr(em_lm, "LM_BLOCK", None),
        "outer_chunk": params.outer_chunk,
        "stop_rule": args.stop_rule,
        "lm_iterations_per_solve": getattr(traced, "inner_iterations", "not recorded"),
        "lm_capture_s_all_pairs": captured_before,
        "lm_capture_s_traced_pair": getattr(lm, "capture_seconds", 0.0) - captured_before,
        "traced_align_s": wall,
        "device_ms": device_ms,
        "device_busy_share": device_ms / (1e3 * wall),
        "device_ops": ops,
        "device_ops_per_iteration": ops / n_iter,
        "host_kernel_launches_per_iteration": host["kernel"] / n_iter,
        "host_graph_launches_per_iteration": host["graph"] / n_iter,
        "host_syncs_per_pair": syncs,
        "device_ms_by_kind": dict(by_kind.most_common()),
    }))


if __name__ == "__main__":
    main()
