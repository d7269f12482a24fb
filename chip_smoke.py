"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (one nvcc per source, in
parallel) and then, raising on the first failure:

1. prints the card, the build seconds and each kernel's ptxas registers;
2. the dense engine: holds B1 (``select_windows``) bit for bit against its
   plain twin at the dense bench shapes and on edge cases, and registers
   the 35k ``bunny_like`` bench pair with ``search_impl="fused"``;
3. holds B4 (``select_bitonic``) and B1 bit for bit against the twin (and
   so against each other) on every class pass of the pooled search of
   both pairs (35k bunny, 131k ``kitti_like``) at their initial pose, and
   B4 on edge cases; times B4, the twin and B1 on the same inputs;
4. holds ``fused_pool_search`` (its kernel classes on B4) slot for slot
   against the same search with every class pass on the twin, on both
   pairs;
5. the main path: ``ProbabilisticRegistration(..., device="cuda").align()``
   with ``auto`` (the pooled engine, its classes on B4) on the bunny pair,
   against the JAX package's fixture (tests/data/torch_port_bunny35k_ref.json);
6. the same on the LiDAR pair (tests/data/torch_port_kitti131k_ref.json).

Each path's launch counts are set to 0 just before it and read just after.
The last two lines of standard output are a JSON line with each kernel's
launches on the paths that run it (B1: the dense registration of step 2;
B4: the two ``auto`` registrations) and its time and its twin's over the
class passes of step 3, then ``{"ok": true, "device": ...}``. It imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DATA = REPO / "tests" / "data"
PORT = "probabilistic_point_clouds_registration_tpu_torch"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "select_windows": (f"{PORT}/csrc/select_windows.cu",
                       "probabilistic_point_clouds_registration_tpu/ops/fused_grid.py:476"),
    "select_bitonic": (f"{PORT}/csrc/select_bitonic.cu",
                       "probabilistic_point_clouds_registration_tpu/ops/select_bitonic.py:66"),
}
TRANSFORM_ATOL = 1e-4  # final 4x4 against the fixture
COUNT_RTOL = 1e-4  # per-iteration correspondence counts against the fixture


def _cuda_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), warm."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bit_equal(got, want, what: str) -> float:
    """Raise unless every slot of the select outputs is bit-equal; returns
    the largest |outd| difference over live slots (0 when equal)."""
    import torch

    (gd, gi, gp), (wd, wi, wp) = got, want
    for name, a, b in [("outd", gd, wd), ("outi", gi, wi)] + [
        (f"out{c}", a, b) for c, a, b in zip("xyz", gp, wp)
    ]:
        if a.shape != b.shape or not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            bad = int((a.view(torch.int32) != b.view(torch.int32)).sum())
            raise AssertionError(f"{what}: kernel and twin differ in {name} ({bad} slots)")
    live = wi >= 0
    return float((gd - wd).abs()[live].max()) if bool(live.any()) else 0.0


def _pair(fixture: dict, synthetic):
    """(source, target) of a fixture's pair: the target rotated about z and
    shifted."""
    pair = fixture["pair"]
    tgt = getattr(synthetic, pair["cloud"])(pair["n_points"], seed=pair["seed"])
    c, s = np.cos(pair["theta"]), np.sin(pair["theta"])
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return tgt @ rot.T + np.array(pair["shift"]), tgt


def _params(port, fixture: dict, search_impl: str):
    pp = {k: v for k, v in fixture["params"].items() if k not in ("search_impl", "outer_chunk")}
    return port.RegistrationParams(**pp, search_impl=search_impl)


def _edge_case(torch, fg, *, seed, lattice, n_lanes, n_win=48, n_groups=512):
    """Windows and grouped rows with segment bounds narrower than the row,
    invalid rows, dead groups and (on a lattice) exact distance ties."""
    rng = np.random.default_rng(seed)
    union = rng.integers(0, n_lanes + 1, n_win)
    union[0] = n_lanes  # at least one full-width window
    union[-1] = 0  # the dead window
    if lattice:
        xyz = rng.integers(0, 5, size=(n_win, 3, n_lanes)).astype(np.float32)
    else:
        xyz = rng.uniform(0, 4, size=(n_win, 3, n_lanes)).astype(np.float32)
    idx = rng.integers(0, 1 << 20, size=(n_win, n_lanes)).astype(np.int32)
    dead = (np.arange(n_lanes)[None, :] >= union[:, None]) | (
        rng.random((n_win, n_lanes)) < 0.1
    )
    idx[dead] = -1
    xyz[np.broadcast_to(dead[:, None, :], xyz.shape)] = 1e30
    width = np.where(union > 0, np.minimum(np.ceil(union / 128) * 128, n_lanes), 0)
    step_rows = rng.integers(0, n_win, n_groups).astype(np.int32)
    step_rows[rng.random(n_groups) < 0.15] = n_win - 1
    rows = n_groups * fg.GROUP
    if lattice:
        src = rng.integers(0, 5, size=(rows, 3)).astype(np.float32)
        src[::3] += 0.5
    else:
        src = rng.uniform(0, 4, size=(rows, 3)).astype(np.float32)
    lo = 16 * rng.integers(0, n_lanes // 32, rows)
    hi = lo + 16 * rng.integers(1, n_lanes // 16, rows)
    full = rng.random(rows) < 0.5
    lo[full], hi[full] = 0, n_lanes
    meta = fg.pack_row_meta(rng.random(rows) > 0.1, lo, hi).astype(np.float32)
    padded = np.concatenate([src, meta[:, None]], axis=1)
    dev = "cuda"
    return dict(
        padded=torch.as_tensor(padded, device=dev),
        cand_xyz=torch.as_tensor(xyz, device=dev),
        cand_idx=torch.as_tensor(idx, device=dev),
        step_rows=torch.as_tensor(step_rows, device=dev),
        width_lut=torch.as_tensor(width.astype(np.int32), device=dev),
    )


def _build_kernels(kernels) -> None:
    """Build every kernel, one nvcc per source, all started together."""

    def build(name):
        cached = kernels.library_path(name).exists()
        t0 = time.perf_counter()
        kernels.build(name)
        return name, time.perf_counter() - t0, cached

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(build, KERNELS))
    for name, seconds, cached in built:
        print(f"build: {Path(KERNELS[name][0]).name} {seconds:.2f} s"
              f"{' (already built)' if cached else ''}")
        log = kernels.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}")
        kernels.load(name)


def _check_against_fixture(reg, final, fixture: dict, what: str) -> None:
    """Raise unless the run reproduces the JAX fixture: every iteration's
    correspondence count within COUNT_RTOL, the final 4x4 within
    TRANSFORM_ATOL."""
    want_T = np.array(fixture["final_transform"])
    if final.shape != (4, 4) or not np.all(np.isfinite(final)):
        raise AssertionError(f"{what}: bad final transform {final}")
    if len(reg.records) != len(fixture["iterations"]):
        raise AssertionError(f"{what}: {len(reg.records)} iterations, fixture has "
                             f"{len(fixture['iterations'])}")
    t_err = float(np.abs(final - want_T).max())
    print(f"{what}: iter  corr(port)  corr(ref)  initial_cost(port)  initial_cost(ref)  lm_steps")
    worst = 0.0
    for i, (rec, ref) in enumerate(zip(reg.records, fixture["iterations"])):
        rel = abs(rec.num_correspondences - ref["correspondences"]) / ref["correspondences"]
        worst = max(worst, rel)
        print(f"{i:4d}  {rec.num_correspondences:10d}  {ref['correspondences']:9d}  "
              f"{rec.initial_cost:18.8g}  {ref['initial_cost']:17.8g}  "
              f"{rec.num_successful_steps:8d}")
    print(f"{what}: final 4x4 vs JAX fixture max abs diff {t_err:.3e} (limit {TRANSFORM_ATOL}); "
          f"worst correspondence-count diff {worst:.2e} (limit {COUNT_RTOL})")
    if t_err > TRANSFORM_ATOL or worst > COUNT_RTOL:
        raise AssertionError(f"{what}: the run disagrees with the JAX fixture")
    if reg.engine_fallbacks or reg.inner_cap_hits:
        raise AssertionError(f"{what}: engine_fallbacks={reg.engine_fallbacks}, "
                             f"inner_cap_hits={reg.inner_cap_hits}")


def _warm_pairs(port, torch, src, tgt, params, what: str) -> None:
    """Median of 3 warm pairs (ctor + align, ending in a synchronize), with
    the ctor / align split."""
    total, ctor, align = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reg.align()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        total.append(t2 - t0)
        ctor.append(t1 - t0)
        align.append(t2 - t1)
    med = statistics.median(total)
    i = total.index(med)
    print(f"{what}: warm pair seconds, median of 3: {med:.4f} "
          f"({', '.join(f'{w:.4f}' for w in total)}); that pair: ctor {ctor[i]:.4f} s, "
          f"align {align[i]:.4f} s ({len(reg.records)} iterations, median iteration "
          f"{1e3 * statistics.median(reg.iteration_times):.2f} ms)")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    import probabilistic_point_clouds_registration_tpu_torch as port
    from probabilistic_point_clouds_registration_tpu_torch import kernels
    from probabilistic_point_clouds_registration_tpu_torch.core.types import (
        pad_cloud,
        round_up,
    )
    from probabilistic_point_clouds_registration_tpu_torch.io import synthetic
    from probabilistic_point_clouds_registration_tpu_torch.ops import fused_grid as fg
    from probabilistic_point_clouds_registration_tpu_torch.ops import fused_pool as fp
    from probabilistic_point_clouds_registration_tpu_torch.ops.grid import build_grid_host
    from probabilistic_point_clouds_registration_tpu_torch.ops.select_bitonic import (
        select_bitonic,
    )

    if Path(port.__file__).resolve().parent.parent != REPO:
        raise SystemExit(f"chip_smoke: the port was imported from {port.__file__}, "
                         f"not from this checkout")
    fixtures = {name: json.loads((DATA / f"torch_port_{name}_ref.json").read_text())
                for name in ("bunny35k", "kitti131k")}
    pairs = {name: _pair(fx, synthetic) for name, fx in fixtures.items()}
    counted = {"select_windows": fg.select_windows, "select_bitonic": select_bitonic}

    def zero_counts():
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0

    # -- 1. setup ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)  # the card's name and power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    _build_kernels(kernels)

    # -- 2. the dense engine: B1 against its twin, then the fused pair -------
    bunny = fixtures["bunny35k"]
    src, tgt = pairs["bunny35k"]
    params = _params(port, bunny, "fused")
    k = params.max_neighbours
    r2 = float(np.float32(params.radius) ** 2)
    grid = port.ProbabilisticRegistration.prepare_target(tgt, params)["grid"]
    pre = fg.build_prepack(
        grid,
        torch.as_tensor(grid["bucket_pts"].astype(np.float32), device="cuda"),
        torch.as_tensor(grid["bucket_idx"], device="cuda"),
        k=k,
    )
    src_p, n_src = pad_cloud(src, params.pad_multiple, pad_value=0.0)
    source = torch.as_tensor(src_p.astype(np.float32), device="cuda")
    valid = torch.arange(src_p.shape[0], device="cuda") < n_src
    padded, step_rows, _, _, overflow = fg._group_by_window(
        source, valid, pre.lut_d, pre.origin_d, pre.dims_d,
        pre.cand_idx.shape[0] - 1, params.radius,
        round_up(2 * src_p.shape[0], fg._ROW_ALIGN), n_lanes=pre.n_lanes,
    )
    if int(overflow) != 0:
        raise AssertionError(f"dense bench grouping overflowed by {int(overflow)} rows")
    args = (padded, pre.cand_xyz, pre.cand_idx, step_rows, pre.width_lut)
    out = fg.select_windows(*args, k=k, radius=params.radius)
    twin = fg._select_windows_plain(*args, k=k, kp=32, r2=r2)
    torch.cuda.synchronize()
    max_err = {"select_windows": _bit_equal(out, twin, "B1 dense bench shapes"),
               "select_bitonic": 0.0}
    print(f"B1 dense bench shapes: rows {padded.shape[0]}, windows {pre.cand_idx.shape[0]}, "
          f"lanes {pre.n_lanes}, k {k}, live slots {int((out[1] >= 0).sum())}: bit-equal to twin")
    b1_ms = _cuda_ms(lambda: fg.select_windows(*args, k=k, radius=params.radius))
    twin_ms = _cuda_ms(lambda: fg._select_windows_plain(*args, k=k, kp=32, r2=r2))
    print(f"B1 dense bench shapes (median of 20, CUDA events): kernel {b1_ms:.4f} ms, "
          f"twin {twin_ms:.4f} ms")
    for name, case in [
        ("segments, invalid rows, dead groups", dict(seed=1, lattice=False, n_lanes=384, k=20)),
        ("lattice ties, k=1", dict(seed=2, lattice=True, n_lanes=256, k=1)),
        ("lattice ties, k=32", dict(seed=3, lattice=True, n_lanes=256, k=32)),
        ("window of 5120 lanes", dict(seed=4, lattice=False, n_lanes=5120, k=20)),
    ]:
        kk = case.pop("k")
        a = _edge_case(torch, fg, **case)
        radius = 1.6 if case["lattice"] else 0.9
        got = fg.select_windows(**a, k=kk, radius=radius)
        want = fg._select_windows_plain(**a, k=kk, kp=32, r2=float(np.float32(radius) ** 2))
        torch.cuda.synchronize()
        _bit_equal(got, want, f"B1 edge case '{name}'")
        print(f"B1 edge case '{name}': {int((got[1] >= 0).sum())} live slots, bit-equal")

    zero_counts()
    reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
    final = reg.align()
    torch.cuda.synchronize()
    launches = fg.select_windows.launches
    b1_launches = launches
    if reg.engine != "fused" or launches != params.n_iter:
        raise AssertionError(f"dense path: engine {reg.engine}, {launches} B1 launches, "
                             f"expected fused and {params.n_iter}")
    print(f"dense path (search_impl='fused'): engine {reg.engine}, B1 launches {launches}, "
          f"engine_fallbacks {reg.engine_fallbacks}, inner_cap_hits {reg.inner_cap_hits}")
    _check_against_fixture(reg, final, bunny, "bunny35k fused")
    _warm_pairs(port, torch, src, tgt, params, "bunny35k fused")

    # -- 3. B4 and B1 against the twin on the pooled class passes -----------
    regs, class_ms = {}, {"select_windows": 0.0, "select_bitonic": 0.0, "plain": 0.0}
    for name, fixture in fixtures.items():
        src, tgt = pairs[name]
        params = _params(port, fixture, "auto")
        reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
        if reg.engine != "pool":
            raise AssertionError(f"{name}: auto took the {reg.engine} engine, expected pool")
        regs[name] = reg
        pool = reg._pool
        budget, class_budgets = reg.pool_budgets()
        passes, _, _, overflow = fp.class_passes(
            reg._src, reg._src_valid, pool.select_xyz, pool.pool_idx,
            pool.class_width_luts, pool.lut_d, pool.origin_d, pool.dims_d,
            radius=params.radius,
            class_widths=pool.class_widths, class_ends=pool.class_ends,
            class_budgets=class_budgets, budget_rows=budget,
            small_unions=pool.small_unions, select_max_w=pool.select_max_w,
        )
        if int(overflow) != 0:
            raise AssertionError(f"{name}: the initial pose overflows the pooled budgets")
        k = params.max_neighbours
        r2 = float(np.float32(params.radius) ** 2)
        print(f"{name} pool: {pool.n_dilated} dilated windows, classes {pool.class_widths}, "
              f"pool rows {pool.class_ends}, row budget {budget}, cutoff {pool.select_max_w}")
        for w_c, b_c, a in passes:
            twin = fg._select_windows_plain(*a, k=k, kp=32, r2=r2)
            b4 = select_bitonic(*a, k=k, radius=params.radius)
            b1 = fg.select_windows(*a, k=k, radius=params.radius)
            torch.cuda.synchronize()
            what = f"{name} class {w_c} ({b_c * fg.GROUP} rows)"
            for kernel, got in (("select_bitonic", b4), ("select_windows", b1)):
                max_err[kernel] = max(max_err[kernel], _bit_equal(got, twin, f"{kernel} {what}"))
            ms = {
                "select_bitonic": _cuda_ms(lambda: select_bitonic(*a, k=k, radius=params.radius)),
                "plain": _cuda_ms(lambda: fg._select_windows_plain(*a, k=k, kp=32, r2=r2)),
                "select_windows": _cuda_ms(lambda: fg.select_windows(*a, k=k, radius=params.radius)),
            }
            for key, value in ms.items():
                class_ms[key] += value
            print(f"{what}: {int((twin[1] >= 0).sum())} live slots, B4 and B1 bit-equal to "
                  f"twin; B4 {ms['select_bitonic']:.4f} ms, twin {ms['plain']:.4f} ms, "
                  f"B1 {ms['select_windows']:.4f} ms (median of 20, CUDA events)")
    for name, case in [
        ("segments, invalid rows, dead groups, 128 lanes",
         dict(seed=11, lattice=False, n_lanes=128, k=20)),
        ("segments, invalid rows, dead groups, 512 lanes",
         dict(seed=12, lattice=False, n_lanes=512, k=20)),
        ("segments, invalid rows, dead groups, 4096 lanes",
         dict(seed=13, lattice=False, n_lanes=4096, k=20)),
        ("lattice ties, k=1, 128 lanes", dict(seed=14, lattice=True, n_lanes=128, k=1)),
        ("lattice ties, k=32, 512 lanes", dict(seed=15, lattice=True, n_lanes=512, k=32)),
        ("lattice ties, k=32, 4096 lanes", dict(seed=16, lattice=True, n_lanes=4096, k=32)),
    ]:
        kk = case.pop("k")
        a = _edge_case(torch, fg, **case)
        radius = 1.6 if case["lattice"] else 0.9
        got = select_bitonic(**a, k=kk, radius=radius)
        want = fg._select_windows_plain(**a, k=kk, kp=32, r2=float(np.float32(radius) ** 2))
        torch.cuda.synchronize()
        _bit_equal(got, want, f"B4 edge case '{name}'")
        print(f"B4 edge case '{name}': {int((got[1] >= 0).sum())} live slots, bit-equal")

    # -- 4. the pooled search against the same search on the twin ---------
    for name, reg in regs.items():
        p, pool = reg.params, reg._pool
        k = p.max_neighbours
        budget, class_budgets = reg.pool_budgets()
        search = dict(k=k, radius=p.radius, class_widths=pool.class_widths,
                      class_ends=pool.class_ends, class_budgets=class_budgets,
                      budget_rows=budget, small_unions=pool.small_unions,
                      select_max_w=pool.select_max_w)
        tables = (reg._src, reg._src_valid, pool.select_xyz, pool.pool_idx,
                  pool.class_width_luts, pool.lut_d, pool.origin_d, pool.dims_d)
        zero_counts()
        got, got_ovf, got_pts = fp.fused_pool_search(*tables, **search)
        torch.cuda.synchronize()
        n_b4, n_b1 = select_bitonic.launches, fg.select_windows.launches
        if (n_b4, n_b1) != (len(pool.class_widths), 0):
            raise AssertionError(f"{name}: {n_b4} B4 and {n_b1} B1 launches, expected "
                                 f"{len(pool.class_widths)} and 0")
        search.pop("k")
        search.pop("radius")
        passes, order, dst, ovf = fp.class_passes(*tables, radius=p.radius, **search)
        r2 = float(np.float32(p.radius) ** 2)
        twin = [(b_c, fg._select_windows_plain(*a, k=k, kp=32, r2=r2)) for _, b_c, a in passes]
        want, want_pts = fp.overlay_classes(twin, order, dst, k=k, n=reg._src.shape[0],
                                            dtype=reg._src.dtype)
        for field, x, y in (("indices", got.indices, want.indices), ("mask", got.mask, want.mask),
                            ("sq_dists", got.sq_dists.view(torch.int32),
                             want.sq_dists.view(torch.int32)),
                            ("points", got_pts.view(torch.int32), want_pts.view(torch.int32))):
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: the pooled search and its twin differ in {field}")
        if int(got_ovf) or int(ovf):
            raise AssertionError(f"{name}: the pooled search overflowed")
        print(f"{name}: fused_pool_search ({n_b4} B4 launches) == the search on the twin in "
              f"every slot ({int(got.mask.sum())} correspondences)")

    # -- 5./6. the main path: auto on the pooled engine, both pairs ---------
    b4_launches = 0
    for name, fixture in fixtures.items():
        src, tgt = pairs[name]
        params = _params(port, fixture, "auto")
        zero_counts()
        t0 = time.perf_counter()
        reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
        final = reg.align()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {key: fn.launches for key, fn in counted.items()}
        n_classes = len(reg._pool.class_widths) if reg._pool is not None else 0
        # Each escalation redoes one iteration; every class (pow2, k = 20)
        # runs B4.
        want = (params.n_iter + reg._pool_budget_boost) * n_classes
        print(f"{name} main path (auto): engine {reg.engine}, classes "
              f"{reg._pool.class_widths if reg._pool is not None else None}, B1 launches "
              f"{launches['select_windows']}, B4 launches {launches['select_bitonic']}, "
              f"budget boost {reg._pool_budget_boost}, engine_fallbacks "
              f"{reg.engine_fallbacks}, inner_cap_hits {reg.inner_cap_hits}; "
              f"first pair in the process {first_s:.4f} s")
        if reg.engine != "pool" or want == 0 or (
                launches["select_bitonic"], launches["select_windows"]) != (want, 0):
            raise AssertionError(f"{name}: engine {reg.engine}, {launches['select_bitonic']} B4 "
                                 f"and {launches['select_windows']} B1 launches, expected "
                                 f"pool, {want} and 0")
        if name == "bunny35k" and reg._pool_budget_boost:
            raise AssertionError(f"{name}: the pooled budget escalated")
        b4_launches += launches["select_bitonic"]
        _check_against_fixture(reg, final, fixture, f"{name} pool")
        _warm_pairs(port, torch, src, tgt, params, f"{name} pool")
        # The host plan and the pool build on their own, warm.
        tg, n_tgt = pad_cloud(np.asarray(tgt, np.float64), params.pad_multiple, pad_value=0.0)
        for rep in range(2):
            t0 = time.perf_counter()
            grid = build_grid_host(tg, params.radius, num_valid=n_tgt,
                                   max_overflow=params.grid_max_overflow, buckets=False)
            t1 = time.perf_counter()
            plan = fp.plan_pool_host(grid, tg, device="cuda")
            t2 = time.perf_counter()
            fp.build_pool_prepack(grid, tg, plan=plan, k=params.max_neighbours, device="cuda")
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        print(f"{name}: host grid build seconds {t1 - t0:.4f}")
        print(f"{name}: host plan seconds {t2 - t1:.4f}")
        print(f"{name}: pool build seconds {t3 - t2:.4f}")

    # -- 7. result lines -----------------------------------------------------
    launch_total = {"select_windows": b1_launches, "select_bitonic": b4_launches}
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launch_total[name],
        "max_abs_err": max_err[name],
        "ms": class_ms[name],
        "plain_ms": class_ms["plain"],
    } for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
