"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``csrc/``, holds the kernel against
its plain PyTorch twin at the main path's shapes and on edge cases (bit for
bit), then registers the 35k ``bunny_like`` bench pair through
``ProbabilisticRegistration(..., device="cuda").align()`` and holds the
result against the JAX package's fixture
(tests/data/torch_port_bunny35k_ref.json). Every failure raises, so the
exit code is nonzero. The last two lines of standard output are a JSON line
with the kernel's launches and times, then ``{"ok": true, "device": ...}``.
It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "tests" / "data" / "torch_port_bunny35k_ref.json"
KERNEL_SOURCE = "probabilistic_point_clouds_registration_tpu_torch/csrc/select_windows.cu"
TPU_KERNEL = "probabilistic_point_clouds_registration_tpu/ops/fused_grid.py:476"
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


def _bit_equal(got, want, what: str) -> None:
    """Raise unless every slot of the select outputs is bit-equal."""
    import torch

    (gd, gi, gp), (wd, wi, wp) = got, want
    for name, a, b in [("outd", gd, wd), ("outi", gi, wi)] + [
        (f"out{c}", a, b) for c, a, b in zip("xyz", gp, wp)
    ]:
        if a.shape != b.shape or not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            bad = int((a.view(torch.int32) != b.view(torch.int32)).sum())
            raise AssertionError(f"{what}: kernel and twin differ in {name} ({bad} slots)")


def _bench_pair(fixture: dict, bunny_like):
    pair = fixture["pair"]
    tgt = bunny_like(pair["n_points"], seed=pair["seed"])
    c, s = np.cos(pair["theta"]), np.sin(pair["theta"])
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return tgt @ rot.T + np.array(pair["shift"]), tgt


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
    from probabilistic_point_clouds_registration_tpu_torch.io.synthetic import bunny_like
    from probabilistic_point_clouds_registration_tpu_torch.ops import fused_grid as fg

    if Path(port.__file__).resolve().parent.parent != REPO:
        raise SystemExit(f"chip_smoke: the port was imported from {port.__file__}, "
                         f"not from this checkout")
    fixture = json.loads(FIXTURE.read_text())

    # -- 1. setup ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)  # the card's name and power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cached = kernels.library_path("select_windows").exists()
    kernels.load("select_windows")
    print(f"build: select_windows.cu {time.perf_counter() - t0:.2f} s"
          f"{' (already built)' if cached else ''}")
    log = kernels.library_path("select_windows").with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # -- 2. B1 against its twin at the bench shapes -------------------------
    pp = {k: v for k, v in fixture["params"].items() if k not in ("search_impl", "outer_chunk")}
    params = port.RegistrationParams(**pp, search_impl="auto")
    src, tgt = _bench_pair(fixture, bunny_like)
    grid = port.ProbabilisticRegistration.prepare_target(tgt, params)["grid"]
    pre = fg.build_prepack(
        grid,
        torch.as_tensor(grid["bucket_pts"].astype(np.float32), device="cuda"),
        torch.as_tensor(grid["bucket_idx"], device="cuda"),
        k=params.max_neighbours,
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
        raise AssertionError(f"bench grouping overflowed by {int(overflow)} rows")
    args = (padded, pre.cand_xyz, pre.cand_idx, step_rows, pre.width_lut)
    k = params.max_neighbours
    r2 = float(np.float32(params.radius) ** 2)
    kernel_out = fg.select_windows(*args, k=k, radius=params.radius)
    twin_out = fg._select_windows_plain(*args, k=k, kp=32, r2=r2)
    torch.cuda.synchronize()
    _bit_equal(kernel_out, twin_out, "bench shapes")
    live = kernel_out[1] >= 0
    max_abs_err = float((kernel_out[0] - twin_out[0]).abs()[live].max()) if live.any() else 0.0
    print(f"B1 bench shapes: rows {padded.shape[0]}, windows {pre.cand_idx.shape[0]}, "
          f"lanes {pre.n_lanes}, k {k}, live slots {int(live.sum())}: bit-equal to twin")
    kernel_ms = _cuda_ms(lambda: fg.select_windows(*args, k=k, radius=params.radius))
    plain_ms = _cuda_ms(lambda: fg._select_windows_plain(*args, k=k, kp=32, r2=r2))
    print(f"B1 time (median of 20, CUDA events): kernel {kernel_ms:.4f} ms, "
          f"twin {plain_ms:.4f} ms")

    # -- 3. B1 edge cases against its twin ----------------------------------
    cases = [
        ("segments, invalid rows, dead groups", dict(seed=1, lattice=False, n_lanes=384, k=20)),
        ("lattice ties, k=1", dict(seed=2, lattice=True, n_lanes=256, k=1)),
        ("lattice ties, k=32", dict(seed=3, lattice=True, n_lanes=256, k=32)),
        ("window of 5120 lanes", dict(seed=4, lattice=False, n_lanes=5120, k=20)),
    ]
    for name, case in cases:
        kk = case.pop("k")
        a = _edge_case(torch, fg, **case)
        radius = 1.6 if case["lattice"] else 0.9
        got = fg.select_windows(**a, k=kk, radius=radius)
        want = fg._select_windows_plain(**a, k=kk, kp=32, r2=float(np.float32(radius) ** 2))
        torch.cuda.synchronize()
        _bit_equal(got, want, name)
        print(f"B1 edge case '{name}': {int((got[1] >= 0).sum())} live slots, bit-equal")

    # -- 4. the main path ----------------------------------------------------
    fg.select_windows.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
    final = reg.align()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = fg.select_windows.launches
    n_iter = params.n_iter
    if reg.engine != "fused":
        raise AssertionError(f"engine is {reg.engine}, expected fused")
    if launches != n_iter:
        raise AssertionError(f"B1 launched {launches} times in the main path, expected {n_iter}")
    if reg.engine_fallbacks or reg.inner_cap_hits:
        raise AssertionError(f"engine_fallbacks={reg.engine_fallbacks}, "
                             f"inner_cap_hits={reg.inner_cap_hits}")
    want_T = np.array(fixture["final_transform"])
    if final.shape != (4, 4) or not np.all(np.isfinite(final)):
        raise AssertionError(f"bad final transform {final}")
    t_err = float(np.abs(final - want_T).max())
    print("iter  corr(port)  corr(ref)  initial_cost(port)  initial_cost(ref)  lm_steps")
    worst = 0.0
    for i, (rec, ref) in enumerate(zip(reg.records, fixture["iterations"])):
        rel = abs(rec.num_correspondences - ref["correspondences"]) / ref["correspondences"]
        worst = max(worst, rel)
        print(f"{i:4d}  {rec.num_correspondences:10d}  {ref['correspondences']:9d}  "
              f"{rec.initial_cost:18.8g}  {ref['initial_cost']:17.8g}  "
              f"{rec.num_successful_steps:8d}")
    if len(reg.records) != len(fixture["iterations"]):
        raise AssertionError(f"{len(reg.records)} iterations, fixture has "
                             f"{len(fixture['iterations'])}")
    print(f"main path: engine {reg.engine}, B1 launches {launches}, engine_fallbacks "
          f"{reg.engine_fallbacks}, inner_cap_hits {reg.inner_cap_hits}")
    print(f"final 4x4 vs JAX fixture: max abs diff {t_err:.3e} (limit {TRANSFORM_ATOL}); "
          f"worst correspondence-count diff {worst:.2e} (limit {COUNT_RTOL})")
    if t_err > TRANSFORM_ATOL or worst > COUNT_RTOL:
        raise AssertionError("the main path disagrees with the JAX fixture")

    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port.ProbabilisticRegistration(src, tgt, params, device="cuda").align()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    print(f"pair seconds (ctor + align, 15 iterations): first {cold_s:.4f}, "
          f"warm median of 3 {statistics.median(warm):.4f} ({', '.join(f'{w:.4f}' for w in warm)})")

    # -- 5. result lines -----------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "select_windows",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
