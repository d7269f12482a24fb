"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (one nvcc per source, in
parallel) and then, raising on the first failure:

1. prints the card, the build seconds and, per kernel function, ptxas's
   registers, spill bytes and static shared memory;
2. the dense engine: holds B1 (``select_windows``) bit for bit against its
   plain twin at the dense bench shapes (timed beside its bound there) and
   on edge cases: random segments, lattice ties, windows of 384, 5,120 and
   202 lanes (the last takes no 16-byte load), widths off a multiple of 4,
   and what the one-pass walk could get wrong (``_walker_cases``), at k 1,
   12, 20, 32 and, through the rounds kernel, 40; then registers the 35k
   ``bunny_like`` bench pair with ``search_impl="fused"``;
3. holds B4 (``select_bitonic``) and B1 bit for bit against the twin (and
   so against each other) on every class pass of the pooled search of
   both pairs (35k bunny, 131k ``kitti_like``) at their initial pose, and
   B4 on the same edge cases at 128, 512, 2,048 and 4,096 lanes; times B4,
   the twin and B1 on the same inputs, each pass beside its own bound;
4. holds ``fused_pool_search`` (its kernel classes on B4) slot for slot
   against the same search with every class pass on the twin, on both
   pairs;
5. the main path: ``ProbabilisticRegistration(..., device="cuda").align()``
   with ``auto`` (the pooled engine, its classes on B4) on the bunny pair,
   against the JAX package's fixture (tests/data/torch_port_bunny35k_ref.json);
6. the same on the LiDAR pair (tests/data/torch_port_kitti131k_ref.json);
7. holds B2 (``pallas_row_topk``) bit for bit against its twin on the real
   candidate-distance matrix of the first source block of both pairs and on
   edge cases (all-+inf rows, ties, ragged and short rows, a base that is
   only 4-byte aligned, exactly k finite entries at a row's far end, a
   staging buffer that fills on a tie); times B2, the twin and
   ``torch.topk`` (the library call);
8. holds ``grid_radius_search`` with ``select_impl="pallas"`` slot for slot
   against ``"topk"`` on both pairs, the overflow merge included;
9. the grid path: ``search_impl="grid"``, ``search_select="pallas"`` on both
   pairs against the fixtures;
10. holds B3 (``brute_knn``) bit for bit against its twin on the bunny pair
    (35,840 x 35,840) and on edge cases (ragged target tiles and source
    blocks, fewer targets than a warp, 33 targets at one distance); times
    both;
11. the KNN-kernel path: ``search_impl="pallas"`` on the bunny pair against
    the fixture, and one timed 131k x 131k B3 search on the LiDAR pair, every
    row of it held against the twin;
12. a forced fallback: a pooled pair whose row budget is held at its floor
    overflows three times and ends on the grid engine, where
    ``search_impl="grid"`` alone ends;
13. the inner solve's CUDA graphs against the same blocks run eagerly: both
    pairs through ``auto`` once with the LM blocks captured and replayed and
    once eagerly, in this process; every record, the LM counts and the
    final 4x4 bit-equal, B4's launches per pair unchanged;
14. ``outer_chunk`` 1, 4 and 16 on the bunny pair at the reference's
    default stopping rule (cost drop 1% for more than 5 iterations): the
    same records, within the fixture limits, and the slots each run spent;
15. the bunny pair with both voxel filters (a 0.02 leaf) through ``auto``,
    against the JAX package's fixture
    (tests/data/torch_port_bunny35k_voxel_ref.json);
16. the pair CLI (``cli.main``) on the bunny pair written as PCD files
    (source binary_compressed through the native LZF, target binary, ground
    truth ascii) with ``-v --dump -g``, 15 fixed iterations, once under
    ``--search_impl auto`` (B4) and once under ``pallas`` (B3), each run's
    verbose correspondences and final 4x4 against the JAX CLI's fixture
    (tests/data/torch_port_cli_bunny35k_ref.json), and the aligned cloud
    read back;
17. sequence odometry at LiDAR scale: six 131,072-point ``kitti_like``
    scans written as KITTI ``.bin`` files, listed and read back through
    ``run_odometry`` (prefetcher, staged prep thread, checkpoint), each
    pair against the JAX fixture (tests/data/torch_port_seq_kitti131k_ref.json:
    relative 4x4, outer iterations), with pairs/s, the ATE, the capture
    seconds per pair and the prep thread's seconds against the main thread's
    wait; the same pairs with each target prepared in line, in turns with
    the pipelined run; then a resume from the checkpoint cut to 2 pairs;
18. loop closure and the pose graph: the square walk of a 35k ``bunny_like``
    world through ``detect_loop_closures`` + ``refine_trajectory`` against
    tests/data/torch_port_loop_bunny35k_ref.json, and a 4,541-pose graph
    (two laps, a closure every 50th pose) in float64 against
    tests/data/torch_port_pose_graph4541_ref.json, with its warm seconds and
    host launches per Gauss-Newton step;
19. the mesh as a world-size-1 NCCL group (``parallel.initialize_multihost``
    on ``tcp://localhost``, a 1x1 mesh whose axes are that group, not the
    no-group identity): ``DistributedRegistration`` (``layout="auto"``) on
    both pairs at full width, each final 4x4 within 5e-6 of its fixture and
    of the single-device ``align()`` of this run, 0 fallbacks, 0 cap hits,
    the LM blocks captured as CUDA graphs with the ``all_reduce`` inside
    (their capture seconds printed); then ``run_odometry(mesh=)`` on the
    first 3 scans of the kitti131k sequence against the sequence fixture's
    first two pairs;
20. four processes sharing the card over ``gloo`` (the backend rule: ranks
    share a card), a 2x2 mesh, the bunny pair at full width with
    ``layout="targets"`` (the reduce-scatter merge and the two-axis solve),
    with ``"auto"``, and with ``debug_replication=True``: every rank's 4x4
    bit-identical and within 5e-6 of the fixture, B4 launched on every rank;
21. two processes, a 1x2 mesh, the bunny pair with its pooled budget
    starved so that the ladder (x2, twice) ends on the sharded grid engine:
    B2 launches on both ranks;
22. the 4,541-pose graph with its edges sharded over two processes
    (``optimize_pose_graph(mesh=)``) against the pose-graph fixture;
23. batches of pairs (``parallel/batch.py``) on the six kitti131k scans of
    phase 17, written as ``.bin`` files and read back: (a) on the batch's
    initial poses, each pooled class pass as ONE launch across the five
    pairs (their pools flattened into one table, each group's row shifted
    by its pair's offset) through B4 and B1, bit-equal to the twin and to
    the same passes launched pair by pair and stacked (the flattened
    pool's largest offset printed beside int32's limit), and B2 bit-equal
    to its twin on one flattened block of the batched grid engine (two
    pairs' rows x 27 x 512 candidates); (b) ``run_odometry_batched`` with
    ``auto`` (the pooled engine, B4) on the five pairs in one program,
    twice: each pair's relative 4x4 within 1e-4 of the sequence fixture,
    its 12 outer iterations, every iteration's correspondence count within
    0.01% of the fixture's, 0 overflow, B4 launched once per class and loop
    iteration, the LM blocks captured; the batch's pairs/s beside phase
    17's, its host-prep and capture seconds; (c) ``grid`` (B2) and
    ``brute`` on the first 3 scans (2 pairs) against the fixture's first
    two pairs; (d) the class budgets starved: the flagged pairs redone on
    the batched grid engine and spliced, within 1e-5 of (c)'s grid run;
24. the batch sharded over two processes sharing the card over ``gloo``
    (5 pairs padded to 6, 3 a rank, no collective in the loop, one
    ``all_gather`` at the end): every rank's poses bit-identical and within
    1e-6 of phase 23(b), B4 launched and the LM blocks captured on each
    rank.

The processes of phases 20-22 and 24 are ``tests/torch_port_mesh_worker.py``'s
(spawned after the kernels are built; a process that fails or outlives its
time limit fails the run); their seconds on the shared card are not scaling
numbers. The workloads of phases 16-18 come from ``tests/torch_port_fixture.py``
(which builds them from the port's ``io/synthetic.py``; it imports JAX only
inside the functions that make the fixtures). The CLIs write into the
working directory: these phases run them in a temporary one.

Phases 5, 6, 13 and 15 print whether the native host library (``native/``,
built with g++) loaded. Each path's launch counts are set to 0 just before
it and read just after.
The last two lines of standard output are a JSON line with each kernel's
launches on the paths that run it (B1: the dense registration of step 2;
B4: the two ``auto`` registrations, the mesh registrations of phases
19-20, every rank's, and the batches of phases 23-24; B2: the two grid
registrations, phase 21's ranks and the batched grid runs of phase 23;
B3: the KNN-kernel registration), its time, its twin's, the library call's where
there is one, and its bound on the same inputs (B1, B4: the class passes of
step 3; B2: the matrices of step 7; B3: the bunny search of step 10), then
``{"ok": true, "device": ...}``. The bound is the larger of the bytes the
function must move (inputs once, outputs once) over 3.35 TB/s and its
float32 operations over 67 TFLOP/s (NVIDIA's H100 SXM data sheet). Beside
B3's bound the script prints the floor its contract sets: the distance must
be rounded operation by operation (no fused multiply-add), about 10 unfused
float32 operations a pair, at half the data sheet's rate, which counts a
fused multiply-add as two operations. It imports neither JAX nor the JAX
package. A failed graph capture or a failed launch raises: nothing falls
back to eager or to the CPU.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
    "row_topk": (f"{PORT}/csrc/row_topk.cu",
                 "probabilistic_point_clouds_registration_tpu/ops/select_pallas.py:28"),
    "brute_knn": (f"{PORT}/csrc/brute_knn.cu",
                  "probabilistic_point_clouds_registration_tpu/ops/neighbors_pallas.py:42"),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
# Unfused float32 operations per (source, target) pair of B3's contract: 3
# multiplies and 2 adds for the cross term, s2 + t2, the multiply by 2, the
# subtraction, the clamp and the compare.
B3_OPERATIONS_PER_PAIR = 10
TRANSFORM_ATOL = 1e-4  # final 4x4 against the fixture
COUNT_RTOL = 1e-4  # per-iteration correspondence counts against the fixture
REFINED_ATOL = 1e-6  # loop-closure refined poses against the fixture
POSE_GRAPH_RTOL = 1e-9  # the 4,541-pose graph's final cost (float64)
POSE_GRAPH_ATOL = 1e-8  # its poses (float64)


def _cuda_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), warm.
    The device is kept busy (a spin of about 0.1 ms) while the host enqueues
    the events and ``fn``'s launches, so that a kernel shorter than its
    wrapper's host time is not charged the wait for its own launch."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _equal_bits(pairs, what: str) -> None:
    """Raise unless every (name, got, want) pair of tensors is bit-equal."""
    import torch

    for name, a, b in pairs:
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.shape != b.shape or not torch.equal(a, b):
            bad = int((a != b).sum()) if a.shape == b.shape else -1
            raise AssertionError(f"{what}: {name} differs in {bad} slots")


def _max_abs_diff(got, want, where) -> float:
    """Largest |got - want| over the slots ``where`` (0 when there is none)."""
    return float((got - want).abs()[where].max()) if bool(where.any()) else 0.0


def _bit_equal(got, want, what: str) -> float:
    """Raise unless every slot of the select outputs is bit-equal; returns
    the largest |outd| difference over live slots (0 when equal)."""
    (gd, gi, gp), (wd, wi, wp) = got, want
    _equal_bits([("outd", gd, wd), ("outi", gi, wi)]
                + [(f"out{c}", a, b) for c, a, b in zip("xyz", gp, wp)], what)
    return _max_abs_diff(gd, wd, wi >= 0)


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


def _walker_cases(pack_row_meta, *, n_lanes: int, seed: int, odd_widths: bool = False,
                  n_groups: int = 36) -> dict:
    """numpy inputs of a window select that its one-pass walk could get
    wrong, with the radius they are made for. Six windows, taken in turn
    by the groups:

    0. every lane live, about a third of them within the radius: more than
       32 survivors in the first 128-lane step;
    1. a lattice of 27 points repeated over the lanes, the sources on its
       centre: runs of equal distances longer than the staging buffer;
    2. live lanes far outside the radius but for 12 near ones, all in the
       last 16 lanes of the segment [48, 208) (or [48, n_lanes - 16) in a
       narrower window): exactly k = 12 live lanes at a segment's end;
    3. random points, a tenth of the lanes dead, a union short of the
       window;
    4. every lane within the radius: 128 survivors a step;
    5. the dead window.

    Each group's 8 rows take, in turn: the whole window; the segment above,
    whose bounds are multiples of 16 and not of 128; an empty segment;
    an invalid row; the whole window; the first and the last 16 lanes; the
    segment again. ``odd_widths`` sets three windows' widths off a multiple
    of 4 (and one below its union), which the twin honours lane by lane.
    """
    rng = np.random.default_rng(seed)
    n_win = 6
    seg_lo, seg_hi = 48, min(208, n_lanes - 16)
    xyz = np.full((n_win, 3, n_lanes), 1e30, np.float32)
    idx = np.full((n_win, n_lanes), -1, np.int32)
    ids = rng.permutation(1 << 20)[: n_win * n_lanes].reshape(n_win, n_lanes).astype(np.int32)
    xyz[0], idx[0] = rng.uniform(-0.6, 0.6, (3, n_lanes)), ids[0]
    xyz[1], idx[1] = 0.25 * rng.integers(-1, 2, (3, n_lanes)), ids[1]
    xyz[2], idx[2] = rng.uniform(50, 60, (3, n_lanes)), ids[2]
    xyz[2][:, seg_hi - 14: seg_hi - 2] = rng.uniform(-0.2, 0.2, (3, 12))
    union = n_lanes - 40
    live = rng.random(union) >= 0.1
    xyz[3][:, :union][:, live] = rng.uniform(-0.8, 0.8, (3, int(live.sum())))
    idx[3][:union][live] = ids[3][:union][live]
    xyz[4], idx[4] = rng.uniform(-0.25, 0.25, (3, n_lanes)), ids[4]
    width = np.array([n_lanes] * 5 + [0], np.int32)
    width[3] = min(-(-union // 128) * 128, n_lanes)
    if odd_widths:
        width[0], width[1], width[3] = n_lanes - 3, n_lanes - 2, 50
    step_rows = (np.arange(n_groups) % n_win).astype(np.int32)
    rows = n_groups * 8
    src = rng.uniform(-0.1, 0.1, (rows, 3)).astype(np.float32)
    on_lattice = np.repeat(step_rows == 1, 8)
    src[on_lattice] = 0.0
    src[on_lattice & (np.arange(rows) % 2 == 1), 0] = 0.125
    turn = np.arange(rows) % 8
    lo = np.select([turn == 1, turn == 2, turn == 6, turn == 7],
                   [seg_lo, 32, (n_lanes - 1) // 16 * 16, seg_lo], 0)
    hi = np.select([turn == 1, turn == 2, turn == 5, turn == 7],
                   [seg_hi, 32, 16, seg_hi], n_lanes)
    meta = pack_row_meta(turn != 3, lo, hi).astype(np.float32)
    return dict(padded=np.concatenate([src, meta[:, None]], axis=1), cand_xyz=xyz,
                cand_idx=idx, step_rows=step_rows, width_lut=width, radius=0.5)


def _hold_walker_cases(torch, fg, select, what: str, lanes, ks) -> None:
    """Hold ``select`` bit for bit against the twin on ``_walker_cases`` at
    every window width of ``lanes`` and every k of ``ks``, with widths on
    and off a multiple of 4."""
    for n_lanes in lanes:
        for odd_widths in (False, True):
            case = _walker_cases(fg.pack_row_meta, n_lanes=n_lanes, seed=n_lanes,
                                 odd_widths=odd_widths)
            radius = case.pop("radius")
            a = {key: torch.as_tensor(value, device="cuda") for key, value in case.items()}
            found = []
            for kk in ks:
                kp = 32 if kk <= 32 else -(-kk // 128) * 128
                got = select(**a, k=kk, radius=radius)
                want = fg._select_windows_plain(**a, k=kk, kp=kp,
                                                r2=float(np.float32(radius) ** 2))
                torch.cuda.synchronize()
                _bit_equal(got, want, f"{what} walker cases, {n_lanes} lanes, k={kk}, "
                                      f"odd widths {odd_widths}")
                found.append(int((got[1] >= 0).sum()))
            print(f"{what} walker cases, {n_lanes} lanes, widths "
                  f"{'off' if odd_widths else 'on'} a multiple of 4: k in {tuple(ks)}, "
                  f"live slots {found}, bit-equal")


def _ptxas_summary(log: str) -> str:
    """One line from ``nvcc -Xptxas -v``'s output: per kernel function its
    registers, spill bytes (stores + loads) and static shared memory."""
    parts = []
    for entry in log.split("Compiling entry function")[1:]:
        mangled = re.search(r"'(\w+)'", entry).group(1)
        found = re.search(r"\d+([a-z_]+_kernel)(?:ILi(\d+)E)?", mangled)
        name = found.group(1) + (f"<{found.group(2)}>" if found.group(2) else "")
        regs = int(re.search(r"Used (\d+) registers", entry).group(1))
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", entry))
        smem = re.search(r"(\d+) bytes smem", entry)
        parts.append(f"{name} {regs} registers, {spills} spill bytes, "
                     f"{int(smem.group(1)) if smem else 0} B static shared")
    return "; ".join(parts)


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
            print(f"  ptxas {name}: {_ptxas_summary(log.read_text())}")
        kernels.load(name)


def _fixture_errors(reg, final, fixture: dict, what: str) -> tuple[float, float]:
    """Print the run beside the JAX fixture; returns (largest |final 4x4
    difference|, largest relative correspondence-count difference). Raises
    on a malformed run or one that fell back or hit the inner cap."""
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
    if reg.engine_fallbacks or reg.inner_cap_hits:
        raise AssertionError(f"{what}: engine_fallbacks={reg.engine_fallbacks}, "
                             f"inner_cap_hits={reg.inner_cap_hits}")
    return t_err, worst


def _check_against_fixture(reg, final, fixture: dict, what: str) -> float:
    """Raise unless the run reproduces the JAX fixture: every iteration's
    correspondence count within COUNT_RTOL, the final 4x4 within
    TRANSFORM_ATOL. Returns the final 4x4's largest difference."""
    t_err, worst = _fixture_errors(reg, final, fixture, what)
    if t_err > TRANSFORM_ATOL or worst > COUNT_RTOL:
        raise AssertionError(f"{what}: the run disagrees with the JAX fixture")
    return t_err


def _select_bound_ms(fg, torch, a, kp: int = 32) -> tuple[float, float]:
    """(bytes ms, operations ms) a window select must spend on the class
    pass ``a`` = (padded, cand_xyz, cand_idx, step_rows, width_lut): rows x
    16 B, each distinct window's scanned lanes x 16 B (xyz + id) and the
    tables in, rows x kp x 20 B out; 8 float32 operations per lane of each
    valid row's segment."""
    padded, _, cand_idx, step_rows, width_lut = a
    rows = padded.shape[0]
    wins = torch.unique(step_rows).long()
    lanes_read = int(width_lut[wins].sum())
    moved = rows * 16 + step_rows.numel() * 4 + wins.numel() * 4 + lanes_read * 16 \
        + rows * kp * 20
    valid, lo, hi = fg._unpack_row_meta(padded[:, 3:4])
    width = width_lut[step_rows.long()].repeat_interleave(fg.GROUP)[:, None]
    end = torch.minimum(width, hi).clamp_max(cand_idx.shape[1])
    lanes = int(torch.where(valid, (end - lo).clamp_min(0), 0).sum())
    return 1e3 * moved / HBM_BYTES_PER_S, 1e3 * 8 * lanes / F32_FLOP_PER_S


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


def _entry_points(port, torch, native, synthetic, bunny_pair, counted, zero_counts) -> list:
    """Phases 16-18: the pair CLI, sequence odometry, loop closure and the
    pose graph, each against its JAX fixture. Returns the sequence's
    run_odometry pairs/s (the first run, then the pipelined turns)."""
    sys.path.insert(0, str(REPO / "tests"))
    import torch_port_fixture as fx

    select_bitonic = counted["select_bitonic"]

    # -- 16. the pair CLI on the card ------------------------------------------
    from probabilistic_point_clouds_registration_tpu_torch import cli as port_cli
    from probabilistic_point_clouds_registration_tpu_torch.io.pcd import load_pcd, save_pcd

    cli_fx = json.loads((DATA / "torch_port_cli_bunny35k_ref.json").read_text())
    want_T = np.array(cli_fx["final_transform"])
    want_corr = [it["correspondences"] for it in cli_fx["iterations"]]
    src, tgt = bunny_pair
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            fx.write_pcd_pair(Path(tmp), save_pcd, cli_fx["cli"])
            print(f"CLI pair files written ({', '.join(f'{n} {m}' for n, m in cli_fx['cli']['files'].items())}); "
                  f"native host library (LZF) loaded {native.available()}")
            for impl, kernel in (("auto", "select_bitonic"), ("pallas", "brute_knn")):
                argv = list(cli_fx["cli"]["argv"])
                argv[argv.index("--search_impl") + 1] = impl
                zero_counts()
                out = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    rc = port_cli.main(argv)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = {key: fn.launches for key, fn in counted.items()}
                stdout = out.getvalue()
                run = fx.parse_cli_run(stdout, Path("src_tgt_summary.txt").read_text())
                got_T = np.array(run["final_transform"])
                got_corr = [it["correspondences"] for it in run["iterations"]]
                t_err = float(np.abs(got_T - want_T).max())
                worst = max(abs(a - b) / b for a, b in zip(got_corr, want_corr))
                aligned = load_pcd("aligned_src.pcd")
                moved = src @ got_T[:3, :3].T + got_T[:3, 3]
                cloud_err = float(np.abs(aligned - moved).max())
                fallbacks = stdout.count("falling back")
                print(f"CLI --search_impl {impl}: exit {rc}, {seconds:.4f} s, launches {launches}, "
                      f"{len(got_corr)} iterations, final 4x4 vs JAX CLI fixture max abs diff "
                      f"{t_err:.3e} (limit {TRANSFORM_ATOL}), worst correspondence-count diff "
                      f"{worst:.2e} (limit {COUNT_RTOL}), fallbacks {fallbacks}; aligned cloud "
                      f"read back {aligned.shape}, {cloud_err:.2e} from the source moved by the "
                      f"printed 4x4, mean distance to the target "
                      f"{float(np.linalg.norm(aligned - tgt, axis=1).mean()):.3e}")
                if (rc != 0 or len(got_corr) != len(want_corr) or t_err > TRANSFORM_ATOL
                        or worst > COUNT_RTOL or fallbacks or launches[kernel] < 1
                        or aligned.shape != src.shape or not np.isfinite(aligned).all()
                        or cloud_err > 1e-5):
                    raise AssertionError(f"CLI --search_impl {impl}: the run disagrees with the "
                                         f"JAX CLI fixture")
        finally:
            os.chdir(cwd)

    # -- 17. sequence odometry at LiDAR scale ----------------------------------
    from probabilistic_point_clouds_registration_tpu_torch.io.kitti import (
        list_velodyne_scans,
        load_velodyne_bin,
    )
    from probabilistic_point_clouds_registration_tpu_torch.models.odometry import run_odometry

    seq_fx = json.loads((DATA / "torch_port_seq_kitti131k_ref.json").read_text())
    spec = seq_fx["sequence"]
    scans, gt_poses = synthetic.kitti_sequence(spec["scans"], spec["n_points"], seed=spec["seed"])
    with tempfile.TemporaryDirectory() as tmp:
        fx.write_velodyne_scans(Path(tmp), scans)
        paths = list_velodyne_scans(tmp)
        params = port.RegistrationParams(**spec["params"])
        ckpt = Path(tmp) / "trajectory.json"
        zero_counts()
        t0 = time.perf_counter()
        result = run_odometry(paths, params, checkpoint_path=ckpt, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        seq_launches = {key: fn.launches for key, fn in counted.items()}
        n_pairs = len(result.relative_transforms)
        iters = [len(r.splitlines()) - 1 for r in result.reports]
        want_iters = [p["iterations"] for p in seq_fx["pairs"]]
        errs = [float(np.abs(a - np.array(p["relative_transform"])).max())
                for a, p in zip(result.relative_transforms, seq_fx["pairs"])]
        print(f"kitti131k sequence ({len(paths)} .bin scans, {n_pairs} pairs, auto): "
              f"{n_pairs / seconds:.4f} pairs/s ({seconds:.4f} s), launches {seq_launches} "
              f"({seq_launches['select_bitonic'] / n_pairs:.1f} B4 a pair), outer iterations "
              f"{iters} (JAX fixture {want_iters}), relative 4x4 vs fixture max abs diff per pair "
              f"{['%.3e' % e for e in errs]} (limit {TRANSFORM_ATOL}), engine_fallbacks "
              f"{result.engine_fallbacks}, inner_cap_hits {result.inner_cap_hits}, ATE "
              f"{result.ate_rmse(gt_poses):.6f} m")
        print(f"kitti131k sequence: capture seconds per pair "
              f"{['%.4f' % c for c in result.capture_seconds]}; prep thread seconds per pair "
              f"{['%.4f' % c for c in result.prep_seconds]} (sum {sum(result.prep_seconds):.4f}), "
              f"main thread's wait on it {['%.4f' % c for c in result.prep_wait_seconds]} (sum "
              f"{sum(result.prep_wait_seconds):.4f}): hidden "
              f"{sum(result.prep_seconds) - sum(result.prep_wait_seconds):.4f} s")
        if (n_pairs != len(seq_fx["pairs"]) or iters != want_iters
                or max(errs) > TRANSFORM_ATOL or result.engine_fallbacks
                or result.inner_cap_hits or seq_launches["select_bitonic"] < 1):
            raise AssertionError("kitti131k sequence: the run disagrees with the JAX fixture")
        # What the pipeline hides: the same pairs with each target prepared
        # in line by the ctor (no prep thread, no staging; the scans in
        # memory) beside the pipelined run again, in turns (in line,
        # pipelined, pipelined, in line).
        clouds = [load_velodyne_bin(path).astype(np.float64) for path in paths]
        rates = {"in line": [], "pipelined": []}
        for mode in ("in line", "pipelined", "pipelined", "in line"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "in line":
                rels = [port.ProbabilisticRegistration(clouds[i + 1], clouds[i], params,
                                                       device="cuda").align()
                        for i in range(n_pairs)]
            else:
                rels = run_odometry(paths, params, device="cuda").relative_transforms
            torch.cuda.synchronize()
            rates[mode].append(n_pairs / (time.perf_counter() - t0))
            if not all(np.array_equal(a, b) for a, b in zip(rels, result.relative_transforms)):
                raise AssertionError(f"kitti131k sequence ({mode}): the pairs differ from the "
                                     f"first run")
        seq_rates = [n_pairs / seconds] + rates["pipelined"]
        print(f"kitti131k sequence pairs/s in turns (in line, pipelined, pipelined, in line; "
              f"each bit-equal to the first run): in line "
              f"{', '.join('%.4f' % r for r in rates['in line'])}; pipelined "
              f"{', '.join('%.4f' % r for r in rates['pipelined'])}")
        # Resume from the checkpoint cut to 2 pairs.
        saved = json.loads(ckpt.read_text())
        keep = 2
        saved.update(num_pairs=keep, poses=saved["poses"][:keep + 1],
                     relative_transforms=saved["relative_transforms"][:keep],
                     per_pair_cost=saved["per_pair_cost"][:keep], reports=saved["reports"][:keep])
        ckpt.write_text(json.dumps(saved))
        redone = []
        resumed = run_odometry(paths, params, checkpoint_path=ckpt, device="cuda",
                               on_pair=lambda i, pose: redone.append(i))
        same = all(np.array_equal(a, b) for a, b in zip(resumed.poses, result.poses))
        diff = max(float(np.abs(a - b).max()) for a, b in zip(resumed.poses, result.poses))
        print(f"kitti131k sequence resumed from 2 pairs: pairs redone {redone}, "
              f"{len(resumed.poses)} poses, trajectory bit-equal {same} (max abs diff {diff:.3e})")
        if redone != list(range(keep, n_pairs)) or len(resumed.poses) != len(result.poses) \
                or not same:
            raise AssertionError("kitti131k sequence: the resumed trajectory differs")

    # -- 18. loop closure and the pose graph -----------------------------------
    from probabilistic_point_clouds_registration_tpu_torch.models.loop_closure import (
        LoopClosure,
        detect_loop_closures,
        refine_trajectory,
    )
    from probabilistic_point_clouds_registration_tpu_torch.models.odometry import OdometryResult
    from probabilistic_point_clouds_registration_tpu_torch.models.pose_graph import (
        optimize_pose_graph,
    )

    loop_fx = json.loads((DATA / "torch_port_loop_bunny35k_ref.json").read_text())
    scans, gt, rels, drifted = fx.loop_problem(loop_fx["loop"])
    odo = OdometryResult(poses=drifted, relative_transforms=rels)
    params = port.RegistrationParams(**loop_fx["loop"]["params"])
    zero_counts()
    t0 = time.perf_counter()
    closures = detect_loop_closures(scans, odo, params, **loop_fx["loop"]["detect"],
                                    device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    refined, cost = refine_trajectory(odo, closures, device="cuda")
    torch.cuda.synchronize()
    detect_s, refine_s = t1 - t0, time.perf_counter() - t1
    want = loop_fx["closures"]
    c_errs = [float(np.abs(c.relative_transform - np.array(w["relative_transform"])).max())
              for c, w in zip(closures, want)]
    # The refinement from the fixture's own closures: the pose graph alone.
    from_fixture, fixture_cost = refine_trajectory(
        odo, [LoopClosure(w["i"], w["j"], np.array(w["relative_transform"]), w["mean_cost"])
              for w in want], device="cuda")
    r_err = max(float(np.abs(a - np.array(b)).max())
                for a, b in zip(from_fixture, loop_fx["refined_poses"]))
    own_err = max(float(np.abs(a - np.array(b)).max())
                  for a, b in zip(refined, loop_fx["refined_poses"]))
    drift = [float(np.linalg.norm(p[-1][:3, 3] - gt[-1][:3, 3])) for p in (drifted, refined)]
    print(f"bunny35k square loop (auto): detection {detect_s:.4f} s, refinement "
          f"{refine_s:.4f} s (the first pose-graph solve in the process), B4 launches "
          f"{select_bitonic.launches}, closures {[(c.i, c.j) for c in closures]} (JAX fixture "
          f"{[(w['i'], w['j']) for w in want]}), closure 4x4 vs fixture "
          f"{['%.3e' % e for e in c_errs]} (limit {TRANSFORM_ATOL}); refined poses from the "
          f"fixture's closures vs fixture {r_err:.3e} (limit {REFINED_ATOL}), cost "
          f"{fixture_cost:.12g} vs {loop_fx['cost']:.12g}; from this run's closures {own_err:.3e} "
          f"(limit {TRANSFORM_ATOL}); end-point drift {drift[0]:.4f} -> {drift[1]:.4f}")
    if ([(c.i, c.j) for c in closures] != [(w["i"], w["j"]) for w in want] or not closures
            or max(c_errs) > TRANSFORM_ATOL or r_err > REFINED_ATOL or own_err > TRANSFORM_ATOL
            or select_bitonic.launches < 1):
        raise AssertionError("bunny35k square loop: the run disagrees with the JAX fixture")

    pg_fx = json.loads((DATA / "torch_port_pose_graph4541_ref.json").read_text())
    poses, edges, weights = fx.pose_graph_problem(pg_fx["pose_graph"])
    stats = {}
    optimize_pose_graph(poses, edges, weights=weights, device="cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pg_poses, pg_cost = optimize_pose_graph(poses, edges, weights=weights, device="cuda",
                                            stats=stats)
    torch.cuda.synchronize()
    pg_seconds = time.perf_counter() - t0
    host_launches = device_kernels = 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        optimize_pose_graph(poses, edges, weights=weights, device="cuda")
        torch.cuda.synchronize()
    device_ms = 0.0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device_kernels += 1
            device_ms += evt.time_range.elapsed_us() / 1e3
        elif evt.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx"):
            host_launches += 1
    steps = stats["gn_iterations"]
    cost_rel = abs(pg_cost - pg_fx["cost"]) / pg_fx["cost"]
    pose_err = max(float(np.abs(pg_poses[int(k)] - np.array(m)).max())
                   for k, m in pg_fx["poses"].items())
    print(f"pose graph ({len(poses)} poses, {len(edges)} edges, float64): {steps} Gauss-Newton "
          f"steps (JAX fixture {pg_fx['gn_iterations']}), cost {pg_cost:.15g} (fixture "
          f"{pg_fx['cost']:.15g}, relative diff {cost_rel:.2e}, limit {POSE_GRAPH_RTOL}), every "
          f"{pg_fx['pose_graph']['keep_every']}th pose max abs diff {pose_err:.2e} (limit "
          f"{POSE_GRAPH_ATOL}); warm solve {pg_seconds:.4f} s; host launches per GN step "
          f"{host_launches / steps:.1f}, device kernels per GN step {device_kernels / steps:.1f}, "
          f"device ms {device_ms:.3f} (traced solve)")
    if (steps != pg_fx["gn_iterations"] or cost_rel > POSE_GRAPH_RTOL
            or pose_err > POSE_GRAPH_ATOL):
        raise AssertionError("pose graph: the solve disagrees with the JAX fixture")
    return seq_rates


MESH_ATOL = 5e-6  # a mesh run's final 4x4 against the fixture and the single-device run


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_phases(port, torch, synthetic, fixtures, pairs, counted, zero_counts, smi) -> dict:
    """Phases 19-22: the mesh on the card. Returns each kernel's launches
    in these phases (every rank's)."""
    import torch.distributed as dist

    from probabilistic_point_clouds_registration_tpu_torch.models.odometry import run_odometry
    from probabilistic_point_clouds_registration_tpu_torch.parallel import (
        DistributedRegistration,
        initialize_multihost,
        make_mesh,
    )

    sys.path.insert(0, str(REPO / "tests"))
    import torch_port_fixture as fx
    import torch_port_mesh_worker as worker

    added = {name: 0 for name in counted}

    def phase_line(what, t0):
        print(f"{what}: {time.perf_counter() - t0:.1f} s on {smi}")

    # -- 19. a world-size-1 NCCL group ------------------------------------------
    t_phase = time.perf_counter()
    initialize_multihost(f"tcp://localhost:{_free_port()}", 1, 0, device="cuda",
                         local_world_size=1)
    mesh = make_mesh(1, 1)
    axes = ("points", "targets")
    if dist.get_backend() != "nccl" or not mesh.has_collectives(axes):
        raise AssertionError(f"phase 19: backend {dist.get_backend()}, collectives "
                             f"{mesh.has_collectives(axes)}")
    for name, fixture in fixtures.items():
        src, tgt = pairs[name]
        params = _params(port, fixture, "auto")
        single = port.ProbabilisticRegistration(src, tgt, params, device="cuda").align()
        zero_counts()
        t0 = time.perf_counter()
        reg = DistributedRegistration(src, tgt, params, mesh=mesh, layout="auto")
        final = reg.align()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {key: fn.launches for key, fn in counted.items()}
        for key, n in launches.items():
            added[key] += n
        t_err, _ = _fixture_errors(reg, final, fixture, f"{name} mesh 1x1 (NCCL)")
        s_err = float(np.abs(final - single).max())
        print(f"{name} mesh 1x1 (NCCL, world of 1): layout {reg.layout}, {seconds:.4f} s, "
              f"launches {launches}, LM blocks as CUDA graphs {reg._lm.graphs} with the "
              f"all_reduce inside {mesh.has_collectives(axes)}, capture seconds "
              f"{reg._lm.capture_seconds:.4f}; final 4x4 vs fixture {t_err:.3e}, vs the "
              f"single-device align() {s_err:.3e} (limit {MESH_ATOL})")
        if (t_err > MESH_ATOL or s_err > MESH_ATOL or not reg._lm.graphs
                or not reg._lm._captured or launches["select_bitonic"] < 1):
            raise AssertionError(f"{name} mesh 1x1: the run disagrees")
    seq_fx = json.loads((DATA / "torch_port_seq_kitti131k_ref.json").read_text())
    spec = seq_fx["sequence"]
    scans, _ = synthetic.kitti_sequence(spec["scans"], spec["n_points"], seed=spec["seed"])
    with tempfile.TemporaryDirectory() as tmp:
        paths = fx.write_velodyne_scans(Path(tmp), scans[:3])
        zero_counts()
        t0 = time.perf_counter()
        result = run_odometry(paths, port.RegistrationParams(**spec["params"]), mesh=mesh)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    added["select_bitonic"] += counted["select_bitonic"].launches
    errs = [float(np.abs(a - np.array(p["relative_transform"])).max())
            for a, p in zip(result.relative_transforms, seq_fx["pairs"][:2])]
    iters = [len(r.splitlines()) - 1 for r in result.reports]
    want_iters = [p["iterations"] for p in seq_fx["pairs"][:2]]
    print(f"kitti131k sequence, 3 scans, mesh 1x1 (NCCL): {seconds:.4f} s, outer iterations "
          f"{iters} (fixture {want_iters}), relative 4x4 vs fixture {['%.3e' % e for e in errs]} "
          f"(limit {TRANSFORM_ATOL}), B4 launches {counted['select_bitonic'].launches}")
    if len(errs) != 2 or max(errs) > TRANSFORM_ATOL or iters != want_iters:
        raise AssertionError("mesh odometry: the run disagrees with the sequence fixture")
    dist.destroy_process_group()
    phase_line("phase 19 (world-size-1 NCCL mesh)", t_phase)

    bunny = fixtures["bunny35k"]
    want_T = np.array(bunny["final_transform"])
    want_corr = [it["correspondences"] for it in bunny["iterations"]]

    def hold(res, tag, what, kernel):
        """Every rank's run: bit-identical 4x4s, within MESH_ATOL of the
        fixture, the fixture's correspondences, the kernel launched."""
        runs = [r[tag] for r in res]
        finals = [r["final"] for r in runs]
        same = all(np.array_equal(f, finals[0]) for f in finals)
        t_err = float(np.abs(finals[0] - want_T).max())
        worst = max(abs(a - b) / b for a, b in zip(runs[0]["n_corr"], want_corr))
        print(f"{what}: layout {runs[0].get('layout')}, ranks' 4x4 bit-identical {same}, vs "
              f"fixture {t_err:.3e}, worst correspondence-count diff {worst:.2e}, engine "
              f"{runs[0]['engine']}, fallbacks {runs[0]['engine_fallbacks']}, cap hits "
              f"{runs[0]['inner_cap_hits']}, seconds per rank "
              f"{['%.2f' % r['seconds'] for r in runs]}, {kernel} launches per rank "
              f"{[r['launches'][kernel] for r in runs]}")
        for r in runs:
            for key, n in r["launches"].items():
                added[key] += n
        if (not same or len(runs[0]["n_corr"]) != len(want_corr) or worst > COUNT_RTOL
                or runs[0]["inner_cap_hits"]
                or any(r["launches"][kernel] < 1 for r in runs)):
            raise AssertionError(f"{what}: the ranks disagree, the run disagrees with the "
                                 f"fixture, or {kernel} did not launch on every rank")
        return runs[0], t_err

    # -- 20. four processes sharing the card over gloo, 2x2 ----------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = worker.run_group(4, [
            ("fixture_registration", dict(name="bunny35k", dp=2, tp=2, layout="targets",
                                          tag="targets")),
            ("fixture_registration", dict(name="bunny35k", dp=2, tp=2, layout="auto",
                                          tag="auto")),
            ("fixture_registration", dict(name="bunny35k", dp=2, tp=2, layout="targets",
                                          debug_replication=True, tag="debug")),
        ], tmp, device="cuda", local_world_size=4, timeout=600)
    for tag in ("targets", "auto", "debug"):
        run, t_err = hold(res, tag, f"bunny35k mesh 2x2 (4 processes, gloo) {tag}",
                          "select_bitonic")
        if t_err > MESH_ATOL or run["engine_fallbacks"] or run["graphs"]:
            raise AssertionError(f"mesh 2x2 {tag}: {t_err:.3e} from the fixture, fallbacks "
                                 f"{run['engine_fallbacks']}, graphs {run['graphs']}")
    if res[0]["_jax_loaded"] or any(r["_jax_loaded"] for r in res):
        raise AssertionError("a mesh worker loaded JAX")
    phase_line("phase 20 (2x2 mesh, 4 processes on one card)", t_phase)

    # -- 21./22. two processes: the budget ladder, the edge-sharded pose graph ---
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = worker.run_group(2, [
            ("fixture_ladder", dict(name="bunny35k", dp=1, tp=2, tag="ladder")),
            ("fixture_pose_graph", dict(dp=2, tag="pose_graph")),
        ], tmp, device="cuda", local_world_size=2, timeout=600)
    run, t_err = hold(res, "ladder", "bunny35k mesh 1x2, starved pooled budget", "row_topk")
    if (run["engine"], run["engine_fallbacks"]) != ("grid", 1) or t_err > TRANSFORM_ATOL:
        raise AssertionError(f"mesh ladder: engine {run['engine']}, fallbacks "
                             f"{run['engine_fallbacks']}, {t_err:.3e} from the fixture")
    pg_fx = json.loads((DATA / "torch_port_pose_graph4541_ref.json").read_text())
    for rank, r in enumerate(res):
        pg = r["pose_graph"]
        cost_rel = abs(pg["cost"] - pg_fx["cost"]) / pg_fx["cost"]
        pose_err = max(float(np.abs(pg["poses"][k] - np.array(m)).max())
                       for k, m in pg_fx["poses"].items())
        print(f"pose graph, edges sharded over 2 processes (rank {rank}): {pg['n_edges']} "
              f"edges, {pg['gn_iterations']} Gauss-Newton steps (fixture "
              f"{pg_fx['gn_iterations']}), cost relative diff {cost_rel:.2e} (limit "
              f"{POSE_GRAPH_RTOL}), poses max abs diff {pose_err:.2e} (limit "
              f"{POSE_GRAPH_ATOL}), warm solve {pg['seconds']:.4f} s")
        if (pg["gn_iterations"] != pg_fx["gn_iterations"] or cost_rel > POSE_GRAPH_RTOL
                or pose_err > POSE_GRAPH_ATOL or pg["cost"] != res[0]["pose_graph"]["cost"]):
            raise AssertionError("edge-sharded pose graph: the solve disagrees")
    phase_line("phases 21-22 (1x2 ladder, edge-sharded pose graph; 2 processes)", t_phase)
    return added


BATCH_ATOL = 1e-6  # phase 24's ranks against phase 23's batch
REDO_ATOL = 1e-5  # the redo splice against the grid engine's batch


def _relative(result, n_pairs: int) -> list:
    """Each pair's relative 4x4 of a BatchedPairResult (float64)."""
    from probabilistic_point_clouds_registration_tpu_torch.core.se3 import np_se3_matrix

    qs, ts = result.q.cpu().double().numpy(), result.t.cpu().double().numpy()
    return [np_se3_matrix(qs[i] / np.linalg.norm(qs[i]), ts[i]) for i in range(n_pairs)]


def _hold_batch(result, stats, want_pairs, what: str, seconds: float) -> list:
    """A batch's pairs against the sequence fixture's: relative 4x4 within
    TRANSFORM_ATOL, the same outer iterations, every iteration's
    correspondence count within COUNT_RTOL. Returns the relative 4x4s."""
    n_pairs = len(want_pairs)
    rel = _relative(result, n_pairs)
    errs = [float(np.abs(a - np.array(p["relative_transform"])).max())
            for a, p in zip(rel, want_pairs)]
    iters = [int(i) for i in result.num_iterations.cpu()[:n_pairs]]
    counts = result.num_correspondences.cpu().numpy()
    worst = max(abs(int(counts[i][j]) - c) / c for i, p in enumerate(want_pairs)
                for j, c in enumerate(p["correspondences"]))
    print(f"{what}: engine {stats['engine']}, {n_pairs / seconds:.4f} pairs/s ({seconds:.4f} s; "
          f"host prep {stats['host_seconds']:.4f} s, LM capture {stats['capture_seconds']:.4f} s, "
          f"{stats['graphs_captured']} shapes captured), {stats['outer_loops']} loop iterations, "
          f"outer iterations {iters} (fixture {[p['iterations'] for p in want_pairs]}), "
          f"relative 4x4 vs fixture {['%.3e' % e for e in errs]} (limit {TRANSFORM_ATOL}), "
          f"worst correspondence-count diff {worst:.2e} (limit {COUNT_RTOL}), overflow "
          f"{result.overflow.cpu().tolist()}, redone {stats.get('redone')}")
    if (max(errs) > TRANSFORM_ATOL or worst > COUNT_RTOL
            or iters != [p["iterations"] for p in want_pairs] or not stats["graphs_captured"]):
        raise AssertionError(f"{what}: the batch disagrees with the sequence fixture")
    return rel


def _batch_flattening(torch, pb, clouds, params, counted, smi) -> None:
    """Phase 23(a): on the batch's initial poses, each pooled class pass as
    ONE launch across the pairs (B4 and B1) against the twin and against
    the same passes launched pair by pair and stacked; B2 on one flattened
    block of the batched grid engine against its twin. Its tensors die with
    the call."""
    from probabilistic_point_clouds_registration_tpu_torch.core.types import pad_cloud
    from probabilistic_point_clouds_registration_tpu_torch.ops import fused_grid as fg
    from probabilistic_point_clouds_registration_tpu_torch.ops import fused_pool as fp
    from probabilistic_point_clouds_registration_tpu_torch.ops import grid as tgrid
    from probabilistic_point_clouds_registration_tpu_torch.ops.select_pallas import (
        _row_topk_plain,
    )

    select_bitonic, select_windows = counted["select_bitonic"], counted["select_windows"]
    pallas_row_topk = counted["row_topk"]
    k, radius = params.max_neighbours, params.radius
    r2 = float(np.float32(radius) ** 2)
    n_pairs = len(clouds) - 1
    t_phase = time.perf_counter()
    stack = np.stack([pad_cloud(c, params.pad_multiple, pad_value=0.0)[0] for c in clouds])
    counts = np.array([c.shape[0] for c in clouds])
    idx_src, idx_tgt = np.arange(n_pairs) + 1, np.arange(n_pairs)
    pools = pb._batched_pools_host(stack, counts, idx_tgt, radius, k, np.float32,
                                   idx_src=idx_src, device="cuda")
    sources = torch.as_tensor(stack[idx_src].astype(np.float32), device="cuda")
    sv = torch.arange(stack.shape[1], device="cuda")[None, :] < torch.as_tensor(
        counts[idx_src], device="cuda")[:, None]
    search = dict(radius=radius, class_widths=pools["class_widths"],
                  class_ends=pools["class_ends"], class_budgets=pools["class_budgets"],
                  budget_rows=pools["budget_rows"], small_unions=pools["small_unions"],
                  select_max_w=pools["select_max_w"])
    tables = (pools["select_xyz"], pools["pool_idx"], pools["class_width_luts"],
              pools["lut_d"], pools["origin_d"], pools["dims_d"])
    passes, _, _, overflow = fp.batched_class_passes(sources, sv, *tables, **search)
    per_pair = [fp.class_passes(sources[b], sv[b], *(tuple(x[b] for x in t) for t in tables[:3]),
                                *(t[b] for t in tables[3:]), **search)[0]
                for b in range(n_pairs)]
    if overflow.tolist() != [0] * n_pairs:
        raise AssertionError(f"batch flattening check: the initial poses overflow {overflow}")
    flat_ms = alone_ms = 0.0
    for c, (w_c, _, args) in enumerate(passes):
        twin = fg._select_windows_plain(*args, k=k, kp=32, r2=r2)
        b4 = select_bitonic(*args, k=k, radius=radius)
        b1 = select_windows(*args, k=k, radius=radius)
        alone = [select_bitonic(*p[c][2], k=k, radius=radius) for p in per_pair]
        stacked = (torch.cat([a[0] for a in alone]), torch.cat([a[1] for a in alone]),
                   tuple(torch.cat([a[2][i] for a in alone]) for i in range(3)))
        torch.cuda.synchronize()
        what = f"batch class {w_c}: one pass over {n_pairs} pairs ({args[0].shape[0]} rows)"
        _bit_equal(b4, twin, f"B4 {what}")
        _bit_equal(b1, twin, f"B1 {what}")
        _bit_equal(b4, stacked, f"B4 {what} against the pairs' own passes")
        ms = _cuda_ms(lambda: select_bitonic(*args, k=k, radius=radius))
        ms_alone = _cuda_ms(lambda: [select_bitonic(*p[c][2], k=k, radius=radius)
                                     for p in per_pair])
        flat_ms, alone_ms = flat_ms + ms, alone_ms + ms_alone
        pool_elems = args[1].numel()
        print(f"{what}, flattened pool ({args[1].shape[0]}, 3, {w_c}): {pool_elems} floats "
              f"(largest offset {pool_elems - 1}, int32 max {2**31 - 1}), "
              f"{int((twin[1] >= 0).sum())} live slots; B4 and B1 bit-equal to the twin and "
              f"B4 to the {n_pairs} per-pair launches stacked; B4 {ms:.4f} ms in one launch, "
              f"{ms_alone:.4f} ms in {n_pairs} (median of 20, CUDA events)")
    print(f"batch class passes: {len(passes)} launches {flat_ms:.4f} ms against "
          f"{len(passes) * n_pairs} launches {alone_ms:.4f} ms")
    del pools, tables, passes, per_pair, args, twin, b4, b1, alone, stacked
    # B2 on one flattened block of the batched grid engine (2 pairs).
    bp, bi, luts, origins, dims, cap = pb._batched_grids_host(stack, counts, idx_tgt[:2],
                                                              radius)
    grid = [torch.as_tensor(x, device="cuda") for x in (bp.astype(np.float32), bi, luts,
                                                        origins.astype(np.float32), dims)]
    tile = tgrid.pick_source_tile(cap, pairs=2)
    no_ids = torch.zeros(bp.shape[1], dtype=torch.int32, device="cuda")
    d2 = torch.cat([tgrid.candidate_distances(
        sources[b, :tile], sv[b, :tile], grid[0][b], grid[1][b], no_ids, grid[3][b],
        grid[4][b], grid[2][b], radius=radius, capacity=cap)[0] for b in range(2)])
    got, want = pallas_row_topk(d2, k=k), _row_topk_plain(d2, k=k)
    torch.cuda.synchronize()
    _equal_bits([("values", got[0], want[0]), ("indices", got[1], want[1])],
                f"B2 batch grid block {tuple(d2.shape)}")
    b2_ms = _cuda_ms(lambda: pallas_row_topk(d2, k=k))
    topk_ms = _cuda_ms(lambda: torch.topk(d2, k, dim=1, largest=False))
    bound = 1e3 * (d2.numel() * 4 + d2.shape[0] * k * 8) / HBM_BYTES_PER_S
    print(f"B2 batch grid block: grids capacity {cap}, {bp.shape[1]} cells, LUT "
          f"{luts.shape[1]}; one block of {tile} rows a pair x 2 pairs = {tuple(d2.shape)}, "
          f"{int(torch.isfinite(d2).sum())} finite entries: bit-equal to the twin; B2 "
          f"{b2_ms:.4f} ms, torch.topk {topk_ms:.4f} ms, bound {bound:.4f} ms (bytes)")
    print(f"phase 23(a) (batch flattening): {time.perf_counter() - t_phase:.1f} s on {smi}")


def _batch_phases(port, torch, synthetic, counted, zero_counts, smi, seq_rates) -> dict:
    """Phases 23-24: batches of pairs (``parallel/batch.py``) on the card.
    Returns each kernel's launches on the batch paths (every rank's)."""
    import gc

    from probabilistic_point_clouds_registration_tpu_torch.io.kitti import load_velodyne_bin
    from probabilistic_point_clouds_registration_tpu_torch.parallel import batch as pb

    sys.path.insert(0, str(REPO / "tests"))
    import torch_port_fixture as fx
    import torch_port_mesh_worker as worker

    added = {name: 0 for name in counted}
    seq_fx = json.loads((DATA / "torch_port_seq_kitti131k_ref.json").read_text())
    spec = seq_fx["sequence"]
    params = port.RegistrationParams(**spec["params"])
    kw = dict(k=params.max_neighbours, radius=params.radius, n_outer=params.n_iter,
              lm_config=port.ProbabilisticRegistration._make_lm_config(params),
              pad_multiple=params.pad_multiple, dtype=params.dtype,
              cost_drop_thresh=params.cost_drop_thresh, n_cost_drop_it=params.n_cost_drop_it)
    scans, _ = synthetic.kitti_sequence(spec["scans"], spec["n_points"], seed=spec["seed"])
    with tempfile.TemporaryDirectory() as tmp:
        # The scans as phase 17 writes and reads them (float32 .bin files).
        paths = fx.write_velodyne_scans(Path(tmp), scans)
        clouds = [load_velodyne_bin(path).astype(np.float64) for path in paths]
        n_pairs = len(clouds) - 1

        # -- 23(a). one launch per class across the batch, against per-pair launches --
        _batch_flattening(torch, pb, clouds, params, counted, smi)

        # -- 23(b). the main batch: five 131k pairs, auto (pooled, B4) ------------
        batch_rates, main = [], None
        for run in range(2):
            stats = {}
            zero_counts()
            t0 = time.perf_counter()
            poses, result = pb.run_odometry_batched(clouds, search_impl="auto", stats=stats, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {key: fn.launches for key, fn in counted.items()}
            batch_rates.append(n_pairs / seconds)
            rel = _hold_batch(result, stats, seq_fx["pairs"],
                              f"kitti131k batch of {n_pairs} pairs (auto), run {run + 1}", seconds)
            n_classes = len(stats["class_widths"])
            print(f"kitti131k batch run {run + 1}: classes {stats['class_widths']}, launches "
                  f"{launches}, B4 launches per loop iteration "
                  f"{launches['select_bitonic'] / stats['outer_loops']:.2f}")
            if (stats["engine"] != "pool" or int(result.overflow.sum()) != 0
                    or launches["select_bitonic"] + launches["select_windows"]
                    != n_classes * stats["outer_loops"] or launches["select_bitonic"] < 1):
                raise AssertionError("kitti131k batch: not on the pooled engine, overflowed, or "
                                     "B4 launched other than once per class and iteration")
            if run == 0:
                added["select_bitonic"] += launches["select_bitonic"]
                main = (poses, rel)
        print(f"kitti131k batch pairs/s {', '.join('%.4f' % r for r in batch_rates)} against "
              f"phase 17's sequential run_odometry in this process (first run, then the "
              f"pipelined turns) {', '.join('%.4f' % r for r in seq_rates)}")

        # -- 23(c). grid and brute force on the first 3 scans (2 pairs) -----------
        grid_poses = None
        for impl in ("grid", "brute"):
            stats = {}
            zero_counts()
            t0 = time.perf_counter()
            poses, result = pb.run_odometry_batched(clouds[:3], search_impl=impl, stats=stats,
                                                    **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {key: fn.launches for key, fn in counted.items()}
            _hold_batch(result, stats, seq_fx["pairs"][:2],
                        f"kitti131k batch, 3 scans ({impl})", seconds)
            print(f"kitti131k batch, 3 scans ({impl}): launches {launches}")
            if stats["engine"] != impl or (impl == "grid" and launches["row_topk"] < 1):
                raise AssertionError(f"kitti131k batch ({impl}): engine {stats['engine']}")
            added["row_topk"] += launches["row_topk"]
            if impl == "grid":
                grid_poses = poses

        # -- 23(d). the redo splice: starved class budgets -> the batched grid ------
        stats = {}
        real = pb._batched_pools_host
        pb._batched_pools_host = worker.starved_pools(real)
        zero_counts()
        try:
            poses, result = pb.run_odometry_batched(clouds[:3], search_impl="pool", stats=stats,
                                                    **kw)
        finally:
            pb._batched_pools_host = real
        torch.cuda.synchronize()
        launches = {key: fn.launches for key, fn in counted.items()}
        diff = max(float(np.abs(a - b).max()) for a, b in zip(poses, grid_poses))
        print(f"kitti131k batch, 3 scans, starved pooled budgets: overflow "
              f"{result.overflow.cpu().tolist()}, pairs redone on the batched grid engine "
              f"{stats['redone']}, launches {launches}, poses vs the grid run {diff:.3e} "
              f"(limit {REDO_ATOL})")
        if not stats["redone"] or diff > REDO_ATOL or launches["row_topk"] < 1:
            raise AssertionError("kitti131k batch redo: no pair redone, or the splice differs "
                                 "from the grid engine's run")
        for key in ("select_bitonic", "row_topk"):
            added[key] += launches[key]

        # -- 24. the batch sharded: two processes sharing the card over gloo ---------
        # The workers share the card with this process: hand its cached
        # blocks back first.
        del result, poses
        gc.collect()
        torch.cuda.empty_cache()
        print(f"before phase 24: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} "
              f"GiB of the card")
        t_phase = time.perf_counter()
        with tempfile.TemporaryDirectory() as work:
            res = worker.run_group(2, [("batch_odometry", dict(dp=2, scans=tmp, tag="batch",
                                                                search_impl="auto", **kw))],
                                   work, device="cuda", local_world_size=2, timeout=600)
        runs = [r["batch"] for r in res]
        same = all(np.array_equal(r["poses"], runs[0]["poses"]) for r in runs)
        diff = float(np.abs(runs[0]["poses"] - np.array(main[0])).max())
        print(f"kitti131k batch sharded over 2 processes (gloo, one card): {n_pairs} pairs "
              f"padded to {runs[0]['result']['q'].shape[0]}, ranks' poses bit-identical {same}, "
              f"vs phase 23(b) {diff:.3e} (limit {BATCH_ATOL}), seconds per rank "
              f"{['%.2f' % r['seconds'] for r in runs]}, B4 launches per rank "
              f"{[r['launches']['select_bitonic'] for r in runs]}, LM graphs captured per rank "
              f"{[r['stats']['graphs_captured'] for r in runs]} (capture seconds "
              f"{['%.4f' % r['stats']['capture_seconds'] for r in runs]}), overflow "
              f"{runs[0]['result']['overflow'].tolist()}")
        if (not same or diff > BATCH_ATOL or runs[0]["result"]["q"].shape[0] != 6
                or any(r["launches"]["select_bitonic"] < 1 or not r["stats"]["graphs_captured"]
                       for r in runs) or any(r["_jax_loaded"] for r in res)):
            raise AssertionError("sharded batch: the ranks disagree, the batch differs from "
                                 "phase 23(b), B4 did not launch or the LM was not captured")
        for r in runs:
            added["select_bitonic"] += r["launches"]["select_bitonic"]
        print(f"phase 24 (batch sharded, 2 processes): {time.perf_counter() - t_phase:.1f} s "
              f"on {smi}")
    return added


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    import probabilistic_point_clouds_registration_tpu_torch as port
    from probabilistic_point_clouds_registration_tpu_torch import kernels, native
    from probabilistic_point_clouds_registration_tpu_torch.core.types import (
        pad_cloud,
        round_up,
    )
    from probabilistic_point_clouds_registration_tpu_torch.io import synthetic
    from probabilistic_point_clouds_registration_tpu_torch.ops import fused_grid as fg
    from probabilistic_point_clouds_registration_tpu_torch.ops import fused_pool as fp
    from probabilistic_point_clouds_registration_tpu_torch.ops import grid as tgrid
    from probabilistic_point_clouds_registration_tpu_torch.ops import neighbors_pallas as npal
    from probabilistic_point_clouds_registration_tpu_torch.ops.grid import build_grid_host
    from probabilistic_point_clouds_registration_tpu_torch.ops.neighbors import bbox_center
    from probabilistic_point_clouds_registration_tpu_torch.ops.select_bitonic import (
        select_bitonic,
    )
    from probabilistic_point_clouds_registration_tpu_torch.ops.select_pallas import (
        _row_topk_plain,
        pallas_row_topk,
    )

    if Path(port.__file__).resolve().parent.parent != REPO:
        raise SystemExit(f"chip_smoke: the port was imported from {port.__file__}, "
                         f"not from this checkout")
    fixtures = {name: json.loads((DATA / f"torch_port_{name}_ref.json").read_text())
                for name in ("bunny35k", "kitti131k")}
    voxel_fixture = json.loads((DATA / "torch_port_bunny35k_voxel_ref.json").read_text())
    pairs = {name: _pair(fx, synthetic) for name, fx in fixtures.items()}
    counted = {"select_windows": fg.select_windows, "select_bitonic": select_bitonic,
               "row_topk": pallas_row_topk, "brute_knn": npal.brute_knn}

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
               "select_bitonic": 0.0, "row_topk": 0.0, "brute_knn": 0.0}
    print(f"B1 dense bench shapes: rows {padded.shape[0]}, windows {pre.cand_idx.shape[0]}, "
          f"lanes {pre.n_lanes}, k {k}, live slots {int((out[1] >= 0).sum())}: bit-equal to twin")
    b1_ms = _cuda_ms(lambda: fg.select_windows(*args, k=k, radius=params.radius))
    twin_ms = _cuda_ms(lambda: fg._select_windows_plain(*args, k=k, kp=32, r2=r2))
    dense_bytes_ms, dense_ops_ms = _select_bound_ms(fg, torch, args)
    print(f"B1 dense bench shapes (median of 20, CUDA events): kernel {b1_ms:.4f} ms, "
          f"twin {twin_ms:.4f} ms, bound {max(dense_bytes_ms, dense_ops_ms):.4f} ms "
          f"(bytes {dense_bytes_ms:.4f}, operations {dense_ops_ms:.4f})")
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
    _hold_walker_cases(torch, fg, fg.select_windows, "B1", lanes=(384, 5120, 202),
                       ks=(1, 12, 20, 32, 40))

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
    select_bytes_ms = select_ops_ms = 0.0
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
            bytes_ms, ops_ms = _select_bound_ms(fg, torch, a)
            select_bytes_ms += bytes_ms
            select_ops_ms += ops_ms
            print(f"{what}: {int((twin[1] >= 0).sum())} live slots, B4 and B1 bit-equal to "
                  f"twin; B4 {ms['select_bitonic']:.4f} ms, twin {ms['plain']:.4f} ms, "
                  f"B1 {ms['select_windows']:.4f} ms (median of 20, CUDA events), bound "
                  f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, operations "
                  f"{ops_ms:.4f})")
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
    _hold_walker_cases(torch, fg, select_bitonic, "B4", lanes=(128, 512, 2048),
                       ks=(1, 12, 20, 32))

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
    main_err = {}
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
              f"first pair in the process {first_s:.4f} s; native host library loaded "
              f"{native.available()}; LM iterations per solve {reg.inner_iterations}")
        if reg.engine != "pool" or want == 0 or (
                launches["select_bitonic"], launches["select_windows"]) != (want, 0):
            raise AssertionError(f"{name}: engine {reg.engine}, {launches['select_bitonic']} B4 "
                                 f"and {launches['select_windows']} B1 launches, expected "
                                 f"pool, {want} and 0")
        if name == "bunny35k" and reg._pool_budget_boost:
            raise AssertionError(f"{name}: the pooled budget escalated")
        b4_launches += launches["select_bitonic"]
        main_err[name] = _check_against_fixture(reg, final, fixture, f"{name} pool")
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
        # The plan's dilation on the native library and on its numpy body
        # (the same tables), warm, best of 3.
        counts = grid["cell_count"].astype(np.int64)
        dilate = {}
        for path, fn in (("native", native.dilate_cells), ("numpy", lambda *a: None)):
            saved, native.dilate_cells = native.dilate_cells, fn
            try:
                runs = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    tables = fg.dilate_cells_host(grid, counts=counts)
                    runs.append(time.perf_counter() - t0)
            finally:
                native.dilate_cells = saved
            dilate[path] = (min(runs), tables)
        same = all(np.array_equal(np.asarray(dilate["native"][1][key]),
                                  np.asarray(dilate["numpy"][1][key]))
                   for key in dilate["numpy"][1])
        print(f"{name}: the plan's dilation, host seconds (best of 3): native "
              f"{dilate['native'][0]:.4f}, numpy {dilate['numpy'][0]:.4f}; tables equal {same}")
        if not same:
            raise AssertionError(f"{name}: the native dilation differs from numpy")

    # -- 7. B2 against its twin: real first-block matrices and edge cases --
    b2 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    grid_regs = {}
    for name, fixture in fixtures.items():
        src, tgt = pairs[name]
        params = _params(port, fixture, "grid")
        k = params.max_neighbours
        reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
        if reg.engine != "grid":
            raise AssertionError(f"{name}: search_impl='grid' took the {reg.engine} engine")
        grid_regs[name] = reg
        g = reg._grid
        tile = tgrid.pick_source_tile(g.capacity)
        d2, _, _ = tgrid.candidate_distances(
            reg._src[:tile], reg._src_valid[:tile], g.bucket_pts, g.bucket_idx, g.cell_ids,
            g.origin, g.dims, g.lut, radius=params.radius, capacity=g.capacity)
        got = pallas_row_topk(d2, k=k)
        want = _row_topk_plain(d2, k=k)
        torch.cuda.synchronize()
        what = f"B2 {name} first block {tuple(d2.shape)}, k {k}"
        _equal_bits([("values", got[0], want[0]), ("indices", got[1], want[1])], what)
        max_err["row_topk"] = max(max_err["row_topk"],
                                  _max_abs_diff(got[0], want[0], torch.isfinite(want[0])))
        ms = {"ms": _cuda_ms(lambda: pallas_row_topk(d2, k=k)),
              "plain_ms": _cuda_ms(lambda: _row_topk_plain(d2, k=k)),
              "library_ms": _cuda_ms(lambda: torch.topk(d2, k, dim=1, largest=False)),
              "bound_ms": 1e3 * (d2.numel() * 4 + d2.shape[0] * k * 8) / HBM_BYTES_PER_S}
        for key, value in ms.items():
            b2[key] += value
        print(f"{what}: {int(torch.isfinite(d2).sum())} finite of {d2.numel()} entries, "
              f"{int(torch.isfinite(got[0]).sum())} finite slots, bit-equal to twin in every "
              f"slot; B2 {ms['ms']:.4f} ms, twin {ms['plain_ms']:.4f} ms, torch.topk "
              f"{ms['library_ms']:.4f} ms, bound {ms['bound_ms']:.4f} ms (bytes) "
              f"(median of 20, CUDA events)")
    rng = np.random.default_rng(21)
    sparse = rng.random((4096, 216)).astype(np.float32)
    sparse[rng.random(sparse.shape) < 0.95] = np.inf
    sparse[::7] = np.inf  # rows of nothing but +inf
    lattice = rng.integers(0, 4, size=(2048, 1728)).astype(np.float32)
    lattice[rng.random(lattice.shape) < 0.5] = np.inf
    ragged = rng.random((1001, 333)).astype(np.float32)  # rows % 8 != 0, W % 32 != 0
    ragged_sparse = ragged.copy()  # row bytes % 16 != 0, few finite entries
    ragged_sparse[rng.random(ragged.shape) < 0.97] = np.inf
    narrow = rng.random((300, 19)).astype(np.float32)  # W < 32
    narrow[rng.random(narrow.shape) < 0.5] = np.inf
    one_step = rng.random((300, 128)).astype(np.float32)  # W = 128 exactly
    one_step[rng.random(one_step.shape) < 0.8] = np.inf
    far_end = np.full((257, 1733), np.inf, np.float32)  # exactly 20 finite, at the far end
    far_end[:, -20:] = rng.random((257, 20))
    tied = np.full((129, 700), np.inf, np.float32)  # 33 equal finite values and 5 smaller
    for r in range(129):
        cols = rng.choice(700, 38, replace=False)
        tied[r, cols[:33]] = 0.5
        tied[r, cols[33:]] = rng.random(5) * 0.4
    # A matrix whose base is 4-byte but not 16-byte aligned.
    flat = torch.as_tensor(np.concatenate([[0.0], lattice.ravel()]).astype(np.float32),
                           device="cuda")
    offset = flat[1:].view(lattice.shape)
    if offset.data_ptr() % 16 != 4 or not offset.is_contiguous():
        raise AssertionError("the offset view is not the 4-byte-aligned case")
    for what, x, ks in [("W=216, mostly +inf, all-inf rows", sparse, (1, 20, 32, 50)),
                        ("lattice ties, W=1728", lattice, (1, 20, 32, 50)),
                        ("1001 rows x 333", ragged, (1, 20, 32, 50, 333)),
                        ("1001 rows x 333, mostly +inf", ragged_sparse, (1, 20, 32)),
                        ("W=19", narrow, (1, 19)),
                        ("W=128", one_step, (20, 32)),
                        ("exactly 20 finite entries at the far end of 1733 columns", far_end,
                         (20, 32)),
                        ("33 equal finite values in a row", tied, (20, 32)),
                        ("lattice ties, W=1728, base 4 bytes off a 16-byte boundary", offset,
                         (20, 32))]:
        x = torch.as_tensor(x, device="cuda")
        for kk in ks:
            got = pallas_row_topk(x, k=kk)
            want = _row_topk_plain(x, k=kk)
            torch.cuda.synchronize()
            _equal_bits([("values", got[0], want[0]), ("indices", got[1], want[1])],
                        f"B2 edge case '{what}', k={kk}")
        print(f"B2 edge case '{what}': k in {ks}, bit-equal in every slot")

    # -- 8. the grid search on B2 against the same search on a stable sort --
    for name, reg in grid_regs.items():
        p, g = reg.params, reg._grid
        search = dict(k=p.max_neighbours, radius=p.radius, capacity=g.capacity,
                      source_valid=reg._src_valid,
                      source_tile=tgrid.pick_source_tile(g.capacity))
        tables = (reg._src, g.bucket_pts, g.bucket_idx, g.cell_ids, g.origin, g.dims, g.lut)
        zero_counts()
        got = tgrid.grid_radius_search(*tables, select_impl="pallas", **search)
        torch.cuda.synchronize()
        n_b2 = pallas_row_topk.launches
        want = tgrid.grid_radius_search(*tables, select_impl="topk", **search)
        n_over = 0
        if g.overflow_pts is not None:
            n_over = int((g.overflow_idx >= 0).sum())
            got, want = (reg._merge_overflow(c, reg._src) for c in (got, want))
        torch.cuda.synchronize()
        blocks = -(-reg._src.shape[0] // search["source_tile"])
        if n_b2 != blocks or pallas_row_topk.launches != blocks:
            raise AssertionError(f"{name}: {n_b2} B2 launches for {blocks} blocks")
        _equal_bits([("indices", got.indices, want.indices), ("mask", got.mask, want.mask),
                     ("sq_dists", got.sq_dists, want.sq_dists)],
                    f"{name}: grid_radius_search pallas vs topk")
        print(f"{name}: grid_radius_search select_impl='pallas' ({n_b2} B2 launches, blocks of "
              f"{search['source_tile']} rows x {27 * g.capacity}) == 'topk' in every slot, "
              f"{n_over} overflow points merged ({int(got.mask.sum())} correspondences)")
    if int((grid_regs["kitti131k"]._grid.overflow_idx >= 0).sum()) != 3123:
        raise AssertionError("kitti131k: expected 3,123 hot-cell overflow points")

    # -- 9. the grid path at full width, both pairs -------------------------
    b2_launches = 0
    for name, fixture in fixtures.items():
        src, tgt = pairs[name]
        params = _params(port, fixture, "grid")
        params.search_select = "pallas"
        zero_counts()
        reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
        final = reg.align()
        torch.cuda.synchronize()
        launches = {key: fn.launches for key, fn in counted.items()}
        tile = tgrid.pick_source_tile(reg._grid.capacity)
        blocks = -(-reg._src.shape[0] // tile)
        print(f"{name} grid path (search_impl='grid', search_select='pallas'): engine "
              f"{reg.engine}, capacity {reg._grid.capacity}, {blocks} blocks of {tile} rows, "
              f"launches {launches}, engine_fallbacks {reg.engine_fallbacks}, inner_cap_hits "
              f"{reg.inner_cap_hits}")
        want = {"select_windows": 0, "select_bitonic": 0, "row_topk": params.n_iter * blocks,
                "brute_knn": 0}
        if reg.engine != "grid" or launches != want:
            raise AssertionError(f"{name}: engine {reg.engine}, launches {launches}, expected "
                                 f"grid and {want}")
        b2_launches += launches["row_topk"]
        _check_against_fixture(reg, final, fixture, f"{name} grid")
        _warm_pairs(port, torch, src, tgt, params, f"{name} grid")

    # -- 10. B3 against its twin ------------------------------------------
    src, tgt = pairs["bunny35k"]
    params = _params(port, bunny, "pallas")
    k = params.max_neighbours
    reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
    if reg.engine != "pallas" or reg._grid_host is not None:
        raise AssertionError(f"search_impl='pallas': engine {reg.engine}, grid "
                             f"{reg._grid_host is not None}")

    def centred(reg):
        center = bbox_center(reg._tgt, reg._tgt_valid)
        return (torch.where(reg._src_valid[:, None], reg._src - center, 0.0).float(),
                (reg._tgt - center).float(), reg._tgt_valid)

    def hold_b3(a, kk, what):
        got = npal.brute_knn(*a, k=kk)
        want = npal._brute_knn_plain(*a, k=kk)
        torch.cuda.synchronize()
        _equal_bits([("indices", got[0], want[0]), ("d2", got[1], want[1])], what)
        max_err["brute_knn"] = max(max_err["brute_knn"],
                                   _max_abs_diff(got[1], want[1], torch.isfinite(want[1])))
        return got

    a = centred(reg)
    got = hold_b3(a, k, "B3 bunny35k at the initial pose")
    n_valid_tgt = int(a[2].sum())
    b3 = {"ms": _cuda_ms(lambda: npal.brute_knn(*a, k=k)),
          "plain_ms": _cuda_ms(lambda: npal._brute_knn_plain(*a, k=k), reps=3)}
    b3_bytes_ms = 1e3 * ((a[0].numel() + a[1].numel()) * 4 + a[2].numel()
                         + a[0].shape[0] * k * 8) / HBM_BYTES_PER_S
    b3_ops_ms = 1e3 * 9 * a[0].shape[0] * n_valid_tgt / F32_FLOP_PER_S
    b3_floor_ms = 1e3 * B3_OPERATIONS_PER_PAIR * a[0].shape[0] * n_valid_tgt / (
        F32_FLOP_PER_S / 2)
    print(f"B3 bunny35k at the initial pose: {a[0].shape[0]} x {a[1].shape[0]} "
          f"({n_valid_tgt} valid targets), k {k}: indices and d2 bit-equal to twin in "
          f"(expansion d2, index) order; B3 {b3['ms']:.4f} ms (median of 20), twin "
          f"{b3['plain_ms']:.2f} ms (median of 3), bound {max(b3_bytes_ms, b3_ops_ms):.4f} ms "
          f"(operations {b3_ops_ms:.4f}, bytes {b3_bytes_ms:.4f}), the contract's floor "
          f"{b3_floor_ms:.4f} ms ({B3_OPERATIONS_PER_PAIR} unfused float32 operations a "
          f"pair)")
    rng = np.random.default_rng(31)
    far_t = rng.uniform(0, 2, size=(5000, 3)) + 200.0
    far_s = far_t[rng.integers(0, 5000, 3001)] + rng.normal(scale=0.05, size=(3001, 3))
    center = (far_t.min(0) + far_t.max(0)) * 0.5
    lat = np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"), -1).reshape(-1, 3)
    few = np.zeros(4096, bool)
    few[[5, 170, 900, 4000]] = True
    holes = rng.random(5000) > 0.1
    zeroed = np.where(rng.random((3001, 1)) > 0.1, far_s - center, 0.0)
    same_t = rng.random((600, 3))  # 33 targets at one place, scattered over the indices
    same_t[rng.choice(600, 33, replace=False)] = same_t[0]
    same_s = same_t[0] + rng.normal(scale=0.02, size=(50, 3))
    for what, s_np, t_np, v_np, ks in [
        ("targets 200 m from the origin, centred; invalid targets, zeroed source rows",
         zeroed, far_t - center, holes, (1, 20, 32, 40)),
        ("lattice ties, every target twice", lat, np.concatenate([lat, lat]),
         np.ones(2 * len(lat), bool), (1, 20, 32, 40)),
        ("4 valid targets of 4096", rng.random((777, 3)), rng.random((4096, 3)), few,
         (1, 20, 40)),
        ("no valid target", rng.random((100, 3)), rng.random((64, 3)), np.zeros(64, bool),
         (20, 40)),
        ("17 targets (fewer than a warp, and than k)", rng.random((45, 3)), rng.random((17, 3)),
         np.ones(17, bool), (5, 20, 40)),
        ("1,300 targets (a ragged last tile), 1,003 rows (a ragged last block)",
         rng.random((1003, 3)), rng.random((1300, 3)), rng.random(1300) > 0.05, (1, 20, 32)),
        ("33 targets at one distance", same_s, same_t, np.ones(600, bool), (20, 32)),
    ]:
        e = (torch.as_tensor(s_np.astype(np.float32), device="cuda"),
             torch.as_tensor(t_np.astype(np.float32), device="cuda"),
             torch.as_tensor(v_np, device="cuda"))
        for kk in ks:
            out = hold_b3(e, kk, f"B3 edge case '{what}', k={kk}")
        print(f"B3 edge case '{what}': k in {ks}, bit-equal "
              f"({int((out[0] < e[1].shape[0]).sum())} filled slots at k={ks[-1]})")

    # -- 11. the KNN-kernel path: the bunny pair, and one LiDAR-size search --
    zero_counts()
    reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
    final = reg.align()
    torch.cuda.synchronize()
    launches = {key: fn.launches for key, fn in counted.items()}
    print(f"bunny35k KNN-kernel path (search_impl='pallas'): engine {reg.engine}, launches "
          f"{launches}, engine_fallbacks {reg.engine_fallbacks}, inner_cap_hits "
          f"{reg.inner_cap_hits}")
    b3_launches = launches["brute_knn"]
    if reg.engine != "pallas" or b3_launches != params.n_iter or sum(launches.values()) != b3_launches:
        raise AssertionError(f"KNN-kernel path: engine {reg.engine}, launches {launches}, "
                             f"expected pallas and {params.n_iter} B3 launches only")
    t_err, worst = _fixture_errors(reg, final, bunny, "bunny35k pallas")
    if t_err > TRANSFORM_ATOL or worst > COUNT_RTOL:
        # The fixture is the grid engine's; brute force selects by the
        # expansion distance, whose k-th slot has an error band. Hold the
        # path against the port's own streaming brute engine instead.
        print("bunny35k pallas: outside the grid fixture's limits; holding it against "
              "search_impl='brute' on the card instead")
        brute_T, brute = port.register_pair(src, tgt, _params(port, bunny, "brute"),
                                            device="cuda")
        t_err = float(np.abs(final - brute_T).max())
        worst = max(abs(a_.num_correspondences - b_.num_correspondences) / b_.num_correspondences
                    for a_, b_ in zip(reg.records, brute.records))
        print(f"bunny35k pallas vs brute: final 4x4 max abs diff {t_err:.3e} (limit "
              f"{TRANSFORM_ATOL}), worst correspondence-count diff {worst:.2e} (limit "
              f"{COUNT_RTOL})")
        if t_err > TRANSFORM_ATOL or worst > COUNT_RTOL or len(brute.records) != len(reg.records):
            raise AssertionError("bunny35k pallas: the run disagrees with the brute engine")
    _warm_pairs(port, torch, src, tgt, params, "bunny35k pallas")
    kreg = grid_regs["kitti131k"]
    ka = centred(kreg)
    kk = kreg.params.max_neighbours
    got = npal.brute_knn(*ka, k=kk)
    torch.cuda.synchronize()
    tile = 4096
    for r0 in range(0, ka[0].shape[0], tile):  # every row, a slice at a time
        rows = slice(r0, r0 + tile)
        want = npal._brute_knn_plain(ka[0][rows], ka[1], ka[2], k=kk)
        _equal_bits([("indices", got[0][rows], want[0]), ("d2", got[1][rows], want[1])],
                    f"B3 kitti131k rows {r0}-{r0 + tile - 1}")
    kitti_b3_ms = _cuda_ms(lambda: npal.brute_knn(*ka, k=kk), reps=3)
    kitti_pairs = ka[0].shape[0] * int(ka[2].sum())
    print(f"B3 kitti131k, one search {ka[0].shape[0]} x {ka[1].shape[0]}, k {kk}: "
          f"{kitti_b3_ms:.3f} ms (median of 3), bound "
          f"{1e3 * 9 * kitti_pairs / F32_FLOP_PER_S:.3f} ms (operations), the contract's floor "
          f"{1e3 * B3_OPERATIONS_PER_PAIR * kitti_pairs / (F32_FLOP_PER_S / 2):.3f} ms; "
          f"every row bit-equal to twin")

    # -- 12. a forced fallback: pool -> grid ----------------------------------
    pts = np.stack(np.meshgrid(np.arange(32), np.arange(32), np.arange(8)), -1).reshape(-1, 3)
    f_src, f_tgt = pts.astype(np.float32), (pts + 0.05).astype(np.float32)
    f_kw = dict(max_neighbours=4, radius=0.4, dtype="float32", n_iter=2, cost_drop_thresh=-1.0)
    zero_counts()
    reg = port.ProbabilisticRegistration(
        f_src, f_tgt, port.RegistrationParams(search_impl="pool", **f_kw), device="cuda")
    if reg.engine != "pool":
        raise AssertionError(f"forced fallback: the pair started on the {reg.engine} engine")
    reg._pool_budget_base = 0

    def floor_budgets():
        """The source-row floor at every escalation rung, which this pair's
        grouping overflows: the ladder runs out and the pair falls back."""
        boost, reg._pool_budget_boost = reg._pool_budget_boost, 0
        budgets = type(reg).pool_budgets(reg)
        reg._pool_budget_boost = boost
        return budgets

    reg.pool_budgets = floor_budgets
    pool_T = reg.align()
    torch.cuda.synchronize()
    grid_T, grid_reg = port.register_pair(
        f_src, f_tgt, port.RegistrationParams(search_impl="grid", **f_kw), device="cuda")
    diff = float(np.abs(pool_T - grid_T).max())
    print(f"forced fallback: budget boost {reg._pool_budget_boost}, engine_fallbacks "
          f"{reg.engine_fallbacks}, pool kept {reg._pool is not None}, grid uploaded "
          f"{reg._grid is not None}; final 4x4 vs search_impl='grid' alone max abs diff "
          f"{diff:.3e} (limit 1e-6: the same searches, float32 reductions on the card)")
    if (reg._pool_budget_boost, reg.engine_fallbacks) != (2, 1) or reg._pool is not None \
            or reg._grid is None or grid_reg.engine != "grid" or not diff <= 1e-6:
        raise AssertionError("forced fallback: the pair did not end on the grid engine")
    if [r.num_correspondences for r in reg.records] != [
            r.num_correspondences for r in grid_reg.records]:
        raise AssertionError("forced fallback: correspondence counts differ from the grid run")

    # -- 13. the LM blocks' CUDA graphs against the same blocks eagerly ----
    from probabilistic_point_clouds_registration_tpu_torch.models.em_lm import (
        LM_BLOCK,
        LMBlocks,
    )

    def record_fields(reg):
        return [(r.num_correspondences, r.num_successful_steps, r.initial_cost, r.final_cost,
                 r.translation.tobytes(), r.rpy_deg.tobytes()) for r in reg.records]

    for name, fixture in fixtures.items():
        src, tgt = pairs[name]
        params = _params(port, fixture, "auto")
        runs = {}
        for mode in ("graphs", "eager", "graphs", "eager"):
            zero_counts()
            reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
            if mode == "eager":
                reg._lm = LMBlocks(graphs=False, block=LM_BLOCK)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final = reg.align()
            torch.cuda.synchronize()
            runs[mode] = (reg, final, select_bitonic.launches, time.perf_counter() - t0)
        (g_reg, g_final, g_b4, g_s), (e_reg, e_final, e_b4, e_s) = runs["graphs"], runs["eager"]
        n_classes = len(g_reg._pool.class_widths)
        if not g_reg._lm._captured or e_reg._lm._captured:
            raise AssertionError(f"{name}: the graph run captured {len(g_reg._lm._captured)} "
                                 f"shapes, the eager run {len(e_reg._lm._captured)}")
        same = (np.array_equal(g_final, e_final)
                and record_fields(g_reg) == record_fields(e_reg)
                and g_reg.inner_iterations == e_reg.inner_iterations)
        print(f"{name} graphs vs eager (auto, LM blocks of {LM_BLOCK}): records, LM counts and "
              f"final 4x4 bit-equal {same}; B4 launches {g_b4} / {e_b4} (expected "
              f"{params.n_iter * n_classes}); warm align seconds {g_s:.4f} with graphs, "
              f"{e_s:.4f} eager; LM iterations per solve {g_reg.inner_iterations}; native host "
              f"library loaded {native.available()}")
        if not same:
            raise AssertionError(f"{name}: graph replay and eager blocks disagree")
        if g_b4 != e_b4 or g_b4 != params.n_iter * n_classes:
            raise AssertionError(f"{name}: B4 launches {g_b4} (graphs) and {e_b4} (eager), "
                                 f"expected {params.n_iter * n_classes}")

    # -- 14. outer_chunk 1 / 4 / 16 at the default stopping rule --------------
    src, tgt = pairs["bunny35k"]
    defaults = port.RegistrationParams()
    chunked = {}
    for chunk in (1, 4, 16):
        params = _params(port, bunny, "auto")
        params.n_iter = defaults.n_iter
        params.cost_drop_thresh = defaults.cost_drop_thresh
        params.n_cost_drop_it = defaults.n_cost_drop_it
        params.outer_chunk = chunk
        zero_counts()
        reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = reg.align()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        slots = select_bitonic.launches // len(reg._pool.class_widths)
        chunked[chunk] = (reg, final)
        print(f"bunny35k outer_chunk={chunk} (default stopping rule): {len(reg.records)} "
              f"iterations, {slots} slots searched ({slots - len(reg.records)} stopped or "
              f"discarded), align {seconds:.4f} s, median iteration "
              f"{1e3 * statistics.median(reg.iteration_times):.2f} ms, engine_fallbacks "
              f"{reg.engine_fallbacks}, inner_cap_hits {reg.inner_cap_hits}")
        if reg.engine_fallbacks or reg.inner_cap_hits or len(reg.records) >= defaults.n_iter:
            raise AssertionError(f"outer_chunk={chunk}: fell back, hit the inner cap or never "
                                 f"stopped")
    one_reg, one_final = chunked[1]
    for chunk in (4, 16):
        reg, final = chunked[chunk]
        t_err = float(np.abs(final - one_final).max())
        worst = max(abs(a.num_correspondences - b.num_correspondences) / b.num_correspondences
                    for a, b in zip(reg.records, one_reg.records))
        cost = max(abs(a.final_cost - b.final_cost) / abs(b.final_cost)
                   for a, b in zip(reg.records, one_reg.records))
        print(f"bunny35k outer_chunk={chunk} vs 1: {len(reg.records)} vs {len(one_reg.records)} "
              f"records, final 4x4 max abs diff {t_err:.3e} (limit {TRANSFORM_ATOL}), worst "
              f"correspondence-count diff {worst:.2e} (limit {COUNT_RTOL}), worst final-cost "
              f"diff {cost:.2e} (float32 compositions on the card between the host's)")
        if len(reg.records) != len(one_reg.records) or t_err > TRANSFORM_ATOL \
                or worst > COUNT_RTOL:
            raise AssertionError(f"outer_chunk={chunk} disagrees with outer_chunk=1")

    # The fixtures come from the JAX package's one-iteration loop: both pairs
    # at outer_chunk=1 beside the default chunks of phases 5-6.
    for name, fixture in fixtures.items():
        params = _params(port, fixture, "auto")
        params.outer_chunk = 1
        reg = port.ProbabilisticRegistration(*pairs[name], params, device="cuda")
        t_err = _check_against_fixture(reg, reg.align(), fixture, f"{name} pool, outer_chunk=1")
        print(f"{name} auto: final 4x4 vs JAX fixture {t_err:.3e} at outer_chunk=1, "
              f"{main_err[name]:.3e} at outer_chunk={_params(port, fixture, 'auto').outer_chunk}")

    # -- 15. the voxel-filtered pair -------------------------------------------
    params = _params(port, voxel_fixture, "auto")
    zero_counts()
    t0 = time.perf_counter()
    reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
    ctor_s = time.perf_counter() - t0
    final = reg.align()
    torch.cuda.synchronize()
    print(f"bunny35k voxel-filtered (leaf {params.source_filter_size} / "
          f"{params.target_filter_size}): {reg.filtered_source.shape[0]} source and "
          f"{reg.target_cloud.shape[0]} target points, engine {reg.engine}, B4 launches "
          f"{select_bitonic.launches}, ctor {ctor_s:.4f} s (filters included); native host "
          f"library loaded {native.available()}")
    if reg.engine != "pool" or select_bitonic.launches < 1:
        raise AssertionError(f"voxel-filtered pair: engine {reg.engine}")
    _check_against_fixture(reg, final, voxel_fixture, "bunny35k voxel pool")

    seq_rates = _entry_points(port, torch, native, synthetic, pairs["bunny35k"], counted,
                              zero_counts)
    mesh_launches = _mesh_phases(port, torch, synthetic, fixtures, pairs, counted, zero_counts,
                                 smi)
    batch_launches = _batch_phases(port, torch, synthetic, counted, zero_counts, smi, seq_rates)
    for added in (mesh_launches, batch_launches):
        b1_launches += added["select_windows"]
        b4_launches += added["select_bitonic"]
        b2_launches += added["row_topk"]
        b3_launches += added["brute_knn"]

    # -- result lines ----------------------------------------------------------
    select_bound = max(select_bytes_ms, select_ops_ms)
    select_by = "bytes" if select_bytes_ms >= select_ops_ms else "operations"
    measured = {
        "select_windows": dict(launches=b1_launches, ms=class_ms["select_windows"],
                               plain_ms=class_ms["plain"], bound_ms=select_bound,
                               bound_by=select_by, library_ms=None),
        "select_bitonic": dict(launches=b4_launches, ms=class_ms["select_bitonic"],
                               plain_ms=class_ms["plain"], bound_ms=select_bound,
                               bound_by=select_by, library_ms=None),
        "row_topk": dict(launches=b2_launches, bound_by="bytes", **b2),
        "brute_knn": dict(launches=b3_launches, bound_ms=max(b3_bytes_ms, b3_ops_ms),
                          bound_by="operations" if b3_ops_ms >= b3_bytes_ms else "bytes",
                          library_ms=None, **b3),
    }
    for name, m in measured.items():
        if m["launches"] < 1:
            raise AssertionError(f"{name}: no launch on the path that runs it")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": measured[name]["launches"],
        "max_abs_err": max_err[name],
        "ms": measured[name]["ms"],
        "plain_ms": measured[name]["plain_ms"],
        "bound_ms": measured[name]["bound_ms"],
        "bound_by": measured[name]["bound_by"],
        "library_ms": measured[name]["library_ms"],
    } for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
