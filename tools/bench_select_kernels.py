"""Time the port's four CUDA kernels of this tree beside another tree's, on
one CUDA device, in one process: the window selects B1 (csrc/select_windows.cu)
and B4 (csrc/select_bitonic.cu), the row top-k B2 (csrc/row_topk.cu) and the
brute KNN B3 (csrc/brute_knn.cu).

    python3 tools/bench_select_kernels.py --parent-root build/parent
    python3 tools/bench_select_kernels.py --parent-root build/parent --count-merges
    python3 tools/bench_select_kernels.py --kernels select_windows,select_bitonic \
        --variants --writes-only
    python3 tools/bench_select_kernels.py --kernels brute_knn --no-candidates

The inputs are the ones the registration gives the kernels, for both fixture
pairs at their initial pose, k = 20: for B1 and B4 every width-class pass of
the pooled search (eight passes) and, for B1, the dense engine's grouped rows
(71,680 rows on windows of 384 lanes); for B2 the candidate-distance matrix
of the first source block of the grid search (16,384 rows); for B3 the
centred clouds (35,840 x 35,840 and 131,072 x 131,072). Every build's output
is held bit-equal to this tree's kernel (which ``chip_smoke.py`` holds
against the plain twins). Times are CUDA events, the median of ``--reps``
launches, each enqueued behind a 0.1 ms spin so that the events bracket
device time only, in the order parent, this tree, this tree, parent.
``--parent-root`` is a checkout of the other tree (for example ``git archive
<commit> | tar -x -C build/parent``); its kernels may predate the
packed-target scratch of B3 and the shared headers. A select's line carries
the bound ``chip_smoke.py`` computes for the same inputs.

``--count-merges`` builds copies of both trees' sources with a counter added
where a sorting network runs and prints the merges per row (a tree's B1
without a network, k rounds over the window, prints none). ``--variants``
builds copies of this tree's sources with one tuning constant changed each
and times them. ``--no-candidates`` times copies of this tree's B3, B1 and B4
whose thresholds admit nothing: the distance loop or the walk alone, without
votes that find a candidate, appends or merges. ``--writes-only`` times copies of this
tree's selects that treat every group as one on the dead window: the
output's stores alone, beside one ``fill_`` of as many bytes.
``--phase-cycles`` runs copies of this tree's selects whose warps add up the
SM clock's cycles of every row's walk and, of those, of its merges. Copies and
builds go to ``build/bench_select/``. One JSON line per measurement; the
first line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
PORT = "probabilistic_point_clouds_registration_tpu_torch"
OUT = REPO / "build" / "bench_select"

_P, _I = ctypes.c_void_p, ctypes.c_int
B2_ARGS = [_P] * 3 + [_I] * 3 + [_P]
B3_ARGS_PACKED = [_P] * 4 + [_I] + [_P] * 2 + [_I] * 3 + [_P]
B3_ARGS_UNPACKED = [_P] * 5 + [_I] * 3 + [_P]
SELECT_ARGS = {"select_windows": [_P] * 10 + [_I] * 4 + [ctypes.c_float, _P],
               "select_bitonic": [_P] * 10 + [_I] * 3 + [ctypes.c_float, _P]}
PACK_TILE = 512
KERNELS = ("select_windows", "select_bitonic", "row_topk", "brute_knn")

COUNTER = "__device__ unsigned long long g_merges;\n__device__ unsigned long long g_staged;\n"
COUNT_ONE = "if ((threadIdx.x & 31) == 0) atomicAdd(&g_merges, 1ull);\n"
READER = """
extern "C" long long merge_count(int staged, int reset) {
  unsigned long long v = 0;
  const unsigned long long zero = 0;
  cudaDeviceSynchronize();
  if (staged) {
    cudaMemcpyFromSymbol(&v, g_staged, sizeof(v));
    if (reset) cudaMemcpyToSymbol(g_staged, &zero, sizeof(zero));
  } else {
    cudaMemcpyFromSymbol(&v, g_merges, sizeof(v));
    if (reset) cudaMemcpyToSymbol(g_merges, &zero, sizeof(zero));
  }
  return (long long)v;
}
"""
# Variants to time, per source: tuning constants set to other values than
# the tree's.
_SELECT_VARIANTS = [{"kLoads": 2}, {"kBlocksPerSM": 4}, {"kBlocksPerSM": 16},
                    {"kBlocksPerSM": 1 << 20}, {"kMinBlocksPerSM": 1}, {"kMinBlocksPerSM": 5},
                    {"kLoads": 2, "kMinBlocksPerSM": 3},
                    {"kRankSort": 0}]
VARIANTS = {
    "select_windows": _SELECT_VARIANTS,
    "select_bitonic": _SELECT_VARIANTS,
    "row_topk": [{"kLoads": 1}, {"kLoads": 2}, {"kLoads": 8}, {"kRowsPerBlock": 4},
                 {"kRowsPerBlock": 16}],
    "brute_knn": [{"kRows": 8, "kWarpsPerSM": 16}, {"kWarps": 4}, {"kWarps": 16},
                  {"kTile": 256, "kStages": 4}, {"kStages": 2},
                  {"kTile": 1024, "kStages": 2}],
}


def _copy_headers(csrc: Path, dst: Path) -> None:
    dst.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        (dst / header.name).write_text(header.read_text())


def _no_candidates_copy(csrc: Path, name: str, dst: Path) -> Path:
    """A copy of ``csrc/<name>.cu`` whose thresholds admit nothing: every
    target or lane is evaluated, none is taken. B3's rows all carry the
    threshold of a row past n (-inf); a window select's rows start from a
    threshold below every distance."""
    _copy_headers(csrc, dst)
    cu = (csrc / f"{name}.cu").read_text()
    if name == "brute_knn":
        cu = _sub(cu, "thr[r] = in_range ? CUDART_INF_F : -CUDART_INF_F;",
                  "thr[r] = -CUDART_INF_F;")
    else:
        header = dst / "window_select.cuh"
        header.write_text(_sub(header.read_text(),
                               "const float thr0 = a.r2 >= below_empty ? below_empty : a.r2;",
                               "const float thr0 = a.r2 >= below_empty ? -1.0f : -2.0f;"))
    (dst / f"{name}.cu").write_text(cu)
    return dst / f"{name}.cu"


def _writes_only_copy(csrc: Path, name: str, dst: Path) -> Path:
    """A copy of a window select (``csrc/<name>.cu`` and its headers) that
    treats every group as one on the dead window: it reads each group's
    window row and width and stores the empty slots, nothing else."""
    _copy_headers(csrc, dst)
    header = dst / "window_select.cuh"
    header.write_text(_sub(header.read_text(), "if (width <= 0) {", "if (width <= a.n_lanes) {"))
    (dst / f"{name}.cu").write_text((csrc / f"{name}.cu").read_text())
    return dst / f"{name}.cu"


PHASES = ("rows_walked", "walk_cycles", "merges", "merge_cycles")
PHASE_COUNTER = """__device__ unsigned long long g_phase[4];
__shared__ unsigned long long s_phase[4];  // the block's sums; added to g_phase at its end
__device__ __forceinline__ void phase_add(int slot, long long since) {
  const long long cycles = clock64() - since;
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&s_phase[slot], 1ull);
    atomicAdd(&s_phase[slot + 1], (unsigned long long)cycles);
  }
}
"""
PHASE_READER = """
extern "C" long long phase_count(int slot, int reset) {
  unsigned long long v[4];
  const unsigned long long zero[4] = {0, 0, 0, 0};
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(v, wsel::g_phase, sizeof(v));
  if (reset) cudaMemcpyToSymbol(wsel::g_phase, zero, sizeof(zero));
  return (long long)v[slot];
}
"""


def _phase_copy(csrc: Path, name: str, dst: Path) -> Path:
    """A copy of a window select whose warps add up, on the SM's clock, the
    cycles of each row's walk (first load to the list's last merge) and, of
    those, the cycles inside merges, with the count of each."""
    _copy_headers(csrc, dst)
    header = dst / "window_select.cuh"
    h = _sub(header.read_text(), "namespace wsel {\n", "namespace wsel {\n" + PHASE_COUNTER)
    h = _sub(h, "  const int lane = threadIdx.x & 31;\n  run = kRankSort ?",
             "  const int lane = threadIdx.x & 31;\n  const long long merge_t0 = clock64();\n"
             "  run = kRankSort ?")
    h = _sub(h, "  const unsigned long long kth = __shfl_sync(kFull, run, k - 1);\n  return {run,",
             "  const unsigned long long kth = __shfl_sync(kFull, run, k - 1);\n"
             "  phase_add(2, merge_t0);\n  return {run,")
    h = _sub(h, "  unsigned long long run = kNone;  // running top 32, ascending across the lanes\n",
             "  unsigned long long run = kNone;  // running top 32, ascending across the lanes\n"
             "  const long long walk_t0 = clock64();\n")
    h = _sub(h, "  if (count > 0) flush();\n  return run;\n",
             "  if (count > 0) flush();\n  phase_add(0, walk_t0);\n  return run;\n")
    h = _sub(h, "  int g = blockIdx.x;\n  if (g >= a.n_groups) return;\n",
             "  int g = blockIdx.x;\n  if (g >= a.n_groups) return;\n"
             "  if (threadIdx.x < 4) s_phase[threadIdx.x] = 0;\n  __syncthreads();\n")
    h = _sub(h, "    sx = next_x, sy = next_y, sz = next_z, fmeta = next_meta;\n  }\n",
             "    sx = next_x, sy = next_y, sz = next_z, fmeta = next_meta;\n  }\n"
             "  __syncthreads();\n"
             "  if (threadIdx.x < 4) atomicAdd(&g_phase[threadIdx.x], s_phase[threadIdx.x]);\n")
    header.write_text(h)
    (dst / f"{name}.cu").write_text((csrc / f"{name}.cu").read_text() + PHASE_READER)
    return dst / f"{name}.cu"


def _variant_tag(name: str, knobs: dict) -> str:
    return f"variant_{name}_" + "_".join(f"{c}_{v}" for c, v in knobs.items())


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"bench_select_kernels: pattern not found: {old!r}")
    return text.replace(old, new)


def _counting_copy(csrc: Path, name: str, dst: Path) -> Path | None:
    """A copy of ``csrc/<name>.cu`` (and its headers) that counts one per
    sorting-network merge in ``g_merges`` and the keys staged for a merge in
    ``g_staged``; None for a source without a network (a window select that
    takes k rounds over the window)."""
    cu = (csrc / f"{name}.cu").read_text()
    if '#include "topk_merge.cuh"' in cu or '#include "window_select.cuh"' in cu:
        # A merge is topk::merge_staged.
        _copy_headers(csrc, dst)
        h = _sub((csrc / "topk_merge.cuh").read_text(), "namespace topk {\n",
                 COUNTER + "namespace topk {\n")
        h = _sub(h, "  __syncwarp();\n  const unsigned long long key = lane < count",
                 "  " + COUNT_ONE + "  __syncwarp();\n  const unsigned long long key = lane < count")
        h = _sub(h, "  return count + __popc(ballot);\n",
                 "  if (lane == 0) atomicAdd(&g_staged, (unsigned long long)__popc(ballot));\n"
                 "  return count + __popc(ballot);\n")
        by_rank = "  __syncwarp();\n  const unsigned long long mine = lane < count"
        if by_rank in h:  # the window selects' merge
            h = _sub(h, by_rank, "  " + COUNT_ONE + by_rank)
        (dst / "topk_merge.cuh").write_text(h)
    elif name == "select_windows":
        return None
    else:  # the merge follows the warp vote, in the kernel
        dst.mkdir(parents=True, exist_ok=True)
        cu = _sub(cu, "namespace {\n", COUNTER + "namespace {\n")
        if name == "brute_knn":
            cu = _sub(cu, "          run[r] = merge_chunk(",
                      "          " + COUNT_ONE + "          run[r] = merge_chunk(")
        elif name == "select_bitonic":
            vote = "      if (!__any_sync(kFull, live && key < worst)) continue;\n"
            cu = _sub(cu, vote, vote + "      " + COUNT_ONE)
        else:
            vote = "      if (!__any_sync(kFull, key < kth)) continue;\n"
            cu = _sub(cu, vote, vote + "      " + COUNT_ONE)
    (dst / f"{name}.cu").write_text(cu + READER)
    return dst / f"{name}.cu"


def _variant_copy(csrc: Path, name: str, knobs: dict, dst: Path) -> Path:
    """A copy of ``csrc/<name>.cu`` and the headers with each constant of
    ``knobs`` (defined once, in the source or in a header) set anew."""
    _copy_headers(csrc, dst)
    (dst / f"{name}.cu").write_text((csrc / f"{name}.cu").read_text())
    for constant, value in knobs.items():
        pattern = rf"(constexpr int {constant} = )[^;]+;"
        # The source's own constant first, else the one header that has it.
        hits = [f for f in [dst / f"{name}.cu"] if re.search(pattern, f.read_text())] or [
            f for f in sorted(dst.glob("*.cuh")) if re.search(pattern, f.read_text())]
        if len(hits) != 1:
            raise SystemExit(f"bench_select_kernels: {name}.cu and its headers define "
                             f"{constant} {len(hits)} times")
        hits[0].write_text(re.sub(pattern, rf"\g<1>{value};", hits[0].read_text(), count=1))
    return dst / f"{name}.cu"


def _compile(kernels, jobs: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """nvcc every source of ``jobs`` (tag -> .cu), all started together."""
    OUT.mkdir(parents=True, exist_ok=True)

    def one(item):
        tag, cu = item
        so = OUT / f"lib{tag}.so"
        proc = subprocess.run(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(cu.parent), "-o", str(so), str(cu)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"bench_select_kernels: nvcc failed on {cu}:\n{proc.stderr}")
        used = [ln.strip() for ln in proc.stderr.splitlines()
                if "registers" in ln or "spill" in ln]
        return tag, ctypes.CDLL(str(so)), used

    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(one, jobs.items()))
    for tag, _, used in built:
        print(json.dumps({"build": tag, "ptxas": used}))
    return {tag: lib for tag, lib, _ in built}


def _select_inputs(port, torch, fixtures, pairs) -> dict:
    """label -> (padded, cand_xyz, cand_idx, step_rows, width_lut, k, radius)
    of every pooled class pass of both pairs and of the dense engine's
    search of the bunny pair, at the initial pose."""
    from probabilistic_point_clouds_registration_tpu_torch.core.types import pad_cloud, round_up
    from probabilistic_point_clouds_registration_tpu_torch.ops import fused_grid as fg
    from probabilistic_point_clouds_registration_tpu_torch.ops import fused_pool as fp

    def params_of(fixture, impl):
        kw = {k: v for k, v in fixture["params"].items()
              if k not in ("search_impl", "outer_chunk")}
        return port.RegistrationParams(**kw, search_impl=impl)

    inputs = {}
    for name, fixture in fixtures.items():
        src, tgt = pairs[name]
        params = params_of(fixture, "auto")
        reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
        if reg.engine != "pool":
            raise SystemExit(f"bench_select_kernels: {name}: auto took the {reg.engine} engine")
        pool = reg._pool
        budget, class_budgets = reg.pool_budgets()
        passes, _, _, overflow = fp.class_passes(
            reg._src, reg._src_valid, pool.select_xyz, pool.pool_idx,
            pool.class_width_luts, pool.lut_d, pool.origin_d, pool.dims_d,
            radius=params.radius, class_widths=pool.class_widths, class_ends=pool.class_ends,
            class_budgets=class_budgets, budget_rows=budget, small_unions=pool.small_unions,
            select_max_w=pool.select_max_w)
        if int(overflow) != 0:
            raise SystemExit(f"bench_select_kernels: {name}: the pooled budgets overflow")
        for w_c, _, a in passes:
            inputs[f"{name} class {w_c}"] = (*(x.contiguous() for x in a),
                                             params.max_neighbours, params.radius)
    src, tgt = pairs["bunny35k"]
    params = params_of(fixtures["bunny35k"], "fused")
    grid = port.ProbabilisticRegistration.prepare_target(tgt, params)["grid"]
    pre = fg.build_prepack(
        grid, torch.as_tensor(grid["bucket_pts"].astype(np.float32), device="cuda"),
        torch.as_tensor(grid["bucket_idx"], device="cuda"), k=params.max_neighbours)
    src_p, n_src = pad_cloud(src, params.pad_multiple, pad_value=0.0)
    padded, step_rows, _, _, overflow = fg._group_by_window(
        torch.as_tensor(src_p.astype(np.float32), device="cuda"),
        torch.arange(src_p.shape[0], device="cuda") < n_src, pre.lut_d, pre.origin_d,
        pre.dims_d, pre.cand_idx.shape[0] - 1, params.radius,
        round_up(2 * src_p.shape[0], fg._ROW_ALIGN), n_lanes=pre.n_lanes)
    if int(overflow) != 0:
        raise SystemExit("bench_select_kernels: the dense grouping overflowed")
    inputs["bunny35k dense"] = (padded, pre.cand_xyz, pre.cand_idx, step_rows, pre.width_lut,
                                params.max_neighbours, params.radius)
    return inputs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-root", type=Path, help="checkout of the tree to compare with")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"comma-separated, of {', '.join(KERNELS)}")
    ap.add_argument("--count-merges", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--no-candidates", action="store_true")
    ap.add_argument("--writes-only", action="store_true")
    ap.add_argument("--phase-cycles", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    names = [name for name in KERNELS if name in args.kernels.split(",")]
    if not names or set(args.kernels.split(",")) - set(KERNELS):
        raise SystemExit(f"bench_select_kernels: --kernels takes {', '.join(KERNELS)}")
    selects = [name for name in names if name in SELECT_ARGS]

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_select_kernels: no CUDA device")
    sys.path.insert(0, str(REPO))
    import probabilistic_point_clouds_registration_tpu_torch as port
    from chip_smoke import _pair, _select_bound_ms
    from probabilistic_point_clouds_registration_tpu_torch import kernels
    from probabilistic_point_clouds_registration_tpu_torch.io import synthetic
    from probabilistic_point_clouds_registration_tpu_torch.ops import fused_grid as fg
    from probabilistic_point_clouds_registration_tpu_torch.ops import grid as tgrid
    from probabilistic_point_clouds_registration_tpu_torch.ops.neighbors import bbox_center

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0])
    stream = torch.cuda.current_stream().cuda_stream

    # -- the builds ---------------------------------------------------------
    csrc = REPO / PORT / "csrc"
    jobs = {f"tree_{name}": csrc / f"{name}.cu" for name in names}
    trees = {"tree": csrc}
    if args.parent_root:
        trees["parent"] = args.parent_root.resolve() / PORT / "csrc"
        jobs.update({f"parent_{name}": trees["parent"] / f"{name}.cu" for name in names})
    if args.count_merges:
        for tree, root in trees.items():
            for name in names:
                cu = _counting_copy(root, name, OUT / f"count_{tree}_{name}")
                if cu is not None:
                    jobs[f"count_{tree}_{name}"] = cu
    if args.variants:
        for name in names:
            for knobs in VARIANTS[name]:
                tag = _variant_tag(name, knobs)
                jobs[tag] = _variant_copy(csrc, name, knobs, OUT / tag)
    if args.no_candidates:
        for name in names:
            if name != "row_topk":
                jobs[f"no_candidates_{name}"] = _no_candidates_copy(
                    csrc, name, OUT / f"no_candidates_{name}")
    if args.writes_only:
        for name in selects:
            jobs[f"writes_only_{name}"] = _writes_only_copy(csrc, name,
                                                            OUT / f"writes_only_{name}")
    if args.phase_cycles:
        for name in selects:
            jobs[f"phases_{name}"] = _phase_copy(csrc, name, OUT / f"phases_{name}")
    libs = _compile(kernels, jobs)

    def row_topk(tag):
        fn = libs[tag].row_topk_launch
        fn.argtypes, fn.restype = B2_ARGS, _I

        def run(d2, k):
            n, w = d2.shape
            vals = torch.empty((n, k), dtype=torch.float32, device="cuda")
            cols = torch.empty((n, k), dtype=torch.int32, device="cuda")
            err = fn(d2.data_ptr(), vals.data_ptr(), cols.data_ptr(), n, w, k, stream)
            if err:
                raise SystemExit(f"bench_select_kernels: {tag}: CUDA error {err}")
            return vals, cols
        return run

    def brute_knn(tag):
        fn = libs[tag].brute_knn_launch
        packed_scratch = "parent" not in tag or (
            "float* packed" in (trees["parent"] / "brute_knn.cu").read_text())
        fn.argtypes, fn.restype = (B3_ARGS_PACKED if packed_scratch else B3_ARGS_UNPACKED), _I
        found = re.search(r"kTile_(\d+)", tag)
        tile = int(found.group(1)) if found else PACK_TILE

        def run(src, tgt, valid, k):
            n, m = src.shape[0], tgt.shape[0]
            out_i = torch.empty((n, k), dtype=torch.int32, device="cuda")
            out_d = torch.empty((n, k), dtype=torch.float32, device="cuda")
            ptrs = [src.data_ptr(), tgt.data_ptr(), valid.view(torch.uint8).data_ptr()]
            if packed_scratch:
                packed = torch.empty((m + -m % tile, 4), dtype=torch.float32, device="cuda")
                ptrs += [packed.data_ptr(), packed.shape[0]]
            err = fn(*ptrs, out_i.data_ptr(), out_d.data_ptr(), n, m, k, stream)
            if err:
                raise SystemExit(f"bench_select_kernels: {tag}: CUDA error {err}")
            return out_i, out_d
        return run

    def select(name):
        def make(tag):
            fn = getattr(libs[tag], f"{name}_launch")
            fn.argtypes, fn.restype = SELECT_ARGS[name], _I

            def run(padded, cand_xyz, cand_idx, step_rows, width_lut, k, radius):
                s = padded.shape[0]
                outs = [torch.empty((s, 32), dtype=torch.int32 if i == 1 else torch.float32,
                                    device="cuda") for i in range(5)]
                slots = (k, 32) if name == "select_windows" else (k,)
                err = fn(padded.data_ptr(), cand_xyz.data_ptr(), cand_idx.data_ptr(),
                         step_rows.data_ptr(), width_lut.data_ptr(),
                         *(o.data_ptr() for o in outs), s // fg.GROUP, cand_idx.shape[1], *slots,
                         ctypes.c_float(float(np.float32(radius) ** 2)), stream)
                if err:
                    raise SystemExit(f"bench_select_kernels: {tag}: CUDA error {err}")
                return tuple(outs)
            return run
        return make

    # -- the inputs -----------------------------------------------------------
    fixtures = {pair_name: json.loads(
        (REPO / "tests" / "data" / f"torch_port_{pair_name}_ref.json").read_text())
        for pair_name in ("bunny35k", "kitti131k")}
    pairs = {pair_name: _pair(fixture, synthetic) for pair_name, fixture in fixtures.items()}
    inputs = {name: {} for name in names}
    if selects:
        select_inputs = _select_inputs(port, torch, fixtures, pairs)
        for name in selects:
            inputs[name] = {label: a for label, a in select_inputs.items()
                            if name == "select_windows" or "class" in label}
    for pair_name, fixture in fixtures.items():
        if not {"row_topk", "brute_knn"} & set(names):
            break
        src, tgt = pairs[pair_name]
        kw = {k: v for k, v in fixture["params"].items()
              if k not in ("search_impl", "outer_chunk")}
        params = port.RegistrationParams(**kw, search_impl="grid")
        reg = port.ProbabilisticRegistration(src, tgt, params, device="cuda")
        g = reg._grid
        rows = tgrid.pick_source_tile(g.capacity)
        d2, _, _ = tgrid.candidate_distances(
            reg._src[:rows], reg._src_valid[:rows], g.bucket_pts, g.bucket_idx, g.cell_ids,
            g.origin, g.dims, g.lut, radius=params.radius, capacity=g.capacity)
        k = params.max_neighbours
        if "row_topk" in names:
            inputs["row_topk"][pair_name] = (d2.contiguous(), k)
        center = bbox_center(reg._tgt, reg._tgt_valid)
        if "brute_knn" in names:
            inputs["brute_knn"][pair_name] = (
                torch.where(reg._src_valid[:, None], reg._src - center, 0.0).float().contiguous(),
                (reg._tgt - center).float().contiguous(), reg._tgt_valid.contiguous(), k)
        del reg
    makers = {"row_topk": row_topk, "brute_knn": brute_knn,
              **{name: select(name) for name in SELECT_ARGS}}

    def shape_of(name, a):
        if name in SELECT_ARGS:
            return [a[0].shape[0], a[2].shape[1]]
        return list(a[0].shape) if name == "row_topk" else [a[0].shape[0], a[1].shape[0]]

    def cuda_ms(fn):
        fn()
        times = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(200_000)  # the device is busy while the host enqueues
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def held(name, tag, a, want):
        got = makers[name](tag)(*a)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                raise SystemExit(f"bench_select_kernels: {tag} differs from this tree's kernel")

    # -- parent, tree, tree, parent --------------------------------------------
    for name in names:
        for label, a in inputs[name].items():
            want = makers[name](f"tree_{name}")(*a)
            torch.cuda.synchronize()
            order = ["tree", "tree"]
            if args.parent_root:
                held(name, f"parent_{name}", a, want)
                order = ["parent", "tree", "tree", "parent"]
            ms = {}
            for tree in order:
                run = makers[name](f"{tree}_{name}")
                ms.setdefault(tree, []).append(cuda_ms(lambda: run(*a)))
            line = {"kernel": name, "pair": label, "shape": shape_of(name, a),
                    "k": a[-2] if name in SELECT_ARGS else a[-1], "ms": ms, "reps": args.reps}
            if name in SELECT_ARGS:
                line["bound_bytes_ms"], line["bound_operations_ms"] = _select_bound_ms(
                    fg, torch, a[:5])
                line["rows_with_a_neighbour"] = int((want[1][:, 0] >= 0).sum())
            print(json.dumps(line))
            if args.no_candidates and name != "row_topk":
                run = makers[name](f"no_candidates_{name}")
                print(json.dumps({"kernel": name, "pair": label, "no_candidates": True,
                                  "ms": cuda_ms(lambda: run(*a))}))
            if args.writes_only and name in SELECT_ARGS:
                run = makers[name](f"writes_only_{name}")
                flat = torch.empty(a[0].shape[0] * 32 * 5, dtype=torch.float32, device="cuda")
                print(json.dumps({"kernel": name, "pair": label, "writes_only": True,
                                  "ms": cuda_ms(lambda: run(*a)),
                                  "fill_ms": cuda_ms(lambda: flat.fill_(0.0)),
                                  "bytes_written": flat.numel() * 4}))
            if args.phase_cycles and name in SELECT_ARGS:
                tag = f"phases_{name}"
                counter = libs[tag].phase_count
                counter.argtypes, counter.restype = [_I, _I], ctypes.c_longlong
                counter(0, 1)
                held(name, tag, a, want)
                print(json.dumps({"kernel": name, "pair": label,
                                  **{phase: counter(i, 0) for i, phase in enumerate(PHASES)}}))
            if args.count_merges:
                for tree in trees:
                    tag = f"count_{tree}_{name}"
                    if tag not in libs:
                        print(json.dumps({"kernel": name, "pair": label, "tree": tree,
                                          "merges_per_row": None, "staged_per_row": None,
                                          "scheme": "k rounds over the window, no network"}))
                        continue
                    counter = libs[tag].merge_count
                    counter.argtypes, counter.restype = [_I, _I], ctypes.c_longlong
                    counter(0, 1), counter(1, 1)
                    held(name, tag, a, want)
                    merges, staged = counter(0, 1), counter(1, 1)
                    # staged: keys that passed the filter (counted in trees
                    # with a staging buffer only).
                    print(json.dumps({"kernel": name, "pair": label, "tree": tree,
                                      "merges_per_row": merges / a[0].shape[0],
                                      "staged_per_row": staged / a[0].shape[0],
                                      "merges": merges, "staged": staged}))
            if args.variants:
                for knobs in VARIANTS[name]:
                    tag = _variant_tag(name, knobs)
                    held(name, tag, a, want)
                    run = makers[name](tag)
                    print(json.dumps({"kernel": name, "pair": label, "variant": knobs,
                                      "ms": cuda_ms(lambda: run(*a)),
                                      "tree_ms": cuda_ms(lambda: makers[name](
                                          f"tree_{name}")(*a))}))


if __name__ == "__main__":
    main()
