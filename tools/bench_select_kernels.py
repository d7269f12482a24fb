"""Time the row top-k kernel (B2, csrc/row_topk.cu) and the brute KNN kernel
(B3, csrc/brute_knn.cu) of this tree beside another tree's, on one CUDA
device, in one process.

    python3 tools/bench_select_kernels.py --parent-root build/parent
    python3 tools/bench_select_kernels.py --parent-root build/parent --count-merges
    python3 tools/bench_select_kernels.py --variants --no-candidates

The inputs are the ones the registration gives the kernels: for B2 the
candidate-distance matrix of the first source block of the grid search
(16,384 rows) of both fixture pairs at their initial pose, for B3 the
centred clouds of both pairs (35,840 x 35,840 and 131,072 x 131,072),
k = 20. Every build's output is held bit-equal to this tree's kernel (which
``chip_smoke.py`` holds against the plain twins). Times are CUDA events, the
median of ``--reps`` launches, each enqueued behind a 0.1 ms spin so that
the events bracket device time only, in the order parent, this tree, this
tree, parent. ``--parent-root`` is a checkout of the other tree (for example
``git archive <commit> | tar -x -C build/parent``); its kernels may predate
the packed-target scratch of B3.

``--count-merges`` builds copies of both trees' sources with a counter added
where a sorting network runs and prints the merges per row. ``--variants``
builds copies of this tree's sources with one tuning constant changed each
and times them. ``--no-candidates`` times a copy of this tree's B3 whose
thresholds admit no target: the distance loop alone, without votes that
find a candidate, appends or merges. Copies and builds go to ``build/bench_select/``. One JSON
line per measurement; the first line is the card's name and power limit.
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
PACK_TILE = 512

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
VARIANTS = {
    "row_topk": [{"kLoads": 1}, {"kLoads": 2}, {"kLoads": 8}, {"kRowsPerBlock": 4},
                 {"kRowsPerBlock": 16}],
    "brute_knn": [{"kRows": 8, "kWarpsPerSM": 16}, {"kWarps": 4}, {"kWarps": 16},
                  {"kTile": 256, "kStages": 4}, {"kStages": 2},
                  {"kTile": 1024, "kStages": 2}],
}


def _no_candidates_copy(csrc: Path, dst: Path) -> Path:
    """A copy of ``csrc/brute_knn.cu`` whose rows all carry the threshold of
    a row past n (-inf): every target is evaluated, none is taken."""
    dst.mkdir(parents=True, exist_ok=True)
    cu = _sub((csrc / "brute_knn.cu").read_text(),
              "thr[r] = in_range ? CUDART_INF_F : -CUDART_INF_F;", "thr[r] = -CUDART_INF_F;")
    for header in csrc.glob("*.cuh"):
        (dst / header.name).write_text(header.read_text())
    (dst / "brute_knn.cu").write_text(cu)
    return dst / "brute_knn.cu"


def _variant_tag(name: str, knobs: dict) -> str:
    return f"variant_{name}_" + "_".join(f"{c}_{v}" for c, v in knobs.items())


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"bench_select_kernels: pattern not found: {old!r}")
    return text.replace(old, new)


def _counting_copy(csrc: Path, name: str, dst: Path) -> Path:
    """A copy of ``csrc/<name>.cu`` (and its headers) that counts one per
    sorting-network merge in ``g_merges``."""
    dst.mkdir(parents=True, exist_ok=True)
    cu = (csrc / f"{name}.cu").read_text()
    header = csrc / "topk_merge.cuh"
    if header.exists():  # a merge is topk::merge_staged
        h = _sub(header.read_text(), "namespace topk {\n", COUNTER + "namespace topk {\n")
        h = _sub(h, "  __syncwarp();\n  const unsigned long long key = lane < count",
                 "  " + COUNT_ONE + "  __syncwarp();\n  const unsigned long long key = lane < count")
        h = _sub(h, "  return count + __popc(ballot);\n",
                 "  if (lane == 0) atomicAdd(&g_staged, (unsigned long long)__popc(ballot));\n"
                 "  return count + __popc(ballot);\n")
        (dst / header.name).write_text(h)
    else:  # the merge follows the warp vote, in the kernel
        cu = _sub(cu, "namespace {\n", COUNTER + "namespace {\n")
        if name == "brute_knn":
            cu = _sub(cu, "          run[r] = merge_chunk(",
                      "          " + COUNT_ONE + "          run[r] = merge_chunk(")
        else:
            cu = _sub(cu, "      if (!__any_sync(kFull, key < kth)) continue;\n",
                      "      if (!__any_sync(kFull, key < kth)) continue;\n      " + COUNT_ONE)
    (dst / f"{name}.cu").write_text(cu + READER)
    return dst / f"{name}.cu"


def _variant_copy(csrc: Path, name: str, knobs: dict, dst: Path) -> Path:
    dst.mkdir(parents=True, exist_ok=True)
    cu = (csrc / f"{name}.cu").read_text()
    for constant, value in knobs.items():
        cu, n = re.subn(rf"(constexpr int {constant} = )[^;]+;", rf"\g<1>{value};", cu)
        if n != 1:
            raise SystemExit(f"bench_select_kernels: {name}.cu has no constant {constant}")
    for header in csrc.glob("*.cuh"):
        (dst / header.name).write_text(header.read_text())
    (dst / f"{name}.cu").write_text(cu)
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
        used = [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln]
        return tag, ctypes.CDLL(str(so)), used

    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(one, jobs.items()))
    for tag, _, used in built:
        print(json.dumps({"build": tag, "ptxas": used}))
    return {tag: lib for tag, lib, _ in built}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-root", type=Path, help="checkout of the tree to compare with")
    ap.add_argument("--count-merges", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--no-candidates", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_select_kernels: no CUDA device")
    sys.path.insert(0, str(REPO))
    import probabilistic_point_clouds_registration_tpu_torch as port
    from probabilistic_point_clouds_registration_tpu_torch import kernels
    from probabilistic_point_clouds_registration_tpu_torch.io import synthetic
    from probabilistic_point_clouds_registration_tpu_torch.ops import grid as tgrid
    from probabilistic_point_clouds_registration_tpu_torch.ops.neighbors import bbox_center

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0])
    stream = torch.cuda.current_stream().cuda_stream

    # -- the builds ---------------------------------------------------------
    csrc = REPO / PORT / "csrc"
    jobs = {f"tree_{name}": csrc / f"{name}.cu" for name in ("row_topk", "brute_knn")}
    trees = {"tree": csrc}
    if args.parent_root:
        trees["parent"] = args.parent_root.resolve() / PORT / "csrc"
        jobs.update({f"parent_{name}": trees["parent"] / f"{name}.cu"
                     for name in ("row_topk", "brute_knn")})
    if args.count_merges:
        for tree, root in trees.items():
            for name in ("row_topk", "brute_knn"):
                jobs[f"count_{tree}_{name}"] = _counting_copy(
                    root, name, OUT / f"count_{tree}_{name}")
    if args.variants:
        for name, variants in VARIANTS.items():
            for knobs in variants:
                tag = _variant_tag(name, knobs)
                jobs[tag] = _variant_copy(csrc, name, knobs, OUT / tag)
    if args.no_candidates:
        jobs["no_candidates_brute_knn"] = _no_candidates_copy(csrc, OUT / "no_candidates")
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

    # -- the inputs -----------------------------------------------------------
    inputs = {"row_topk": {}, "brute_knn": {}}
    for pair_name in ("bunny35k", "kitti131k"):
        fixture = json.loads(
            (REPO / "tests" / "data" / f"torch_port_{pair_name}_ref.json").read_text())
        pair = fixture["pair"]
        tgt = getattr(synthetic, pair["cloud"])(pair["n_points"], seed=pair["seed"])
        c, s = np.cos(pair["theta"]), np.sin(pair["theta"])
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        src = tgt @ rot.T + np.array(pair["shift"])
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
        inputs["row_topk"][pair_name] = (d2.contiguous(), k)
        center = bbox_center(reg._tgt, reg._tgt_valid)
        inputs["brute_knn"][pair_name] = (
            torch.where(reg._src_valid[:, None], reg._src - center, 0.0).float().contiguous(),
            (reg._tgt - center).float().contiguous(), reg._tgt_valid.contiguous(), k)
        del reg
    makers = {"row_topk": row_topk, "brute_knn": brute_knn}

    def shape_of(name, a):
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
    for name in ("row_topk", "brute_knn"):
        for pair_name, a in inputs[name].items():
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
            print(json.dumps({"kernel": name, "pair": pair_name, "shape": shape_of(name, a),
                              "k": a[-1], "ms": ms, "reps": args.reps}))
            if args.no_candidates and name == "brute_knn":
                run = makers[name]("no_candidates_brute_knn")
                print(json.dumps({"kernel": name, "pair": pair_name, "no_candidates": True,
                                  "ms": cuda_ms(lambda: run(*a))}))
            if args.count_merges:
                for tree in trees:
                    tag = f"count_{tree}_{name}"
                    counter = libs[tag].merge_count
                    counter.argtypes, counter.restype = [_I, _I], ctypes.c_longlong
                    counter(0, 1), counter(1, 1)
                    held(name, tag, a, want)
                    merges, staged = counter(0, 1), counter(1, 1)
                    # staged: keys that passed the filter (counted in trees
                    # with a staging buffer only).
                    print(json.dumps({"kernel": name, "pair": pair_name, "tree": tree,
                                      "merges_per_row": merges / a[0].shape[0],
                                      "staged_per_row": staged / a[0].shape[0]}))
            if args.variants:
                for knobs in VARIANTS[name]:
                    tag = _variant_tag(name, knobs)
                    held(name, tag, a, want)
                    run = makers[name](tag)
                    print(json.dumps({"kernel": name, "pair": pair_name, "variant": knobs,
                                      "ms": cuda_ms(lambda: run(*a)),
                                      "tree_ms": cuda_ms(lambda: makers[name](
                                          f"tree_{name}")(*a))}))


if __name__ == "__main__":
    main()
