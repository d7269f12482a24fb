"""Readings that the batch cell's limits are set from
(``limits/kitti131k_mesh4.batch.json``).

    python3 portbench/calibrate_batch.py --workload kitti131k_mesh4.batch --seeds 3 --control 3

On one CUDA card, in one process. The program: for each seed, one call of
the cell's batch through the harness on a one-rank mesh (a pair's answer
does not depend on its batch, its block or its rank: ``parallel/batch.py``
runs the pair axis written out, and a sharded batch equals the unsharded
one bit for bit), ``pairs_per_rank`` pairs, every one compared with the
plain reference. The control (the reference in TF32, put in the program's
place) against the reference on the seed's first pair. Prints one JSON
line a reading, then each number's largest program reading (the lower)
and smallest control reading (the upper).
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(config: dict, traffic: dict, seed: int, device: str) -> dict:
    """The compared numbers of the control against the reference on the
    first pair of stretch 0 of a run with ``seed``."""
    import numpy as np

    from portbench.drivers.batch import reference_cfg, stretch
    from portbench.harness.check import compare
    from portbench.reference.registration import register

    scans, _ = stretch(config, traffic, seed, 0)
    src, tgt = (s.astype(np.float64) for s in scans[1::-1])
    cfg = reference_cfg(config, traffic)
    ref = register(src, tgt, cfg, device=device)
    ctl = register(src, tgt, cfg, precision="tf32", device=device)
    return compare(ctl.transform, [(i.initial_cost, i.final_cost, i.num_correspondences)
                                   for i in ctl.iterations], ref)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**33 + 101)
    args = ap.parse_args()
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from portbench.harness import manifest, runner

    if not torch.cuda.is_available():
        print("calibrate_batch: no CUDA device", file=sys.stderr)
        return 3
    cell = manifest.Cell(manifest.load_json(ROOT / "BENCHMARK.json"), args.workload)
    short = copy.copy(cell)
    short.config = {**cell.config, "ranks": 1}
    short.traffic = {**cell.traffic, "max_calls": 1, "min_distinct_calls": 2,
                     "checked_pairs": int(cell.config["pairs_per_rank"])}
    lower, upper = {}, {}
    for n in range(args.seeds):
        seed = args.first_seed + n
        _, result = runner.execute(short, seed=seed, seconds=1e6, trace=False, device="cuda",
                                   started=time.perf_counter())
        got = {k: v["value"] for k, v in result["checks"].items()}
        print(json.dumps({"seed": seed, "side": "program", "correct": result["correct"], **got}),
              flush=True)
        for k, v in got.items():
            lower[k] = max(lower.get(k, 0.0), v)
        if n >= args.control:
            continue
        got = control_numbers(cell.config, cell.traffic, seed, "cuda")
        print(json.dumps({"seed": seed, "side": "control", **got}), flush=True)
        for k, v in got.items():
            upper[k] = min(upper.get(k, np.inf), v)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "seconds": time.perf_counter() - STARTED}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
