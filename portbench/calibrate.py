"""Readings that the limits of ``correct`` are set from (``limits/``).

    python3 portbench/calibrate.py --workload kitti131k.pair --seeds 13 --control 3

On a CUDA card, in one process. For each seed, one short run of the cell
through the harness (its set-up, one timed unit, the comparison with the
plain reference, as ``run.py`` makes them; a sequence: one whole call
over its scans, 8 of its pairs checked): the program's readings. For the first ``--control`` seeds, the
control (the reference in TF32, put in the program's place) against the
reference on the seed's first pair: the control's readings. Prints one
JSON line a reading, then each number's largest program reading (the
lower) and smallest control reading (the upper).
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Per driver: the traffic cut to one short unit a seed.
SHORT = {
    "pair": {"min_distinct_pairs": 1, "distinct_pairs_per_second": 0, "warmup_pairs": 1,
             "checked_pairs": 1},
    "seq": {"checked_pairs": 8, "max_calls": 1},
}


def control_numbers(config: dict, traffic: dict, seed: int, device: str) -> dict:
    """The compared numbers of the control (the reference in TF32) against
    the reference, on the first pair of a run with ``seed``: a pair of the
    pair traffic, else the sequence's first pair as its ``.bin`` files
    hold it."""
    import numpy as np

    from portbench.drivers.pair import input_seed, make_pair, stopping
    from portbench.drivers.seq import make_scans
    from portbench.harness.check import compare
    from portbench.reference.registration import register

    if traffic["driver"] == "pair":
        src, tgt = make_pair(config, input_seed(seed, 0))
        cfg = {**config["params"], **stopping(config)}
    else:
        scans, _ = make_scans(config, traffic, seed)
        src, tgt = (s.astype(np.float32).astype(np.float64) for s in scans[1::-1])
        cfg = {**config["params"], **traffic["stopping"]}
    ref = register(src, tgt, cfg, device=device)
    ctl = register(src, tgt, cfg, precision="tf32", device=device)
    # A sequence's reports carry no correspondence counts: the control
    # reads the numbers the program's do.
    counts = traffic["driver"] == "pair"
    return compare(ctl.transform, [(i.initial_cost, i.final_cost,
                                    i.num_correspondences if counts else None)
                                   for i in ctl.iterations], ref)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=13)
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
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = manifest.Cell(manifest.load_json(ROOT / "BENCHMARK.json"), args.workload)
    short = copy.copy(cell)
    short.traffic = {**cell.traffic, **SHORT[cell.traffic["driver"]]}
    lower, upper = {}, {}
    for n in range(args.seeds):
        seed = args.first_seed + n
        # A sequence runs its one call to the end; the others one unit.
        seconds = 1e6 if "max_calls" in short.traffic else 0.001
        _, result = runner.execute(short, seed=seed, seconds=seconds, trace=False, device="cuda",
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
