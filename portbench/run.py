"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload kitti131k.pair --seed 7 --seconds 45 --trace 0

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names its configuration and traffic mix; the run makes its inputs from
``--seed``, warms up, measures for ``--seconds``, compares the answers with
the plain reference and prints one JSON line: the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics. It measures the PyTorch
port on CUDA devices and refuses to run without enough of them.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["PCR_TORCH_BUILD_DIR"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import manifest, runner

    cell = manifest.Cell(manifest.load_json(ROOT / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    _, result = runner.execute(cell, seed=args.seed, seconds=args.seconds,
                               trace=bool(args.trace), device="cuda", started=STARTED)
    found = runner.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    runner.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
