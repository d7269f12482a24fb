"""CPU tests of the port's benchmark harness (``python -m pytest
portbench/tests``). A test that needs a CUDA card carries the ``cuda``
marker and skips, from inside the test, where there is none."""
import copy
import time

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def tiny_cell():
    """A cell of BENCHMARK.json cut to a size the CPU runs in seconds."""
    from portbench.harness import manifest

    def make(name="kitti131k.pair", **traffic):
        cell = manifest.Cell(manifest.load_json(manifest.HERE.parent / "BENCHMARK.json"), name)
        cell.config = copy.deepcopy(cell.config)
        cell.config["cloud"]["n_points"] = 4096
        cell.config["params"]["pad_multiple"] = 256
        cell.config["fixed_outer_iterations"] = 3
        short = {"pair": {"min_distinct_pairs": 2, "distinct_pairs_per_second": 0,
                          "warmup_pairs": 1},
                 "seq": {"scans": 3, "warmup_scans": 2, "max_calls": 1}}[cell.traffic["driver"]]
        stop = {"stopping": {**cell.traffic["stopping"], "n_iter": 3}} \
            if "stopping" in cell.traffic else {}
        cell.traffic = {**cell.traffic, **short, **stop, "checked_pairs": 2, **traffic}
        return cell

    return make


def run_cpu(cell, seconds=1.0, seed=2**33 + 1, trace=False):
    """One run of ``cell`` on the CPU; a sequence runs its one call whole."""
    from portbench.harness import runner

    if "max_calls" in cell.traffic:
        seconds = 1e6

    return runner.execute(cell, seed=seed, seconds=seconds, trace=trace, device="cpu",
                          started=time.perf_counter())
