"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own, found by the name ``BENCHMARK.json`` gives it:

  configs/<config>.json      the configuration (the cell's ``config``)
  traffic/<traffic>.json     the traffic mix; its ``driver`` names drivers/<driver>.py
  limits/<cell>.json         the limits of the numbers ``correct`` compares
  metrics/<metric>.py        the reader of one metric (``read(run)``); a
                             metric without a file of its own is read by
                             the file of its name's first part
                             (``device_idle_pct.seq`` by ``device_idle_pct.py``)
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # portbench/


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix,
    limits and the metrics it reports."""

    def __init__(self, manifest: dict, name: str, root: Path = HERE):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {', '.join(cells)})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = load_json(root.parent / configs[self.entry["config"]]["file"])
        self.traffic = load_json(root / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(root / "limits" / f"{name}.json")
        self.chips = int(self.entry["chips"])
        self.root = root

        def reports(metric):
            return name in metric.get("workloads", [w["name"] for w in manifest["workloads"]])

        self.end_to_end = [m for m in manifest["end_to_end"] if reports(m)]
        self.per_layer = [m for m in manifest["per_layer"] if reports(m)]

    def driver(self):
        driver = self.traffic["driver"]
        return load_module(self.root / "drivers" / f"{driver}.py", f"portbench_driver_{driver}")

    def reader(self, metric: str):
        return load_module(reader_path(self.root, metric),
                           "portbench_metric_" + metric.replace(".", "_"))


def reader_path(root: Path, metric: str) -> Path:
    """``metrics/<metric>.py``, or else the reader of the name's first part."""
    own = root / "metrics" / f"{metric}.py"
    return own if own.is_file() else root / "metrics" / f"{metric.split('.')[0]}.py"
