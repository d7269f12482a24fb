"""BENCHMARK.json keeps to the limits of its format, and every name in it
has its file."""
import json
import re
from pathlib import Path

import pytest

from portbench.harness.manifest import reader_path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}


def reports(metric, cell):
    return cell in metric.get("workloads", CELLS)


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert 1 <= len(MANIFEST["configs"]) <= 24 and 1 <= len(CELLS) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16 and 1 <= len(MANIFEST["per_layer"]) <= 128
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # 14 runs of each of 24 cells, with set-up and compile room, fit in 12 hours.
    assert 2 + 14 * 24 * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = [m["name"] for m in METRICS] + list(CELLS) + [c["name"] for c in MANIFEST["configs"]]
    assert len(names) == len(set(names))
    for name in names + [w["config"] for w in CELLS.values()] + \
            [w["traffic"] for w in CELLS.values()]:
        assert NAME.match(name), name
    for m in METRICS:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if m in MANIFEST["end_to_end"] else {"layer", "moves"}
        assert set(m) <= allowed and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(1 <= len(c[k]) <= 200 and "\n" not in c[k] and "\t" not in c[k]
                   for k in ("source", "why"))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in CELLS.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_every_moves_names_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and reports(e2e[m["moves"]], cell), (m["name"], cell)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_reports_enough_and_has_its_files(cell):
    w = CELLS[cell]
    e2e = [m["name"] for m in MANIFEST["end_to_end"] if reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m, cell) for m in MANIFEST["per_layer"])
    config = {c["name"]: c for c in MANIFEST["configs"]}[w["config"]]
    assert (ROOT / config["file"]).is_file() and config["file"].startswith("portbench/")
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    assert (BENCH / "limits" / f"{cell}.json").is_file()
    for m in METRICS:
        if reports(m, cell):
            assert reader_path(BENCH, m["name"]).is_file(), m["name"]
