"""A traced run reports the cell's per-layer metrics and its breakdown
(on the CPU: the profiler sees the spans, no device operation)."""
import pytest

from .conftest import run_cpu


@pytest.mark.parametrize("cell,spans", [("kitti131k.pair", {"prepare_target", "ctor", "align"}),
                                        ("kitti131k.seq", {"run_odometry"})])
def test_traced_run_reports_per_layer_metrics(tiny_cell, cell, spans):
    run, result = run_cpu(tiny_cell(cell), trace=True)
    assert result["correct"], result["checks"]
    wanted = {m["name"] for m in run.cell.per_layer}
    # select_roofline has no kernel time to divide by on the CPU: left out.
    assert set(result["metrics"]) == wanted - {"select_roofline.pair"}
    assert result["device"]["window_s"] > 0 and result["device"]["busy_s"] == 0
    assert {name for name, _ in result["breakdown"]["idle_gaps"]} <= spans | {"harness"}
    assert result["metrics"][f"device_idle_pct.{cell.split('.')[1]}"]["value"] == 100.0
