"""Reference fixtures for the PyTorch port's main path.

Runs the JAX package's registration of a bench pair on the CPU and records
the final 4x4 and every outer iteration's (initial cost, final cost,
correspondences). ``chip_smoke.py`` holds the port's run on the GPU against
these files. Two pairs:

* ``bunny35k``: ``bench.py``'s 35k ``bunny_like`` pair and parameters
  (tests/data/torch_port_bunny35k_ref.json);
* ``kitti131k``: ``benchmarks/bench_kitti.py``'s 131,072-point
  ``kitti_like`` pair and parameters, 10 fixed outer iterations
  (tests/data/torch_port_kitti131k_ref.json). Its file also records the
  plan-level facts of the target grid (capacity, hot-cell overflow count,
  the pool's class widths at the narrow-class cutoff 0);
* ``bunny35k_voxel``: the ``bunny35k`` pair with both clouds voxel-filtered
  at a 0.02 leaf before registration (``source_filter_size``,
  ``target_filter_size``; 35,000 -> about 30,000 points each)
  (tests/data/torch_port_bunny35k_voxel_ref.json).

The reference runs its XLA grid engine here, whose neighbor sets equal the
fused and pooled engines' (tests/test_fused_grid.py, tests/test_fused_pool.py;
the grid engine merges the hot-cell overflow set), because the Pallas
engines' interpret mode is too slow on a CPU at these sizes. ``outer_chunk=1``
keeps the reference on its one-iteration host loop, which the port's chunks
reproduce.

Regenerate with::

    JAX_PLATFORMS=cpu python tests/torch_port_fixture.py bunny35k
    JAX_PLATFORMS=cpu python tests/torch_port_fixture.py kitti131k
    JAX_PLATFORMS=cpu python tests/torch_port_fixture.py bunny35k_voxel
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"

PAIRS = {
    "bunny35k": {
        # bench.py:build_pair: the target rotated about z and shifted.
        "pair": {"cloud": "bunny_like", "n_points": 35_000, "seed": 0,
                 "theta": 0.02, "shift": [0.02, -0.015, 0.01]},
        # bench.py:run_once's parameters (outer_chunk aside).
        "params": dict(
            max_neighbours=20, dof=5.0, radius=0.075, n_iter=15,
            cost_drop_thresh=-1.0, dtype="float32", pad_multiple=1024,
            max_inner_iterations=50,
        ),
    },
    "kitti131k": {
        # benchmarks/bench_kitti.py:54-63: ~1 m of ego-motion at 10 Hz.
        "pair": {"cloud": "kitti_like", "n_points": 131_072, "seed": 0,
                 "theta": 0.01, "shift": [0.8, 0.1, 0.02]},
        # benchmarks/bench_kitti.py:65-70 (outer_chunk aside).
        "params": dict(
            max_neighbours=20, dof=5.0, radius=0.5, n_iter=10,
            cost_drop_thresh=-1.0, dtype="float32", pad_multiple=4096,
            max_inner_iterations=50, grid_max_overflow=4096,
        ),
    },
}
PAIRS["bunny35k_voxel"] = {
    "pair": PAIRS["bunny35k"]["pair"],
    "params": dict(PAIRS["bunny35k"]["params"], source_filter_size=0.02,
                   target_filter_size=0.02),
}


def fixture_path(name: str) -> Path:
    return DATA / f"torch_port_{name}_ref.json"


FIXTURE = fixture_path("bunny35k")


def make_pair(pair: dict, generators) -> tuple[np.ndarray, np.ndarray]:
    """(source, target) of a pair spec: the target rotated by ``theta``
    about z and shifted. ``generators`` maps a cloud name to its function
    (the JAX package's or the port's ``io.synthetic``)."""
    tgt = getattr(generators, pair["cloud"])(pair["n_points"], seed=pair["seed"])
    c, s = np.cos(pair["theta"]), np.sin(pair["theta"])
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return tgt @ rot.T + np.array(pair["shift"]), tgt


def reference_run(name: str = "bunny35k", n_iter: int | None = None):
    """The JAX package's registration of pair ``name``: (4x4, records)."""
    from probabilistic_point_clouds_registration_tpu.core.params import (
        RegistrationParams,
    )
    from probabilistic_point_clouds_registration_tpu.io import synthetic
    from probabilistic_point_clouds_registration_tpu.models.registration import (
        register_pair,
    )

    spec = PAIRS[name]
    src, tgt = make_pair(spec["pair"], synthetic)
    kw = dict(spec["params"])
    if n_iter is not None:
        kw["n_iter"] = n_iter
    params = RegistrationParams(**kw, search_impl="grid", outer_chunk=1)
    final, reg = register_pair(src, tgt, params)
    return final, reg.records


def plan_facts(name: str) -> dict:
    """The JAX package's host facts for pair ``name``'s target: grid
    capacity, hot-cell overflow count and the pool's class widths when every
    class runs a kernel (cutoff 0)."""
    from probabilistic_point_clouds_registration_tpu.core.types import pad_cloud
    from probabilistic_point_clouds_registration_tpu.io import synthetic
    from probabilistic_point_clouds_registration_tpu.ops.fused_pool import (
        plan_pool_host,
    )
    from probabilistic_point_clouds_registration_tpu.ops.grid import build_grid_host

    spec = PAIRS[name]
    p = spec["params"]
    _, tgt = make_pair(spec["pair"], synthetic)
    tg, n_tgt = pad_cloud(tgt, p["pad_multiple"], pad_value=0.0)
    grid = build_grid_host(tg, p["radius"], num_valid=n_tgt,
                           max_overflow=p.get("grid_max_overflow", 4096))
    plan = plan_pool_host(grid, tg, select_max_w=0)
    return {
        "capacity": int(grid["capacity"]),
        "overflow_points": int((grid.get("overflow_idx", np.zeros(0)) >= 0).sum()),
        "class_widths_cutoff0": [int(w) for w in plan["widths"]],
    }


def main(name: str) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(DATA.parents[1]))
    spec = PAIRS[name]
    final, records = reference_run(name)
    out = {
        "pair": spec["pair"],
        "params": {**spec["params"], "search_impl": "grid", "outer_chunk": 1},
        "final_transform": np.asarray(final).tolist(),
        "iterations": [
            {
                "initial_cost": r.initial_cost,
                "final_cost": r.final_cost,
                "correspondences": r.num_correspondences,
            }
            for r in records
        ],
    }
    if name == "kitti131k":
        out["plan"] = plan_facts(name)
    path = fixture_path(name)
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "bunny35k")
