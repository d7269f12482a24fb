"""Reference fixture for the PyTorch port's main path.

Runs the JAX package's registration on the 35k ``bunny_like`` bench pair
(``bench.py``'s pair and parameters) on the CPU and records the final 4x4
and every outer iteration's (initial cost, final cost, correspondences).
``chip_smoke.py`` holds the port's run on the GPU against this file.

The reference runs its XLA grid engine here, whose neighbor sets equal the
fused engine's (tests/test_fused_grid.py), because the fused engine's
interpret mode is too slow on a CPU at 35k points. ``outer_chunk=1`` keeps
the reference on its one-iteration host loop, which is the loop the port
runs.

Regenerate with::

    JAX_PLATFORMS=cpu python tests/torch_port_fixture.py
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port_bunny35k_ref.json"

N_POINTS = 35_000
SEED = 0
# bench.py:build_pair's misalignment: a rotation about z plus a shift.
THETA = 0.02
SHIFT = (0.02, -0.015, 0.01)
# bench.py:run_once's parameters (outer_chunk aside, see the docstring).
PARAMS = dict(
    max_neighbours=20,
    dof=5.0,
    radius=0.075,
    n_iter=15,
    cost_drop_thresh=-1.0,
    dtype="float32",
    pad_multiple=1024,
    max_inner_iterations=50,
)


def bench_pair(bunny_like):
    """(source, target) of the bench: the target moved by the known offset."""
    tgt = bunny_like(N_POINTS, seed=SEED)
    c, s = np.cos(THETA), np.sin(THETA)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    src = tgt @ rot.T + np.array(SHIFT)
    return src, tgt


def reference_run(n_iter: int = PARAMS["n_iter"]):
    """The JAX package's registration of the bench pair: (4x4, records)."""
    from probabilistic_point_clouds_registration_tpu.core.params import (
        RegistrationParams,
    )
    from probabilistic_point_clouds_registration_tpu.io.synthetic import bunny_like
    from probabilistic_point_clouds_registration_tpu.models.registration import (
        register_pair,
    )

    src, tgt = bench_pair(bunny_like)
    params = RegistrationParams(
        **{**PARAMS, "n_iter": n_iter}, search_impl="grid", outer_chunk=1
    )
    final, reg = register_pair(src, tgt, params)
    return final, reg.records


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(FIXTURE.parents[2]))
    final, records = reference_run()
    out = {
        "pair": {"n_points": N_POINTS, "seed": SEED, "theta": THETA,
                 "shift": list(SHIFT)},
        "params": {**PARAMS, "search_impl": "grid", "outer_chunk": 1},
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
    FIXTURE.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    main()
