"""Registration parameters.

A copy of the JAX package's ``core/params.py`` (it imports no JAX), so the
two packages take the same configuration field for field. The fields mirror
the reference config struct
(include/prob_point_cloud_registration/prob_point_cloud_registration_params.hpp:5-18),
plus accelerator knobs (dtype, padding, search engine) that have no
reference counterpart. :func:`from_reference_params` carries a JAX-package
``RegistrationParams`` across.

Every knob is honoured by this package; ``ProbabilisticRegistration``
raises ``NotImplementedError`` only for a ``search_impl`` it does not have.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass
class RegistrationParams:
    """Configuration for probabilistic point-cloud registration.

    Defaults mirror prob_point_cloud_registration_params.hpp:6-17. Note the
    CLI overrides ``radius`` to 3 (prob_point_cloud_registration_ex.cc:49);
    the struct default here stays 1 for parity.
    """

    # --- reference-parity fields -------------------------------------------
    max_neighbours: int = 20
    dof: float = 5.0  # degrees of freedom of the t-distribution; inf = Gaussian
    radius: float = 1.0
    n_iter: int = 1000  # max outer iterations
    cost_drop_thresh: float = 0.01
    n_cost_drop_it: int = 5  # consecutive low-cost-drop iterations tolerated
    verbose: bool = False
    summary: bool = False
    initial_rotation: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    initial_translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    source_filter_size: float = 0.0
    target_filter_size: float = 0.0

    # --- inner-solver knobs (Ceres options in the reference) ----------------
    # function_tolerance = 10e-6 (src/prob_point_cloud_registration.cc:97).
    function_tolerance: float = 1e-5
    # The reference sets max_num_iterations = INT_MAX (...cc:96); a jittable
    # while_loop still needs a sane bound for wall-clock safety.
    max_inner_iterations: int = 100
    # Ceres trust-region defaults reproduced by the LM loop.
    initial_trust_region_radius: float = 1e4
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    min_relative_decrease: float = 1e-3
    use_nonmonotonic_steps: bool = True  # ...cc:90

    # --- accelerator knobs ----------------------------------------------------
    dtype: str = "float32"
    # Pad source/target point counts to multiples of this for static shapes.
    pad_multiple: int = 256
    # Neighbor-search engine: "auto" (hash grid when occupancy allows, else
    # brute force; with a grid, on a CUDA device the capacity-free pooled
    # engine when the pool plan accepts the scan, then the fused grouped
    # engine when its prepack fits, else the grid engine; on the CPU the
    # pooled step is skipped) | "pool" (force the pooled engine) | "brute"
    # (always the streaming tiled engine) | "grid" (force the hash-grid
    # engine) | "fused" (force the grouped engine) | "pallas" (brute force
    # through the hand-written KNN kernel; no grid is built).
    search_impl: str = "auto"
    # Outer iterations per chunk: the cumulative transform and the stopping
    # rule are carried on the device across a chunk, whose outputs reach
    # the host in one transfer (the JAX package's device scans).
    outer_chunk: int = 4
    # Hot-cell overflow budget for the grid engines: bucket capacity is the
    # smallest power of two that strands at most this many points in hotter
    # cells; stranded points merge back via a streaming brute pass. Caps the
    # candidate-window width against occupancy outliers (a single ~300-point
    # near-sensor LiDAR cell would otherwise force capacity 512 for every
    # source). 0 = pad to the hottest cell (no overflow pass).
    grid_max_overflow: int = 4096
    # Candidate k-selection inside the grid engine: "auto" (the row top-k
    # kernel on a CUDA device, a stable sort on the CPU) | "topk" | "hier" |
    # "pallas" | "approx" (see ops.grid.grid_radius_search; every mode is
    # exact here and returns the same neighbors).
    search_select: str = "auto"
    # Tile size over the target axis in the streaming top-k search.
    search_target_tile: int = 2048
    # When set, align() runs under torch.profiler and writes its trace into
    # this directory (the reference's closest analogue is Ceres's per-solve
    # FullReport timing, src/prob_point_cloud_registration.cc:108).
    profile_dir: Optional[str] = None
    # Per-LM-iteration diagnostics printed when verbose (the parity analogue
    # of the reference's per-outer-iteration ``summary.FullReport()``,
    # src/prob_point_cloud_registration.cc:108).
    trace_inner: bool = False

    @property
    def is_gaussian(self) -> bool:
        return math.isinf(self.dof)

    def validate(self) -> None:
        if self.max_neighbours <= 0:
            raise ValueError("max_neighbours must be positive")
        if not (self.dof > 0):
            raise ValueError("dof must be positive (inf selects the Gaussian model)")
        if self.radius <= 0:
            raise ValueError("radius must be positive")


def from_reference_params(p) -> RegistrationParams:
    """This package's :class:`RegistrationParams` from the JAX package's,
    field for field (the two dataclasses declare the same fields)."""
    return RegistrationParams(
        **{f.name: getattr(p, f.name) for f in dataclasses.fields(RegistrationParams)}
    )
