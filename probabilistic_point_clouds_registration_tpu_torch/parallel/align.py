"""Multi-device ``align()``: the registration loop on a mesh (port of the
JAX package's ``parallel/align.py``).

``DistributedRegistration`` is the multi-device counterpart of
``models.registration.ProbabilisticRegistration`` (the reference's unit,
src/prob_point_cloud_registration.cc:63-136): the same constructor plus a
:class:`~.mesh.Mesh`, the same ``align()`` / ``report()`` /
``transformation_history`` / ``has_converged()``, records and LM traces.
Every rank of the mesh constructs it with the same arguments and runs
``align()``; per chunk of outer iterations each rank runs the sharded pooled
engine on its target shard (its class passes on the select kernels), the
merge across ``"targets"`` and the EM-LM solve reduced across ``"points"``
(or both axes), with the stopping rule carried on the device. The host
bookkeeping is the base class's, on values that are the same on every rank,
so every rank takes the same branches. Only rank 0 prints.

Budget fallback: a pooled row-budget overflow first raises the per-shard
budget (x2, twice), then moves the rest of the pair to the sharded grid
engine (``grid_sharded.make_sharded_grid_align_scan``), as in the JAX
package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.params import RegistrationParams
from ..core.se3 import np_quat_to_matrix
from ..core.types import round_up
from ..models.em_lm import LM_BLOCK, LMBlocks
from ..models.registration import ProbabilisticRegistration
from ..ops.fused_pool import _select_max_w
from ..ops.voxel import voxel_downsample
from .grid_sharded import build_sharded_grid_host, grid_shard_to_device, \
    make_sharded_grid_align_scan
from .mesh import POINTS_AXIS, TARGETS_AXIS, Mesh, make_mesh
from .pool_sharded import (
    build_sharded_pool_host,
    build_sharded_pools_device,
    choose_pool_shard_layout,
    demand_sized_plan,
    make_sharded_pool_align_scan,
    pack_sharded_pools,
    share_sharded_pools,
)


def _choose_layout(layout: str, mesh: Mesh, target: np.ndarray, n_src: int, radius: float):
    """(layout, the chooser's estimate or None, the mesh the layout runs
    on): "auto" asks :func:`choose_pool_shard_layout` when the mesh has a
    targets axis; "points" collapses every rank onto the points axis."""
    tp = mesh.shape[TARGETS_AXIS]
    est = None
    want = layout
    if want == "auto":
        if tp > 1:
            ijk = np.floor((target - target.min(axis=0)) / radius).astype(np.int64)
            dims = ijk.max(axis=0) + 1
            lin = ijk[:, 0] + dims[0] * (ijk[:, 1] + dims[1] * ijk[:, 2])
            est = choose_pool_shard_layout(
                n_src, target.shape[0], np.unique(lin).size,
                mesh.shape[POINTS_AXIS] * tp, tp, select_max_w=_select_max_w(mesh.device),
            )
            want = est["layout"]
        else:
            want = "targets"
    if want == "points" and tp > 1:
        mesh = mesh.collapsed()
    return ("points" if want == "points" else "targets"), est, mesh


class DistributedRegistration(ProbabilisticRegistration):
    """Registration over a ``("points", "targets")`` mesh, one instance per
    rank.

    Args (beyond the base class's):
      mesh: this rank's :class:`~.mesh.Mesh` (``make_mesh()``: a 1x1 mesh on
        the default device without a process group). The device is the
        mesh's.
      layout: "auto" (the occupancy chooser), "targets" or "points".
      debug_replication: check on every slot that the merged results agree
        across "targets"; a disagreement poisons the solve with NaN.
      prepared_target: :meth:`prepare_target`'s result.

    Results match the single-device ``align()`` to float tolerance.
    """

    @staticmethod
    def prepare_target(
        target_cloud: np.ndarray,
        params: RegistrationParams,
        mesh: Mesh,
        stage: bool = False,
        layout: str = "auto",
        n_src_hint: Optional[int] = None,
    ) -> dict:
        """Target prep for the mesh path (the counterpart of
        ``ProbabilisticRegistration.prepare_target``): voxel filter, layout
        choice and the per-shard harmonized pool plans, all host numpy, so
        a sequence pipeline runs it on its prep thread. ``stage=True`` also
        packs this rank's shard's pools (on the column's "points" row 0, on
        a CUDA stream of its own); it issues no collective, and the ctor
        broadcasts the pools on the thread that runs the pair.

        The layout is decided here (the plan's shard count depends on it);
        ``n_src_hint`` feeds the chooser (default: the target's own size).
        ``sp`` is None when the pooled engine declines the target.
        """
        target = np.asarray(target_cloud, dtype=np.float64)
        if params.target_filter_size > 0:
            target = voxel_downsample(target, params.target_filter_size)
        layout, est, mesh = _choose_layout(
            layout, mesh, target, n_src_hint or target.shape[0], params.radius)
        sp = build_sharded_pool_host(
            target, params.radius, mesh.shape[TARGETS_AXIS], num_valid=target.shape[0],
            k=params.max_neighbours, device=mesh.device,
        )
        prepared = {"target_cloud": target, "sp": sp, "mesh": mesh, "layout": layout,
                    "layout_estimate": est}
        if stage and sp is not None:
            prepared["pool_packed"], prepared["pool_event"] = _stage_pack(
                mesh, sp, np.dtype(params.dtype))
        return prepared

    def __init__(
        self,
        source_cloud: np.ndarray,
        target_cloud: np.ndarray,
        params: RegistrationParams,
        mesh: Optional[Mesh] = None,
        ground_truth_cloud: Optional[np.ndarray] = None,
        layout: str = "auto",
        debug_replication: bool = False,
        prepared_target: Optional[dict] = None,
    ):
        if layout not in ("auto", "targets", "points"):
            raise ValueError(f"layout must be auto|targets|points: {layout}")
        self._debug_replication = bool(debug_replication)
        mesh = mesh if mesh is not None else make_mesh()
        self._init_host_prelude(source_cloud, params, mesh.device, main=mesh.rank == 0)

        if prepared_target is not None:
            # Target prep (filter, layout, plans, maybe the pool packing) ran
            # earlier: take its outputs, the layout baked into the plan too.
            self.target_cloud = prepared_target["target_cloud"]
            self.mesh = prepared_target["mesh"]
            self.layout = prepared_target["layout"]
            self._layout_estimate = prepared_target.get("layout_estimate")
            self._init_ground_truth(ground_truth_cloud)
        else:
            target = np.asarray(target_cloud, dtype=np.float64)
            if params.target_filter_size > 0:
                self.out << (f"Filtering target point cloud with leaf of size "
                             f"{params.target_filter_size}\n")
                target = voxel_downsample(target, params.target_filter_size)
            self.target_cloud = target
            self._init_ground_truth(ground_truth_cloud)
            self.layout, self._layout_estimate, self.mesh = _choose_layout(
                layout, mesh, target, self.filtered_source.shape[0], params.radius)
        if self._layout_estimate is not None:
            e = self._layout_estimate
            self.out << (
                f"Shard layout: {self.layout} (est. lane work targets="
                f"{e['w_targets']:.3g} points={e['w_points']:.3g}, "
                f"occupancy/devrow={e['occ_per_devrow']:.2f})\n"
            )
        mesh = self.mesh
        dp, tp = mesh.shape[POINTS_AXIS], mesh.shape[TARGETS_AXIS]

        # Source rows padded so every "points" shard gets equal rows and
        # each shard's rows divide the targets axis (the reduce-scatter
        # merge deals a shard's rows into tp blocks).
        n_src = self.filtered_source.shape[0]
        rows = round_up(round_up(n_src, params.pad_multiple), 8 * dp * max(1, tp))
        rps = rows // dp
        fs = np.zeros((rows, 3), np.float64)
        fs[:n_src] = self.filtered_source
        self._n_src = n_src
        self._rows_per_shard = rps
        p0 = mesh.index(POINTS_AXIS)
        mine = slice(p0 * rps, (p0 + 1) * rps)
        self._src = torch.as_tensor(fs[mine].astype(np.dtype(params.dtype)), device=self.device)
        self._src_valid = torch.as_tensor(np.arange(rows)[mine] < n_src, device=self.device)

        # The per-points-shard source slices under the initial pose size the
        # row budget from measured demand instead of the 8x floor.
        rot0 = np_quat_to_matrix(np.asarray(params.initial_rotation, np.float64))
        moved0 = self.filtered_source @ rot0.T + np.asarray(params.initial_translation,
                                                            np.float64)
        slices = [moved0[d * rps:min((d + 1) * rps, n_src)]
                  for d in range(dp) if d * rps < n_src]
        if prepared_target is not None:
            self._sp = prepared_target["sp"]
            if self._sp is not None:
                self._sp = demand_sized_plan(self._sp, slices)
        else:
            self._sp = build_sharded_pool_host(
                self.target_cloud, params.radius, tp, num_valid=self.target_cloud.shape[0],
                k=params.max_neighbours, source_slices=slices, device=self.device,
            )
        if self._sp is None:
            raise ValueError(
                "target does not fit the sharded pooled engine (degenerate cloud, "
                "oversized window union, or pool budget); use the single-device "
                "ProbabilisticRegistration for this pair"
            )
        np_dtype = np.dtype(params.dtype)
        if prepared_target is not None and "pool_packed" in prepared_target:
            packed = prepared_target["pool_packed"]
            event = prepared_target.get("pool_event")
            if event is not None and packed is not None:
                # Packed on another stream: this stream waits for it, and the
                # allocator keeps the blocks until this stream is done too.
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for t in packed:
                    t.record_stream(stream)
            self._pools = share_sharded_pools(mesh, self._sp, packed, np_dtype)
        else:
            self._pools = build_sharded_pools_device(mesh, self._sp, np_dtype)

        self._lm_config = self._make_lm_config(params)
        self._init_bookkeeping(params)
        self._lm = self._lm_blocks()
        self.engine = "pool"
        self._scan = None  # built lazily per budget rung
        self._grid = None  # the sharded grid fallback: (scan, shard)

    def _lm_blocks(self) -> LMBlocks:
        """CUDA graphs on a card when the solve's collectives can be
        captured (NCCL, or none at all); eager blocks when they stage
        through host memory (``gloo``). Rank 0 says which, once per mesh."""
        mesh = self.mesh
        if self.device.type != "cuda":
            return LMBlocks.for_device(self.device)
        axes = (POINTS_AXIS, TARGETS_AXIS)
        graphs = mesh.capturable(axes)
        if mesh.rank == 0 and not mesh.announced:
            mesh.announced = True
            how = ("CUDA graphs" + (f", the {mesh.backend} all_reduce captured inside"
                                    if mesh.has_collectives(axes) else "")
                   if graphs else
                   f"eager blocks ({mesh.backend} stages its all_reduce through host "
                   "memory, which a CUDA graph cannot hold)")
            print(f"DistributedRegistration on {mesh}: LM solve as {how}", flush=True)
        return LMBlocks(graphs=graphs, block=LM_BLOCK)

    # -- device dispatch ----------------------------------------------------

    def _conv_statics(self) -> dict:
        p = self.params
        return dict(chunk=max(1, int(p.outer_chunk)), n_iter=int(p.n_iter),
                    cost_drop_thresh=float(p.cost_drop_thresh),
                    n_cost_drop_it=int(p.n_cost_drop_it))

    def _trace_config(self):
        return self._lm_config._replace(trace=True) if self.params.trace_inner \
            else self._lm_config

    def _ensure_grid_fallback(self):
        """The sharded grid engine (built once, on the first overflow past
        the budget ladder): (scan, this rank's grid shard)."""
        if self._grid is not None:
            return self._grid
        p = self.params
        sg = build_sharded_grid_host(self.target_cloud, p.radius,
                                     self.mesh.shape[TARGETS_AXIS],
                                     num_valid=self.target_cloud.shape[0])
        if sg is None:
            raise RuntimeError(
                "pooled budget overflow and the sharded grid fallback declined this target")
        scan = make_sharded_grid_align_scan(
            self.mesh, k=p.max_neighbours, radius=p.radius, lm_config=self._trace_config(),
            debug_replication=self._debug_replication, lm=self._lm, **self._conv_statics(),
        )
        shard = grid_shard_to_device(sg, self.mesh.index(TARGETS_AXIS), p.dtype, self.device)
        self._grid = (scan, shard)
        return self._grid

    def _run_chunk(self, conv0, slots: int, q0, t0, lm_config) -> np.ndarray:
        if self.engine == "grid":
            scan, state = self._ensure_grid_fallback()
        else:
            if self._scan is None:
                p = self.params
                self._scan = make_sharded_pool_align_scan(
                    self.mesh, self._sp, k=p.max_neighbours, radius=p.radius,
                    lm_config=self._trace_config(), source_rows_per_shard=self._rows_per_shard,
                    budget_boost=self._pool_budget_boost,
                    debug_replication=self._debug_replication, lm=self._lm,
                    **self._conv_statics(),
                )
            scan, state = self._scan, self._pools
        return scan(self._src, self._src_valid, state, self.transformation(), conv0, q0, t0,
                    slots=slots)

    def _overflowed(self) -> None:
        """Raise the pooled row budget (x2, twice), then move the rest of the
        pair to the sharded grid engine."""
        if self._pool_budget_boost < 2:
            self._pool_budget_boost += 1
            self._scan = None
            self.out << ("Sharded pooled budget overflow; retrying with a "
                         f"{1 << self._pool_budget_boost}x row budget\n")
            return
        self.engine = "grid"
        self.engine_fallbacks += 1
        self.out << ("Sharded pooled budget overflow; falling back to the sharded grid "
                     "engine for this pair\n")


def _stage_pack(mesh: Mesh, sp, dtype):
    """(this rank's packed pools or None, the event that marks the packing)
    for ``prepare_target(stage=True)``: on a CUDA device the packing runs
    on a stream of its own; elsewhere in line (no event)."""
    if mesh.device.type != "cuda":
        return pack_sharded_pools(mesh, sp, dtype), None
    stream = torch.cuda.Stream(device=mesh.device)
    with torch.cuda.stream(stream):
        packed = pack_sharded_pools(mesh, sp, dtype)
        event = torch.cuda.Event()
        event.record(stream)
    return packed, event
