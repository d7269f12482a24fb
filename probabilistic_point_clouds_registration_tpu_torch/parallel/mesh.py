"""The ("points", "targets") device mesh on ``torch.distributed`` (port of
the JAX package's ``parallel/mesh.py``).

The JAX package runs one program over a ``jax.sharding.Mesh`` under
``shard_map``: source rows shard over the ``"points"`` axis (the 7x7 normal
equations and the costs are reduced with ``psum``), target rows over the
``"targets"`` axis (per-source top-k lists merged across it). Here each
rank of a process group is one device of that mesh, running its own copy
of the program on its own device, and each axis is a process group:

  * rank ``r = p * tp + t`` sits at ("points" p, "targets" t), the JAX
    package's ``devices.reshape(dp, tp)``, so a rank's inputs are the JAX
    device's shard for shard;
  * a rank's "points" group is its mesh column, its "targets" group its
    mesh row; an axis that spans every rank uses the default group, and a
    size-1 axis of a larger world has no group (its collectives are the
    identity);
  * with no process group initialized, :func:`make_mesh` gives a 1x1 mesh
    whose collectives are all the identity (JAX's one-device mesh).

The collectives are this class's methods (``psum`` = ``all_reduce``,
``all_gather``, ``exchange`` = a paired send / receive in place of
``lax.ppermute``, ``broadcast_``, ``pmean``). Every rank must issue the same
collectives in the same order: callers branch only on replicated values.

Transport: NCCL moves CUDA tensors itself. ``gloo`` (torch 2.11) takes CUDA
tensors for its reductions, broadcasts and gathers, but a send / receive of
one aborts the process (``tools/probe_gloo_cuda.py``), so with ``gloo`` and a
CUDA device every collective stages through host memory, by one rule
(``transport == "host"``); such a collective cannot be captured in a CUDA
graph. The backend itself is chosen before the group is initialized
(:func:`choose_backend`, ``parallel/multihost.py``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils import spans
from ..utils.device import resolve_device

POINTS_AXIS = "points"
TARGETS_AXIS = "targets"


def choose_backend(device="cuda", local_world_size: Optional[int] = None) -> str:
    """The collective backend for ranks on ``device``: NCCL when every rank
    on this host has a card of its own, ``gloo`` on the CPU or when ranks
    share a card. ``local_world_size`` defaults to torchrun's
    ``LOCAL_WORLD_SIZE`` (1 when unset)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if torch.cuda.device_count() >= local_world_size else "gloo"


def default_device():
    """``cuda:(LOCAL_RANK % device_count)``: one card per local rank, shared
    round-robin when there are fewer cards than ranks. Raises without a
    card (the CPU must be asked for)."""
    resolve_device("cuda")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


class Mesh:
    """This rank's view of a ("points", "targets") mesh of ``dp x tp``
    ranks.

    Attributes:
      shape: {"points": dp, "targets": tp}, as ``jax.sharding.Mesh.shape``.
      devices: (dp, tp) int array of global ranks (``r = p * tp + t``).
      rank: this process's global rank; ``coords`` its (axis -> index).
      device: the torch device this rank computes on.
      backend: the process group's backend, None without one.
      transport: "device" when collectives take this rank's tensors as they
        are (NCCL, or ``gloo`` on the CPU), "host" when they stage through
        host memory (``gloo`` with a CUDA device).
    """

    axis_names = (POINTS_AXIS, TARGETS_AXIS)

    def __init__(self, dp: int, tp: int, *, rank: int = 0, groups: Optional[dict] = None,
                 device="cuda", backend: Optional[str] = None):
        self.shape = {POINTS_AXIS: int(dp), TARGETS_AXIS: int(tp)}
        self.devices = np.arange(dp * tp).reshape(dp, tp)
        self.rank = int(rank)
        self.coords = {POINTS_AXIS: self.rank // tp, TARGETS_AXIS: self.rank % tp}
        self.device = torch.device(device)
        self.backend = backend
        self.transport = (
            "host" if backend == "gloo" and self.device.type == "cuda" else "device"
        )
        # axis -> the process group, or None for an identity axis
        self._groups = dict(groups or {})
        self.announced = False  # set by the first caller that prints the setup

    def __repr__(self) -> str:
        return (f"Mesh(points={self.shape[POINTS_AXIS]}, targets={self.shape[TARGETS_AXIS]}, "
                f"rank={self.rank}, device={self.device}, backend={self.backend})")

    # -- layout ---------------------------------------------------------------

    def index(self, axis: str) -> int:
        """``lax.axis_index``: this rank's coordinate on ``axis``."""
        return self.coords[axis]

    def global_rank(self, axis: str, index: int) -> int:
        """The global rank at coordinate ``index`` of ``axis``, the other
        coordinate this rank's."""
        tp = self.shape[TARGETS_AXIS]
        if axis == POINTS_AXIS:
            return index * tp + self.coords[TARGETS_AXIS]
        return self.coords[POINTS_AXIS] * tp + index

    def has_collectives(self, axes) -> bool:
        """Whether a reduction over ``axes`` issues any collective."""
        return any(self._groups.get(a) is not None for a in _axes(axes))

    def capturable(self, axes) -> bool:
        """Whether collectives over ``axes`` can sit inside a CUDA graph: none
        is issued, or they run on the device (NCCL)."""
        return not self.has_collectives(axes) or self.transport == "device"

    def collapsed(self) -> "Mesh":
        """Every rank on the "points" axis (``make_mesh(dp * tp, 1)`` over
        the same ranks in the same order, as the JAX package's "points"
        layout builds it). No group is created: the mesh spans the world, so
        its one non-trivial axis is the default group."""
        if self.shape[TARGETS_AXIS] == 1:
            return self
        n = self.shape[POINTS_AXIS] * self.shape[TARGETS_AXIS]
        groups = {POINTS_AXIS: dist.group.WORLD} if self.backend is not None else {}
        return Mesh(n, 1, rank=self.rank, groups=groups, device=self.device,
                    backend=self.backend)

    # -- collectives ----------------------------------------------------------

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """A contiguous buffer the backend takes (host memory for ``gloo``
        with a CUDA tensor); never ``x`` itself."""
        if self.transport == "host":
            return x.detach().to("cpu", copy=True).contiguous()
        return x.detach().clone(memory_format=torch.contiguous_format)

    def _unstage(self, y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return y.to(like.device) if y.device != like.device else y

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``lax.psum`` over one axis or a tuple of axes (reduced in the
        tuple's order); returns a new tensor, or ``x`` when no axis has a
        group."""
        for axis in _axes(axes):
            group = self._groups.get(axis)
            if group is None:
                continue
            y = self._stage(x)
            dist.all_reduce(y, group=group)
            x = self._unstage(y, x)
        return x

    def pmean(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.pmean``."""
        return self.psum(x, axis) / self.shape[axis]

    def all_gather(self, x: torch.Tensor, axis: str, span: bool = True) -> torch.Tensor:
        """``lax.all_gather``: (axis size, *x.shape), index i from the rank
        at coordinate i. The span ``all_gather`` (none with ``span``
        False: the caller's own span holds it) holds the wait on the
        slowest rank where the backend waits on the host (``gloo``); NCCL
        only enqueues, and the wait falls on the result's first read."""
        group = self._groups.get(axis)
        if group is None:
            return x[None]
        with spans.span("all_gather") if span else contextlib.nullcontext():
            y = self._stage(x)
            parts = [torch.empty_like(y) for _ in range(self.shape[axis])]
            dist.all_gather(parts, y, group=group)
            return self._unstage(torch.stack(parts), x)

    def exchange(self, x: torch.Tensor, axis: str, partner: int) -> torch.Tensor:
        """One pair of a ``lax.ppermute`` whose permutation is an involution
        (the butterfly's ``j ^ stage``): send ``x`` to the rank at
        coordinate ``partner`` of ``axis`` and return what it sent here."""
        if partner == self.coords[axis]:
            return x
        group = self._groups.get(axis)
        if group is None:
            raise RuntimeError(f"exchange on the identity axis {axis!r}")
        peer = self.global_rank(axis, partner)
        y = self._stage(x)
        buf = torch.empty_like(y)
        ops = [dist.P2POp(dist.isend, y, peer, group), dist.P2POp(dist.irecv, buf, peer, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._unstage(buf, x)

    def broadcast_(self, x: torch.Tensor, axis: str, src: int = 0) -> torch.Tensor:
        """In place: every rank of ``axis`` gets the tensor of the rank at
        coordinate ``src`` (shapes and dtypes must agree)."""
        group = self._groups.get(axis)
        if group is None:
            return x
        y = x if self.transport == "device" else x.detach().to("cpu").contiguous()
        if self.transport == "device" and not x.is_contiguous():
            raise ValueError("broadcast_ needs a contiguous tensor")
        dist.broadcast(y, self.global_rank(axis, src), group=group)
        if y is not x:
            x.copy_(y)
        return x


def _axes(axes) -> tuple:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def make_mesh(n_points_shards: Optional[int] = None, n_target_shards: int = 1, *,
              device=None) -> Mesh:
    """Build this rank's ("points", "targets") mesh over the process group.

    Args:
      n_points_shards: size of the points (data-parallel) axis; defaults to
        the world size divided by ``n_target_shards``.
      n_target_shards: size of the targets (search) axis.
      device: this rank's device; defaults to :func:`default_device`
        (``cuda:(LOCAL_RANK % device_count)``).

    The mesh must span the whole world (``dp * tp`` = world size; 1 without
    a process group). Every rank must call this with the same arguments, in
    the same order as its other group creations: the axis groups are made
    with ``new_group`` on every rank.
    """
    device = default_device() if device is None else resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    tp = int(n_target_shards)
    if n_points_shards is None:
        if world % tp:
            raise ValueError(f"{world} ranks not divisible by {tp} target shards")
        n_points_shards = world // tp
    dp = int(n_points_shards)
    if dp * tp != world:
        raise ValueError(
            f"a {dp}x{tp} mesh needs a world of {dp * tp} ranks, this one has {world} "
            "(start one process per mesh device, e.g. torchrun --nproc-per-node "
            f"{dp * tp}, and initialize_multihost() first)"
        )
    if not dist.is_initialized():
        return Mesh(1, 1, device=device)
    rank = dist.get_rank()
    devices = np.arange(world).reshape(dp, tp)
    groups = {
        POINTS_AXIS: _axis_group([devices[:, t] for t in range(tp)], rank, world),
        TARGETS_AXIS: _axis_group([devices[p, :] for p in range(dp)], rank, world),
    }
    return Mesh(dp, tp, rank=rank, groups=groups, device=device,
                backend=dist.get_backend())


def _axis_group(members: Sequence[np.ndarray], rank: int, world: int):
    """This rank's group among ``members`` (one rank list per group),
    creating every group on every rank in the same order. An axis spanning
    the world is the default group; a size-1 axis of a larger world has
    none."""
    size = len(members[0])
    if size == world:
        return dist.group.WORLD
    if size == 1:
        return None
    mine = None
    for ranks in members:
        group = dist.new_group([int(r) for r in ranks])
        if rank in ranks:
            mine = group
    return mine


def shard_rows(x, mesh: Mesh, axis: str):
    """This rank's contiguous block of ``x``'s leading axis over ``axis``
    (the JAX package's ``PartitionSpec(axis)`` placement)."""
    n = x.shape[0]
    size = mesh.shape[axis]
    if n % size:
        raise ValueError(f"{n} rows do not divide the {axis!r} axis of size {size}")
    per = n // size
    i = mesh.index(axis)
    return x[i * per:(i + 1) * per]
