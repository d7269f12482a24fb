"""Multi-process setup for the mesh (port of the JAX package's
``parallel/multihost.py``).

The JAX package initializes ``jax.distributed`` from
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` and
spans one global mesh over every process's devices. Here every process is
one rank with one device: :func:`initialize_multihost` starts the default
process group from torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``) or from explicit arguments, with the backend chosen
by rule before the group exists (``mesh.choose_backend``: NCCL when every
rank has a card of its own, ``gloo`` on the CPU or when ranks share a card).
Without a launcher it does nothing, so library code can call it
unconditionally.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import Mesh, choose_backend, make_mesh


def initialize_multihost(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    device="cuda",
    local_rank: Optional[int] = None,
    local_world_size: Optional[int] = None,
) -> bool:
    """Initialize the default process group when running under a
    multi-process launcher; no-op (returns False) in a single process.

    Arguments default to torchrun's environment; ``init_method`` to
    ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``). ``device`` is the device
    type the ranks compute on ("cuda", or "cpu" when asked for); on CUDA the
    rank's current device becomes ``cuda:(local_rank % device_count)``.
    Rank 0 prints the backend and why.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if world_size is None and init_method is None:
        return False
    if rank is None:
        rank = int(env.get("RANK", "0"))
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    backend = choose_backend(dev, local_world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=int(world_size), rank=int(rank),
    )
    if rank == 0:
        why = ("every rank has a card of its own" if backend == "nccl" else
               "ranks on the CPU" if dev.type != "cuda" else
               "ranks share a card; collectives stage through host memory")
        print(f"torch.distributed: {world_size} ranks, backend {backend} ({why})", flush=True)
    return True


def make_global_mesh(n_target_shards: int = 1, *, device=None) -> Mesh:
    """("points", "targets") mesh over every rank of the process group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % n_target_shards:
        raise ValueError(f"{world} global ranks not divisible by {n_target_shards}")
    return make_mesh(world // n_target_shards, n_target_shards, device=device)


def allgather_trajectory(local_poses) -> np.ndarray:
    """Every process's block of 4x4 poses, in rank order, on every process
    (multi-process odometry with the scan pairs split across processes).
    Blocks must have equal sizes. Single process: the poses as they are."""
    poses = np.asarray(local_poses, dtype=np.float64)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return poses
    where = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    block = torch.as_tensor(poses, device=where)
    parts = [torch.empty_like(block) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, block)
    return torch.cat(parts).cpu().numpy().reshape(-1, 4, 4)
