"""Multi-device execution on ``torch.distributed`` (port of the JAX
package's ``parallel/``): one process per mesh device, a process group per
mesh axis (``mesh.py``), the sharded brute-force, grid and pooled engines,
the top-k merges, and ``DistributedRegistration``. Batches of pairs
(``batch.py``: ``run_odometry_batched`` and the batched engines) are
imported from their module, as in the JAX package."""
from .mesh import (
    POINTS_AXIS,
    TARGETS_AXIS,
    Mesh,
    choose_backend,
    make_mesh,
    shard_rows,
)
from .multihost import allgather_trajectory, initialize_multihost, make_global_mesh
from .distributed import (
    ShardedStepResult,
    make_sharded_registration_step,
    pad_for_mesh,
)
from .grid_sharded import (
    ShardedGrid,
    ShardedGridStepResult,
    build_sharded_grid_host,
    make_sharded_grid_align_scan,
    make_sharded_grid_registration_step,
    merge_topk,
    merge_topk_scatter,
    merge_topk_tree,
    sharded_merge_topk,
)
from .pool_sharded import (
    ShardedPoolPlan,
    ShardedPools,
    ShardedPoolStepResult,
    build_sharded_pool_host,
    build_sharded_pools_device,
    choose_pool_shard_layout,
    make_sharded_pool_align_scan,
    make_sharded_pool_registration_step,
)
from .align import DistributedRegistration
from .search import local_topk_merge, make_target_sharded_search

__all__ = [
    "POINTS_AXIS",
    "TARGETS_AXIS",
    "Mesh",
    "choose_backend",
    "make_mesh",
    "shard_rows",
    "initialize_multihost",
    "make_global_mesh",
    "allgather_trajectory",
    "ShardedStepResult",
    "make_sharded_registration_step",
    "pad_for_mesh",
    "local_topk_merge",
    "make_target_sharded_search",
    "ShardedGrid",
    "ShardedGridStepResult",
    "build_sharded_grid_host",
    "make_sharded_grid_registration_step",
    "merge_topk",
    "merge_topk_scatter",
    "merge_topk_tree",
    "sharded_merge_topk",
    "ShardedPoolPlan",
    "choose_pool_shard_layout",
    "ShardedPools",
    "ShardedPoolStepResult",
    "build_sharded_pool_host",
    "build_sharded_pools_device",
    "make_sharded_pool_align_scan",
    "make_sharded_pool_registration_step",
    "make_sharded_grid_align_scan",
    "DistributedRegistration",
]
