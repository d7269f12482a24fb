"""Probabilistic point-cloud registration in PyTorch, for NVIDIA GPUs.

A port of the JAX package ``probabilistic_point_clouds_registration_tpu``
(which stays the reference) to PyTorch, with its TPU kernels rewritten by
hand for Hopper (``csrc/``, built with nvcc at first use by ``kernels.py``).
It imports neither JAX nor the JAX package. Each module mirrors the JAX
module of the same path.

Ported so far: pair registration (``ProbabilisticRegistration``,
``register_pair``) with Student-t or Gaussian EM weights, the moments-form
LM solve (fixed-shape steps in blocks, CUDA graphs on a card), the outer
loop in chunks with the stopping rule on the device (``outer_chunk``),
``trace_inner``, ``profile_dir``, the voxel filters, the native host
library (``native/``), and every search engine: the pooled engine (``auto``
on a CUDA device) and the dense fused grouped engine (both through the CUDA
select kernels), the hash-grid engine they fall back to (its k-selection
through the CUDA row top-k kernel), brute force through the CUDA KNN kernel
(``search_impl="pallas"``) and streaming brute force. All four TPU kernels
of the JAX package have a CUDA counterpart. Around the pair: PCD / KITTI /
ETH CSV I/O and the scan prefetcher (``io/``), the evaluation metrics
(``utils/eval.py``), the reference-compatible command line (``cli.py``,
``python -m probabilistic_point_clouds_registration_tpu_torch``), sequence
odometry with a staged target-prep thread (``models/odometry.py``), loop
closure and the pose-graph solve (``models/loop_closure.py``,
``models/pose_graph.py``) and the sequence command line
(``cli_odometry.py``). The multi-device half runs on ``torch.distributed``,
one process per mesh device (``parallel/``): the ("points", "targets")
mesh, the sharded brute-force, grid and pooled engines with their top-k
merges, ``DistributedRegistration``, ``run_odometry(mesh=)`` and
``cli_odometry.py --mesh`` under torchrun, and the edge-sharded pose graph;
batches of pairs (``parallel/batch.py``: a sequence's pairs in one program,
each pooled class pass and each grid block one kernel launch across the
pairs, optionally split over the mesh). Every module and kernel of the JAX
package has its counterpart here, ``utils/compile_cache.py`` aside (a JAX
compilation cache).
"""

from .core.params import RegistrationParams
from .core.se3 import SE3
from .models.em_lm import LMConfig, em_lm_solve
from .models.registration import ProbabilisticRegistration, register_pair

__version__ = "0.1.0"

__all__ = [
    "RegistrationParams",
    "SE3",
    "LMConfig",
    "em_lm_solve",
    "ProbabilisticRegistration",
    "register_pair",
    "__version__",
]
