"""Multi-device paths: the rank mesh, sharded batched ICP, distributed solves.

Counterpart of ``lidar_slam_arvc_tpu.parallel``.  A mesh of N devices is a
process group of N ranks, one process per device (``parallel/mesh.py``).
The parallel units are (a) data parallelism over independent scan pairs,
the scanmatcher's pair axis split over the ranks, and (b) the pose-graph
normal equations assembled from per-rank factor slices and summed with
``all_reduce`` before a replicated dense solve, or eliminated chunk-wise
by the distributed Schur complement (``parallel/schur.py``), where only
the separator system is communicated.  The reference's
``schur_lm_step_jit`` (a ``jax.jit`` wrapper) has no counterpart.
"""

from lidar_slam_arvc_tpu_torch.parallel.mesh import (
    DataMesh, data_mesh, launch, resolve_mesh, shard_batch,
)
from lidar_slam_arvc_tpu_torch.parallel.sharded_icp import sharded_icp_batch
from lidar_slam_arvc_tpu_torch.parallel.dist_solver import (
    distributed_assemble, distributed_lm_step,
)
from lidar_slam_arvc_tpu_torch.parallel.schur import schur_lm_step, schur_solve_graph

__all__ = ["DataMesh", "data_mesh", "resolve_mesh", "shard_batch", "launch",
           "sharded_icp_batch", "distributed_assemble", "distributed_lm_step",
           "schur_lm_step", "schur_solve_graph"]
