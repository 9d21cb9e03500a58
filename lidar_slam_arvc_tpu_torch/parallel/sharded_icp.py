"""Scan-pair ICP sharded over the ranks of a mesh.

Counterpart of ``lidar_slam_arvc_tpu/parallel/sharded_icp.py``.  The
pairs of a batch are independent, so each rank runs ``icp_batch`` (K1 for
the correspondences) on its own contiguous block of them and the results
are gathered.  The reference returns outputs sharded over the mesh for
the caller to pull; torch has no global array, so here every rank gets
the whole ``ICPResult``, bit-equal to one ``icp_batch`` of the blocks in
rank order.
"""

from __future__ import annotations

from lidar_slam_arvc_tpu_torch.parallel.mesh import DataMesh, gather_blocks, shard_batch
from lidar_slam_arvc_tpu_torch.registration.icp import ICPParams, ICPResult, icp_batch


def sharded_icp_batch(mesh: DataMesh, src_points, src_masks, tgt_points,
                      tgt_masks, tgt_normals, T_inits,
                      params: ICPParams = ICPParams(),
                      method: str = "point_to_plane",
                      axis: str = "data") -> ICPResult:
    """``icp_batch`` with the pair axis split over ``mesh``'s ranks.

    Every rank passes the whole batch (or the same one); the batch size
    must be divisible by the mesh size, as in the reference."""
    if src_points.shape[0] % mesh.size:
        raise ValueError(f"batch {src_points.shape[0]} not divisible by mesh "
                         f"size {mesh.size}")
    res = icp_batch(*shard_batch(mesh, src_points, src_masks, tgt_points,
                                 tgt_masks, tgt_normals, T_inits),
                    params, method)
    return ICPResult(*gather_blocks(mesh, *res))
