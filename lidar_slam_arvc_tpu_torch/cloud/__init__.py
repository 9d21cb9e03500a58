"""Point-cloud ops on fixed-capacity padded tensors (counterpart of
``lidar_slam_arvc_tpu.cloud``): a cloud is (..., CAP, 3) f32 points plus a
(..., CAP) bool validity mask."""

from lidar_slam_arvc_tpu_torch.cloud.cloud import (
    Cloud, compact_counted, crop_radius_height, from_arrays, from_numpy, num_valid,
    to_numpy,
)
from lidar_slam_arvc_tpu_torch.cloud.fpfh import compute_fpfh
from lidar_slam_arvc_tpu_torch.cloud.normals import estimate_normals
from lidar_slam_arvc_tpu_torch.cloud.plane import (
    ransac_ground_plane, refine_plane_lsq, split_by_plane,
)
from lidar_slam_arvc_tpu_torch.cloud.voxel import (
    addressable_extent, voxel_downsample, voxel_downsample_counted,
)

__all__ = [
    "Cloud", "from_arrays", "from_numpy", "to_numpy", "crop_radius_height",
    "num_valid", "compact_counted", "voxel_downsample",
    "voxel_downsample_counted", "addressable_extent",
    "estimate_normals", "ransac_ground_plane", "split_by_plane",
    "refine_plane_lsq", "compute_fpfh",
]
