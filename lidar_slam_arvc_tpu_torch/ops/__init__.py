"""Kernels and elementwise solvers: K1/K3/K4 (nn), K2 (moments), K5
(nn_pruned), the 3x3 eigensolver; the plain matmul forms ``nn_search_xla``,
``nn2_search`` and ``radius_accumulate``."""

from lidar_slam_arvc_tpu_torch.ops.eigh3 import eigvals_sym3, smallest_eigenvector_sym3
from lidar_slam_arvc_tpu_torch.ops.moments import ball_moments, ball_moments_plain
from lidar_slam_arvc_tpu_torch.ops.nn import (
    nn2_search, nn_search, nn_search_plain, nn_search_vals, nn_search_vals_plain,
    nn_search_xla, radius_accumulate,
)
from lidar_slam_arvc_tpu_torch.ops.nn_pruned import nn_search_pruned

__all__ = ["eigvals_sym3", "smallest_eigenvector_sym3", "ball_moments",
           "ball_moments_plain", "nn_search", "nn_search_plain",
           "nn_search_vals", "nn_search_vals_plain", "nn_search_xla", "nn2_search",
           "radius_accumulate", "nn_search_pruned"]
