"""Scan registration: batched point-to-plane / point-to-point ICP, the
two-plane ICP (``icp2planes``) and FPFH + RANSAC global registration
(``fpfh``, ``registration.global_reg``)."""

from lidar_slam_arvc_tpu_torch.registration.icp import (
    ICPParams, ICPResult, icp, icp_batch, icp_two_planes,
)

__all__ = ["ICPParams", "ICPResult", "icp", "icp_batch", "icp_two_planes"]
