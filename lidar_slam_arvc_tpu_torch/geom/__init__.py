"""SO(3)/SE(3) algebra on tensors, batched over leading dimensions
(counterpart of ``lidar_slam_arvc_tpu.geom``, the same 32 names), and
float64 numpy host mirrors (``geom.hostmath``).

Conventions: quaternions are wxyz; Euler angles are XYZ mobile axes,
R = Rx @ Ry @ Rz, with both branches available; transforms are
(..., 4, 4) tensors and trajectories stacked (N, 4, 4) tensors.
"""

from lidar_slam_arvc_tpu_torch.geom.rotations import (
    euler_to_quat, euler_to_rot, normalize_angle, quat_conjugate, quat_multiply,
    quat_normalize, quat_slerp, quat_to_euler, quat_to_rot, rot_to_euler,
    rot_to_euler_both, rot_to_quat, so3_log, so3_vee,
)
from lidar_slam_arvc_tpu_torch.geom.se3 import (
    compose, global_transforms, inverse, make_transform, multiply_by_transform,
    pose_columns_from_transforms, positions, relative_transforms, rotations,
    se3_exp, se3_log, so3_exp, so3_hat, t2v, transform_from_euler,
    transform_from_quat, transform_points, transforms_from_pose_columns,
)

__all__ = [
    "quat_to_rot", "rot_to_quat", "quat_multiply", "quat_conjugate",
    "quat_normalize", "quat_slerp", "euler_to_rot", "rot_to_euler",
    "rot_to_euler_both", "euler_to_quat", "quat_to_euler", "normalize_angle",
    "so3_exp", "so3_log", "so3_hat", "so3_vee",
    "make_transform", "transform_from_quat", "transform_from_euler",
    "compose", "inverse", "transform_points", "positions", "rotations",
    "t2v", "se3_exp", "se3_log", "relative_transforms", "global_transforms",
    "multiply_by_transform", "transforms_from_pose_columns",
    "pose_columns_from_transforms",
]
