"""Batched SO(3)/SE(3) algebra on tensors.

Counterpart of ``lidar_slam_arvc_tpu/geom/se3.py`` (and of the parts of
``rotations.py`` it needs; the SO(3) log and Euler angles are in
``geom/rotations.py``).  Every 3x3/4x4 product is written out
elementwise, so no matmul runs and TF32 cannot touch the geometry — the
counterpart of the reference's ``Precision.HIGHEST`` rule.  Tangent
convention ``xi = [w(3), v(3)]``; transforms are (..., 4, 4).
"""

from __future__ import annotations

import torch

from lidar_slam_arvc_tpu_torch.geom.rotations import rot_to_euler, so3_log


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle vector(s) -> (..., 3, 3) skew matrices."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _hat_sq(w: torch.Tensor) -> torch.Tensor:
    """hat(w) @ hat(w) via the closed form w w^T - (w.w) I."""
    outer = w[..., :, None] * w[..., None, :]
    theta2 = torch.sum(w * w, dim=-1)
    return outer - theta2[..., None, None] * _eye3(w)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential with a Taylor branch near zero."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-24))
    return (_eye3(w) + A[..., None, None] * so3_hat(w)
            + B[..., None, None] * _hat_sq(w))


def _V_matrix(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): V = I + B*W + C*W^2 with series near zero."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-24))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.clamp(theta2 * theta, min=1e-24))
    return (_eye3(w) + B[..., None, None] * so3_hat(w)
            + C[..., None, None] * _hat_sq(w))


def _V_inv_matrix(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3): I - W/2 + c*W^2 with series near zero."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    half = theta / 2.0
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - half * torch.cos(half)
                     / torch.clamp(torch.sin(half), min=1e-24))
                    / torch.clamp(theta2, min=1e-24))
    return _eye3(w) - 0.5 * so3_hat(w) + c[..., None, None] * _hat_sq(w)


def matvec3(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3), written out elementwise."""
    return (M[..., 0] * v[..., 0, None] + M[..., 1] * v[..., 1, None]
            + M[..., 2] * v[..., 2, None])


def make_transform(position: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) homogeneous transforms from (..., 3) and (..., 3, 3)."""
    batch = torch.broadcast_shapes(position.shape[:-1], R.shape[:-2])
    R = R.expand(batch + (3, 3))
    position = position.expand(batch + (3,))
    top = torch.cat([R, position[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3); xi = [w(3), v(3)]."""
    w = xi[..., :3]
    v = xi[..., 3:]
    return make_transform(matvec3(_V_matrix(w), v), so3_exp(w))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map SE(3) -> se(3); returns [w(3), v(3)]."""
    w = so3_log(T[..., :3, :3])
    return torch.cat([w, matvec3(_V_inv_matrix(w), T[..., :3, 3])], dim=-1)


def t2v(T: torch.Tensor) -> torch.Tensor:
    """SE(3) -> [tx, ty, tz, alpha, beta, gamma] (first Euler branch)."""
    return torch.cat([T[..., :3, 3], rot_to_euler(T[..., :3, :3])], dim=-1)


def compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Ta @ Tb for batches of (..., 4, 4), written out elementwise."""
    return (Ta[..., :, 0, None] * Tb[..., None, 0, :]
            + Ta[..., :, 1, None] * Tb[..., None, 1, :]
            + Ta[..., :, 2, None] * Tb[..., None, 2, :]
            + Ta[..., :, 3, None] * Tb[..., None, 3, :])


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse: [R^T, -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_transform(-matvec3(Rt, T[..., :3, 3]), Rt)


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to (..., N, 3) points."""
    R = T[..., None, :3, :3]
    t = T[..., None, :3, 3]
    return matvec3(R, points) + t
