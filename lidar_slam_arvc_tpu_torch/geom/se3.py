"""Batched SE(3) transforms and trajectory algebra on tensors.

Counterpart of ``lidar_slam_arvc_tpu/geom/se3.py``, name for name (the
SO(3) primitives are in ``geom/rotations.py``).  Every 3x3/4x4 product is
written out elementwise, so no matmul runs and TF32 cannot touch the
geometry — the counterpart of the reference's ``Precision.HIGHEST`` rule.
Tangent convention ``xi = [w(3), v(3)]``; transforms are (..., 4, 4),
trajectories stacked (N, 4, 4).  ``global_transforms`` folds a trajectory
as a log-depth prefix product of batched ``compose`` calls, where the
reference runs ``lax.associative_scan``.
"""

from __future__ import annotations

import torch

from lidar_slam_arvc_tpu_torch.geom.rotations import (  # noqa: F401 (re-exported)
    _eye3, _hat_sq, euler_to_rot, quat_to_rot, rot_to_euler, rot_to_quat, so3_exp,
    so3_hat, so3_log,
)
from lidar_slam_arvc_tpu_torch.utils.profiling import span


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
    with span("sync.make_transform_row"):     # a host-to-card copy
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                              device=top.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def transform_from_quat(position: torch.Tensor, q_wxyz: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) from a position and a wxyz quaternion."""
    return make_transform(position, quat_to_rot(q_wxyz))


def transform_from_euler(position: torch.Tensor, abg: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) from a position and XYZ-mobile Euler angles."""
    return make_transform(position, euler_to_rot(abg))


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


def positions(T: torch.Tensor) -> torch.Tensor:
    """(..., 3) translation parts."""
    return T[..., :3, 3]


def rotations(T: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation parts."""
    return T[..., :3, :3]


def relative_transforms(global_T: torch.Tensor) -> torch.Tensor:
    """(N, 4, 4) global -> (N-1, 4, 4) relative: T_i^-1 @ T_{i+1}."""
    return compose(inverse(global_T[:-1]), global_T[1:])


def _prefix_products(chain: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products P_k = chain_0 @ ... @ chain_k of an
    (N, 4, 4) chain, each product in that left-to-right order.

    Hillis-Steele: step d composes every P_k (k >= d) with the prefix d
    rows back, so ceil(log2 N) batched ``compose`` calls run, not N."""
    out = chain
    d = 1
    while d < out.shape[0]:
        out = torch.cat([out[:d], compose(out[:-d], out[d:])], dim=0)
        d *= 2
    return out


def global_transforms(relative_T: torch.Tensor, T0: torch.Tensor | None = None,
                      Trobot_gps: torch.Tensor | None = None) -> torch.Tensor:
    """(N-1, 4, 4) relative -> (N, 4, 4) global poses starting at ``T0``
    (identity by default), each right-multiplied by ``Trobot_gps`` when
    given.  A log-depth prefix product (``_prefix_products``): f32 rounding
    follows another order than a sequential fold or the reference's
    ``associative_scan``."""
    if T0 is None:
        T0 = torch.eye(4, dtype=relative_T.dtype, device=relative_T.device)
    out = _prefix_products(torch.cat([T0[None], relative_T], dim=0))
    if Trobot_gps is not None:
        out = multiply_by_transform(out, Trobot_gps)
    return out


def multiply_by_transform(transforms: torch.Tensor, Trel: torch.Tensor) -> torch.Tensor:
    """Right-multiply every pose by ``Trel``."""
    return compose(transforms, Trel.expand(transforms.shape))


def transforms_from_pose_columns(xyz: torch.Tensor, q_wxyz: torch.Tensor) -> torch.Tensor:
    """Stacked (N, 4, 4) from position columns and wxyz quaternion columns
    (a trajectory CSV's [x y z] and [qw qx qy qz])."""
    return transform_from_quat(xyz, q_wxyz)


def pose_columns_from_transforms(T: torch.Tensor):
    """(N, 4, 4) -> (xyz (N, 3), q_wxyz (N, 4))."""
    return positions(T), rot_to_quat(T[..., :3, :3])
