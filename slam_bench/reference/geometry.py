"""SE(3) algebra for the reference, in plain torch: xi = [w (3), v (3)]."""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coeffs(theta2):
    theta = torch.sqrt(torch.clamp(theta2, min=1e-30))
    small = theta2 < 1e-10
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-30))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=1e-30))
    return A, B, C


def exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) of (..., 6)."""
    w, v = xi[..., :3], xi[..., 3:]
    W = hat(w)
    A, B, C = _coeffs((w * w).sum(-1))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A[..., None, None] * W + B[..., None, None] * (W @ W)
    V = eye + B[..., None, None] * W + C[..., None, None] * (W @ W)
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def log(T: torch.Tensor) -> torch.Tensor:
    """(..., 6) of (..., 4, 4)."""
    R = T[..., :3, :3]
    c = torch.clamp((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(c)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.sin(theta)
    small = theta < 1e-5
    w = torch.where(small[..., None], 0.5 * vee,
                    vee * (theta / torch.where(small, 1.0, 2.0 * s))[..., None])
    # near pi the antisymmetric part vanishes: take the axis from R + I
    near_pi = theta > 3.14
    if bool(near_pi.any()):
        M = (R + R.transpose(-1, -2)) / 2 - c[..., None, None] * torch.eye(
            3, dtype=T.dtype, device=T.device)
        col = torch.argmax(M.diagonal(dim1=-2, dim2=-1), -1)
        axis = torch.gather(M, -1, col[..., None, None].expand(M.shape[:-1] + (1,)))[..., 0]
        axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
        axis = axis * torch.sign((axis * vee).sum(-1, keepdim=True) + 1e-30)
        w = torch.where(near_pi[..., None], axis * theta[..., None], w)
    W = hat(w)
    _, B, C = _coeffs((w * w).sum(-1))
    theta2 = (w * w).sum(-1)
    # V^-1 = I - W/2 + (1 - A / (2B)) / theta^2 W^2
    A = torch.where(theta2 < 1e-10, 1.0 - theta2 / 6.0,
                    torch.sin(torch.sqrt(torch.clamp(theta2, min=1e-30)))
                    / torch.sqrt(torch.clamp(theta2, min=1e-30)))
    D = torch.where(theta2 < 1e-10, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - A / (2.0 * B)) / torch.clamp(theta2, min=1e-30))
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = eye - 0.5 * W + D[..., None, None] * (W @ W)
    return torch.cat([w, (Vinv @ T[..., :3, 3:4])[..., 0]], -1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = R
    out[..., :3, 3] = -(R @ T[..., :3, 3:4])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def gaps(Ta, Tb):
    """(translation gap (m), rotation gap (rad)) of matching transforms."""
    Ta, Tb = (torch.as_tensor(x, dtype=torch.float64) for x in (Ta, Tb))
    dt = torch.linalg.vector_norm(Ta[..., :3, 3] - Tb[..., :3, 3], dim=-1)
    Rd = Ta[..., :3, :3].transpose(-1, -2) @ Tb[..., :3, :3]
    c = (Rd.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    s = torch.linalg.vector_norm(torch.stack(
        [Rd[..., 2, 1] - Rd[..., 1, 2], Rd[..., 0, 2] - Rd[..., 2, 0],
         Rd[..., 1, 0] - Rd[..., 0, 1]], -1), dim=-1) / 2.0
    return dt, torch.atan2(s, c)
