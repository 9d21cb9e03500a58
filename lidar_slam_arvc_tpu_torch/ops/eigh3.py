"""Closed-form symmetric 3x3 eigen-solve (batched, branchless, elementwise).

Counterpart of ``lidar_slam_arvc_tpu/ops/eigh3.py`` (Smith's
trigonometric closed form): normals are the eigenvectors of the local
covariance with the smallest eigenvalue.
"""

from __future__ import annotations

import math

import torch

from lidar_slam_arvc_tpu_torch.utils.profiling import span


def eigvals_sym3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3) matrices, ascending."""
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))

    # det(B)/2 with B = (A - qI)/p
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    ) / (p * p * p)
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e_max = q + 2.0 * p * torch.cos(phi)
    e_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_max - e_min

    # diagonal matrices (p2 ~ 0): all eigenvalues equal q
    iso = p2 < 1e-24
    e_min = torch.where(iso, q, e_min)
    e_mid = torch.where(iso, q, e_mid)
    e_max = torch.where(iso, q, e_max)
    return torch.stack([e_min, e_mid, e_max], dim=-1)


def smallest_eigenvector_sym3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3).

    Recovered as the largest-norm cross product of rows of
    (A - lambda_min I); isotropic inputs fall back to +z.
    """
    lam = eigvals_sym3(A)[..., 0]
    B = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0 = B[..., 0, :]
    r1 = B[..., 1, :]
    r2 = B[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)

    best01 = (n01 >= n02) & (n01 >= n12)
    best02 = (n02 > n01) & (n02 >= n12)
    v = torch.where(best01[..., None], c01,
                    torch.where(best02[..., None], c02, c12))
    nv = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    with span("sync.eigh3_ez"):               # a host-to-card copy
        ez = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    return torch.where(nv > 1e-18, v / torch.clamp(nv, min=1e-30), ez)
