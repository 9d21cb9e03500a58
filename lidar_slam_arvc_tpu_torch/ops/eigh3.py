"""Closed-form symmetric 3x3 eigen-solve (batched, branchless, elementwise).

Counterpart of ``lidar_slam_arvc_tpu/ops/eigh3.py`` (Smith's
trigonometric closed form): normals are the eigenvectors of the local
covariance with the smallest eigenvalue.  ``smallest_eigenvector_sym3``
is the JAX package's, operation for operation.  ``resolved_normals``
solves each row in f32 and again in float64 and keeps the float64 normal
where the f32 one departs from it (K7, ``csrc/normal_solve.cu``, one
launch on a card; its plain version ``resolved_normals_plain``, eager, on
the CPU): f32 cannot resolve two small eigenvalues that meet.
"""

from __future__ import annotations

import math

import torch

from lidar_slam_arvc_tpu_torch.ops import _cuda

# a normal from the f32 closed form is kept where it lies within ~1 degree
# of the float64 solve of the same covariance (|cos| >= 1 - OFF_F64)
OFF_F64 = 1.5e-4


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
    # +z made on the device: a constant from the host is a copy it waits for
    ez = torch.eye(3, dtype=A.dtype, device=A.device)[2]
    return torch.where(nv > 1e-18, v / torch.clamp(nv, min=1e-30), ez)


def smallest_eigenvector_sym3_f64(A: torch.Tensor) -> torch.Tensor:
    """``smallest_eigenvector_sym3`` in float64, returned in float64: the
    eigenvalue from Smith's form (det(B)/2 of B = (A - qI)/p), then the
    largest of the three cross products of rows of (A - lambda_min I)."""
    A = A.double()
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = A.diagonal(dim1=-2, dim2=-1).mean(-1)[..., None, None]
    B = A - q * eye
    p = torch.sqrt(torch.clamp((B * B).sum((-2, -1), keepdim=True) / 6.0, min=1e-30))
    det = (B[..., 0, :] * torch.linalg.cross(B[..., 1, :], B[..., 2, :])).sum(
        -1)[..., None, None]
    r = torch.clamp(det / (2.0 * p * p * p), -1.0, 1.0)
    lam = q + 2.0 * p * torch.cos(torch.arccos(r) / 3.0 + 2.0 * math.pi / 3.0)
    M = A - lam * eye
    # rows (0, 0, 1) x rows (1, 2, 2), by slices: an index tuple would be
    # copied from the host, which waits for the card
    c = torch.linalg.cross(torch.cat([M[..., :1, :], M[..., :2, :]], -2),
                           torch.cat([M[..., 1:, :], M[..., 2:, :]], -2))
    best = (c * c).sum(-1).argmax(-1)[..., None, None]
    v = torch.take_along_dim(c, best, dim=-2)[..., 0, :]
    nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(nv > 1e-18, v / torch.clamp(nv, min=1e-30), eye[2])


def resolved_normals_plain(cov: torch.Tensor) -> torch.Tensor:
    """K7's plain version, on any device: ``smallest_eigenvector_sym3`` of
    the f32 covariances ``cov`` (..., 3, 3), with each row whose |cos| to
    ``smallest_eigenvector_sym3_f64`` of the same covariance is below
    1 - ``OFF_F64`` replaced by that float64 normal, rounded to f32."""
    f32 = smallest_eigenvector_sym3(cov)
    exact = smallest_eigenvector_sym3_f64(cov)
    off = torch.sum(f32.double() * exact, dim=-1).abs() < 1.0 - OFF_F64
    return torch.where(off[..., None], exact.to(f32.dtype), f32)


def resolved_normals(cov: torch.Tensor) -> torch.Tensor:
    """(..., 3) f32 normals of the f32 covariances ``cov`` (..., 3, 3):
    K7 for CUDA tensors (a wrong dtype or a non-contiguous tensor raises),
    ``resolved_normals_plain`` for CPU tensors."""
    dev = cov.device
    if dev.type == "cpu":
        return resolved_normals_plain(cov)
    if dev.type != "cuda":
        raise ValueError(f"resolved_normals: unsupported device {dev}")
    _cuda.require(cov, "cov", torch.float32, cov.shape[:-2] + (3, 3), dev)
    out = torch.empty(cov.shape[:-1], dtype=torch.float32, device=dev)
    n = out.numel() // 3
    if n == 0:
        return out
    with _cuda.on_device(dev):
        err = _cuda.library().normal_solve_launch(cov.data_ptr(), out.data_ptr(), n,
                                                  OFF_F64, _cuda.stream_of(cov))
    _cuda.check(err, "normal_solve")
    _cuda.launch_counts["normal_solve"] += 1
    return out
