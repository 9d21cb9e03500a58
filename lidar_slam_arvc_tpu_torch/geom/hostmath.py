"""Numpy float64 mirrors of the small geometry ops needed on the host.

Counterpart of ``lidar_slam_arvc_tpu/geom/hostmath.py``, line for line:
the CSV bytes the pipeline writes depend on these exact operations
(wxyz quaternions, XYZ mobile Euler, Corke-style quaternion extraction).
"""

from __future__ import annotations

import numpy as np


def quat_to_rot_np(q: np.ndarray) -> np.ndarray:
    """wxyz quaternion(s) -> (..., 3, 3) rotation matrices (float64)."""
    q = np.asarray(q, dtype=np.float64)
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    q = np.divide(q, n, out=np.zeros_like(q), where=n > 1e-12)
    q[..., 0] = np.where(n[..., 0] > 1e-12, q[..., 0], 1.0)
    w, x, y, z = np.moveaxis(q, -1, 0)
    R = np.empty(q.shape[:-1] + (3, 3), dtype=np.float64)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - z * w)
    R[..., 0, 2] = 2 * (x * z + y * w)
    R[..., 1, 0] = 2 * (x * y + z * w)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - x * w)
    R[..., 2, 0] = 2 * (x * z - y * w)
    R[..., 2, 1] = 2 * (y * z + x * w)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotation matrices -> wxyz quaternions (float64).

    Corke-style extraction (dominant-diagonal branch, modified sign), with
    no trailing re-normalisation, exactly as the JAX package's host mirror.
    """
    R = np.asarray(R, dtype=np.float64)[..., :3, :3]
    tr = np.maximum(R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] + 1.0, 0.0)
    s = np.sqrt(tr) / 2.0
    kx = R[..., 2, 1] - R[..., 1, 2]
    ky = R[..., 0, 2] - R[..., 2, 0]
    kz = R[..., 1, 0] - R[..., 0, 1]
    diag = np.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    k = np.argmax(diag, axis=-1)

    kx1 = np.where(k == 0, R[..., 0, 0] - R[..., 1, 1] - R[..., 2, 2] + 1.0,
                   np.where(k == 1, R[..., 1, 0] + R[..., 0, 1],
                            R[..., 2, 0] + R[..., 0, 2]))
    ky1 = np.where(k == 0, R[..., 1, 0] + R[..., 0, 1],
                   np.where(k == 1, R[..., 1, 1] - R[..., 0, 0] - R[..., 2, 2] + 1.0,
                            R[..., 2, 1] + R[..., 1, 2]))
    kz1 = np.where(k == 0, R[..., 2, 0] + R[..., 0, 2],
                   np.where(k == 1, R[..., 2, 1] + R[..., 1, 2],
                            R[..., 2, 2] - R[..., 0, 0] - R[..., 1, 1] + 1.0))
    ksel = np.where(k == 0, kx, np.where(k == 1, ky, kz))
    sgn = np.where(ksel >= 0, 1.0, -1.0)
    kx = kx + sgn * kx1
    ky = ky + sgn * ky1
    kz = kz + sgn * kz1
    # The norm goes through a batched matmul (BLAS ddot, with FMA) as the
    # JAX package's mirror does: a plain sum of squares differs by 1 ulp on
    # ~10% of inputs, which would change the bytes of the trajectory CSVs.
    kvec = np.stack([kx, ky, kz], axis=-1)
    nm = np.sqrt(np.matmul(kvec[..., None, :], kvec[..., :, None])
                 [..., 0, 0])
    scale = np.divide(np.sqrt(np.maximum(1.0 - s * s, 0.0)),
                      nm, out=np.zeros_like(nm), where=nm > 1e-12)
    q = np.stack([s, kx * scale, ky * scale, kz * scale], axis=-1)
    q[..., 0] = np.where(nm > 1e-12, q[..., 0], 1.0)
    return q


def quat_to_yaw_np(q: np.ndarray) -> np.ndarray:
    """Yaw (gamma of XYZ-mobile Euler) from wxyz quaternion(s)."""
    R = quat_to_rot_np(q)
    # gamma from the first Euler branch: arctan2(-R01, R00) for |R02|<1
    s1 = np.sign(np.cos(np.arcsin(np.clip(R[..., 0, 2], -1.0, 1.0))))
    s1 = np.where(s1 == 0, 1.0, s1)
    return np.arctan2(-s1 * R[..., 0, 1], s1 * R[..., 0, 0])


def transforms_from_pose_columns_np(xyz: np.ndarray, q_wxyz: np.ndarray) -> np.ndarray:
    xyz = np.asarray(xyz, dtype=np.float64)
    T = np.zeros(xyz.shape[:-1] + (4, 4), dtype=np.float64)
    T[..., :3, :3] = quat_to_rot_np(q_wxyz)
    T[..., :3, 3] = xyz
    T[..., 3, 3] = 1.0
    return T


def pose_columns_from_transforms_np(T: np.ndarray):
    T = np.asarray(T, dtype=np.float64)
    return T[..., :3, 3].copy(), rot_to_quat_np(T[..., :3, :3])
