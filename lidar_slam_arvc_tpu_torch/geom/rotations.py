"""Batched SO(3) primitives on tensors: quaternions (wxyz), XYZ-mobile
Euler angles, the so(3) exp and log maps.

Counterpart of ``lidar_slam_arvc_tpu/geom/rotations.py``, name for name.
Every function takes arbitrary leading batch dimensions.  The reference
artelib conventions hold where interop matters:

  * ``rot_to_quat`` is the JAX package's branchless Corke-style extraction
    (reference artelib/tools.py:110-172): w from the clamped trace, the
    vector part from the dominant diagonal element (``argmax``, the first
    maximum) with the modified-sign rule, then re-normalised.  It is not
    the host mirror ``hostmath.rot_to_quat_np``: the two can take
    different branches on near-ties.
  * ``euler_to_rot`` builds R = Rx(a) @ Ry(b) @ Rz(g) (artelib/tools.py:
    226-238); ``rot_to_euler_both`` returns both branches, with the
    degenerate |R02| ~ 1 (gimbal lock) handling (artelib/tools.py:241-275).
  * ``so3_log`` takes the axis from the symmetric part within 1e-3 of pi,
    where theta / (2 sin theta) would blow up; below that its f32 error
    grows as 1 / sin theta.

No 3x3 product runs as a matmul, so TF32 cannot touch the geometry.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-9


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _hat_sq(w: torch.Tensor) -> torch.Tensor:
    """hat(w) @ hat(w) via the closed form w w^T - (w.w) I."""
    outer = w[..., :, None] * w[..., None, :]
    theta2 = torch.sum(w * w, dim=-1)
    return outer - theta2[..., None, None] * _eye3(w)


def _rows3(rows) -> torch.Tensor:
    """(..., 3, 3) from three rows of three (...) tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles elementwise to [-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


# ---------------------------------------------------------------------------
# Quaternions (wxyz)
# ---------------------------------------------------------------------------

def _identity_quat(like: torch.Tensor) -> torch.Tensor:
    unit = torch.zeros_like(like)
    unit[..., 0] = 1.0
    return unit


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) scaled to unit length; a zero quaternion maps to the
    identity."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(n > _EPS, q / torch.clamp(n, min=_EPS),
                       _identity_quat(q))


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions (artelib/tools.py:205-216)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of wxyz quaternion(s)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion(s) (normalised first) -> (..., 3, 3) rotations
    (artelib/tools.py:92-107)."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    return _rows3(((1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                    2 * (x * z + y * w)),
                   (2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                    2 * (y * z - x * w)),
                   (2 * (x * z - y * w), 2 * (y * z + x * w),
                    1 - 2 * (x * x + y * y))))


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) (or (..., 4, 4)) rotations -> wxyz quaternions, robust
    to noisy, nearly orthonormal input (see the module docstring)."""
    R = R[..., :3, :3]
    s = torch.sqrt(torch.clamp(R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
                               + 1.0, min=0.0)) / 2.0
    kx = R[..., 2, 1] - R[..., 1, 2]
    ky = R[..., 0, 2] - R[..., 2, 0]
    kz = R[..., 1, 0] - R[..., 0, 1]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    is0, is1 = k == 0, k == 1

    def pick(b0, b1, b2):
        return torch.where(is0, b0, torch.where(is1, b1, b2))

    kx1 = pick(R[..., 0, 0] - R[..., 1, 1] - R[..., 2, 2] + 1.0,
               R[..., 1, 0] + R[..., 0, 1], R[..., 2, 0] + R[..., 0, 2])
    ky1 = pick(R[..., 1, 0] + R[..., 0, 1],
               R[..., 1, 1] - R[..., 0, 0] - R[..., 2, 2] + 1.0,
               R[..., 2, 1] + R[..., 1, 2])
    kz1 = pick(R[..., 2, 0] + R[..., 0, 2], R[..., 2, 1] + R[..., 1, 2],
               R[..., 2, 2] - R[..., 0, 0] - R[..., 1, 1] + 1.0)
    sgn = torch.where(pick(kx, ky, kz) >= 0, 1.0, -1.0).to(R.dtype)
    kx = kx + sgn * kx1
    ky = ky + sgn * ky1
    kz = kz + sgn * kz1
    nm = torch.sqrt(kx * kx + ky * ky + kz * kz)
    scale = torch.sqrt(torch.clamp(1.0 - s * s, min=0.0)) \
        / torch.clamp(nm, min=_EPS)
    q = torch.cat([s[..., None],
                   torch.stack([kx, ky, kz], dim=-1) * scale[..., None]], dim=-1)
    # re-normalised (unlike artelib): a noisy R otherwise gives |q| != 1
    return quat_normalize(torch.where(nm[..., None] > _EPS, q,
                                      _identity_quat(q)))


def quat_slerp(q1: torch.Tensor, q2: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation along the shortest path (artelib/tools.py:
    290-310); linear weights where sin(theta) <= 1e-9.  ``t`` (a number
    or a tensor broadcasting against the batch) is taken in q1's dtype."""
    t = torch.as_tensor(t, dtype=q1.dtype, device=q1.device)
    cth = torch.sum(q1 * q2, dim=-1)
    q1 = torch.where((cth < 0)[..., None], -q1, q1)
    th = torch.acos(torch.clamp(torch.abs(cth), -1.0, 1.0))
    sth = torch.sin(th)
    safe = sth > _EPS
    den = torch.where(safe, sth, 1.0)
    a = torch.where(safe, torch.sin((1 - t) * th) / den, 1 - t)
    b = torch.where(safe, torch.sin(t * th) / den, t)
    return quat_normalize(q1 * a[..., None] + q2 * b[..., None])


def euler_to_rot(abg: torch.Tensor) -> torch.Tensor:
    """Euler [alpha, beta, gamma] (..., 3) -> R = Rx @ Ry @ Rz (..., 3, 3),
    the product written out as the reference writes it."""
    a, b, g = abg.unbind(-1)
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cg, sg = torch.cos(g), torch.sin(g)
    return _rows3(((cb * cg, -cb * sg, sb),
                   (ca * sg + sa * sb * cg, ca * cg - sa * sb * sg, -sa * cb),
                   (sa * sg - ca * sb * cg, sa * cg + ca * sb * sg, ca * cb)))


def rot_to_euler_both(R: torch.Tensor):
    """Both XYZ-mobile Euler branches (..., 3), angles wrapped to [-pi, pi],
    with the degenerate |R02| ~ 1 (gimbal lock) handling of the reference."""
    r02 = torch.clamp(R[..., 0, 2], -1.0, 1.0)
    degenerate = torch.abs(torch.abs(R[..., 0, 2]) - 1.0) <= 1e-4

    beta1 = torch.asin(r02)
    beta2 = math.pi - beta1
    s1 = torch.sign(torch.cos(beta1))
    s2 = torch.sign(torch.cos(beta2))
    s1 = torch.where(s1 == 0, 1.0, s1)
    s2 = torch.where(s2 == 0, 1.0, s2)
    alpha1 = torch.atan2(-s1 * R[..., 1, 2], s1 * R[..., 2, 2])
    gamma1 = torch.atan2(-s1 * R[..., 0, 1], s1 * R[..., 0, 0])
    alpha2 = torch.atan2(-s2 * R[..., 1, 2], s2 * R[..., 2, 2])
    gamma2 = torch.atan2(-s2 * R[..., 0, 1], s2 * R[..., 0, 0])

    alpha2_d = torch.full_like(beta1, math.pi)
    beta_pos = beta1 > 0
    beta2_d = torch.where(beta_pos, math.pi / 2, -math.pi / 2)
    gamma1_d = torch.where(beta_pos, torch.atan2(R[..., 1, 0], R[..., 1, 1]),
                           torch.atan2(-R[..., 1, 0], R[..., 1, 1]))
    gamma2_d = gamma1_d - alpha2_d

    alpha1 = torch.where(degenerate, torch.zeros_like(beta1), alpha1)
    alpha2 = torch.where(degenerate, alpha2_d, alpha2)
    beta2 = torch.where(degenerate, beta2_d.to(beta2.dtype), beta2)
    gamma1 = torch.where(degenerate, gamma1_d, gamma1)
    gamma2 = torch.where(degenerate, gamma2_d, gamma2)
    e1 = normalize_angle(torch.stack([alpha1, beta1, gamma1], dim=-1))
    e2 = normalize_angle(torch.stack([alpha2, beta2, gamma2], dim=-1))
    return e1, e2


def rot_to_euler(R: torch.Tensor) -> torch.Tensor:
    """The first XYZ-mobile Euler branch."""
    return rot_to_euler_both(R)[0]


def euler_to_quat(abg: torch.Tensor) -> torch.Tensor:
    """XYZ-mobile Euler angles -> wxyz quaternions."""
    return rot_to_quat(euler_to_rot(abg))


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternions -> the first XYZ-mobile Euler branch."""
    return rot_to_euler(quat_to_rot(q))


# ---------------------------------------------------------------------------
# so(3) exp/log
# ---------------------------------------------------------------------------

def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle vector(s) -> (..., 3, 3) skew matrices."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return _rows3(((z, -wz, wy), (wz, z, -wx), (-wy, wx, z)))


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


def so3_vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of ``so3_hat``: (..., 3, 3) skew matrices -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) -> so(3), robust near theta = 0 and theta = pi.

    Near zero the scale theta / (2 sin theta) takes its series; near pi the
    axis comes from the dominant diagonal of (R + R^T)/2 - cos(theta) I,
    signed by the off-diagonal entries and then by the skew part."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.acos(cos_theta)
    skew = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                        R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = theta < 1e-4
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / torch.clamp(2.0 * torch.sin(theta), min=1e-12))
    w_generic = skew * scale[..., None]

    near_pi = theta > math.pi - 1e-3
    S = 0.5 * (R + R.transpose(-1, -2))
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    c = cos_theta[..., None]
    axis = torch.sqrt(torch.clamp((diag - c) / torch.clamp(1.0 - c, min=1e-12),
                                  min=0.0))
    k = torch.argmax(axis, dim=-1)[..., None]
    a0, a1, a2 = axis.unbind(-1)

    def sgn(s, a):
        return torch.where(s >= 0, a, -a)

    s01, s02, s12 = S[..., 0, 1], S[..., 0, 2], S[..., 1, 2]
    cand0 = torch.stack([a0, sgn(s01, a1), sgn(s02, a2)], dim=-1)
    cand1 = torch.stack([sgn(s01, a0), a1, sgn(s12, a2)], dim=-1)
    cand2 = torch.stack([sgn(s02, a0), sgn(s12, a1), a2], dim=-1)
    w_pi = torch.where(k == 0, cand0, torch.where(k == 1, cand1, cand2)) \
        * theta[..., None]
    dot = torch.sum(w_pi * skew, dim=-1, keepdim=True)
    w_pi = torch.where(dot < 0, -w_pi, w_pi)
    return torch.where(near_pi[..., None], w_pi, w_generic)
