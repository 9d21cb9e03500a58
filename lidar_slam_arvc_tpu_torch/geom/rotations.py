"""Rotation helpers on tensors: XYZ-mobile Euler angles and the SO(3) log.

Counterpart of the parts of ``lidar_slam_arvc_tpu/geom/rotations.py`` that
stage 2 and the two-plane ICP need: ``normalize_angle``,
``euler_to_rot`` (reference artelib/tools.py:226-238),
``rot_to_euler_both``/``rot_to_euler`` (artelib/tools.py:241-275, both
branches), ``so3_vee`` and ``so3_log``, which the pose-graph residuals
evaluate on every LM step at rotations near the identity and which stays
exact near pi too.
"""

from __future__ import annotations

import math

import torch


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles elementwise to [-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def euler_to_rot(abg: torch.Tensor) -> torch.Tensor:
    """Euler [alpha, beta, gamma] (..., 3) -> R = Rx @ Ry @ Rz (..., 3, 3),
    the product written out as the reference writes it."""
    a, b, g = abg.unbind(-1)
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cg, sg = torch.cos(g), torch.sin(g)
    rows = ((cb * cg, -cb * sg, sb),
            (ca * sg + sa * sb * cg, ca * cg - sa * sb * sg, -sa * cb),
            (sa * sg - ca * sb * cg, sa * cg + ca * sb * sg, ca * cb))
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


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
