"""Batched RANSAC ground-plane estimation and plane segmentation.

Counterpart of ``lidar_slam_arvc_tpu/cloud/plane.py`` (the reference's
two-planes preprocessing, keyframe.py:417-461): a plane is RANSAC-fit to
the points below a seed height, refined by least squares on the winning
inlier set, and the cloud is split into ground and non-ground by
point-to-plane distance.  Every function takes (B, CAP) batches of clouds.

All hypotheses of a cloud are drawn and scored at once: (iters, 3) point
triplets, a batched 3-point plane, one (B, iters, CAP) distance tensor for
the inlier counts (33 MB a scan at iters = 1000, CAP = 8192), a first-max
``argmax``.

What is drawn from what: each cloud's (iters, 3) triplets are uniform
among its candidates (valid points with z < seed height; all CAP rows if
it has none), from ``iters * 3`` uniforms of the generator given for that
cloud (``ops.draws``); ``sample_idx`` replaces the draw.
"""

from __future__ import annotations

import torch

from lidar_slam_arvc_tpu_torch.cloud.cloud import Cloud
from lidar_slam_arvc_tpu_torch.ops.draws import choose_uniform, uniform_draws
from lidar_slam_arvc_tpu_torch.ops.eigh3 import smallest_eigenvector_sym3


def _dot3(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """p . n over the last axis, (x n0 + y n1) + z n2, each operation
    rounded on its own."""
    return (p[..., 0] * n[..., 0] + p[..., 1] * n[..., 1]) + p[..., 2] * n[..., 2]


def ransac_ground_plane(cloud: Cloud, generator=None, *,
                        seed_height: float = -0.5,
                        distance_threshold: float = 0.01,
                        num_iterations: int = 1000,
                        sample_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Best-fit planes [a, b, c, d] (B, 4), unit normals, near the ground.

    ``generator``: a CPU ``torch.Generator``, or one per cloud; or pass
    ``sample_idx`` (B, num_iterations, 3), the point triplets to use."""
    pts, mask = cloud.points, cloud.mask
    B = pts.shape[0]
    cand = mask & (pts[..., 2] < seed_height)
    if sample_idx is None:
        if generator is None:
            raise ValueError("ransac_ground_plane needs a generator or sample_idx")
        u = uniform_draws(generator, B, (num_iterations * 3,), pts.device)
        sample_idx = choose_uniform(u, cand).view(B, num_iterations, 3)
    idx = sample_idx.to(device=pts.device, dtype=torch.int64)
    rows = torch.arange(B, device=pts.device)
    p0, p1, p2 = pts[rows[:, None, None], idx].unbind(-2)      # (B, I, 3) each
    n = torch.linalg.cross(p1 - p0, p2 - p0)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    d = -torch.sum(n * p0, dim=-1)
    dist = torch.abs(_dot3(pts[:, None], n[:, :, None]) + d[..., None])
    inlier = (dist < distance_threshold) & cand[:, None]       # (B, I, N)
    counts = torch.where(norm[..., 0] > 1e-9, inlier.sum(-1), -1)
    best = torch.argmax(counts, dim=-1)
    plane = torch.cat([n[rows, best], d[rows, best, None]], dim=-1)
    return refine_plane_lsq(pts, inlier[rows, best], fallback=plane)


def refine_plane_lsq(points: torch.Tensor, inlier_mask: torch.Tensor,
                     fallback: torch.Tensor) -> torch.Tensor:
    """Least-squares planes (..., 4) through the masked points (centroid and
    smallest eigenvector of the covariance); ``fallback`` where fewer than
    3 points are masked."""
    w = inlier_mask.to(points.dtype)
    n_in = w.sum(-1)
    safe_n = torch.clamp(n_in, min=1.0)[..., None]
    mean = torch.sum(points * w[..., None], dim=-2) / safe_n
    c = (points - mean[..., None, :]) * w[..., None]
    cov = torch.sum(c[..., :, None] * c[..., None, :], dim=-3) / safe_n[..., None]
    normal = smallest_eigenvector_sym3(cov)
    d = -torch.sum(normal * mean, dim=-1, keepdim=True)
    refined = torch.cat([normal, d], dim=-1)
    return torch.where((n_in >= 3)[..., None], refined, fallback)


def split_by_plane(cloud: Cloud, plane: torch.Tensor,
                   distance_threshold: float = 0.4):
    """(ground, non_ground) clouds by point-to-plane distance:
    |a x + b y + c z + d| / |(a, b, c)| < threshold is ground.  Both share
    the input's points and normals; only the masks differ."""
    n = plane[..., None, :3]
    denom = torch.clamp(torch.linalg.vector_norm(plane[..., :3], dim=-1), min=1e-12)
    dist = torch.abs(_dot3(cloud.points, n) + plane[..., None, 3]) / denom[..., None]
    is_ground = dist < distance_threshold
    return (Cloud(cloud.points, cloud.mask & is_ground, cloud.normals),
            Cloud(cloud.points, cloud.mask & ~is_ground, cloud.normals))
