"""FPFH (Fast Point Feature Histogram) descriptors, batched over clouds.

Counterpart of ``lidar_slam_arvc_tpu/cloud/fpfh.py`` (Open3D's
``compute_fpfh_feature`` in the reference, keyframe.py:227-229): 33-dim
histograms, 11 bins for each of the three Darboux angles, exact over the
epsilon-ball (no neighbour cap).  Plain PyTorch: the JAX package computes
it in XLA, with no Pallas kernel.

Both passes sweep blocks of query rows against every target of the cloud:

* pass 1 (SPFH): the angles of every (query, target) pair, their bins,
  the 33 per-bin counts and the neighbour count over 0 < dist <= r.  The
  histogram is a compare and an integer sum per bin, exact and in a fixed
  order, never a ``scatter_add_``/``index_add_``, which sum in a
  run-dependent order on CUDA;
* pass 2: the 1/d-weighted mixing of the neighbours' SPFH as a full-f32
  matmul (TF32 off).

Then the PCL weighting SPFH + (1/k) sum_j SPFH_j / d_j and a
normalisation of each 11-bin block to 100; invalid rows are 0.
"""

from __future__ import annotations

import math

import torch

from lidar_slam_arvc_tpu_torch.cloud.cloud import Cloud
from lidar_slam_arvc_tpu_torch.ops.nn import _full_f32_matmul

N_BINS = 11


def _pair_geometry(qp, tp):
    """(diff (B, Q, T, 3) = target - query, dist (B, Q, T))."""
    diff = tp[:, None, :, :] - qp[:, :, None, :]
    return diff, torch.sqrt(torch.sum(diff * diff, dim=-1))


def _pair_angles(diff, dist, n_p, n_q):
    """Darboux-frame features (f1 = cos alpha, f2 = cos phi, f3 = theta) of
    every (query p, target q) pair: with d = (q - p)/|q - p|, u = n_p,
    v = d x u (normalised), w = u x v: f1 = v . n_q, f2 = u . d,
    f3 = atan2(w . n_q, u . n_q)."""
    d = diff / torch.clamp(dist[..., None], min=1e-12)
    u = n_p[:, :, None, :].expand_as(d)
    v = torch.linalg.cross(d, u)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    w = torch.linalg.cross(u, v)
    nq = n_q[:, None, :, :]
    f1 = torch.sum(v * nq, dim=-1)
    f2 = torch.sum(d * u, dim=-1)
    f3 = torch.atan2(torch.sum(w * nq, dim=-1), torch.sum(u * nq, dim=-1))
    return f1, f2, f3


def _bin_index(f, lo: float, hi: float):
    b = torch.floor((f - lo) / (hi - lo) * N_BINS).to(torch.int32)
    return torch.clamp(b, 0, N_BINS - 1)


def _in_ball(dist, radius: float, tmask):
    return (dist <= radius) & (dist > 1e-9) & tmask[:, None, :]


def _blocks(N: int, B: int, max_pairs: int):
    step = max(1, max_pairs // max(B * N, 1))
    return range(0, N, step), step


def _spfh(points, normals, mask, radius: float, max_pairs: int):
    """(B, N, 33) unnormalised SPFH histograms and (B, N) neighbour counts
    (float32) of clouds (B, N, 3); query blocks keep each (B, Q, N) pair
    tensor under ``max_pairs`` elements."""
    B, N, _ = points.shape
    hist, count = [], []
    starts, step = _blocks(N, B, max_pairs)
    for q0 in starts:
        sl = slice(q0, q0 + step)
        diff, dist = _pair_geometry(points[:, sl], points)
        f1, f2, f3 = _pair_angles(diff, dist, normals[:, sl], normals)
        ball = _in_ball(dist, radius, mask)
        h = []
        for f, lo, hi in ((f1, -1.0, 1.0), (f2, -1.0, 1.0), (f3, -math.pi, math.pi)):
            b = torch.where(ball, _bin_index(f, lo, hi), -1)
            h += [torch.sum(b == k, dim=-1) for k in range(N_BINS)]
        hist.append(torch.stack(h, dim=-1))
        count.append(torch.sum(ball, dim=-1))
    return (torch.cat(hist, dim=1).to(points.dtype),
            torch.cat(count, dim=1).to(points.dtype))


def compute_fpfh(cloud: Cloud, radius: float = 0.3,
                 max_pairs: int = 1 << 24) -> torch.Tensor:
    """(B, CAP, 33) FPFH descriptors of batched clouds with normals; rows of
    invalid points are 0.  A cloud's descriptors depend on that cloud
    alone.  ``max_pairs`` bounds each block's (B, Q, CAP) pair tensors."""
    if cloud.normals is None:
        raise ValueError("compute_fpfh needs normals (cloud.estimate_normals)")
    points, mask = cloud.points, cloud.mask
    B, N, _ = points.shape
    s, count = _spfh(points, cloud.normals, mask, radius, max_pairs)
    acc = []
    starts, step = _blocks(N, B, max_pairs)
    with _full_f32_matmul():
        for q0 in starts:
            _, dist = _pair_geometry(points[:, q0:q0 + step], points)
            w = _in_ball(dist, radius, mask).to(points.dtype) / torch.clamp(dist, min=1e-6)
            acc.append(torch.matmul(w, s))
    # PCL weighting: FPFH(p) = SPFH(p) + (1/k) sum_j SPFH(j) / d_j
    f = s + torch.cat(acc, dim=1) / torch.clamp(count, min=1.0)[..., None]
    f = f.view(B, N, 3, N_BINS)
    f = 100.0 * f / torch.clamp(torch.sum(f, dim=-1, keepdim=True), min=1e-6)
    return torch.where(mask[..., None], f.view(B, N, 3 * N_BINS), 0.0)
