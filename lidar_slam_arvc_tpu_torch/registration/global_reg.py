"""Global (initialisation-free) registration: FPFH matching + batched RANSAC.

Counterpart of ``lidar_slam_arvc_tpu/registration/global_reg.py`` (the
reference's ``registration_ransac_based_on_feature_matching``,
keyframe.py:297-345): correspondences from mutual-nearest FPFH features
with a ratio test on the non-ground clouds, RANSAC over 3-point
correspondence triplets with the edge-length checker and MSAC scoring,
then point-to-plane ICP on the full clouds (K1).  Plain PyTorch besides
that ICP: the JAX package has no Pallas kernel here.  Every function takes
a batch of B pairs.

What is drawn from what: each pair's (H, 3) hypothesis triplets are
uniform among its mutual, distinctive matches (all S rows if it has
none), from ``H * 3`` uniforms of the generator given for the batch, drawn
for the pairs in turn (``ops.draws``); ``sel`` replaces the draw.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_slam_arvc_tpu_torch.cloud.cloud import Cloud
from lidar_slam_arvc_tpu_torch.cloud.fpfh import compute_fpfh
from lidar_slam_arvc_tpu_torch.geom.se3 import make_transform, matvec3, transform_points
from lidar_slam_arvc_tpu_torch.ops.draws import choose_uniform, uniform_draws
from lidar_slam_arvc_tpu_torch.ops.nn import nn2_search, nn_search_xla
from lidar_slam_arvc_tpu_torch.registration.icp import ICPParams, ICPResult, icp_batch


# elements of a hypothesis chunk's transformed sources (128 MiB of f32)
SCORE_ELEMS = 1 << 25


class GlobalRegParams(NamedTuple):
    """The reference's parameters, same names and defaults."""
    fpfh_radius: float = 0.3
    distance_threshold: float = 5.0     # reference fpfh_threshold (keyframe.py:19)
    edge_length_similarity: float = 0.9  # keyframe.py:323-324
    num_hypotheses: int = 8192           # batched stand-in for 100k sequential
    icp: ICPParams = ICPParams()


def _feature_correspondences(feat_src, mask_src, feat_tgt, mask_tgt,
                             ratio: float = 0.95):
    """(idx (B, S), good (B, S)): each source row's nearest target feature,
    and whether the match is mutual, passes the ratio test (best squared
    distance below ratio^2 x the second best) and the source is valid."""
    idx_st, d1, d2 = nn2_search(feat_src, feat_tgt, mask_tgt)
    idx_ts, _ = nn_search_xla(feat_tgt, feat_src, mask_src)
    idx_st = idx_st.to(torch.int64)
    back = torch.gather(idx_ts.to(torch.int64), 1, idx_st)
    mutual = back == torch.arange(feat_src.shape[1], device=back.device)
    return idx_st, mutual & (d1 < (ratio ** 2) * d2) & mask_src


def _three_point_transform(ps, qs):
    """Rigid T (..., 4, 4) aligning source triangles ps (..., 3, 3) to qs:
    an orthonormal frame per triangle (edge, in-plane normal, plane
    normal), R = F_q F_p^T, t aligning the centroids.  No SVD."""
    def frame(tri):
        e1 = tri[..., 1, :] - tri[..., 0, :]
        e2 = tri[..., 2, :] - tri[..., 0, :]
        u = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1, keepdim=True), min=1e-9)
        n = torch.linalg.cross(e1, e2)
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)
        return torch.stack([u, torch.linalg.cross(n, u), n], dim=-1)  # columns

    Fp, Fq = frame(ps), frame(qs)
    R = torch.sum(Fq[..., :, None, :] * Fp[..., None, :, :], dim=-1)
    t = torch.mean(qs, dim=-2) - matvec3(R, torch.mean(ps, dim=-2))
    return make_transform(t, R)


def _edges(tri):
    return torch.stack([
        torch.linalg.vector_norm(tri[..., 1, :] - tri[..., 0, :], dim=-1),
        torch.linalg.vector_norm(tri[..., 2, :] - tri[..., 1, :], dim=-1),
        torch.linalg.vector_norm(tri[..., 0, :] - tri[..., 2, :], dim=-1)], dim=-1)


def ransac_feature_registration(src: Cloud, src_feat, tgt: Cloud, tgt_feat,
                                params: GlobalRegParams, generator=None, *,
                                sel: torch.Tensor | None = None):
    """Coarse (B, 4, 4) transforms and their (B,) scores from FPFH
    correspondences and batched 3-point RANSAC.

    ``generator``: a CPU ``torch.Generator``, drawn from for the pairs in
    turn; or pass ``sel`` (B, H, 3), the source rows of each hypothesis.
    Scoring is MSAC at tau = min(distance_threshold, 1) m over every
    mutual match, in hypothesis chunks that keep the (B, C, S, 3)
    transformed sources under SCORE_ELEMS; the best score wins (first on
    a tie)."""
    corr_idx, mutual = _feature_correspondences(src_feat, src.mask,
                                                tgt_feat, tgt.mask)
    B, S, _ = src.points.shape
    rows = torch.arange(B, device=src.points.device)
    q_of_src = tgt.points[rows[:, None], corr_idx]            # (B, S, 3)
    if sel is None:
        if generator is None:
            raise ValueError("ransac_feature_registration needs a generator or sel")
        H = params.num_hypotheses
        u = uniform_draws(generator, B, (H * 3,), src.points.device)
        sel = choose_uniform(u, mutual).view(B, H, 3)
    sel = sel.to(device=src.points.device, dtype=torch.int64)
    ps = src.points[rows[:, None, None], sel]                 # (B, H, 3, 3)
    qs = q_of_src[rows[:, None, None], sel]
    ep, eq = _edges(ps), _edges(qs)
    sim = params.edge_length_similarity
    ok_edge = torch.all((ep > sim * eq) & (eq > sim * ep) & (ep > 1e-3), dim=-1)
    T = _three_point_transform(ps, qs)                        # (B, H, 4, 4)

    tau2 = min(params.distance_threshold, 1.0) ** 2
    w_mutual = mutual.to(src.points.dtype)[:, None]
    chunk = max(1, SCORE_ELEMS // (B * S * 3))
    score = []
    for h0 in range(0, T.shape[1], chunk):
        p = transform_points(T[:, h0:h0 + chunk], src.points[:, None])
        d2 = torch.sum((p - q_of_src[:, None]) ** 2, dim=-1)
        score.append(torch.sum(torch.clamp(1.0 - d2 / tau2, min=0.0) * w_mutual, dim=-1))
    score = torch.cat(score, dim=1) * ok_edge
    best = torch.argmax(score, dim=-1)
    return T[rows, best], score[rows, best]


def global_registration(src: Cloud, tgt: Cloud,
                        params: GlobalRegParams = GlobalRegParams(),
                        generator=None, *,
                        src_nonground: Cloud | None = None,
                        tgt_nonground: Cloud | None = None,
                        src_feat: torch.Tensor | None = None,
                        tgt_feat: torch.Tensor | None = None,
                        sel: torch.Tensor | None = None) -> ICPResult:
    """The fpfh method (reference keyframe.py:297-345) for B pairs: FPFH on
    the non-ground clouds, RANSAC coarse alignment, then point-to-plane ICP
    on the full clouds from the coarse transform.

    ``src_feat``/``tgt_feat`` (B, CAP, 33): descriptors already computed
    for these non-ground clouds (a scan's descriptors depend on that scan
    alone, so a caller registering many pairs computes them once per
    scan)."""
    sng = src_nonground or src
    tng = tgt_nonground or tgt
    if src_feat is None:
        src_feat = compute_fpfh(sng, params.fpfh_radius)
    if tgt_feat is None:
        tgt_feat = compute_fpfh(tng, params.fpfh_radius)
    T0, _ = ransac_feature_registration(sng, src_feat, tng, tgt_feat, params,
                                        generator, sel=sel)
    return icp_batch(src.points, src.mask, tgt.points, tgt.mask, tgt.normals,
                     T0, params.icp, "point_to_plane")


def scan_features(points, normals, nonground_mask, radius: float, batch: int):
    """(N, CAP, 33) FPFH descriptors of every scan's non-ground cloud,
    ``batch`` scans a call."""
    return torch.cat([
        compute_fpfh(Cloud(points[k:k + batch], nonground_mask[k:k + batch],
                           normals[k:k + batch]), radius)
        for k in range(0, points.shape[0], batch)])


def fpfh_pairs(points, mask, normals, nonground_mask, feats, si, ti,
               params: GlobalRegParams, generator):
    """``global_registration`` of the pairs (source scan si[k] onto target
    scan ti[k]) of a stack of split scans, from their descriptors
    ``feats`` (N, CAP, 33)."""
    return global_registration(
        Cloud(points[si], mask[si], normals[si]),
        Cloud(points[ti], mask[ti], normals[ti]), params, generator,
        src_nonground=Cloud(points[si], nonground_mask[si], normals[si]),
        tgt_nonground=Cloud(points[ti], nonground_mask[ti], normals[ti]),
        src_feat=feats[si], tgt_feat=feats[ti])
