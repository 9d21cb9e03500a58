"""Scan preprocessing for the reference, in plain torch: crop, voxel
centroids (or every point at full resolution) and ball-covariance normals.

The semantics are those the program states: the radius/height crop with
strict bounds, a voxel grid whose origin is the cropped cloud's minimum
corner with one centroid per occupied voxel, and per point the
smallest-eigenvector of the covariance of the neighbours within the
radius (self included, ``d^2 <= r^2``), facing the sensor origin, +z where
fewer than 3 neighbours.  Covariances and eigenvectors in float64.
"""

from __future__ import annotations

import torch

# a voxel cell's packed key (11 | 11 | 10 bits), used only to keep the
# same voxels the program keeps when a scan has more than the capacity
_HI = (2 ** 11 - 1, 2 ** 11 - 1, 2 ** 10 - 1)


def crop(points: torch.Tensor, icp: dict) -> torch.Tensor:
    r2 = points[:, 0] ** 2 + points[:, 1] ** 2
    keep = ((r2 < icp["max_radius"] ** 2) & (r2 > icp["min_radius"] ** 2)
            & (points[:, 2] > icp["min_height"]) & (points[:, 2] < icp["max_height"]))
    return points[keep]


def voxel_centroids(points: torch.Tensor, size: float, capacity: int):
    """(centroids (V', 3) float32 with V' = min(V, capacity), V)."""
    ijk = torch.floor((points - points.amin(0)) / size).to(torch.int64)
    hi = torch.tensor(_HI, device=points.device)
    ijk = torch.minimum(torch.clamp(ijk, min=0), hi)
    key = (ijk[:, 0] << 21) | (ijk[:, 1] << 10) | ijk[:, 2]
    # the program's int32 key: x cells >= 1024 wrap to negative and sort first
    key = torch.where(key >= 2 ** 31, key - 2 ** 32, key)
    uniq, inv = torch.unique(key, return_inverse=True)
    sums = torch.zeros((len(uniq), 3), dtype=torch.float64, device=points.device)
    sums.index_add_(0, inv, points.double())
    n = torch.bincount(inv, minlength=len(uniq)).double()
    cent = (sums / n[:, None]).float()
    return cent[:capacity], len(uniq)


def normals(points: torch.Tensor, radius: float, block: int = 2048) -> torch.Tensor:
    """(N, 3) unit normals of an (N, 3) cloud."""
    out = []
    r2 = radius * radius
    order = torch.argsort(points[:, 0])
    points = points[order]
    for q0 in range(0, len(points), block):
        q = points[q0:q0 + block]
        # a slab of candidates around the block keeps the pair tensor small
        lo, hi = q[:, 0].amin() - radius, q[:, 0].amax() + radius
        cand = points[(points[:, 0] >= lo) & (points[:, 0] <= hi)]
        d = (cand[None, :, :] - q[:, None, :]).double()
        w = ((d * d).sum(-1) <= r2).double()
        n = w.sum(-1)
        m = (w[..., None] * d).sum(1) / n[:, None]
        S = torch.einsum("qc,qci,qcj->qij", w, d, d) / n[:, None, None]
        C = S - m[:, :, None] * m[:, None, :]
        _, vec = torch.linalg.eigh(C)
        nrm = vec[..., 0]
        nrm = torch.where(((nrm * q.double()).sum(-1) > 0)[:, None], -nrm, nrm)
        ez = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=q.device)
        out.append(torch.where((n < 3)[:, None], ez, nrm))
    result = torch.empty_like(points)
    result[order] = torch.cat(out).float()
    return result


def uniform(points: torch.Tensor, capacity: int):
    """(the points kept, n): all n points when they fit, else exactly
    ``capacity`` of them spread uniformly over the order, rank r kept iff
    floor((r + 1) k / n) > floor(r k / n) (the program's rule)."""
    n = len(points)
    k = min(n, capacity)
    r = torch.arange(n, device=points.device)
    return points[(r + 1) * k // max(n, 1) > r * k // max(n, 1)], n


def preprocess(raw: torch.Tensor, icp: dict, voxel_size):
    """(points (N, 3) f32, normals (N, 3) f32, occupied voxels or points)
    of one raw scan: the first ``raw_capacity`` returns, cropped, voxelised
    (``voxel_size`` None: every point, or a uniform ``capacity`` of them)."""
    pts = crop(raw[:icp["raw_capacity"]].float(), icp)
    if voxel_size is None:
        pts, n = uniform(pts, icp["capacity"])
    else:
        pts, n = voxel_centroids(pts, voxel_size, icp["capacity"])
    radius = icp["normal_radius"]
    if voxel_size is not None:
        radius = max(radius, 2.5 * voxel_size)
    return pts, normals(pts, radius), n
