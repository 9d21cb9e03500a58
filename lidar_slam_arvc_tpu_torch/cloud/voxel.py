"""Voxel-grid downsampling with static shapes.

Counterpart of ``lidar_slam_arvc_tpu/cloud/voxel.py``: each occupied
voxel becomes the centroid of its points.  The packed key is the
reference's, bit for bit: ``x << 21 | y << 10 | z`` in int32, so x-cells
>= 1024 land on the sign bit and sort first, and output rows come out in
the same key order (the ball-moment kernel's tile skipping depends on
it).  Per-voxel sums are a deterministic sorted-segment sum: a float64
prefix sum over the key-sorted points, differenced at the run bounds —
no atomics, so centroids are the same on every run.
"""

from __future__ import annotations

import torch

from lidar_slam_arvc_tpu_torch.cloud.cloud import Cloud

# key packing: 11 bits x | 11 bits y | 10 bits z  (32-bit total)
_BITS_X, _BITS_Y, _BITS_Z = 11, 11, 10
_KEY_MAX = 2 ** 31 - 1


def addressable_extent(voxel_size: float) -> tuple[float, float]:
    """(xy, z) metres addressable by the packed key at this cell size."""
    return ((2 ** _BITS_X - 1) * voxel_size, (2 ** _BITS_Z - 1) * voxel_size)


def voxel_keys(points: torch.Tensor, valid: torch.Tensor,
               voxel_size: float) -> torch.Tensor:
    """(..., N) int32 packed voxel keys; invalid points get 2**31 - 1."""
    vsize = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    masked = torch.where(valid[..., None], points, torch.inf)
    mins = masked.amin(dim=-2, keepdim=True)
    mins = torch.where(torch.isfinite(mins), mins, 0.0)
    ijk = torch.floor((points - mins) / vsize).to(torch.int32)
    hi = torch.tensor([2 ** _BITS_X - 1, 2 ** _BITS_Y - 1, 2 ** _BITS_Z - 1],
                      dtype=torch.int32, device=points.device)
    ijk = torch.minimum(torch.clamp(ijk, min=0), hi)
    key = ((ijk[..., 0] << (_BITS_Y + _BITS_Z))
           | (ijk[..., 1] << _BITS_Z)
           | ijk[..., 2])
    return torch.where(valid, key, _KEY_MAX)


def voxel_downsample_counted(cloud: Cloud, voxel_size: float,
                             out_capacity: int | None = None):
    """Centroid-per-voxel downsample of (B, N, 3) or (N, 3) clouds.

    Returns (Cloud, n_voxels): ``n_voxels`` is the occupied-voxel count
    BEFORE capacity truncation; when it exceeds ``out_capacity`` the tail
    voxels (highest keys) are dropped.
    """
    batched = cloud.points.dim() == 3
    pts = cloud.points if batched else cloud.points[None]
    valid = cloud.mask if batched else cloud.mask[None]
    B, N, _ = pts.shape
    cap = N if out_capacity is None else out_capacity
    dev = pts.device

    key = voxel_keys(pts, valid, voxel_size)
    key_s, order = torch.sort(key, dim=1, stable=True)
    valid_s = torch.gather(valid, 1, order)
    pts_s = torch.gather(pts, 1, order[..., None].expand(B, N, 3))

    first = valid_s.clone()
    first[:, 1:] &= key_s[:, 1:] != key_s[:, :-1]
    n_voxels = first.sum(1)                                   # (B,)
    n_valid = valid_s.sum(1)                                  # valid rows lead

    # run start row of each voxel, in key order; slot n_voxels holds the end
    # of the last run (= n_valid), unused slots too
    seg = torch.cumsum(first.to(torch.int64), dim=1) - 1
    starts = n_valid[:, None].expand(B, N + 1).clone()
    slot = torch.where(first, seg, torch.full_like(seg, N))
    pos = torch.arange(N, device=dev).expand(B, N)
    starts.scatter_(1, slot, torch.where(first, pos, n_valid[:, None]))
    lo, hi = starts[:, :-1], starts[:, 1:]

    # float64 exclusive prefix sums of (x, y, z, 1) over the sorted rows,
    # laid out (B, 4, N) so the scan runs along the innermost axis (a scan
    # along a middle axis took ~11 ms per batch of 4 x 65536 on an H100)
    vals = torch.cat([pts_s.to(torch.float64).transpose(1, 2),
                      torch.ones((B, 1, N), dtype=torch.float64, device=dev)],
                     dim=1) * valid_s[:, None, :]
    csum = torch.cat([torch.zeros_like(vals[..., :1]),
                      torch.cumsum(vals, dim=-1)], dim=-1)    # (B, 4, N+1)
    sums = (torch.gather(csum, 2, hi[:, None, :].expand(B, 4, N))
            - torch.gather(csum, 2, lo[:, None, :].expand(B, 4, N)))
    centroids = (sums[:, :3] / torch.clamp(sums[:, 3:], min=1.0))
    centroids = centroids.transpose(1, 2).to(torch.float32).contiguous()

    if cap > N:
        centroids = torch.cat(
            [centroids, centroids.new_zeros((B, cap - N, 3))], dim=1)
    centroids = centroids[:, :cap]
    out_mask = (torch.arange(cap, device=dev)[None, :]
                < torch.clamp(n_voxels, max=cap)[:, None])
    out = Cloud(points=torch.where(out_mask[..., None], centroids, 0.0),
                mask=out_mask)
    n_voxels = n_voxels.to(torch.int32)
    if not batched:
        return Cloud(out.points[0], out.mask[0]), n_voxels[0]
    return out, n_voxels


def voxel_downsample(cloud: Cloud, voxel_size: float,
                     out_capacity: int | None = None) -> Cloud:
    """``voxel_downsample_counted`` without the occupancy count."""
    return voxel_downsample_counted(cloud, voxel_size, out_capacity)[0]
