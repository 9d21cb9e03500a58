"""Fixed-capacity cloud container, crop filter and compaction.

Counterpart of ``lidar_slam_arvc_tpu/cloud/cloud.py``.  Every function
takes optional leading batch dimensions: a batch of scans is one
``Cloud`` with (B, CAP, 3) points.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Cloud:
    """Padded point cloud: (..., CAP, 3) f32 points, (..., CAP) bool mask,
    optional (..., CAP, 3) f32 normals."""
    points: torch.Tensor
    mask: torch.Tensor
    normals: torch.Tensor | None = None


def from_arrays(points, mask, normals=None, device="cuda") -> Cloud:
    """A Cloud on ``device`` from host arrays, e.g. the JAX package's clouds
    or ``PreprocessedScans`` fields passed through ``np.asarray``.  The
    default is the card, as for every entry point of the port: with no
    card that raises; pass ``device="cpu"`` for the plain versions."""
    def t(a, dtype):
        # np.array copies: arrays handed over from JAX are read-only
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return Cloud(points=t(points, torch.float32), mask=t(mask, torch.bool),
                 normals=None if normals is None else t(normals, torch.float32))


def pad_numpy(points: np.ndarray, capacity: int):
    """Pad/truncate (N, 3) host points to ``capacity`` rows + mask.

    Truncation keeps a uniform stride of points (not a prefix) so a scan
    denser than the capacity degrades like uniform downsampling."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    if n > capacity:
        idx = np.linspace(0, n - 1, capacity).round().astype(np.int64)
        points = points[idx]
        n = capacity
    buf = np.zeros((capacity, 3), dtype=np.float32)
    buf[:n] = points
    mask = np.zeros(capacity, dtype=bool)
    mask[:n] = True
    return buf, mask


def from_numpy(points: np.ndarray, capacity: int, device="cuda") -> Cloud:
    """Pad/truncate an (N, 3) host array into a fixed-capacity Cloud on
    ``device`` (the card unless the caller names another)."""
    buf, mask = pad_numpy(points, capacity)
    return from_arrays(buf, mask, device=device)


def to_numpy(cloud: Cloud):
    """Valid points as a host (N, 3) array; for a batched (B, CAP) cloud, a
    list of B such arrays, one per scan (their N differ).  More leading
    dimensions raise ``ValueError``."""
    pts = cloud.points.detach().cpu().numpy()
    mask = cloud.mask.detach().cpu().numpy()
    if mask.ndim == 1:
        return pts[mask]
    if mask.ndim == 2:
        return [p[m] for p, m in zip(pts, mask)]
    raise ValueError(f"to_numpy: a cloud of mask shape {tuple(mask.shape)}; "
                     "expected (CAP,) or (B, CAP)")


def num_valid(cloud: Cloud) -> torch.Tensor:
    """Valid points per cloud: the int32 sum of the mask over its last axis
    (a 0-d tensor for one cloud, (B,) for a batch)."""
    return torch.sum(cloud.mask, dim=-1, dtype=torch.int32)


def crop_radius_height(cloud: Cloud, min_radius: float, max_radius: float,
                       min_height: float, max_height: float) -> Cloud:
    """Keep points with min_r < sqrt(x^2+y^2) < max_r and min_h < z < max_h
    (mask-only update)."""
    x, y, z = cloud.points.unbind(-1)
    r2 = x * x + y * y
    keep = ((r2 < max_radius ** 2) & (r2 > min_radius ** 2)
            & (z > min_height) & (z < max_height))
    return Cloud(points=cloud.points, mask=cloud.mask & keep,
                 normals=cloud.normals)


def compact_counted(cloud: Cloud, out_capacity: int | None = None):
    """Compact valid points into a fixed-capacity prefix WITHOUT merging.

    Returns (Cloud, n) with n the pre-truncation valid count per cloud.
    If more than ``out_capacity`` points are valid a uniform stride over
    the valid points is kept; output points are always a subset of the
    input points, in their original order.
    """
    capacity = cloud.points.shape[-2]
    if out_capacity is None:
        out_capacity = capacity
    if out_capacity > capacity:
        raise ValueError(
            f"compact_counted: out_capacity {out_capacity} exceeds the "
            f"input capacity {capacity}; pad the input cloud instead")
    # the reference's uniform selection runs in int32; keep its guard so
    # both packages accept the same shapes
    if capacity * out_capacity >= 2 ** 31:
        raise ValueError(
            f"compact_counted: capacity {capacity} x out_capacity "
            f"{out_capacity} overflows the int32 uniform-selection "
            "arithmetic; reduce capacities or add a chunked path")
    valid = cloud.mask
    v64 = valid.to(torch.int64)
    n = v64.sum(-1, keepdim=True)
    k = torch.clamp(n, max=out_capacity)
    # rank r among the valid points is kept iff floor((r+1)k/n) >
    # floor(rk/n): exactly k of the n valid points, uniformly
    rank = torch.cumsum(v64, dim=-1) - 1
    nn = torch.clamp(n, min=1)
    sel = valid & ((rank + 1) * k // nn > rank * k // nn)
    # stable partition: selected points to the front, original order kept
    order = torch.argsort((~sel).to(torch.int8), dim=-1, stable=True)
    order = order[..., :out_capacity]
    pts = torch.gather(cloud.points, -2,
                       order[..., None].expand(order.shape + (3,)))
    out_mask = torch.arange(out_capacity, device=valid.device) < k
    return (Cloud(points=torch.where(out_mask[..., None], pts, 0.0),
                  mask=out_mask),
            n[..., 0].to(torch.int32))
