"""Batched scan preprocessing: crop -> voxel downsample (or compaction) ->
normals (-> ground split).

Counterpart of ``lidar_slam_arvc_tpu/pipeline/preprocess.py``.  Under
``icp2planes`` and ``fpfh`` each scan's ground plane is RANSAC-fit below
-0.5 m (1000 hypotheses, 0.01 m inliers) and the scan split at 0.4 m into
ground and non-ground masks (reference :69-78).  Scan k of a batch draws
its hypotheses from ``generators[k]`` (``cloud.plane``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_slam_arvc_tpu_torch import cloud as cl
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
from lidar_slam_arvc_tpu_torch.utils.profiling import span

METHODS = ("icppointplane", "icppointpoint", "icp2planes", "fpfh")
SPLIT_METHODS = ("icp2planes", "fpfh")
# the ground planes' seed in stage 1 and in the keyframe store, as the
# reference's preprocessing seed (0 in both)
PLANE_SEED = 0


class PreprocessedScans(NamedTuple):
    """Stacked preprocessed scans (leading axis = scan index)."""
    points: torch.Tensor          # (N, CAP, 3)
    mask: torch.Tensor            # (N, CAP)
    normals: torch.Tensor         # (N, CAP, 3) — zeros if not needed
    ground_mask: torch.Tensor | None = None      # (N, CAP) icp2planes, fpfh
    nonground_mask: torch.Tensor | None = None   # (N, CAP)
    # occupied voxels (or valid points) BEFORE capacity truncation
    n_voxels: torch.Tensor | None = None         # (N,) int32


def check_voxel_extent(cfg: IcpConfig, voxel_size: float) -> None:
    """Reject a grid too fine for the 32-bit key to address the crop."""
    ext_xy, ext_z = cl.addressable_extent(voxel_size)
    if 2 * cfg.max_radius > ext_xy or (cfg.max_height - cfg.min_height) > ext_z:
        raise ValueError(
            f"voxel_size={voxel_size} cannot address the cropped "
            f"extent ({2 * cfg.max_radius:.1f} m xy, "
            f"{cfg.max_height - cfg.min_height:.1f} m z) within the "
            f"32-bit key ({ext_xy:.1f} x {ext_z:.1f} m); coarsen the "
            "voxel size or tighten the crop")


def preprocess_batch(raw_pts: torch.Tensor, raw_mask: torch.Tensor,
                     cfg: IcpConfig, method: str,
                     voxel_size: float | None,
                     generators=None) -> PreprocessedScans:
    """Preprocess a (B, RAW, 3) batch of raw scans on their device.

    ``generators``: one CPU ``torch.Generator`` per scan, for the ground
    plane's draws under icp2planes and fpfh."""
    if method not in METHODS:
        raise ValueError(f"unknown registration method {method!r}; "
                         f"expected one of {METHODS}")
    c = cl.Cloud(raw_pts, raw_mask)
    c = cl.crop_radius_height(c, cfg.min_radius, cfg.max_radius,
                              cfg.min_height, cfg.max_height)
    if voxel_size is not None:
        check_voxel_extent(cfg, voxel_size)
        c, n_vox = cl.voxel_downsample_counted(c, voxel_size,
                                               out_capacity=cfg.capacity)
    else:
        # full resolution: compact without merging
        with span("preprocess.compact"):
            c, n_vox = cl.compact_counted(c, out_capacity=cfg.capacity)

    # covariance normals need several ball neighbours; on a voxelised
    # cloud that means a radius of a few voxels
    normal_radius = cfg.normal_radius
    if voxel_size is not None:
        normal_radius = max(normal_radius, 2.5 * voxel_size)

    if method == "icppointpoint":
        return PreprocessedScans(points=c.points, mask=c.mask,
                                 normals=torch.zeros_like(c.points),
                                 n_voxels=n_vox)
    c = cl.estimate_normals(c, normal_radius)
    ground = nonground = None
    if method in SPLIT_METHODS:
        plane = cl.ransac_ground_plane(c, generators, seed_height=-0.5,
                                       distance_threshold=0.01,
                                       num_iterations=1000)
        ground, nonground = (x.mask for x in cl.split_by_plane(c, plane, 0.4))
    return PreprocessedScans(points=c.points, mask=c.mask, normals=c.normals,
                             n_voxels=n_vox, ground_mask=ground,
                             nonground_mask=nonground)
