"""Stage 1: odometry-seeded sequential scan matching, batched on the card.

Counterpart of ``lidar_slam_arvc_tpu/pipeline/scanmatcher.py``
(``run_scanmatcher`` with its single-device fused matcher): read and
time-sample the LiDAR scans, associate odometry, seed each consecutive
pair's ICP with the relative odometry transform, fold the refined relative
transforms into a global trajectory in float64, and write the three
scanmatcher CSVs and ``robot0/viz/scanmatcher_profile.json``.

Path: PCD load (thread pool) -> per batch of ``cfg.batch_size`` scans on
the device: crop, voxel downsample (or compaction), normals (K2) -> ICP
over groups of ``cfg.batch_size`` consecutive pairs (``match_all``; K1 once
per iteration per group, or the search ``nn_impl`` names) -> divergence
gate -> fold -> CSVs.

Not ported yet (they raise): mid-stage checkpointing, device meshes and
multi-host runs, the streamed load, and the icp2planes/fpfh methods.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import time

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.cloud.cloud import pad_numpy
from lidar_slam_arvc_tpu_torch.geom.hostmath import transforms_from_pose_columns_np
from lidar_slam_arvc_tpu_torch.io.euroc import TIME, EurocDataset
from lidar_slam_arvc_tpu_torch.io.pcd import read_pcd
from lidar_slam_arvc_tpu_torch.io.sampling import sample_times
from lidar_slam_arvc_tpu_torch.ops import _cuda
from lidar_slam_arvc_tpu_torch.pipeline.preprocess import METHODS, preprocess_batch
from lidar_slam_arvc_tpu_torch.registration.icp import ICPParams, icp_batch
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig


def prepare_experiment_data(euroc: EurocDataset, start_index: int,
                            delta_time: float):
    """Scan-time sampling + odometry/GPS association
    (reference run_scanmatcher.py:101-125)."""
    scan_times = euroc.read_csv("/robot0/lidar/data.csv")[TIME]
    scan_times = sample_times(scan_times, start_index=start_index,
                              delta_time=delta_time * 1e9)
    odo = euroc.read_csv("/robot0/odom/data.csv")
    odo_times = euroc.get_closest_times(scan_times, odo[TIME])
    odo = euroc.get_rows_at_times(odo, odo_times)
    try:
        gps = euroc.read_csv("/robot0/gps0/data.csv")
    except FileNotFoundError:
        gps_times, gps = None, None
    else:
        gps_times = euroc.get_closest_times(scan_times, gps[TIME])
        gps = euroc.get_rows_at_times(gps, gps_times)
    return scan_times, odo_times, gps_times, odo, gps


def relative_odometry(odo: dict) -> np.ndarray:
    """(N-1,4,4) float64 relative transforms from odometry rows."""
    xyz = np.stack([odo[k] for k in ("x", "y", "z")], axis=1).astype(np.float64)
    q = np.stack([odo[k] for k in ("qw", "qx", "qy", "qz")], axis=1).astype(np.float64)
    T = transforms_from_pose_columns_np(xyz, q)
    return np.einsum("nij,njk->nik", np.linalg.inv(T[:-1]), T[1:])


def load_scans(euroc: EurocDataset, scan_times, raw_capacity: int,
               max_workers: int = 4):
    """All PCDs as a padded (N, raw_capacity, 3) f32 stack + (N, raw) mask."""
    paths = [euroc.scan_pcd_path(t) for t in scan_times]
    pts = np.zeros((len(paths), raw_capacity, 3), dtype=np.float32)
    mask = np.zeros((len(paths), raw_capacity), dtype=bool)

    def load_one(i):
        return i, pad_numpy(read_pcd(paths[i]), raw_capacity)

    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        for i, (p, m) in ex.map(load_one, range(len(paths))):
            pts[i] = p
            mask[i] = m
    return pts, mask


def preprocess_all(raw_pts: np.ndarray, raw_mask: np.ndarray, cfg: IcpConfig,
                   method: str, voxel_size, device):
    """Preprocess every scan on ``device`` in batches of cfg.batch_size.

    Returns device tensors (points, mask, normals) of the whole stack and
    the host (N,) count of voxels dropped by the capacity per scan."""
    n = raw_pts.shape[0]
    B = cfg.batch_size
    outs = []
    for b0 in range(0, n, B):
        pts = torch.from_numpy(raw_pts[b0:b0 + B]).to(device)
        msk = torch.from_numpy(raw_mask[b0:b0 + B]).to(device)
        outs.append(preprocess_batch(pts, msk, cfg, method, voxel_size))
    points = torch.cat([o.points for o in outs])
    mask = torch.cat([o.mask for o in outs])
    normals = torch.cat([o.normals for o in outs])
    n_vox = torch.cat([o.n_voxels for o in outs]).cpu().numpy()
    overflow = np.maximum(n_vox - cfg.capacity, 0)
    if overflow.any():
        # never silent: the tail voxels beyond the capacity were dropped
        print(f"WARNING: {int((overflow > 0).sum())}/{n} scans exceed "
              f"capacity {cfg.capacity} (max occupied voxels "
              f"{int(n_vox.max())}, {int(overflow.sum())} voxels dropped) — "
              f"raise IcpConfig.capacity or coarsen voxel_size")
    return points, mask, normals, overflow


def match_all(points, mask, normals, idx_src, idx_tgt, seeds,
              params: ICPParams, method: str, batch: int):
    """ICP of every listed scan pair, in groups of ``batch``.

    Counterpart of the reference's ``_match_all_fused``: pair k matches
    source scan ``idx_src[k]`` to target scan ``idx_tgt[k]`` of the
    (N, C, 3) stack from seed ``seeds[k]``; the pair count must be a
    multiple of ``batch``.  ``params.nn_impl`` selects the correspondence
    search.  Returns device tensors (transforms (P, 4, 4), fitness,
    iterations, final_delta), each over the P pairs."""
    if len(idx_src) % batch:
        raise ValueError(f"{len(idx_src)} pairs are not whole groups of {batch}")
    outs = []
    for g0 in range(0, len(idx_src), batch):
        si, ti = idx_src[g0:g0 + batch], idx_tgt[g0:g0 + batch]
        outs.append(icp_batch(points[si], mask[si], points[ti], mask[ti],
                              normals[ti], seeds[g0:g0 + batch], params,
                              method))
    return tuple(torch.cat([getattr(r, f) for r in outs]) for f in
                 ("transform", "fitness", "iterations", "final_delta"))


def consecutive_pairs(n_scans: int, batch: int, T_seeds: np.ndarray):
    """(idx_src, idx_tgt, seeds f32) of the pairs (i+1 -> i), padded to a
    batch multiple with identity-seeded self-pairs of the last scan
    (computed, then discarded)."""
    n_pairs = n_scans - 1
    pad = (-n_pairs) % batch
    idx_src = np.concatenate([np.arange(1, n_pairs + 1), np.full(pad, n_pairs)])
    idx_tgt = np.concatenate([np.arange(0, n_pairs), np.full(pad, n_pairs)])
    seeds = np.concatenate(
        [T_seeds, np.tile(np.eye(4), (pad, 1, 1))]).astype(np.float32)
    return idx_src, idx_tgt, seeds


def fell_back(fitness: np.ndarray, final_delta: np.ndarray,
              min_fitness: float, params: ICPParams) -> np.ndarray:
    """Pairs that keep their seed: a low inlier fraction, or still moving
    by >= 100x the convergence tol when max_iterations ran out (the
    carried fitness predates the last update, so divergence there shows in
    final_delta)."""
    bad = fitness < min_fitness
    if params.convergence_tol > 0:
        bad |= final_delta > 100 * params.convergence_tol
    return bad


def match_consecutive(points, mask, normals, T_seeds: np.ndarray,
                      cfg: IcpConfig, method: str, progress: bool = True):
    """Batched ICP over consecutive pairs.

    Source = scan i+1, target = scan i.  Returns the (N-1,4,4) float64
    refined T_i_i+1 and per-pair host arrays (fitness, iterations,
    final_delta, fell_back) for the profile.
    """
    n_pairs = points.shape[0] - 1
    B = cfg.batch_size
    params = ICPParams(max_correspondence_distance=cfg.distance_threshold,
                       max_iterations=cfg.max_iterations,
                       source_stride=cfg.source_stride)
    icp_method = ("point_to_point" if method == "icppointpoint"
                  else "point_to_plane")
    dev = points.device
    idx_src, idx_tgt, seeds = consecutive_pairs(points.shape[0], B, T_seeds)
    T_all, fit, iters, delta = match_all(
        points, mask, normals, torch.from_numpy(idx_src).to(dev),
        torch.from_numpy(idx_tgt).to(dev), torch.from_numpy(seeds).to(dev),
        params, icp_method, B)
    T_all = T_all.cpu().numpy().astype(np.float64)[:n_pairs]
    fit = fit.cpu().numpy()[:n_pairs]
    iters = iters.cpu().numpy()[:n_pairs]
    delta = delta.cpu().numpy()[:n_pairs]
    bad = fell_back(fit, delta, cfg.min_fitness, params)
    if bad.any():
        T_all[bad] = seeds[:n_pairs][bad].astype(np.float64)
    if progress:
        print(f"scanmatch pairs {n_pairs}/{n_pairs} (groups of {B} on {dev})")
    return T_all, {"fitness": fit, "iterations": iters,
                   "final_delta": delta, "fell_back": bad}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _check_supported(cfg: IcpConfig, method: str) -> None:
    if cfg.checkpoint_batches > 0:
        raise NotImplementedError("mid-stage checkpointing is not ported yet "
                                  "(ROADMAP Queue 1, checkpoint/resume)")
    if cfg.mesh_devices != 1 or cfg.shard_scans:
        raise NotImplementedError("device meshes are not ported yet "
                                  "(ROADMAP M8)")
    if method not in METHODS:
        raise NotImplementedError(f"method {method!r} is not ported yet "
                                  "(ROADMAP M7)")


def run_scanmatcher(directory: str, cfg: IcpConfig | None = None,
                    progress: bool = True, device="cuda",
                    return_preprocessed: bool = False) -> dict:
    """Full stage 1 on ``device``; writes the scanmatcher CSVs and the
    profile, and returns the trajectory.

    ``return_preprocessed=True`` also returns the preprocessed scan tensors
    under ``"preprocessed"``, with the fingerprint of every configuration
    field the preprocessing read, so that stage 2 can reuse them when it
    wants the same clouds (``pipeline.graphslam.run_graphslam``)."""
    device = _cuda.torch_device(device, "run_scanmatcher")
    euroc = EurocDataset(directory)
    sm_params = euroc.read_scanmatcher_parameters()
    start_index = sm_params.get("start_index", 0)
    delta_time = sm_params.get("delta_time", 0.5)
    voxel_size = sm_params.get("voxel_size", None)
    method = sm_params.get("method", "icppointplane")
    if cfg is None:
        cfg = IcpConfig()
    _check_supported(cfg, method)

    scan_times, _, _, odo, _ = prepare_experiment_data(
        euroc, start_index, delta_time)
    rel_odo = relative_odometry(odo)
    n = len(scan_times)
    launches0 = dict(_cuda.launch_counts)

    t_load = time.time()
    raw_pts, raw_mask = load_scans(euroc, scan_times, cfg.raw_capacity)
    points, mask, normals, overflow = preprocess_all(
        raw_pts, raw_mask, cfg, method, voxel_size, device)
    _sync(device)
    preprocess_seconds = time.time() - t_load
    if progress:
        print(f"loaded+preprocessed {n} scans in {preprocess_seconds:.2f}s")

    t_icp = time.time()
    rel_sm, stats = match_consecutive(points, mask, normals, rel_odo, cfg,
                                      method, progress=progress)
    icp_seconds = time.time() - t_icp

    # fold to global in float64 on the host
    T_global = np.empty((len(rel_sm) + 1, 4, 4))
    T_global[0] = np.eye(4)
    for i, Tij in enumerate(rel_sm):
        T_global[i + 1] = T_global[i] @ Tij

    iters = stats["iterations"]
    profile = {
        "load_preprocess_seconds": round(preprocess_seconds, 4),
        "icp_seconds": round(icp_seconds, 4),
        "pairs": int(len(rel_sm)),
        "frames_per_second": round(len(rel_sm) / max(icp_seconds, 1e-9), 3),
        "capacity": int(cfg.capacity),
        "scans_over_capacity": int((overflow > 0).sum()),
        "voxels_dropped_total": int(overflow.sum()),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "icp_iterations_mean": float(iters.mean()) if len(iters) else 0.0,
        "icp_iterations_max": int(iters.max()) if len(iters) else 0,
        "pairs_fallback_to_seed": int(stats["fell_back"].sum()),
        "kernel_launches": {k: v - launches0[k]
                            for k, v in _cuda.launch_counts.items()},
    }
    euroc.save_sensor_times_as_csv(scan_times,
                                   "/robot0/scanmatcher/lidar_times.csv")
    euroc.save_transforms_as_csv(scan_times, rel_sm,
                                 "/robot0/scanmatcher/scanmatcher_relative.csv")
    euroc.save_transforms_as_csv(scan_times, T_global,
                                 "/robot0/scanmatcher/scanmatcher_global.csv")
    os.makedirs(f"{directory}/robot0/viz", exist_ok=True)
    with open(f"{directory}/robot0/viz/scanmatcher_profile.json", "w") as f:
        json.dump(profile, f, indent=2)
    out = {"scan_times": scan_times, "relative": rel_sm,
           "global": T_global, "icp_seconds": icp_seconds,
           "frames_per_second": profile["frames_per_second"],
           "profile": profile}
    if return_preprocessed:
        out["preprocessed"] = {
            "points": points, "mask": mask, "normals": normals,
            "scan_times": scan_times, "voxel_size": voxel_size,
            "method": method, "capacity": int(cfg.capacity),
            "raw_capacity": int(cfg.raw_capacity),
            "crop": (float(cfg.min_radius), float(cfg.max_radius),
                     float(cfg.min_height), float(cfg.max_height)),
            "normal_radius": float(cfg.normal_radius)}
    return out
