"""Stage 1: odometry-seeded sequential scan matching, batched on the card.

Counterpart of ``lidar_slam_arvc_tpu/pipeline/scanmatcher.py``
(``run_scanmatcher`` with its single-device fused matcher): read and
time-sample the LiDAR scans, associate odometry, seed each consecutive
pair's ICP with the relative odometry transform, fold the refined relative
transforms into a global trajectory in float64, and write the three
scanmatcher CSVs and ``robot0/viz/scanmatcher_profile.json``.

Path: streamed load (``load_and_preprocess_streamed``: one IO thread
decodes chunk k+1 with the native PCD parser, ``io/native.py``, into
pinned host memory while the device preprocesses chunk k) -> per batch of
``cfg.batch_size`` scans on the device: crop, voxel downsample (or
compaction), normals (K2), and the ground split under icp2planes/fpfh ->
registration over groups of ``cfg.batch_size`` consecutive pairs: ICP
(``match_all``; K1 once per iteration per group, or the search ``nn_impl``
names), the two-plane ICP (one ICP batch of twice the pairs) or FPFH +
RANSAC + ICP (the descriptors computed once per scan) -> divergence gate
-> fold -> CSVs.  With ``IcpConfig.checkpoint_batches > 0`` each group's
result comes to the host after the group and ``robot0/scanmatcher/
checkpoint.npz`` is saved, in the reference's format, so that an
interrupted stage resumes where it stopped (in either package).

Draws (icp2planes, fpfh): scan i's ground plane from
``seeded_generator(seed, i)``, i the scan's index in the whole sequence,
whatever the batch or chunk; the fpfh matcher's group b of pairs from
``torch.Generator().manual_seed(b)``, as the reference keys its group b
with ``PRNGKey(b)``, resumed or not.

Over N ranks (``IcpConfig.mesh_devices``; ``parallel/mesh.py``) the plain
ICP methods split the pairs: every rank holds the whole scan stack and
registers its contiguous share of the pair groups, or, with
``shard_scans``, loads and preprocesses only its own contiguous block of
scans and takes the next rank's first scan as a halo.  The results are
gathered to every rank and gated there; rank 0 alone writes the files and
the mid-stage checkpoint is off (it would be a file per rank).  The
other methods run whole in every rank.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import json
import os
import time
import zipfile

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.cloud.cloud import pad_numpy
from lidar_slam_arvc_tpu_torch.geom.hostmath import transforms_from_pose_columns_np
from lidar_slam_arvc_tpu_torch.io import native
from lidar_slam_arvc_tpu_torch.io.euroc import TIME, EurocDataset
from lidar_slam_arvc_tpu_torch.io.pcd import read_pcd
from lidar_slam_arvc_tpu_torch.io.sampling import sample_times
from lidar_slam_arvc_tpu_torch.ops import _cuda
from lidar_slam_arvc_tpu_torch.ops.draws import seeded_generator
from lidar_slam_arvc_tpu_torch.ops.nn import swept_pairs
from lidar_slam_arvc_tpu_torch.parallel import mesh as _mesh
from lidar_slam_arvc_tpu_torch.pipeline.preprocess import (
    METHODS, PLANE_SEED, SPLIT_METHODS, PreprocessedScans, preprocess_batch,
)
from lidar_slam_arvc_tpu_torch.registration.global_reg import (
    GlobalRegParams, fpfh_pairs, scan_features,
)
from lidar_slam_arvc_tpu_torch.registration.icp import ICPParams, icp_batch, two_planes_pairs
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
from lidar_slam_arvc_tpu_torch.utils import profiling
from lidar_slam_arvc_tpu_torch.utils.profiling import BuildCounter, StageTimer, span

# the methods whose pairs split over a mesh (the reference's scanmatcher.py:358-360)
MESH_METHODS = ("icppointplane", "icppointpoint")


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


def _load_paths(paths, raw_capacity: int, out: np.ndarray | None = None,
                max_workers: int = 4):
    """Decode PCDs into a padded (n, raw_capacity, 3) f32 stack.

    The native batch parser reads binary and binary_compressed files (a
    file's first ``raw_capacity`` points); a file it rejects (ASCII, a parse
    error) is parsed in Python and padded with ``pad_numpy``, as in the
    reference (scanmatcher.py:75-104).  ``out``: the array to decode into.
    Returns (points, counts (n,) int64, number of files parsed in Python)."""
    pts, counts = native.read_pcd_batch(paths, raw_capacity, out=out)
    rejected = np.nonzero(counts < 0)[0]
    if len(rejected):
        def load_one(i):
            return i, pad_numpy(read_pcd(paths[i]), raw_capacity)

        with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
            for i, (p, m) in ex.map(load_one, rejected):
                pts[i] = p
                counts[i] = int(m.sum())
    return pts, counts, len(rejected)


def load_scans(euroc: EurocDataset, scan_times, raw_capacity: int,
               max_workers: int = 4):
    """All PCDs as a padded (N, raw_capacity, 3) f32 stack + (N, raw) mask
    (the native batch parser; the files it rejects in Python, on
    ``max_workers`` threads)."""
    pts, counts, _ = _load_paths([euroc.scan_pcd_path(t) for t in scan_times],
                                 raw_capacity, max_workers=max_workers)
    return pts, np.arange(raw_capacity)[None, :] < counts[:, None]


def _preprocess_into(outs: list, pts, mask, first: int, cfg: IcpConfig,
                     method: str, voxel_size, seed: int) -> None:
    """Preprocess device stacks ``pts``/``mask`` of scans ``first``,
    ``first`` + 1, ... in batches of cfg.batch_size, appending each batch's
    ``PreprocessedScans`` to ``outs``.  Scan i draws its ground plane from
    ``seeded_generator(seed, i)``."""
    B = cfg.batch_size
    n = pts.shape[0]
    for b0 in range(0, n, B):
        gens = ([seeded_generator(seed, first + i)
                 for i in range(b0, min(b0 + B, n))]
                if method in SPLIT_METHODS else None)
        with span("preprocess.batch"):
            outs.append(preprocess_batch(pts[b0:b0 + B], mask[b0:b0 + B], cfg,
                                         method, voxel_size, gens))


def _assemble(outs: list, cfg: IcpConfig):
    """The whole stack from its batches, the host (N,) count of voxels
    dropped by the capacity per scan and the host (N,) count of each
    scan's valid points (the one host read of the stage).

    Counts (``utils.profiling.counts``), from that read: the scans' voxels
    (at full resolution, cropped points) before the capacity in
    ``scan_points_valid``, and those the capacity keeps in
    ``scan_points_kept``."""
    scans = PreprocessedScans(*(
        None if outs[0][k] is None else torch.cat([o[k] for o in outs])
        for k in range(len(outs[0]))))
    n = scans.points.shape[0]
    with span("sync.voxel_counts"):
        n_vox = scans.n_voxels.cpu().numpy()
    kept = np.minimum(n_vox, cfg.capacity)
    profiling.count("scan_points_valid", int(n_vox.sum(dtype=np.int64)))
    profiling.count("scan_points_kept", int(kept.sum(dtype=np.int64)))
    overflow = np.maximum(n_vox - cfg.capacity, 0)
    if overflow.any():
        # never silent: the tail voxels beyond the capacity were dropped
        print(f"WARNING: {int((overflow > 0).sum())}/{n} scans exceed "
              f"capacity {cfg.capacity} (max occupied voxels "
              f"{int(n_vox.max())}, {int(overflow.sum())} voxels dropped) — "
              f"raise IcpConfig.capacity or coarsen voxel_size")
    return scans, overflow, kept


def preprocess_all(raw_pts: np.ndarray, raw_mask: np.ndarray, cfg: IcpConfig,
                   method: str, voxel_size, seed: int = PLANE_SEED,
                   device="cuda"):
    """Preprocess every scan of a loaded stack on ``device`` in batches of
    cfg.batch_size (the two-phase path: ``load_scans`` first).

    Returns the whole stack as ``PreprocessedScans`` of device tensors and
    the host (N,) count of voxels dropped by the capacity per scan."""
    device = _cuda.torch_device(device, "preprocess_all")
    outs = []
    B = cfg.batch_size
    for b0 in range(0, raw_pts.shape[0], B):
        _preprocess_into(outs, torch.from_numpy(raw_pts[b0:b0 + B]).to(device),
                         torch.from_numpy(raw_mask[b0:b0 + B]).to(device), b0,
                         cfg, method, voxel_size, seed)
    return _assemble(outs, cfg)[:2]


def load_and_preprocess_streamed(euroc: EurocDataset, scan_times,
                                 cfg: IcpConfig, method: str, voxel_size,
                                 seed: int = PLANE_SEED,
                                 chunk_scans: int | None = None, device="cuda",
                                 first: int = 0):
    """Chunked PCD loading pipelined with device preprocessing (reference
    scanmatcher.py:128-170).

    Scans stream in chunks of ``chunk_scans`` (default ``max(8 B, 32)``,
    rounded up to a multiple of B) with one chunk of lookahead: one IO
    thread decodes chunk k+1 with the native parser, which releases the
    interpreter lock, while this thread dispatches chunk k's preprocessing.
    On a card a chunk is decoded into pinned host memory and copied with
    ``non_blocking``, so the copy does not hold the thread either.  The
    batches, the draws and so the output are those of ``load_scans`` +
    ``preprocess_all``.  ``first``: the index in the whole sequence of
    ``scan_times[0]`` (a rank's block), which keys the draws.  Returns
    (``PreprocessedScans``, overflow (N,), number of files parsed in
    Python).

    Counts (``utils.profiling.counts``): the decode thread's seconds in
    ``pcd_decode_seconds``, this thread's seconds blocked on it (span
    ``pcd.wait``) in ``pcd_wait_seconds``."""
    return _streamed(euroc, scan_times, cfg, method, voxel_size, seed,
                     chunk_scans, device, first)[:3]


def _streamed(euroc, scan_times, cfg, method, voxel_size, seed, chunk_scans,
              device, first):
    """``load_and_preprocess_streamed``, and the host (N,) count of each
    scan's valid points last."""
    device = _cuda.torch_device(device, "load_and_preprocess_streamed")
    B = cfg.batch_size
    if chunk_scans is None:
        chunk_scans = max(8 * B, 32)
    chunk_scans = -(-chunk_scans // B) * B
    paths = [euroc.scan_pcd_path(t) for t in scan_times]
    raw = cfg.raw_capacity
    pinned = device.type == "cuda"

    def load(lo):
        t0 = time.perf_counter()
        part = paths[lo:lo + chunk_scans]
        buf = torch.empty((len(part), raw, 3), dtype=torch.float32,
                          pin_memory=pinned)
        _, counts, n_python = _load_paths(part, raw, out=buf.numpy())
        # pinned as well: a pageable copy would wait for the device
        cnt = torch.empty(len(part), dtype=torch.int64, pin_memory=pinned)
        cnt.numpy()[:] = counts
        profiling.count("pcd_decode_seconds", time.perf_counter() - t0)
        return buf, cnt, n_python

    outs = []
    n_python = 0
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(load, 0)
        for lo in range(0, len(paths), chunk_scans):
            t0 = time.perf_counter()
            with span("pcd.wait"):
                buf, counts, k = fut.result()
            profiling.count("pcd_wait_seconds", time.perf_counter() - t0)
            if lo + chunk_scans < len(paths):
                fut = ex.submit(load, lo + chunk_scans)
            n_python += k
            pts = buf.to(device, non_blocking=True)
            mask = (torch.arange(raw, device=device)
                    < counts.to(device, non_blocking=True)[:, None])
            _preprocess_into(outs, pts, mask, first + lo, cfg, method,
                             voxel_size, seed)
    scans, overflow, n_valid = _assemble(outs, cfg)
    return scans, overflow, n_python, n_valid


def _by_groups(n_pairs: int, batch: int, register):
    """``register(g, sl)`` -> ICPResult for group g (pairs ``sl``) of
    ``batch`` pairs, over every group; returns device tensors
    (transforms (P, 4, 4), fitness, iterations, final_delta)."""
    if n_pairs % batch:
        raise ValueError(f"{n_pairs} pairs are not whole groups of {batch}")
    outs = [register(g, slice(g0, g0 + batch))
            for g, g0 in enumerate(range(0, n_pairs, batch))]
    return tuple(torch.cat([getattr(r, f) for r in outs]) for f in
                 ("transform", "fitness", "iterations", "final_delta"))


def _icp_register(points, mask, normals, idx_src, idx_tgt, seeds,
                  params: ICPParams, method: str, valid=None):
    """``register(g, sl)``: the ICP of the listed pairs ``sl``.

    ``valid``: host (P,) valid source and (P,) valid target points of each
    pair (a prefix of its rows), or None; given, every ICP step's K1 sweep
    adds the pairs it scores to ``k1_pairs_swept`` and the group's valid
    source x valid target pairs to ``k1_pairs_valid``
    (``utils.profiling.counts``).  On a card K1 scores the source blocks
    and target tiles that hold a valid point (``ops.nn.swept_pairs``, at
    the geometry the kernel library reports); on the CPU its plain version
    scores every source x target slot."""
    C = points.shape[1]
    S = -(-C // params.source_stride)

    def swept(vs, vt):
        if points.device.type != "cuda":
            return len(vs) * S * C
        return swept_pairs(vs, vt, _cuda.sweep_geometry(len(vs), S, C, points.device))

    def register(_, sl):
        si, ti = idx_src[sl], idx_tgt[sl]
        steps = profiling.counts["icp_steps"]
        res = icp_batch(points[si], mask[si], points[ti], mask[ti],
                        normals[ti], seeds[sl], params, method)
        if valid is not None:
            trips = profiling.counts["icp_steps"] - steps
            vs, vt = valid[0][sl], valid[1][sl]
            profiling.count("k1_pairs_swept", trips * swept(vs, vt))
            profiling.count("k1_pairs_valid", trips * int(np.dot(vs, vt)))
        return res
    return register


def match_all(points, mask, normals, idx_src, idx_tgt, seeds,
              params: ICPParams, method: str, batch: int):
    """ICP of every listed scan pair, in groups of ``batch``.

    Counterpart of the reference's ``_match_all_fused``: pair k matches
    source scan ``idx_src[k]`` to target scan ``idx_tgt[k]`` of the
    (N, C, 3) stack from seed ``seeds[k]``; the pair count must be a
    multiple of ``batch``.  ``params.nn_impl`` selects the correspondence
    search.  Returns device tensors (transforms (P, 4, 4), fitness,
    iterations, final_delta), each over the P pairs."""
    return _by_groups(len(idx_src), batch, _icp_register(
        points, mask, normals, idx_src, idx_tgt, seeds, params, method))


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


def read_checkpoint(path: str, key: int, n_pairs: int, batch: int):
    """(groups done, (n_pairs, 4, 4) float64 transforms) from a checkpoint
    of the same key, pair count and batch size, or (0, None) when there is
    none or it is unreadable (reference scanmatcher.py:414-430)."""
    if not os.path.exists(path):
        return 0, None
    try:
        with np.load(path) as ck:
            if (int(ck["key"]) != int(key) or int(ck["n_pairs"]) != n_pairs
                    or int(ck["batch_size"]) != batch):
                return 0, None
            done = int(ck["batches_done"])
            transforms = np.asarray(ck["transforms"], dtype=np.float64)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return 0, None
    if transforms.shape != (n_pairs, 4, 4) or done < 0:
        return 0, None
    return done, transforms


def write_checkpoint(path: str, key: int, n_pairs: int, batch: int,
                     batches_done: int, transforms: np.ndarray) -> None:
    """The reference's checkpoint (fields ``key, n_pairs, batch_size,
    batches_done, transforms``), written to a temporary file and renamed
    over ``path``, so that a crash leaves the previous one whole."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, key=key, n_pairs=n_pairs, batch_size=batch,
                 batches_done=batches_done, transforms=transforms)
    os.replace(tmp, path)


def _match_checkpointed(register, n_groups: int, n_pairs: int, B: int,
                        seeds: np.ndarray, cfg: IcpConfig, params: ICPParams,
                        path: str, key: int, progress: bool):
    """Group by group, each group's result on the host after it and the
    checkpoint saved; groups a matching checkpoint holds are not run again.
    Their fitness, iterations and final_delta are unknown (NaN, -1, NaN)
    and they count as not fallen back."""
    T_out = np.zeros((n_pairs, 4, 4))
    fit = np.full(n_pairs, np.nan, dtype=np.float32)
    iters = np.full(n_pairs, -1, dtype=np.int32)
    delta = np.full(n_pairs, np.nan, dtype=np.float32)
    bad = np.zeros(n_pairs, dtype=bool)
    start, saved = read_checkpoint(path, key, n_pairs, B)
    start = min(start, n_groups)
    if start:
        T_out[:min(start * B, n_pairs)] = saved[:start * B]
        if progress:
            print(f"resuming scanmatch from group {start} "
                  f"({min(start * B, n_pairs)}/{n_pairs} pairs)")
    for g in range(start, n_groups):
        lo, hi = g * B, min((g + 1) * B, n_pairs)
        res = register(g, slice(g * B, (g + 1) * B))
        k = hi - lo
        T = res.transform.cpu().numpy().astype(np.float64)[:k]
        fit[lo:hi] = res.fitness.cpu().numpy()[:k]
        iters[lo:hi] = res.iterations.cpu().numpy()[:k]
        delta[lo:hi] = res.final_delta.cpu().numpy()[:k]
        bad[lo:hi] = fell_back(fit[lo:hi], delta[lo:hi], cfg.min_fitness, params)
        T[bad[lo:hi]] = seeds[lo:hi][bad[lo:hi]].astype(np.float64)
        T_out[lo:hi] = T
        write_checkpoint(path, key, n_pairs, B, g + 1, T_out)
    return T_out, fit, iters, delta, bad


def sharded_rows(n_scans: int, n_ranks: int, batch: int) -> int:
    """Scans (= pairs) per rank of the sharded stack: a batch multiple
    with n_ranks of them covering every scan."""
    return -(-n_scans // (n_ranks * batch)) * batch


def _replicated_dispatch(mesh, points, mask, normals, T_seeds, params,
                         method: str, B: int):
    """Every rank holds the whole stack and registers its contiguous share
    of the pair groups (the pair list padded to whole groups on every
    rank with identity-seeded self-pairs of the last scan).  Returns the
    results of every pair, gathered to every rank."""
    idx_src, idx_tgt, seeds = consecutive_pairs(points.shape[0], B * mesh.size,
                                                T_seeds)
    lo, hi = _mesh.shard_bounds(len(idx_src), mesh)
    si, ti, sd = (torch.from_numpy(a[lo:hi]).to(points.device)
                  for a in (idx_src, idx_tgt, seeds))
    return _mesh.gather_blocks(mesh, *_by_groups(hi - lo, B, _icp_register(
        points, mask, normals, si, ti, sd, params, method)))


def _sharded_stack_dispatch(mesh, points, mask, normals, n_scans: int,
                            T_seeds: np.ndarray, params, method: str, B: int):
    """Rank d holds scans [d K, (d + 1) K) of the stack padded with copies
    of the last scan (``points`` etc. are its block) and registers the K
    pairs whose target it holds.  The only remote scan is its last pair's
    source, the next rank's first scan, exchanged as a halo (the cyclic
    wrap row feeds a self-pair that is discarded).  Local source = target
    + 1 for real pairs, self-pairs for padding.  Returns the results of
    the D K pairs, gathered to every rank."""
    K = sharded_rows(n_scans, mesh.size, B)
    if points.shape[0] != K:
        raise ValueError(f"rank {mesh.rank} holds {points.shape[0]} scans, "
                         f"expected {K} of {n_scans} over {mesh.size} ranks")
    pts, msk, nrm = (torch.cat([a, _mesh.halo_next(mesh, a[0])[None]])
                     for a in (points, mask, normals))
    glob = mesh.rank * K + np.arange(K)
    real = glob < n_scans - 1
    tgt = np.arange(K)
    seeds = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    seeds[real] = np.asarray(T_seeds, dtype=np.float32)[glob[real]]
    si, ti, sd = (torch.from_numpy(a).to(points.device)
                  for a in (tgt + real, tgt, seeds))
    return _mesh.gather_blocks(mesh, *_by_groups(K, B, _icp_register(
        pts, msk, nrm, si, ti, sd, params, method)))


def match_consecutive(points, mask, normals, T_seeds: np.ndarray,
                      cfg: IcpConfig, method: str,
                      ground_mask=None, nonground_mask=None,
                      progress: bool = True,
                      checkpoint_path: str | None = None,
                      checkpoint_key: int | None = None,
                      mesh=None, n_scans: int | None = None,
                      n_valid: np.ndarray | None = None):
    """Batched registration of consecutive pairs under ``method``
    (icp2planes and fpfh need the scans' ground/non-ground masks).

    Source = scan i+1, target = scan i.  Returns the (N-1,4,4) float64
    refined T_i_i+1 and per-pair host arrays (fitness, iterations,
    final_delta, fell_back) for the profile.

    With ``checkpoint_path`` every group's result comes to the host after
    the group and the checkpoint is saved there; a checkpoint of the same
    ``checkpoint_key`` (derived from the scan times), pair count and batch
    size resumes after its last group, with the transforms it holds.
    Without, every group runs before one read of the results.  Both give
    the same transforms.

    ``mesh`` (a ``parallel.mesh.DataMesh``; every rank calls): the plain
    ICP methods without a checkpoint split their pairs over the ranks, as
    in the reference; with ``cfg.shard_scans`` the stacks are this rank's
    block of the sharded stack (``sharded_rows`` scans) and ``n_scans``
    the whole sequence's count.  Every rank returns the whole result.

    ``n_valid``: the host (N,) count of each scan's valid points (a
    prefix of its mask); with it, the plain ICP methods without a mesh
    split count K1's swept and valid pairs (``_icp_register``).
    """
    n_scans = points.shape[0] if n_scans is None else n_scans
    n_pairs = n_scans - 1
    B = cfg.batch_size
    params = ICPParams(max_correspondence_distance=cfg.distance_threshold,
                       max_iterations=cfg.max_iterations,
                       source_stride=cfg.source_stride)
    icp_method = ("point_to_point" if method == "icppointpoint"
                  else "point_to_plane")
    dev = points.device
    if mesh is not None and checkpoint_path is None and method in MESH_METHODS:
        seeds = np.asarray(T_seeds, dtype=np.float32)
        T_all, fit, iters, delta = (
            t.cpu().numpy()[:n_pairs] for t in
            (_sharded_stack_dispatch(mesh, points, mask, normals, n_scans,
                                     T_seeds, params, icp_method, B)
             if cfg.shard_scans else
             _replicated_dispatch(mesh, points, mask, normals, T_seeds,
                                  params, icp_method, B)))
        tag = (f"mesh dispatch, {mesh.size} ranks"
               + (", sharded scan stack" if cfg.shard_scans else ""))
    else:
        idx_src, idx_tgt, seeds = consecutive_pairs(n_scans, B, T_seeds)
        with span("sync.pair_upload"):       # host-to-card copies
            si, ti, sd = (torch.from_numpy(a).to(dev)
                          for a in (idx_src, idx_tgt, seeds))
        if method in SPLIT_METHODS and (ground_mask is None or nonground_mask is None):
            raise ValueError(f"method {method!r} needs the ground/non-ground masks")
        if method == "icp2planes":
            def register(_, sl):
                return two_planes_pairs(points, normals, ground_mask, nonground_mask,
                                        si[sl], ti[sl], sd[sl], params)
        elif method == "fpfh":
            gp = GlobalRegParams(fpfh_radius=cfg.fpfh_radius, icp=params)
            feats = scan_features(points, normals, nonground_mask, cfg.fpfh_radius, B)

            def register(g, sl):
                return fpfh_pairs(points, mask, normals, nonground_mask, feats,
                                  si[sl], ti[sl], gp, torch.Generator().manual_seed(g))
        else:
            valid = None
            if n_valid is not None:
                n_valid = np.asarray(n_valid, dtype=np.int64)
                stride = params.source_stride
                valid = (-(-n_valid[idx_src] // stride), n_valid[idx_tgt])
            register = _icp_register(points, mask, normals, si, ti, sd, params,
                                     icp_method, valid)
        if checkpoint_path is not None:
            T_all, fit, iters, delta, bad = _match_checkpointed(
                register, len(si) // B, n_pairs, B, seeds, cfg, params,
                checkpoint_path, checkpoint_key, progress)
        else:
            res = _by_groups(len(si), B, register)
            with span("sync.icp_results"):
                T_all, fit, iters, delta = (t.cpu().numpy()[:n_pairs] for t in res)
        tag = f"groups of {B}"
    if checkpoint_path is None:
        T_all = T_all.astype(np.float64)
        bad = fell_back(fit, delta, cfg.min_fitness, params)
        if bad.any():
            T_all[bad] = seeds[:n_pairs][bad].astype(np.float64)
    if progress:
        print(f"scanmatch pairs {n_pairs}/{n_pairs} ({tag} on {dev})")
    return T_all, {"fitness": fit, "iterations": iters,
                   "final_delta": delta, "fell_back": bad}


def _check_supported(cfg: IcpConfig, method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown registration method {method!r}; "
                         f"expected one of {METHODS}")


def run_scanmatcher(directory: str, cfg: IcpConfig | None = None,
                    progress: bool = True, return_preprocessed: bool = False,
                    device="cuda", seed: int = PLANE_SEED) -> dict:
    """Full stage 1 on ``device``; writes the scanmatcher CSVs and the
    profile, and returns the trajectory.

    ``seed`` keys the ground planes' draws under icp2planes and fpfh (the
    reference's preprocessing seed, 0).  ``return_preprocessed=True`` also
    returns the preprocessed scan tensors under ``"preprocessed"``, with
    the seed and every configuration field the preprocessing read, so that
    stage 2 reuses them only when its store would make the same clouds and
    masks (``pipeline.graphslam.run_graphslam``).

    With ``cfg.checkpoint_batches > 0`` the registration saves
    ``robot0/scanmatcher/checkpoint.npz`` after every group, resumes from
    a matching one, and removes it when the stage completes.

    ``cfg.mesh_devices`` != 1 runs the stage over the ranks of the process
    group (every rank calls; ``parallel.mesh.resolve_mesh``'s rules), with
    ``cfg.shard_scans`` each rank loading only its block of scans; every
    rank returns the whole trajectory, rank 0 writes the files."""
    builds = BuildCounter()
    with builds.scope():
        return _run_scanmatcher(directory, cfg, progress, device,
                                return_preprocessed, seed, builds)


def _run_scanmatcher(directory, cfg, progress, device, return_preprocessed,
                     seed, builds):
    device = _cuda.torch_device(device, "run_scanmatcher")
    timer = StageTimer()
    with timer.stage("scanmatch.setup", sync=device):
        euroc = EurocDataset(directory)
        sm_params = euroc.read_scanmatcher_parameters()
        start_index = sm_params.get("start_index", 0)
        delta_time = sm_params.get("delta_time", 0.5)
        voxel_size = sm_params.get("voxel_size", None)
        method = sm_params.get("method", "icppointplane")
        if cfg is None:
            cfg = IcpConfig()
        _check_supported(cfg, method)
        mesh = _mesh.resolve_mesh(cfg.mesh_devices)
        group = _mesh.data_mesh()
        if group.size > 1 and cfg.checkpoint_batches > 0:
            # a checkpoint per rank would race on one file (the reference
            # turns it off under several processes too)
            cfg = dataclasses.replace(cfg, checkpoint_batches=0)
        if method not in MESH_METHODS:
            mesh = None           # the other methods run whole in every rank
        shard = mesh is not None and cfg.shard_scans

        scan_times, _, _, odo, _ = prepare_experiment_data(
            euroc, start_index, delta_time)
        rel_odo = relative_odometry(odo)
        n = len(scan_times)
    launches0 = dict(_cuda.launch_counts)
    collectives0 = copy.deepcopy(_mesh.collective_counts)
    counts0 = dict(profiling.counts)

    n_valid = None
    with timer.stage("scanmatch.load_preprocess", sync=device):
        if shard:
            # this rank's block of the stack padded with copies of the last
            # scan; the draws keep each scan's index in the whole sequence
            K = sharded_rows(n, mesh.size, cfg.batch_size)
            first = mesh.rank * K
            times = np.concatenate([scan_times, np.repeat(scan_times[-1:],
                                                          mesh.size * K - n)])
            scans, overflow, n_python = load_and_preprocess_streamed(
                euroc, times[first:first + K], cfg, method, voxel_size, seed=seed,
                device=device, first=first)
            overflow = _mesh.gather_rows(mesh, torch.as_tensor(overflow), mesh.size * K,
                                         first).cpu().numpy()[:n]
            n_python = int(_mesh.all_reduce_sum(
                mesh, torch.tensor([n_python], device=mesh.device)).item())
            n_local = K
        else:
            scans, overflow, n_python, n_valid = _streamed(
                euroc, scan_times, cfg, method, voxel_size, seed, None, device, 0)
            n_local = n
    preprocess_seconds = timer.seconds["scanmatch.load_preprocess"]
    if progress:
        print(f"loaded+preprocessed {n_local} scans "
              f"{'on this rank ' if shard else ''}in {preprocess_seconds:.2f}s")

    ck_path = ck_key = None
    if cfg.checkpoint_batches > 0:
        os.makedirs(f"{directory}/robot0/scanmatcher", exist_ok=True)
        ck_path = f"{directory}/robot0/scanmatcher/checkpoint.npz"
        ck_key = int(np.int64(np.sum(scan_times)) & 0x7FFFFFFF)
    # K1's pairs are counted on one device under the plain ICP methods
    k1_counted = mesh is None and method in MESH_METHODS
    with timer.stage("scanmatch.icp", sync=device):
        rel_sm, stats = match_consecutive(
            scans.points, scans.mask, scans.normals, rel_odo, cfg, method,
            progress=progress, ground_mask=scans.ground_mask,
            nonground_mask=scans.nonground_mask, checkpoint_path=ck_path,
            checkpoint_key=ck_key, mesh=mesh, n_scans=n,
            n_valid=n_valid if k1_counted else None)
    icp_seconds = timer.seconds["scanmatch.icp"]
    counted = profiling.counts_since(counts0)
    if ck_path is not None:
        # stage complete: the mid-stage checkpoint goes
        os.remove(ck_path)

    iters = stats["iterations"]
    iters = iters[iters >= 0]          # pairs resumed from a checkpoint: -1
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
        "pairs_resumed_from_checkpoint": int(len(rel_sm) - len(iters)),
        "pcd_files_python_parsed": int(n_python),
        # the mesh the pairs actually split over (1: none)
        "mesh_devices": int(mesh.size) if mesh is not None else 1,
        "shard_scans": bool(shard),
        "process_count": int(group.size),
        "backend": group.backend,
        "scans_loaded_locally": int(n_local),
        "kernel_launches": {k: v - launches0[k]
                            for k, v in _cuda.launch_counts.items()},
        "collectives": _mesh.counts_since(collectives0),
        # host counts (utils.profiling.counts): ICP steps over every
        # group, the PCD wait and decode, the scans' points before the
        # capacity and kept, K1's swept and valid pairs
        "icp_steps": int(counted["icp_steps"]),
        "pcd_wait_seconds": round(counted["pcd_wait_seconds"], 4),
        "pcd_decode_seconds": round(counted["pcd_decode_seconds"], 4),
        "scan_points_valid": int(counted["scan_points_valid"]),
        "scan_points_kept": int(counted["scan_points_kept"]),
        "k1_pairs_swept": int(counted["k1_pairs_swept"]) if k1_counted else None,
        "k1_pairs_valid": int(counted["k1_pairs_valid"]) if k1_counted else None,
        **builds.report(),
    }

    def write():
        euroc.save_sensor_times_as_csv(scan_times,
                                       "/robot0/scanmatcher/lidar_times.csv")
        euroc.save_transforms_as_csv(scan_times, rel_sm,
                                     "/robot0/scanmatcher/scanmatcher_relative.csv")
        euroc.save_transforms_as_csv(scan_times, T_global,
                                     "/robot0/scanmatcher/scanmatcher_global.csv")
        os.makedirs(f"{directory}/robot0/viz", exist_ok=True)
        with open(f"{directory}/robot0/viz/scanmatcher_profile.json", "w") as f:
            json.dump(profile, f, indent=2)
        return [f"{directory}/robot0/scanmatcher/{name}" for name in
                ("lidar_times.csv", "scanmatcher_relative.csv",
                 "scanmatcher_global.csv")] + [
                     f"{directory}/robot0/viz/scanmatcher_profile.json"]

    with timer.stage("scanmatch.write", sync=device):
        # fold to global in float64 on the host
        T_global = np.empty((len(rel_sm) + 1, 4, 4))
        T_global[0] = np.eye(4)
        for i, Tij in enumerate(rel_sm):
            T_global[i + 1] = T_global[i] @ Tij
        # one writer; the other ranks wait for it, as stage 2 reads the CSVs
        written = _mesh.write_once(group, write)
    out = {"scan_times": scan_times, "relative": rel_sm,
           "global": T_global, "icp_seconds": icp_seconds,
           "frames_per_second": profile["frames_per_second"],
           "scans_loaded_locally": int(n_local), "written": written,
           "profile": profile}
    if return_preprocessed and not shard:
        out["preprocessed"] = {
            "points": scans.points, "mask": scans.mask, "normals": scans.normals,
            "ground_mask": scans.ground_mask,
            "nonground_mask": scans.nonground_mask, "seed": seed,
            "scan_times": scan_times, "voxel_size": voxel_size,
            "method": method, "capacity": int(cfg.capacity),
            "raw_capacity": int(cfg.raw_capacity),
            "crop": (float(cfg.min_radius), float(cfg.max_radius),
                     float(cfg.min_height), float(cfg.max_height)),
            "normal_radius": float(cfg.normal_radius)}
    return out
