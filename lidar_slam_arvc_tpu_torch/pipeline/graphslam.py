"""Stage 2: pose-graph SLAM with loop closing and GPS fusion, on the card.

Counterpart of ``lidar_slam_arvc_tpu/pipeline/graphslam.py`` (pipeline
parity with reference run_graphSLAM.py:123-289): read stage 1's CSVs, the
odometry and the GPS; build a pose graph of SM and ODO between factors and
GPS unary factors in the GPS frame; optimise every ``skip_optimization``
poses; try triangle loop closures every ``skip_loop_closing`` poses and on
the last two; optimise once more with 30 iterations; compute marginals;
write ``robot0/SLAM/solution_graphslam.csv``,
``robot0/SLAM/loop_closures.csv``, the two renders
``robot0/SLAM/uncertainty.png`` (1-sigma position ellipses from the
marginals) and ``gps_comparison.png`` (with GPS), and
``robot0/viz/graphslam_profile.json``.

The loop-closure store is every scan at full resolution (voxel None,
normals by K2, the ground split under icp2planes and fpfh), or stage 1's
own tensors when ``run_scanmatcher`` made them with the same
configuration and plane seed; it registers candidates under the slam
parameters' ``method``, its ICPs over K1.  The renders need matplotlib:
without it (``ImportError``) or when a file cannot be written
(``OSError``) the stage still writes its CSVs and records the error in the
profile's ``uncertainty_error``, as the reference does; an error in the
marginals propagates.

Over N ranks (``IcpConfig.mesh_devices``; ``parallel/mesh.py``) every rank
builds the same graph and runs the same loop closer; the pose graph
solves by the distributed Schur complement (``auto_solver``) unless it is
too small to split (``_next_pow2(n) < 2 N``: no mesh), and the store is
sharded over the ranks (each loads only its block with ``shard_scans``,
else loads every scan and keeps its block).  Rank 0 alone computes the
marginals, renders and writes the files; the others wait for it.
"""

from __future__ import annotations

import copy
import json
import os
import time

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.graph import PoseGraph
from lidar_slam_arvc_tpu_torch.io.euroc import TIME, EurocDataset, trajectory_from_table
from lidar_slam_arvc_tpu_torch.io.utm import filter_gps, gps2utm
from lidar_slam_arvc_tpu_torch.keyframes import KeyframeStore
from lidar_slam_arvc_tpu_torch.loop import LoopCloser
from lidar_slam_arvc_tpu_torch.ops import _cuda
from lidar_slam_arvc_tpu_torch.parallel import mesh as _mesh
from lidar_slam_arvc_tpu_torch.pipeline.preprocess import PLANE_SEED
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
from lidar_slam_arvc_tpu_torch.utils.profiling import BuildCounter, span
from lidar_slam_arvc_tpu_torch.viz.plots import (
    plot_gps_comparison, plot_trajectory_with_uncertainty,
)


def prepare_experiment_data(euroc: EurocDataset):
    """(reference run_graphSLAM.py:38-74)."""
    scan_times = euroc.read_csv("/robot0/scanmatcher/lidar_times.csv")[TIME]
    sm_global = euroc.read_csv("/robot0/scanmatcher/scanmatcher_global.csv")
    try:
        odo = euroc.read_csv("/robot0/odom/data.csv")
        odo = euroc.get_rows_at_times(
            odo, euroc.get_closest_times(scan_times, odo[TIME]))
    except FileNotFoundError:
        odo = None
    try:
        gps = euroc.read_csv("/robot0/gps0/data.csv")
        gps = gps2utm(filter_gps(gps), euroc.read_utm_ref("gps0"))
        gps_times = gps[TIME]
        T0_gps = euroc.read_transform("gps0")
    except FileNotFoundError:
        gps, gps_times, T0_gps = None, None, None
    return scan_times, sm_global, odo, gps, gps_times, T0_gps


def get_current_gps_reading(current_time, gps_times,
                            max_delta_time_s: float = 0.1):
    """(reference run_graphSLAM.py:77-85)."""
    if gps_times is None:
        return None
    diff = np.abs((gps_times - current_time) / 1e9)
    i = int(np.argmin(diff))
    return i if diff[i] < max_delta_time_s else None


def _relative(T: np.ndarray) -> np.ndarray:
    return np.einsum("nij,njk->nik", np.linalg.inv(T[:-1]), T[1:])


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _reusable(preprocessed, method, cfg: IcpConfig, scan_times) -> bool:
    """Whether stage 1's tensors are the clouds this store would load: the
    full-resolution regime, the same method, capacities, crop, normal
    radius and scan times, and the ground planes drawn from the seed the
    store draws them from."""
    return (preprocessed is not None
            and preprocessed.get("seed") == PLANE_SEED
            and preprocessed.get("voxel_size") is None
            and preprocessed.get("method") == method
            and preprocessed.get("capacity") == cfg.capacity
            and preprocessed.get("raw_capacity") == cfg.raw_capacity
            and preprocessed.get("crop") == (
                float(cfg.min_radius), float(cfg.max_radius),
                float(cfg.min_height), float(cfg.max_height))
            and preprocessed.get("normal_radius") == float(cfg.normal_radius)
            and np.array_equal(preprocessed.get("scan_times"), scan_times))


def run_graphslam(directory: str, cfg: IcpConfig | None = None,
                  progress: bool = True, preprocessed: dict | None = None,
                  device="cuda") -> dict:
    """Full stage 2 on ``device``; writes the SLAM CSVs and the profile.

    ``preprocessed``: the ``"preprocessed"`` dict of
    ``run_scanmatcher(return_preprocessed=True)``; the loop-closure store
    reuses its tensors when they match this run's configuration, and loads
    every PCD again otherwise."""
    builds = BuildCounter()
    with builds.scope():
        return _run_graphslam(directory, cfg, progress, preprocessed, device,
                              builds)


def _run_graphslam(directory, cfg, progress, preprocessed, device, builds):
    device = _cuda.torch_device(device, "run_graphslam")
    euroc = EurocDataset(directory)
    params = euroc.read_slam_parameters()
    perform_loop_closing = params.get("perform_loop_closing", True)
    method = params.get("method", "icppointplane")
    skip_loop_closing = params.get("skip_loop_closing", 50)
    skip_optimization = params.get("skip_optimization", 50)
    n_triplets = params.get("number_of_triplets_loop_closing", 20)
    radius_threshold = params.get("radius_threshold", 2.0)
    distance_backwards = params.get("distance_backwards", 9.0)
    if cfg is None:
        cfg = IcpConfig()
    mesh = _mesh.resolve_mesh(cfg.mesh_devices)
    group = _mesh.data_mesh()
    launches0 = dict(_cuda.launch_counts)
    collectives0 = copy.deepcopy(_mesh.collective_counts)

    (scan_times, sm_table, odo, gps, gps_times,
     T0_gps) = prepare_experiment_data(euroc)
    if T0_gps is None:
        T0_gps = np.eye(4)

    # trajectories rebased into the GPS frame (run_graphSLAM.py:207-215)
    sm_global = np.einsum("nij,jk->nik", trajectory_from_table(sm_table)[1],
                          T0_gps)
    sm_rel = _relative(sm_global)
    odo_rel = None
    if odo is not None:
        odo_rel = _relative(np.einsum("nij,jk->nik",
                                      trajectory_from_table(odo)[1], T0_gps))

    n = len(sm_rel) + 1
    if mesh is not None and _next_pow2(n) < 2 * mesh.size:
        mesh = None      # graph too small to split across the ranks
    # 2*max_poses chain slots (SM+ODO consecutive edges) + a loop budget
    # sized from the closing cadence
    max_poses = _next_pow2(n)
    chain_cap = 2 * max_poses
    loop_cap = _next_pow2(8 * n_triplets
                          * max(n // max(skip_loop_closing, 1), 1) + 64)
    graph = PoseGraph(T0=np.eye(4), T0_gps=T0_gps, max_poses=max_poses,
                      max_between=chain_cap + loop_cap,
                      chain_capacity=chain_cap, max_gps=_next_pow2(n),
                      device=device, mesh=mesh)
    graph.init_graph()

    t_store0 = time.time()
    store_reused = False
    closer = None
    if perform_loop_closing:
        store_reused = (group.size == 1
                        and _reusable(preprocessed, method, cfg, scan_times))
        if store_reused:
            store = KeyframeStore.from_arrays(
                preprocessed["points"], preprocessed["mask"],
                preprocessed["normals"], method=method, cfg=cfg,
                ground_mask=preprocessed["ground_mask"],
                nonground_mask=preprocessed["nonground_mask"])
            store.scan_times = scan_times
            store.n_loaded_locally = 0     # no PCD read from disk
        else:
            store = KeyframeStore(directory, scan_times, voxel_size=None,
                                  method=method, cfg=cfg, device=device)
            store.load_and_preprocess(mesh=mesh if cfg.shard_scans else None)
        if mesh is not None and not store.sharded:
            store.shard(mesh)
        if device.type == "cuda":
            with span("sync.store_loaded"):
                torch.cuda.synchronize(device)
        closer = LoopCloser(graph, store, distance_backwards=distance_backwards,
                            radius_threshold=radius_threshold)
    store_seconds = time.time() - t_store0
    store_loaded = closer.store.n_loaded_locally if closer is not None else 0

    corr_indexes = []
    loop_closures = []
    n_optimizations = 0
    optimize_seconds = 0.0
    t0 = time.time()
    for i in range(len(sm_rel)):
        gps_index = get_current_gps_reading(scan_times[i], gps_times,
                                            max_delta_time_s=0.05)
        if gps_index is not None:
            graph.add_gps_factor(gps["x"][gps_index], gps["y"][gps_index],
                                 gps["altitude"][gps_index], i)
            corr_indexes.append([i, gps_index])

        graph.add_initial_estimate(sm_rel[i], i + 1)
        graph.add_edge(sm_rel[i], i, i + 1, "SM")
        if odo_rel is not None:
            graph.add_edge(odo_rel[i], i, i + 1, "ODO")

        if i % skip_optimization == 0:
            t_opt = time.time()
            graph.optimize()
            optimize_seconds += time.time() - t_opt
            n_optimizations += 1

        if closer is not None and ((i % skip_loop_closing) == 0
                                   or (len(sm_rel) - i) < 2):
            # no re-optimise here: the reference only plots at this point
            # (run_graphSLAM.py:259-268); closures act at the next optimise
            with span("loop.round"):
                loop_closures.append(closer.loop_closing_triangle(i, n_triplets))
        if progress:
            print(f"\rgraphSLAM step {i + 1}/{len(sm_rel)} "
                  f"({(i + 1) / max(time.time() - t0, 1e-9):.1f} steps/s)",
                  end="")
    if progress:
        print()

    t_opt = time.time()
    graph.optimize(max_iterations=30)
    optimize_seconds += time.time() - t_opt
    n_optimizations += 1

    solution_lidar = graph.get_solution_transforms_lidar()[:n]
    n_loops = sum(len(g) for g in loop_closures if g)
    # the writer's work (the marginals are only drawn); its error is
    # raised after the barrier below, which the other ranks wait at
    written, marginals_seconds, uncertainty_error, write_error = [], 0.0, None, None
    if group.rank == 0:
        try:
            written, marginals_seconds, uncertainty_error = _write_solution(
                directory, euroc, graph, scan_times, solution_lidar,
                loop_closures, gps, corr_indexes, n, progress)
        except Exception as exc:
            write_error = exc
    seconds = time.time() - t0

    loop_t = closer.timings if closer is not None else {
        "candidate_search_seconds": 0.0, "icp_seconds": 0.0,
        "icp_dispatches": 0, "icp_pairs": 0}
    # the solve+loop wall not in a timed phase (graph building, CSVs);
    # clamped, since the phases are timed apart from the wall
    host_other = max(0.0, seconds - optimize_seconds - marginals_seconds
                     - loop_t["candidate_search_seconds"]
                     - loop_t["icp_seconds"])
    profile = {
        "store_load_preprocess_seconds": round(store_seconds, 4),
        "solve_loop_seconds": round(seconds, 4),
        "optimize_seconds": round(optimize_seconds, 4),
        "loop_candidate_search_seconds":
            round(loop_t["candidate_search_seconds"], 4),
        "loop_icp_seconds": round(loop_t["icp_seconds"], 4),
        "loop_icp_dispatches": int(loop_t["icp_dispatches"]),
        "loop_icp_pairs": int(loop_t["icp_pairs"]),
        "marginals_seconds": round(marginals_seconds, 4),
        "host_other_seconds": round(host_other, 4),
        "poses": int(n),
        "optimizations": int(n_optimizations),
        "loop_closing_rounds": int(len(loop_closures)),
        "loop_closures_accepted": int(n_loops),
        "gps_factors": int(len(corr_indexes)),
        "solver": graph.auto_solver(),
        "method": method,
        "uncertainty_error": uncertainty_error,
        # the mesh the graph solved over (1: none)
        "mesh_devices": int(mesh.size) if mesh is not None else 1,
        "shard_scans": bool(cfg.shard_scans and mesh is not None),
        "process_count": int(group.size),
        "backend": group.backend,
        "store_scans_loaded_locally": int(store_loaded),
        "store_reused_stage1": bool(store_reused),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "solver_stats": dict(graph.stats),
        "kernel_launches": {k: v - launches0[k]
                            for k, v in _cuda.launch_counts.items()},
        "collectives": _mesh.counts_since(collectives0),
        **builds.report(),
    }

    def write_profile():
        if write_error is not None:
            raise write_error
        os.makedirs(f"{directory}/robot0/viz", exist_ok=True)
        path = f"{directory}/robot0/viz/graphslam_profile.json"
        with open(path, "w") as f:
            json.dump(profile, f, indent=2)
        return written + [path]

    # downstream stages and callers read these files: no rank returns
    # before the writer is done
    written = _mesh.write_once(group, write_profile)
    return {"solution": solution_lidar, "scan_times": scan_times,
            "loop_closures": loop_closures, "n_loop_closures": n_loops,
            "gps_correspondences": corr_indexes,
            "store_scans_loaded_locally": int(store_loaded),
            "seconds": seconds, "written": written, "profile": profile}


def _write_solution(directory, euroc, graph, scan_times, solution_lidar,
                    loop_closures, gps, corr_indexes, n, progress):
    """The two SLAM CSVs, the marginals and the renders (the writer's
    part of stage 2): (paths written, marginals seconds, the renders'
    recorded error or None)."""
    euroc.save_transforms_as_csv(scan_times, solution_lidar,
                                 "/robot0/SLAM/solution_graphslam.csv")
    euroc.save_loop_closures_as_csv(loop_closures,
                                    "/robot0/SLAM/loop_closures.csv")
    written = [f"{directory}/robot0/SLAM/solution_graphslam.csv",
               f"{directory}/robot0/SLAM/loop_closures.csv"]

    # the marginals the uncertainty plot draws: every pose by dense
    # chunked back-substitution up to the dense solver's capacity, only the
    # skip-sampled ones (the ellipses drawn) by PCG beyond
    t_marg = time.time()
    skip = max(n // 64, 1)
    if graph.max_poses <= 256:
        covs = graph.marginal_covariances()
    else:
        idx = np.arange(0, graph.n_poses, skip)
        covs = np.zeros((graph.n_poses, 6, 6))
        covs[idx] = graph.marginal_covariances(indices=idx)
    marginals_seconds = time.time() - t_marg
    uncertainty_error = None
    try:
        plot_trajectory_with_uncertainty(
            graph.current_estimate, covs,
            f"{directory}/robot0/SLAM/uncertainty.png", skip=skip)
        written.append(f"{directory}/robot0/SLAM/uncertainty.png")
        if gps is not None:
            plot_gps_comparison(graph.current_estimate, gps, corr_indexes,
                                f"{directory}/robot0/SLAM/gps_comparison.png")
            written.append(f"{directory}/robot0/SLAM/gps_comparison.png")
    except (ImportError, OSError) as exc:   # the renders only
        uncertainty_error = f"{type(exc).__name__}: {exc}"
        if progress:
            print(f"uncertainty plot skipped: {uncertainty_error}")
    return written, marginals_seconds, uncertainty_error
