"""Entry points for a quick check of the port: one ICP batch, a multi-rank dry run.

Counterpart of the JAX package's ``__graft_entry__.py``: ``entry`` gives
the flagship step (a batch of odometry-seeded point-to-plane ICP
registrations, K1 for the correspondences) with example inputs, and
``dryrun_multichip(n, device)`` runs the whole pipeline over n ranks,
the paths ``cli --devices n`` takes: stage 1 with the sharded and with
the replicated scan stack, stage 2 with the distributed Schur solve, and
the distributed solvers on a noisy loop-closed graph against the dense
one.
"""

from __future__ import annotations

import dataclasses
import tempfile

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.cloud import (
    crop_radius_height, estimate_normals, from_numpy, voxel_downsample_counted,
)
from lidar_slam_arvc_tpu_torch.utils import synthetic


def tiny_pair_batch(batch: int, cap: int, seed: int = 0, device="cuda"):
    """Small synthetic preprocessed scan-pair batch: (src points, src
    masks, tgt points, tgt masks, tgt normals, seeds) tensors on
    ``device`` (the reference's ``_tiny_pair_batch``, same draws)."""
    rng = np.random.default_rng(seed)
    world = synthetic.make_world(rng, extent=10.0, n_ground=1500,
                                 n_pillars=8, pillar_pts=100)
    T = synthetic.make_trajectory(batch + 1, radius=5.0)

    def prep(i):
        scan = synthetic.render_scan(world, T[i], rng, max_range=12.0,
                                     max_points=cap)
        c = from_numpy(scan, cap, device=device)
        c = crop_radius_height(c, 0.5, 35.0, -1.0, 50.0)
        c = voxel_downsample_counted(c, 0.3)[0]
        return estimate_normals(c, radius=0.6)

    clouds = [prep(i) for i in range(batch + 1)]
    src, tgt = clouds[1:], clouds[:-1]
    seeds = np.stack([np.linalg.inv(T[i]) @ T[i + 1]
                      for i in range(batch)]).astype(np.float32)
    return (torch.stack([c.points for c in src]), torch.stack([c.mask for c in src]),
            torch.stack([c.points for c in tgt]), torch.stack([c.mask for c in tgt]),
            torch.stack([c.normals for c in tgt]),
            torch.as_tensor(seeds, device=device))


def entry(device="cuda"):
    """(fn, example_args): the forward step of the flagship path, a batch
    of odometry-seeded point-to-plane ICP registrations."""
    from lidar_slam_arvc_tpu_torch.registration.icp import ICPParams, icp_batch

    params = ICPParams(max_correspondence_distance=5.0, max_iterations=8,
                       src_block=256, tgt_block=256)

    def fn(src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals, T_init):
        return icp_batch(src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals,
                         T_init, params, "point_to_plane").transform

    return fn, tiny_pair_batch(batch=2, cap=512, device=device)


def _noisy_graph(n: int, mesh):
    """The dry run's noisy loop-closed graph of n poses, with GPS."""
    from lidar_slam_arvc_tpu_torch.graph import PoseGraph
    rng = np.random.default_rng(2)
    T_gt = synthetic.make_trajectory(n, radius=5.0)
    g = PoseGraph(max_poses=n, max_between=4 * n, max_gps=n, mesh=mesh,
                  device=mesh.device)
    g.init_graph()
    for i in range(n - 1):
        rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1]
        rel[:3, 3] += rng.normal(scale=0.03, size=3)
        g.add_initial_estimate(rel, i + 1)
        g.add_edge(rel, i, i + 1, "SM")
    for (a, b) in [(1, n - 2), (2, n // 2), (n // 4, 3 * n // 4)]:
        g.add_edge(np.linalg.inv(T_gt[a]) @ T_gt[b], a, b, "SM")
    for i in (0, n // 3, 2 * n // 3):
        z = T_gt[i][:3, 3] + rng.normal(scale=0.05, size=3)
        g.add_gps_factor(z[0], z[1], z[2], i)
    return g


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_rank(directory: str, T_gt: np.ndarray, cfg_kwargs: dict) -> dict:
    """One rank of ``dryrun_multichip`` (a ``mesh.launch`` target)."""
    from lidar_slam_arvc_tpu_torch.graph.solver import graph_cost, lm_schedule, solve_graph
    from lidar_slam_arvc_tpu_torch.parallel.dist_solver import distributed_lm_step
    from lidar_slam_arvc_tpu_torch.parallel.mesh import data_mesh
    from lidar_slam_arvc_tpu_torch.parallel.schur import schur_solve_graph
    from lidar_slam_arvc_tpu_torch.pipeline.graphslam import run_graphslam
    from lidar_slam_arvc_tpu_torch.pipeline.scanmatcher import run_scanmatcher
    from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
    from lidar_slam_arvc_tpu_torch.utils.metrics import ate

    mesh = data_mesh()
    dev = mesh.device
    n_devices = mesh.size
    quiet = mesh.rank != 0
    cfg = IcpConfig(mesh_devices=n_devices, shard_scans=True, **cfg_kwargs)
    # the sharded scan stack (halo exchange), then the replicated one
    out_sm = run_scanmatcher(directory, cfg=cfg, device=dev, progress=not quiet)
    out_rep = run_scanmatcher(directory, cfg=dataclasses.replace(cfg, shard_scans=False),
                              device=dev, progress=not quiet)
    dev_layout = float(np.abs(out_rep["relative"] - out_sm["relative"]).max())
    _check(dev_layout < 1e-4, f"sharded vs replicated stack {dev_layout}")
    out_g = run_graphslam(directory, cfg=cfg, device=dev, progress=False)
    _check(out_g["profile"]["solver"] == "schur",
           f"stage 2 solved by {out_g['profile']['solver']}, not schur")
    err_sm = ate(out_sm["global"], T_gt)["rmse"]
    err_slam = ate(np.asarray(out_g["solution"]), T_gt)["rmse"]
    _check(np.isfinite(err_sm) and err_sm < 0.5, f"stage-1 ATE {err_sm}")
    _check(np.isfinite(err_slam) and err_slam < 1.0, f"stage-2 ATE {err_slam}")

    # the distributed solvers on a noisy loop-closed graph (nonzero r) of
    # at least the 32 poses the reference's dry run solves on 8 devices
    # (on the 8 poses it builds for 2, its own dense LM only reaches 57%
    # of the starting cost: 18.91 -> 10.78, not the halving it checks)
    n = n_devices * max(4, -(-32 // n_devices))
    g = _noisy_graph(n, mesh)
    poses0 = torch.as_tensor(g.poses, device=dev)
    fd = g._factor_data()
    cost0 = float(graph_cost(poses0, fd))
    _check(cost0 > 1.0, f"graph not noisy enough (cost0={cost0})")
    p_dense, c_dense = solve_graph(poses0, fd, g.n_poses, max_iterations=10)
    p_schur, c_schur = schur_solve_graph(
        mesh, poses0, fd, g.n_poses, sep_capacity=g._sep_capacity(n_devices),
        max_iterations=10)
    p_dist, c_dist = lm_schedule(
        lambda p, lam: distributed_lm_step(mesh, p, fd, g.n_poses, lam=lam),
        poses0, graph_cost(poses0, fd), 10, 1e-6, 1e-7)
    _check(c_schur < 0.5 * cost0, f"schur cost {c_schur} of {cost0}")
    _check(c_dist < 0.5 * cost0, f"distributed cost {c_dist} of {cost0}")

    def max_dt(p):
        return float((p[:g.n_poses, :3, 3] - p_dense[:g.n_poses, :3, 3]).abs().max())

    dev_schur, dev_dist = max_dt(p_schur), max_dt(p_dist)
    _check(dev_schur < 5e-3, f"schur vs dense max |dt| {dev_schur}")
    _check(dev_dist < 5e-3, f"distributed vs dense max |dt| {dev_dist}")
    _check(g.auto_solver() == "schur", f"auto_solver {g.auto_solver()} at {n} poses")
    return {"ate_stage1": err_sm, "ate_slam": err_slam, "layout": dev_layout,
            "cost0": cost0, "dense": float(c_dense), "schur": float(c_schur),
            "distributed": float(c_dist), "schur_vs_dense": dev_schur,
            "distributed_vs_dense": dev_dist, "relative": out_sm["relative"]}


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """The whole pipeline over ``n_devices`` ranks on ``device`` (tiny
    shapes), then the distributed solvers on a noisy loop-closed graph:
    nonzero starting cost, the cost halved, Schur and distributed steps
    within 5e-3 m of the dense solve.  Raises when a check fails in any
    rank; returns each rank's summary."""
    from lidar_slam_arvc_tpu_torch.parallel.mesh import launch

    n_scans = max(12, 2 * n_devices)
    # capacity 2048 >= the ~1400 cropped points of a 1500-point scan: the
    # full-resolution loop-closure store runs without capacity overflow
    cfg = dict(raw_capacity=2048, capacity=2048, batch_size=2, max_iterations=8)
    with tempfile.TemporaryDirectory() as d:
        info = synthetic.make_dataset(
            d, n_scans=n_scans, seed=5, radius=6.0, scan_points=1500,
            scanmatcher_params={"voxel_size": 0.25, "method": "icppointplane",
                                "delta_time": 1.0, "start_index": 0},
            slam_params={"perform_loop_closing": False, "skip_optimization": 5})
        out = launch(n_devices, dryrun_rank, d, info["T_gt"], cfg, device=device)
    for r in out[1:]:
        _check(np.array_equal(r["relative"], out[0]["relative"]),
               "the ranks returned different stage-1 results")
    s = out[0]
    print(f"dryrun_multichip({n_devices}, {device}): pipeline ATE sm="
          f"{s['ate_stage1'] * 1e3:.1f}mm slam={s['ate_slam'] * 1e3:.1f}mm "
          f"(mesh stage1+stage2 OK); noisy graph cost {s['cost0']:.4f} -> dense "
          f"{s['dense']:.4f} / schur {s['schur']:.4f} / distributed "
          f"{s['distributed']:.4f}; dense-vs-schur max|dt| "
          f"{s['schur_vs_dense'] * 1e3:.3f}mm, dense-vs-distributed "
          f"{s['distributed_vs_dense'] * 1e3:.3f}mm")
    return out
