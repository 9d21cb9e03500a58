"""Rank entry points of the multi-device checks (``mesh.launch`` targets).

Each function runs in every rank of a launched group, takes numpy inputs
and returns numpy results with this rank's counters, so that a parent
process (the tests, ``chip_smoke.py``, ``parallel/dryrun.py``) can hold
the ranks against a single-process run.  ``sequence`` runs several in one
group, which saves a spawn per check.  The functions live in the package
because a spawned rank imports the module of its target: a test module
would bring JAX into the ranks.
"""

from __future__ import annotations

import copy
import sys
import time

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.graph import PoseGraph
from lidar_slam_arvc_tpu_torch.graph.solver import graph_cost
from lidar_slam_arvc_tpu_torch.ops import _cuda
from lidar_slam_arvc_tpu_torch.parallel import mesh as _mesh
from lidar_slam_arvc_tpu_torch.parallel.dist_solver import (
    distributed_assemble, distributed_lm_step,
)
from lidar_slam_arvc_tpu_torch.parallel.schur import (
    schur_lm_step, schur_plan, schur_solve_graph,
)
from lidar_slam_arvc_tpu_torch.parallel.sharded_icp import sharded_icp_batch


def counters() -> dict:
    """This rank's identity, its kernel and collective counters, and the
    modules of JAX, of the JAX package or of the tests it has imported
    (none should be)."""
    m = _mesh.data_mesh()
    foreign = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "lidar_slam_arvc_tpu")
                     or k.split(".")[0].startswith(("test_", "conftest")))
    return {"rank": m.rank, "size": m.size, "backend": m.backend,
            "device": str(m.device), "launches": dict(_cuda.launch_counts),
            "collectives": copy.deepcopy(_mesh.collective_counts),
            "foreign_modules": foreign}


def sequence(*calls) -> list:
    """[fn(*args) for (fn, args) in calls], in this rank."""
    return [fn(*args) for fn, args in calls]


def exchange(rows: np.ndarray) -> dict:
    """The exact gather of rank r's rows ``rows[r]`` (each rank's block of
    a (size, k, ...) array) and the halo of each rank's first row, with
    the collective counters before and after."""
    m = _mesh.data_mesh()
    before = copy.deepcopy(_mesh.collective_counts)
    local = torch.as_tensor(rows[m.rank], device=m.device)
    k = local.shape[0]
    gathered = _mesh.gather_rows(m, local, k * m.size, k * m.rank)
    halo = _mesh.halo_next(m, local[0])
    return {"gathered": gathered.cpu().numpy(), "halo": halo.cpu().numpy(),
            "before": before, "after": copy.deepcopy(_mesh.collective_counts)}


def sharded_icp(batch: tuple, params, method: str = "point_to_plane",
                reps: int = 0) -> dict:
    """``sharded_icp_batch`` of a host pair batch (src points, src masks,
    tgt points, tgt masks, tgt normals, seeds), the K1 launches its first
    call made in this rank, and the wall seconds of that call and of each
    of ``reps`` more (warm)."""
    m = _mesh.data_mesh()
    args = [torch.as_tensor(a, device=m.device) for a in batch]

    def call():
        if m.device.type == "cuda":
            torch.cuda.synchronize(m.device)
        t0 = time.perf_counter()
        res = sharded_icp_batch(m, *args, params=params, method=method)
        return {k: v.cpu().numpy() for k, v in res._asdict().items()}, \
            time.perf_counter() - t0

    k1 = _cuda.launch_counts["nn_sweep"]
    out, first = call()
    out["seconds_first"] = first
    out["k1_launches"] = _cuda.launch_counts["nn_sweep"] - k1
    if reps:
        out["seconds"] = sum(call()[1] for _ in range(reps)) / reps
    return out


def _graph(state: dict) -> PoseGraph:
    return PoseGraph.from_reference_state(state, device=_mesh.rank_device())


def assemble(state: dict, lam: float = 1e-6) -> dict:
    """``distributed_assemble`` of a graph's normal equations, and the
    cost before and after one ``distributed_lm_step``."""
    m = _mesh.data_mesh()
    g = _graph(state)
    p, f = torch.as_tensor(g.poses, device=m.device), g._factor_data()
    H, b = distributed_assemble(m, p, f, g.n_poses)
    _, c1 = distributed_lm_step(m, p, f, g.n_poses, lam=lam)
    return {"H": H.cpu().numpy(), "b": b.cpu().numpy(),
            "cost0": float(graph_cost(p, f)), "cost1": float(c1)}


def schur_step(state: dict, lam: float, sep_capacity: int, reps: int = 0) -> dict:
    """One ``schur_lm_step`` of a graph: its candidate poses, cost and
    separator count, and the wall ms per step over ``reps`` more steps
    (each reading its cost on the host, as the solve does; the plan built
    once, as a solve builds it)."""
    m = _mesh.data_mesh()
    g = _graph(state)
    p, f = torch.as_tensor(g.poses, device=m.device), g._factor_data()
    plan = schur_plan(m, f, g.n_poses, sep_capacity)     # once per solve
    new, cost, n_sep = schur_lm_step(m, p, f, g.n_poses, lam=lam, plan=plan)
    out = {"poses": new.cpu().numpy(), "cost": float(cost), "n_sep": n_sep}
    if reps:
        t0 = time.perf_counter()
        for _ in range(reps):
            float(schur_lm_step(m, p, f, g.n_poses, lam=lam, plan=plan)[1])
        out["ms_per_step"] = (time.perf_counter() - t0) / reps * 1e3
    return out


def schur_solve(state: dict, sep_capacity: int, max_iterations: int) -> dict:
    """``schur_solve_graph`` of a graph; a separator overflow is returned
    as its message (``"error"``), so that a parent sees every rank raise."""
    m = _mesh.data_mesh()
    g = _graph(state)
    p, f = torch.as_tensor(g.poses, device=m.device), g._factor_data()
    try:
        poses, cost = schur_solve_graph(m, p, f, g.n_poses,
                                        sep_capacity=sep_capacity,
                                        max_iterations=max_iterations)
    except ValueError as exc:
        return {"error": str(exc)}
    return {"poses": poses.cpu().numpy(), "cost": float(cost),
            "cost0": float(graph_cost(p, f))}


def store_pairs(directory: str, scan_times: np.ndarray, cfg_kwargs: dict,
                method: str, pairs: np.ndarray, seeds: np.ndarray) -> dict:
    """A keyframe store sharded over the ranks, each loading only its
    block, and its registration of ``pairs`` from ``seeds``."""
    from lidar_slam_arvc_tpu_torch.keyframes import KeyframeStore
    from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
    m = _mesh.data_mesh()
    store = KeyframeStore(directory, scan_times, method=method,
                          cfg=IcpConfig(**cfg_kwargs), device=m.device)
    store.load_and_preprocess(mesh=m)
    k1 = _cuda.launch_counts["nn_sweep"]
    if m.device.type == "cuda":
        torch.cuda.synchronize(m.device)
    t0 = time.perf_counter()
    T = store.compute_transformations_batch(pairs, seeds)
    return {"T": T, "seconds": time.perf_counter() - t0,
            "rows": int(store.points.shape[0]),
            "loaded": int(store.n_loaded_locally),
            "k1_launches": _cuda.launch_counts["nn_sweep"] - k1}


def sharded_stack(points: np.ndarray, mask: np.ndarray, normals: np.ndarray,
                  seeds: np.ndarray, params, batch: int) -> dict:
    """Stage 1's sharded-stack dispatch of a host scan stack: this rank
    takes its block of the stack padded with copies of the last scan."""
    from lidar_slam_arvc_tpu_torch.pipeline.scanmatcher import (
        _sharded_stack_dispatch, sharded_rows,
    )
    m = _mesh.data_mesh()
    n = points.shape[0]
    k = sharded_rows(n, m.size, batch)
    pad = np.minimum(np.arange(m.rank * k, (m.rank + 1) * k), n - 1)
    block = [torch.as_tensor(a[pad], device=m.device) for a in (points, mask, normals)]
    T, fit, _, _ = _sharded_stack_dispatch(m, *block, n, seeds, params,
                                           "point_to_plane", batch)
    return {"T": T.cpu().numpy()[:n - 1], "fitness": fit.cpu().numpy()[:n - 1]}


def fail_on(ranks: list, message: str) -> None:
    """Raise ``ValueError(message)`` in the listed ranks while the others
    wait at a barrier (the launcher's error path)."""
    m = _mesh.data_mesh()
    if m.rank in ranks:
        raise ValueError(message)
    _mesh.barrier(m)
