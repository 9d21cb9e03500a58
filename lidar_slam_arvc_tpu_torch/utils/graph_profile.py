"""Where the time of one pose-graph LM step goes, on the card.

    python -m lidar_slam_arvc_tpu_torch.utils.graph_profile \\
        [--capacity 512] [--solver pcg|dense] [--steps 3]

Builds the SLAM-shaped graph of ``chip_smoke.py``'s phase 9
(``solver_graph``: noisy SM and exact ODO chain edges, a loop edge to pose
0 every 40 poses, GPS every 5) at ``--capacity`` poses and traces
``--steps`` damped LM steps (``graph.solver._lm_step`` or
``graph.pcg.pcg_lm_step``, each ending in reading its cost on the host,
as the solve does) under torch.profiler after one warm-up step.  Prints
one JSON line: wall ms per step, CUDA kernels and device busy ms per
step, host synchronisations per step, and the ten host-side operators
with the most self CPU time (calls and ms per step).  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.graph import PoseGraph, make_factor_data, pcg, solver
from lidar_slam_arvc_tpu_torch.graph.factors import FACTOR_FIELDS
from lidar_slam_arvc_tpu_torch.utils import synthetic

# host-side CUDA runtime calls that wait for the device (a read of a
# device value is an async copy followed by one of these)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def solver_graph(n: int, device) -> tuple[PoseGraph, np.ndarray]:
    """A SLAM-shaped graph of n poses (the reference's
    benchmarks/graph_roofline.py graph) and its ground truth."""
    T = synthetic.make_trajectory(n, radius=max(8.0, n / 40.0))
    rng = np.random.default_rng(0)
    g = PoseGraph(T0=T[0], max_poses=n, max_between=3 * n, chain_capacity=2 * n,
                  max_gps=n // 5 + 1, device=device)
    g.init_graph()
    for i in range(n - 1):
        rel = np.linalg.inv(T[i]) @ T[i + 1]
        noisy = rel.copy()
        noisy[:3, 3] += rng.normal(scale=0.01, size=3)
        g.add_initial_estimate(noisy, i + 1)
        g.add_edge(noisy, i, i + 1, "SM")
        g.add_edge(rel, i, i + 1, "ODO")
    for k in range(1, n // 40 + 1):
        j = min(40 * k, n - 1)
        g.add_edge(np.linalg.inv(T[0]) @ T[j], 0, j, "SM")
    for i in range(0, n, 5):
        g.add_gps_factor(T[i][0, 3], T[i][1, 3], T[i][2, 3], i)
    return g, T


def profile_steps(n: int, which: str, steps: int, device) -> dict:
    g, _ = solver_graph(n, device)
    f = make_factor_data(n, device, **{k: getattr(g, k) for k in FACTOR_FIELDS})
    poses = torch.as_tensor(g.poses, device=device)
    if which == "pcg":
        def step(p):
            return pcg.pcg_lm_step(p, f, n, 1e-6, stats=stats)
    else:
        def step(p):
            return solver._lm_step(p, f, n, 1e-6)
    stats: dict = {}
    step(poses)[1].item()
    torch.cuda.synchronize(device)
    stats.clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        p = poses
        for _ in range(steps):
            p, cost = step(p)
            cost.item()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    syncs = sum(1 for e in events if e.name.startswith(SYNC_CALLS))
    launches = sum(1 for e in events if e.name.startswith("cudaLaunch"))
    top = sorted((a for a in prof.key_averages()
                  if not a.key.startswith(("cuda", "Activity"))),
                 key=lambda a: a.self_cpu_time_total, reverse=True)[:10]
    return {"capacity": n, "solver": which, "steps": steps,
            "device": torch.cuda.get_device_name(device),
            "wall_ms_per_step": wall / steps * 1e3,
            "cuda_kernels_per_step": len(kernels) / steps,
            "kernel_launch_calls_per_step": launches / steps,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "host_sync_calls_per_step": syncs / steps,
            "cg_iterations_per_step": stats.get("cg_iterations", 0) / steps,
            "top_self_cpu": [
                {"op": a.key, "calls_per_step": a.count / steps,
                 "self_cpu_ms_per_step": a.self_cpu_time_total / steps / 1e3}
                for a in top]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--capacity", type=int, default=512)
    parser.add_argument("--solver", choices=("pcg", "dense"), default="pcg")
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("graph_profile needs a CUDA device")
    print(json.dumps(profile_steps(args.capacity, args.solver, args.steps,
                                   torch.device("cuda", 0))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
