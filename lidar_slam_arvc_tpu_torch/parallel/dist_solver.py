"""Distributed pose-graph normal equations: split assembly + all_reduce.

Counterpart of ``lidar_slam_arvc_tpu/parallel/dist_solver.py``.  Each rank
linearises a contiguous slice of the active between factors and assembles
its partial (H, b) with the port's gather tables (``graph/factors.py``:
fixed-order sums, no scatter-add); the partials are summed over the ranks
in one ``all_reduce``, the unary factors (GPS, prior) and the inactive
poses' identity blocks are added once, and the damped solve runs
replicated in every rank, with the same Marquardt damping and Jacobi
equilibration as ``graph/solver.py::_lm_step``.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.graph.factors import FACTOR_FIELDS, FactorData, make_factor_data
from lidar_slam_arvc_tpu_torch.graph.solver import (
    _retract, damp, dense_matrix, equilibrated_solve, graph_cost, linearize,
)
from lidar_slam_arvc_tpu_torch.parallel.mesh import DataMesh, all_reduce_sum

_BETWEEN = ("bt_i", "bt_j", "bt_T", "bt_winv")
_GPS = ("gps_i", "gps_z", "gps_winv")
_PRIOR = ("pr_i", "pr_T", "pr_winv")


def host_factors(f: FactorData) -> dict:
    """The factor arrays of ``f`` on the host (its active factors)."""
    return {k: getattr(f, k).cpu().numpy() for k in FACTOR_FIELDS}


def factor_subset(h: dict, capacity: int, device, dtype, between=None,
                  gps=None, prior=None) -> FactorData:
    """FactorData of the factors of the host arrays ``h`` that ``between``,
    ``gps`` and ``prior`` select (index arrays, masks or slices; None
    selects none of that kind)."""
    sub = {}
    for keys, sel in ((_BETWEEN, between), (_GPS, gps), (_PRIOR, prior)):
        for k in keys:
            sub[k] = h[k][sel] if sel is not None else h[k][:0]
    return make_factor_data(capacity, device, dtype=dtype, **sub)


def distributed_assemble(mesh: DataMesh, poses: torch.Tensor, factors: FactorData,
                         n_active: int, axis: str = "data"):
    """(H (6N, 6N), b (6N,)): this rank's slice of the between factors
    assembled locally, the partials summed over the ranks, then the unary
    factors and the inactive poses' identity blocks added once."""
    N = poses.shape[0]
    h = host_factors(factors)
    bounds = np.linspace(0, len(h["bt_i"]), mesh.size + 1).astype(int)
    part = factor_subset(h, N, poses.device, poses.dtype,
                         between=slice(bounds[mesh.rank], bounds[mesh.rank + 1]))
    lin = linearize(poses, part, N)
    Hb = dense_matrix(lin, part)
    packed = torch.cat([Hb.reshape(-1), lin.grad.reshape(-1)])
    all_reduce_sum(mesh, packed)
    n6 = 6 * N
    H, b = packed[:n6 * n6].reshape(n6, n6), packed[n6 * n6:]
    unary = factor_subset(h, N, poses.device, poses.dtype, gps=slice(None),
                          prior=slice(None))
    lin_u = linearize(poses, unary, n_active)
    b = b + lin_u.grad.reshape(-1)
    b[6 * n_active:] = 0.0
    return H + dense_matrix(lin_u, unary), b


def distributed_lm_step(mesh: DataMesh, poses: torch.Tensor, factors: FactorData,
                        n_active: int, lam: float = 1e-6, axis: str = "data"):
    """One damped GN step with distributed assembly; returns (candidate
    poses, candidate cost), the cost infinite where the Cholesky fails
    (a rejected step), as ``graph/solver.py::_lm_step``."""
    H, b = distributed_assemble(mesh, poses, factors, n_active, axis)
    delta, info = equilibrated_solve(damp(H, lam), -b)
    new = _retract(poses, delta.reshape(-1, 6), n_active)
    cost = graph_cost(new, factors)
    return new, torch.where(info == 0, cost, torch.full_like(cost, torch.inf))
