"""Distributed Schur-complement pose-graph solve over the ranks of a mesh.

Counterpart of ``lidar_slam_arvc_tpu/parallel/schur.py``.  The poses are
cut into contiguous chunks of N / D, one per rank.  Poses touched by a
between factor that crosses chunks form the separator set S; the other
active poses of chunk d are its interior I_d.  Rank d

  1. linearises only the factors it owns (between factors by the chunk of
     their first pose: every factor touching an interior pose of chunk d
     lies inside chunk d; unary factors by the chunk of their pose), with
     the port's gather tables, and cuts H_II^d, H_IS^d, b_I^d and its
     partial H_SS, b_S out of those blocks,
  2. eliminates its interior: Y = H_II^-1 [H_IS | b_I] (damped, Jacobi
     equilibrated, ``cholesky_ex``),
  3. sums H_SS, b_S and H_SI Y over the ranks in one ``all_reduce`` and
     solves the damped separator system S = H_SS - sum_d H_SI^d Y^d,
     replicated in every rank,
  4. back-substitutes its interior update; the interior and separator
     updates are merged over the ranks bit for bit, so every rank holds
     the same candidate poses and cost.

The step is the dense damped step of ``graph/solver.py::_lm_step`` in
exact algebra, on another f32 rounding path.  Inactive poses are left out
of the factors and get a zero update.  A Cholesky that fails, in any rank
(the failure flags travel in the same ``all_reduce``) or on the separator
system, gives an infinite cost in every rank: a rejected step.

The reference's TPU layout (static dump rows, ``mode="drop"`` scatters)
is not ported: the port's factors are the active ones and the blocks are
cut out with index lists built on the host.  Its capacity contract is
kept: ``sep_capacity`` bounds the separator count, and every rank raises
the overflow ``ValueError`` before the step's first collective, from the
replicated factor data, so no rank is left waiting in one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.graph.factors import FactorData
from lidar_slam_arvc_tpu_torch.graph.solver import (
    _retract, damp, equilibrated_solve, graph_cost, linearize, lm_schedule,
)
from lidar_slam_arvc_tpu_torch.parallel.dist_solver import factor_subset, host_factors
from lidar_slam_arvc_tpu_torch.parallel.mesh import DataMesh, all_reduce_sum, merge_exact


class SchurPlan(NamedTuple):
    """What one rank needs for the steps of one factor set."""
    n_sep: int
    own: FactorData            # the factors this rank linearises
    interior: torch.Tensor     # (nI,) this rank's interior poses
    sep: torch.Tensor          # (S,) the separator poses, ascending
    ii: tuple                  # (block positions, row, column) of H_II
    i_s: tuple                 # ... of H_IS
    ss: tuple                  # ... of this rank's partial H_SS


def separators(bt_i: np.ndarray, bt_j: np.ndarray, capacity: int,
               n_chunks: int) -> np.ndarray:
    """The poses, ascending, touched by an active between factor (i, j)
    that crosses chunks of capacity / n_chunks poses."""
    m = capacity // n_chunks
    cross = (bt_i // m) != (bt_j // m)
    return np.unique(np.concatenate([bt_i[cross], bt_j[cross]]))


def schur_plan(mesh: DataMesh, factors: FactorData, n_active: int,
               sep_capacity: int = 64) -> SchurPlan:
    """This rank's share of the solve, built on the host; raises
    ``ValueError`` (in every rank alike) when the pose capacity does not
    divide over the mesh or the separators exceed ``sep_capacity``."""
    N = factors.diag_pos.shape[0]
    D = mesh.size
    if N % D:
        raise ValueError(f"pose capacity {N} not divisible by mesh size {D}")
    m = N // D
    h = host_factors(factors)
    sep = separators(h["bt_i"], h["bt_j"], N, D)
    if len(sep) > sep_capacity:
        raise ValueError(
            f"separator count {len(sep)} exceeds sep_capacity {sep_capacity}; "
            f"raise it (bound: mesh size * 2 + 2 per loop closure)")
    d = mesh.rank
    is_sep = np.zeros(N, dtype=bool)
    is_sep[sep] = True
    chunk = np.arange(d * m, (d + 1) * m)
    interior = chunk[~is_sep[chunk] & (chunk < n_active)]
    dev, dtype = factors.bt_T.device, factors.bt_T.dtype
    own = factor_subset(h, N, dev, dtype, between=h["bt_i"] // m == d,
                        gps=h["gps_i"] // m == d, prior=h["pr_i"] // m == d)
    rows, cols = own.blk_rows.cpu().numpy(), own.blk_cols.cpu().numpy()
    li = np.full(N, -1)
    li[interior] = np.arange(len(interior))
    si = np.full(N, -1)
    si[sep] = np.arange(len(sep))

    def cut(r_ix, c_ix):
        u = np.nonzero((r_ix[rows] >= 0) & (c_ix[cols] >= 0))[0]
        return tuple(torch.as_tensor(a, device=dev)
                     for a in (u, r_ix[rows[u]], c_ix[cols[u]]))

    return SchurPlan(len(sep), own, torch.as_tensor(interior, device=dev),
                     torch.as_tensor(sep, device=dev), cut(li, li), cut(li, si),
                     cut(si, si))


def _dense(blocks: torch.Tensor, where: tuple, n_rows: int, n_cols: int):
    """(6 n_rows, 6 n_cols) matrix of the listed blocks (each written once)."""
    u, r, c = where
    M = blocks.new_zeros((n_rows, 6, n_cols, 6))
    M[r, :, c, :] = blocks[u]
    return M.reshape(6 * n_rows, 6 * n_cols)


def schur_lm_step(mesh: DataMesh, poses: torch.Tensor, factors: FactorData,
                  n_active: int, lam: float = 1e-6, sep_capacity: int = 64,
                  axis: str = "data", plan: SchurPlan | None = None):
    """One damped GN step via distributed Schur elimination.

    Returns (candidate poses, candidate cost, n_sep), the same in every
    rank; ``plan`` (``schur_plan``) is built here when not given."""
    if plan is None:
        plan = schur_plan(mesh, factors, n_active, sep_capacity)
    N = poses.shape[0]
    nI, S = len(plan.interior), plan.n_sep
    lin = linearize(poses, plan.own, n_active)
    HII = _dense(lin.blocks, plan.ii, nI, nI)
    HIS = _dense(lin.blocks, plan.i_s, nI, S)
    HSS = _dense(lin.blocks, plan.ss, S, S)
    bI = lin.grad[plan.interior].reshape(-1)
    bS = lin.grad[plan.sep].reshape(-1)

    fails = poses.new_zeros(1)
    if nI:
        Y, info = equilibrated_solve(damp(HII, lam),
                                     torch.cat([HIS, bI[:, None]], dim=1))
        fails = fails + (info != 0).to(poses.dtype)
    else:
        Y = poses.new_zeros((0, 6 * S + 1))
    red = HIS.T @ Y                                   # (6S, 6S + 1)
    packed = all_reduce_sum(mesh, torch.cat(
        [HSS.reshape(-1), bS, red.reshape(-1), fails]))
    n6 = 6 * S
    HSS = packed[:n6 * n6].reshape(n6, n6)
    bS = packed[n6 * n6:n6 * n6 + n6]
    red = packed[n6 * n6 + n6:-1].reshape(n6, n6 + 1)
    ok = packed[-1] == 0
    if S:
        xS, info = equilibrated_solve(damp(HSS, lam) - red[:, :n6],
                                      -bS + red[:, -1])
        ok = ok & (info == 0)
    else:
        xS = poses.new_zeros(0)
    delta = poses.new_zeros((N, 6))
    if nI:
        delta[plan.interior] = (-Y[:, -1] - Y[:, :n6] @ xS).reshape(-1, 6)
    if mesh.rank == 0:
        delta[plan.sep] = xS.reshape(-1, 6)
    delta = merge_exact(mesh, delta)
    new = _retract(poses, delta, n_active)
    cost = graph_cost(new, factors)
    return new, torch.where(ok, cost, torch.full_like(cost, torch.inf)), S


def schur_solve_graph(mesh: DataMesh, poses: torch.Tensor, factors: FactorData,
                      n_active: int, sep_capacity: int = 64,
                      max_iterations: int = 15, lam0: float = 1e-6,
                      tol: float = 1e-7, axis: str = "data",
                      stats: dict | None = None):
    """The LM loop over distributed Schur steps: the multi-rank
    counterpart of ``graph.solver.solve_graph`` (the same host-driven
    accept/reject schedule, on costs every rank holds alike).  Returns
    (poses, cost as a numpy scalar)."""
    plan = schur_plan(mesh, factors, n_active, sep_capacity)
    return lm_schedule(
        lambda p, lam: schur_lm_step(mesh, p, factors, n_active, lam,
                                     plan=plan)[:2],
        poses, graph_cost(poses, factors), max_iterations, lam0, tol, stats)
