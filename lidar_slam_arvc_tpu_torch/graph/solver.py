"""Batch Levenberg-Marquardt pose-graph solver with a dense Cholesky step.

Counterpart of ``lidar_slam_arvc_tpu/graph/solver.py``: residuals and
closed-form Jacobians of every factor (first-order inverse right Jacobian
Jr^-1(r) ~= I + ad(r)/2), the normal equations J^T W^2 J, the damped step
with Marquardt damping and Jacobi equilibration before the f32 Cholesky,
chunked marginal covariances, and the LM accept/reject schedule of the
reference's fused solve (``_solve_graph_fused``), driven from the host.

The normal equations are assembled block by block as fixed-order sums of
gathered contributions (``graph/factors.py``), so a solve on the card is
deterministic.  The 6x6 products are batched matmuls, in f32: a solve on
the card raises if TF32 matmuls are switched on.  The dense factorisations
are cuSOLVER's (``torch.linalg.cholesky_ex``, ``torch.cholesky_solve``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.geom.se3 import (
    compose, inverse, se3_exp, se3_log, so3_hat,
)
from lidar_slam_arvc_tpu_torch.graph.factors import FactorData
from lidar_slam_arvc_tpu_torch.ops.nn import require_f32_matmul


def _mv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched (..., m, k) @ (..., k)."""
    return torch.matmul(a, x[..., None])[..., 0]


def inv_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (..., n, n) blocks, NaN wherever a block is
    singular (``inv_ex``'s info != 0), on every device: the CPU's LU gives
    inf/NaN there as ``jnp.linalg.inv`` does, CUDA's result is undefined,
    and a NaN preconditioner makes the LM reject the step."""
    inv, info = torch.linalg.inv_ex(A)
    return torch.where((info == 0)[..., None, None], inv, torch.nan)


def _adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for xi = [w, v]: Ad(T) = [[R, 0], [[t]x R, R]]."""
    R = T[..., :3, :3]
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bottom = torch.cat([so3_hat(T[..., :3, 3]) @ R, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _jr_inv(r: torch.Tensor) -> torch.Tensor:
    """First-order inverse right Jacobian of SE(3): I + ad(r)/2, with
    ad(xi) = [[[w]x, 0], [[v]x, [w]x]]."""
    wx = so3_hat(r[..., :3])
    ad = torch.cat([torch.cat([wx, torch.zeros_like(wx)], dim=-1),
                    torch.cat([so3_hat(r[..., 3:]), wx], dim=-1)], dim=-2)
    return torch.eye(6, dtype=r.dtype, device=r.device) + 0.5 * ad


def _between_residuals(poses, f: FactorData):
    """(r (E,6), A = dr/dxi_i (E,6,6), B = dr/dxi_j (E,6,6))."""
    Tij = compose(inverse(poses[f.bt_i]), poses[f.bt_j])
    r = se3_log(compose(inverse(f.bt_T), Tij))
    B = _jr_inv(r)
    return r, -(B @ _adjoint(inverse(Tij))), B


def _gps_residuals(poses, f: FactorData):
    """(r (G,3), J (G,3,6)): r = t(X_i) - z, J = [0 | R_i]."""
    Ti = poses[f.gps_i]
    R = Ti[..., :3, :3]
    return Ti[..., :3, 3] - f.gps_z, torch.cat([torch.zeros_like(R), R], dim=-1)


def _prior_residuals(poses, f: FactorData):
    r = se3_log(compose(inverse(f.pr_T), poses[f.pr_i]))
    return r, _jr_inv(r)


def graph_cost(poses: torch.Tensor, factors: FactorData) -> torch.Tensor:
    """0.5 * sum of squared whitened residuals (a 0-dim tensor)."""
    r_b, _, _ = _between_residuals(poses, factors)
    r_g, _ = _gps_residuals(poses, factors)
    r_p, _ = _prior_residuals(poses, factors)
    return 0.5 * (torch.sum((r_b * factors.bt_winv) ** 2)
                  + torch.sum((r_g * factors.gps_winv) ** 2)
                  + torch.sum((r_p * factors.pr_winv) ** 2))


class Linearized(NamedTuple):
    """H = J^T W^2 J as its nonzero 6x6 blocks, and the gradient."""
    blocks: torch.Tensor   # (U, 6, 6) at (f.blk_rows, f.blk_cols)
    grad: torch.Tensor     # (N, 6) J^T W^2 r, zero at inactive poses


def _weighted(J, w2):
    """(J^T W^2) per factor: (K, n, m) Jacobians, (K, m) weights."""
    return J.transpose(-1, -2) * w2[..., None, :]


def linearize(poses: torch.Tensor, f: FactorData, n_active: int) -> Linearized:
    """The blocks of H and the gradient at ``poses``.  Poses at index >=
    n_active are inactive: identity diagonal, zero gradient, so the solve
    stays regular and leaves them fixed."""
    require_f32_matmul(poses, "the pose-graph solvers")
    r, A, B = _between_residuals(poses, f)
    AtW = _weighted(A, f.bt_winv ** 2)
    BtW = _weighted(B, f.bt_winv ** 2)
    Hij = AtW @ B
    rg, Jg = _gps_residuals(poses, f)
    GtW = _weighted(Jg, f.gps_winv ** 2)
    rp, Jp = _prior_residuals(poses, f)
    PtW = _weighted(Jp, f.pr_winv ** 2)
    zero = poses.new_zeros((1, 6, 6))
    contrib = torch.cat([AtW @ A, BtW @ B, Hij, Hij.transpose(-1, -2),
                         GtW @ Jg, PtW @ Jp, zero])
    blocks = contrib[f.blk_ix].sum(1)
    inact = f.diag_pos[n_active:]
    blocks[inact] = blocks[inact] + torch.eye(6, dtype=poses.dtype,
                                              device=poses.device)
    g = torch.cat([_mv(AtW, r), _mv(BtW, r), _mv(GtW, rg), _mv(PtW, rp),
                   poses.new_zeros((1, 6))])
    grad = g[f.grad_ix].sum(1)
    grad[n_active:] = 0.0
    return Linearized(blocks, grad)


def dense_matrix(lin: Linearized, f: FactorData) -> torch.Tensor:
    """The (6N, 6N) matrix of H's blocks (each block written once)."""
    N = lin.grad.shape[0]
    H = lin.blocks.new_zeros((N, 6, N, 6))
    H[f.blk_rows, :, f.blk_cols, :] = lin.blocks
    return H.reshape(6 * N, 6 * N)


def _assemble(poses: torch.Tensor, f: FactorData, n_active: int):
    """Dense H (6N, 6N) and gradient b (6N,)."""
    lin = linearize(poses, f, n_active)
    return dense_matrix(lin, f), lin.grad.reshape(-1)


def _retract(poses, delta, n_active):
    """poses Exp(delta) with the inactive poses' steps forced to zero."""
    delta = delta.clone()
    delta[n_active:] = 0.0
    return compose(poses, se3_exp(delta))


def damp(H: torch.Tensor, lam) -> torch.Tensor:
    """H with Marquardt damping on its diagonal: H + diag(lam diag(H) + 1e-9)."""
    return H + torch.diag(torch.diagonal(H) * lam + 1e-9)


def equilibrated_solve(A: torch.Tensor, R: torch.Tensor):
    """(A^-1 R, Cholesky info) for a symmetric positive definite A and
    right-hand sides R (n,) or (n, k), through a Jacobi-equilibrated f32
    Cholesky: rotation vs weak-prior rows put cond(A) at ~1e8, and S A S
    solves several digits more accurately.  info != 0: A did not factor
    and the result is meaningless."""
    s = torch.rsqrt(torch.clamp(torch.diagonal(A), min=1e-30))
    L, info = torch.linalg.cholesky_ex(A * s[:, None] * s[None, :])
    sr = s if R.dim() == 1 else s[:, None]
    X = torch.cholesky_solve((R * sr).reshape(R.shape[0], -1), L)
    return sr * X.reshape(R.shape), info


def _lm_step(poses, f: FactorData, n_active: int, lam: float):
    """One damped step: (candidate poses, candidate cost).  A matrix that
    the Cholesky cannot factor gives an infinite cost (a rejected step)."""
    H, b = _assemble(poses, f, n_active)
    delta, info = equilibrated_solve(damp(H, lam), -b)
    new = _retract(poses, delta.reshape(-1, 6), n_active)
    cost = graph_cost(new, f)
    return new, torch.where(info == 0, cost, torch.full_like(cost, torch.inf))


def marginal_covariances(poses: torch.Tensor, factors: FactorData, n_active: int,
                         chunk: int = 64) -> torch.Tensor:
    """Per-pose 6x6 marginal covariance blocks in the tangent frame [w, v]
    (gtsam.Marginals parity, reference graphSLAM.py:117-137): the diagonal
    blocks of H^-1, from ONE Cholesky of the equilibrated S H S and
    back-substitution of ``chunk`` poses' unit columns at a time.  Rows of
    inactive poses are meaningless; slice [:n_active].  Where the Cholesky
    fails (a graph with a free gauge) every block is NaN, as the
    reference's ``cho_factor``/``cho_solve`` give; a tensor ``where``, so
    no host synchronisation."""
    n = poses.shape[0]
    chunk = min(chunk, n)
    if n % chunk:
        raise ValueError(f"pose capacity {n} not divisible by chunk {chunk}")
    H, _ = _assemble(poses, factors, n_active)
    H = H + 1e-9 * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    s = torch.rsqrt(torch.clamp(torch.diagonal(H), min=1e-30))
    L, info = torch.linalg.cholesky_ex(H * s[:, None] * s[None, :])
    C6 = 6 * chunk
    k = torch.arange(chunk, device=H.device)
    out = []
    for c0 in range(0, 6 * n, C6):
        cols = torch.arange(c0, c0 + C6, device=H.device)
        rhs = H.new_zeros((6 * n, C6))
        rhs[cols, torch.arange(C6, device=H.device)] = s[cols]
        X = torch.cholesky_solve(rhs, L) * s[:, None]
        out.append(X.reshape(n, 6, chunk, 6)[c0 // 6 + k, :, k, :])
    return torch.where(info == 0, torch.cat(out), torch.nan)


def lm_schedule(step, poses: torch.Tensor, cost0: torch.Tensor,
                max_iterations: int, lam0: float, tol: float,
                stats: dict | None = None):
    """The reference's fused LM accept/reject schedule, driven from the host.

    ``step(poses, lam) -> (candidate, candidate cost)``.  A candidate is
    taken when its cost is finite and lower; lam then falls 5x (floor
    1e-9) and the solve stops once the gain is below tol * max(cost, 1).
    A rejection raises lam 10x (cap 1e4) and stops at the cap.  lam, the
    costs and tol are float32, as in the reference's device loop.  Each
    step reads its cost on the host: one synchronisation per step, counted
    in ``stats["host_syncs"]``.  A float64 solve keeps its schedule in
    float64.  Returns (poses, cost as a numpy scalar)."""
    f32 = np.float64 if cost0.dtype == torch.float64 else np.float32
    cost = f32(cost0.item())
    lam, tol = f32(lam0), f32(tol)
    n_steps = 0
    for _ in range(max_iterations):
        cand, cand_cost = step(poses, float(lam))
        c = f32(cand_cost.item())
        n_steps += 1
        if np.isfinite(c) and c < cost:
            improved = f32(cost - c)
            poses, cost = cand, c
            lam = max(f32(lam / f32(5.0)), f32(1e-9))
            if improved < f32(tol * max(cost, f32(1.0))):
                break
        else:
            lam = min(f32(lam * f32(10.0)), f32(1e4))
            if lam >= f32(1e4):
                break
    if stats is not None:
        stats["lm_steps"] = stats.get("lm_steps", 0) + n_steps
        stats["host_syncs"] = stats.get("host_syncs", 0) + n_steps + 1
    return poses, cost


def solve_graph(poses: torch.Tensor, factors: FactorData, n_active: int,
                max_iterations: int = 15, lam0: float = 1e-6,
                tol: float = 1e-7, stats: dict | None = None):
    """Batch LM solve with dense Cholesky steps.  Returns (poses (N,4,4)
    on the device, final cost as a numpy scalar)."""
    return lm_schedule(
        lambda p, lam: _lm_step(p, factors, n_active, lam), poses,
        graph_cost(poses, factors), max_iterations, lam0, tol, stats)
