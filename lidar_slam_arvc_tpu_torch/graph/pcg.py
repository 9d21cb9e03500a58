"""Preconditioned conjugate gradient for large pose graphs.

Counterpart of ``lidar_slam_arvc_tpu/graph/pcg.py``.  Each LM step
linearises once (the nonzero 6x6 blocks of H, ``solver.linearize``) and
solves the damped normal equations by CG, H @ x being a gather and a
fixed-order sum over each block row: O(blocks) work, no (6N)^2 matrix.

Preconditioners (``precond``): ``bcr`` (cyclic reduction of the
block-tridiagonal part of damped H, log-depth, power-of-two capacity),
``tridiag`` (the same part by a sequential block LDL^T, any capacity),
``jacobi`` (the 6x6 diagonal blocks); ``auto`` takes bcr at a power-of-two
capacity, else tridiag.  The chain part is solved exactly, so CG only has
the loop-closure and GPS corrections left.

The CG stop test dot(r, r) > rtol^2 ||b||^2 is read on the host after
every iteration: one synchronisation per iteration, counted in
``stats["host_syncs"]``.  A batch of right-hand sides (the marginal
columns) iterates until its slowest column has converged, each column
frozen from its own stop onwards, as the reference's vmapped while_loop.
"""

from __future__ import annotations

import torch

from lidar_slam_arvc_tpu_torch.graph.bcr import bcr_factor, bcr_solve
from lidar_slam_arvc_tpu_torch.graph.factors import FactorData
from lidar_slam_arvc_tpu_torch.graph.solver import (
    Linearized, _mv, _retract, graph_cost, inv_or_nan, linearize, lm_schedule,
)

PRECONDS = ("auto", "bcr", "tridiag", "jacobi")


def _eye6(like):
    return torch.eye(6, dtype=like.dtype, device=like.device)


def _tridiag_blocks(lin: Linearized, f: FactorData, lam: float):
    """(A (N,6,6) damped diagonal blocks, E (N,6,6) superdiagonal blocks
    H[k, k+1], E[N-1] = 0): the block-tridiagonal part of damped H.  Every
    dropped block is the whole coupling of the factors that made it, so the
    part stays SPD."""
    D = lin.blocks[f.diag_pos]
    A = D * (1.0 + lam) + 1e-8 * _eye6(D)
    E = torch.cat([lin.blocks, D.new_zeros((1, 6, 6))])[f.band_pos]
    return A, E


def _build_tridiag_precond(A: torch.Tensor, E: torch.Tensor):
    """Block LDL^T of the block-tridiagonal matrix (A, E): (Uinv, W) with
    U_k = A_k - W_k E_{k-1}, W_k = E_{k-1}^T U_{k-1}^-1, one 6x6 step per
    pose."""
    Uinv = [inv_or_nan(A[0])]
    W = [torch.zeros_like(A[0])]
    for k in range(1, A.shape[0]):
        Wk = E[k - 1].transpose(-1, -2) @ Uinv[-1]
        W.append(Wk)
        Uinv.append(inv_or_nan(A[k] - Wk @ E[k - 1]))
    return torch.stack(Uinv), torch.stack(W)


def _apply_tridiag_precond(Uinv, W, E, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b, M = (L+I) U (L+I)^T, for b (..., N, 6)."""
    N = b.shape[-2]
    y = [b[..., 0, :]]
    for k in range(1, N):
        y.append(b[..., k, :] - _mv(W[k], y[-1]))
    x = [_mv(Uinv[N - 1], y[N - 1])]
    for k in range(N - 2, -1, -1):
        x.append(_mv(Uinv[k], y[k] - _mv(E[k], x[-1])))
    return torch.stack(x[::-1], dim=-2)


def _preconditioner(lin: Linearized, f: FactorData, lam: float, precond: str):
    N = lin.grad.shape[0]
    if precond not in PRECONDS:
        raise ValueError(f"unknown precond {precond!r} ({' | '.join(PRECONDS)})")
    if precond == "auto":
        precond = "bcr" if (N & (N - 1)) == 0 else "tridiag"
    if precond == "jacobi":
        D = lin.blocks[f.diag_pos]
        Minv = inv_or_nan(D * (1.0 + lam) + 1e-8 * _eye6(D))
        return lambda r: _mv(Minv, r)
    A, E = _tridiag_blocks(lin, f, lam)
    if precond == "bcr":
        levels, root = bcr_factor(A, E)
        return lambda r: bcr_solve(levels, root, r)
    Uinv, W = _build_tridiag_precond(A, E)
    return lambda r: _apply_tridiag_precond(Uinv, W, E, r)


def _hx_operator(lin: Linearized, f: FactorData, lam: float):
    """x (..., N, 6) -> (H + lam * blockdiag(H)) @ x, one fixed-order sum
    over the blocks of each block row."""
    blocks = lin.blocks + lam * torch.where(
        (f.blk_rows == f.blk_cols)[:, None, None], lin.blocks, 0.0)
    blocks = torch.cat([blocks, blocks.new_zeros((1, 6, 6))])
    rows = blocks[f.row_ix]                                  # (N, R, 6, 6)
    cols = torch.cat([f.blk_cols, f.blk_cols.new_zeros(1)])[f.row_ix]

    def hx(x):
        return _mv(rows, x[..., cols, :]).sum(-2)
    return hx


def _dot(a, b):
    return torch.sum(a * b, dim=(-2, -1))


def conjugate_gradient(hx, apply_M, b: torch.Tensor, max_iters: int,
                       rtol: float, stats: dict | None = None) -> torch.Tensor:
    """Preconditioned CG on each right-hand side of b (..., N, 6) from x = 0.
    A column stops once dot(r, r) <= rtol^2 ||b||^2 or after max_iters
    iterations and is frozen from then on; the loop ends when all have."""
    x = torch.zeros_like(b)
    r = b
    z = apply_M(r)
    p = z
    rz = _dot(r, z)
    thresh = rtol * rtol * torch.clamp(_dot(b, b), min=1e-30)
    k = torch.zeros(rz.shape, dtype=torch.int64, device=b.device)
    n_iter = 0
    for _ in range(max_iters):
        live = (k < max_iters) & (_dot(r, r) > thresh)
        n_iter += 1
        if not bool(live.any()):
            break
        Hp = hx(p)
        alpha = rz / torch.clamp(_dot(p, Hp), min=1e-30)
        x_new = x + alpha[..., None, None] * p
        r_new = r - alpha[..., None, None] * Hp
        z = apply_M(r_new)
        rz_new = _dot(r_new, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p_new = z + beta[..., None, None] * p
        m = live[..., None, None]
        x = torch.where(m, x_new, x)
        r = torch.where(m, r_new, r)
        p = torch.where(m, p_new, p)
        rz = torch.where(live, rz_new, rz)
        k = k + live.to(k.dtype)
    if stats is not None:
        stats["cg_iterations"] = stats.get("cg_iterations", 0) + int(k.max())
        stats["host_syncs"] = stats.get("host_syncs", 0) + n_iter + 1
    return x


def pcg_lm_step(poses, factors: FactorData, n_active: int, lam: float,
                max_cg_iters: int = 200, rtol: float = 1e-6,
                precond: str = "auto", stats: dict | None = None):
    """One damped Gauss-Newton step solved by preconditioned CG:
    (candidate poses, candidate cost)."""
    lin = linearize(poses, factors, n_active)
    delta = conjugate_gradient(
        _hx_operator(lin, factors, lam),
        _preconditioner(lin, factors, lam, precond),
        -lin.grad, max_cg_iters, rtol, stats)
    new = _retract(poses, delta, n_active)
    return new, graph_cost(new, factors)


def solve_graph_pcg(poses, factors: FactorData, n_active: int,
                    max_iterations: int = 15, lam0: float = 1e-6,
                    tol: float = 1e-7, max_cg_iters: int = 200,
                    precond: str = "auto", stats: dict | None = None):
    """The LM schedule of ``solver.solve_graph`` around PCG steps.  Returns
    (poses on the device, final cost as a numpy scalar)."""
    return lm_schedule(
        lambda p, lam: pcg_lm_step(p, factors, n_active, lam, max_cg_iters,
                                   precond=precond, stats=stats),
        poses, graph_cost(poses, factors), max_iterations, lam0, tol, stats)


def marginal_blocks_pcg(poses, factors: FactorData, n_active: int, indices,
                        max_cg_iters: int = 400, rtol: float = 1e-9,
                        stats: dict | None = None) -> torch.Tensor:
    """Marginal 6x6 covariance blocks of the poses in ``indices`` (K,),
    without assembling H: the 6 columns H^-1 e_{p,j} of each pose by PCG
    (undamped H, the cyclic-reduction or tridiagonal preconditioner), all
    K*6 columns in one batch.  Returns (K, 6, 6)."""
    lin = linearize(poses, factors, n_active)
    idx = torch.as_tensor(indices, dtype=torch.int64, device=poses.device)
    K = idx.shape[0]
    rows = idx.repeat_interleave(6)
    comp = torch.arange(6, device=poses.device).repeat(K)
    b = poses.new_zeros((K * 6,) + lin.grad.shape)
    b[torch.arange(K * 6, device=poses.device), rows, comp] = 1.0
    x = conjugate_gradient(_hx_operator(lin, factors, 0.0),
                           _preconditioner(lin, factors, 0.0, "auto"), b,
                           max_cg_iters, rtol, stats)
    cols = x[torch.arange(K * 6, device=poses.device), rows]   # (K*6, 6)
    return cols.reshape(K, 6, 6).transpose(1, 2)
