"""Pose-graph least squares for the reference: dense Levenberg-Marquardt
and marginal covariances, in plain torch, float64 unless told otherwise.

The factors are those the program states (its factor module docstring),
with the right perturbation X <- X Exp(delta) and xi = [w, v]:
  prior(i, Tp):    r = Log(Tp^-1 X_i)
  between(i, j, Tm): r = Log(Tm^-1 X_i^-1 X_j)
  gps(i, z):       r = t(X_i) - z
each whitened by 1/sigma, with the first-order inverse right Jacobian
I + ad(r)/2 in the linearisation.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_bench.reference import geometry

# the program's noise table (rad for rotations, m for translations), as
# the reference stage-2 code documents it
SIGMAS = {"prior": [np.deg2rad(10.0)] * 3 + [10.0] * 3,
          "SM": [np.deg2rad(0.05)] * 3 + [0.05] * 3,
          "ODO": [np.deg2rad(3.0)] * 3 + [0.05] * 3,
          "gps": [2.5, 2.5, 3.0]}


def _adjoint(T):
    R = T[..., :3, :3]
    Z = torch.zeros_like(R)
    top = torch.cat([R, Z], -1)
    bottom = torch.cat([geometry.hat(T[..., :3, 3]) @ R, R], -1)
    return torch.cat([top, bottom], -2)


def _jr_inv(r):
    wx = geometry.hat(r[..., :3])
    Z = torch.zeros_like(wx)
    ad = torch.cat([torch.cat([wx, Z], -1),
                    torch.cat([geometry.hat(r[..., 3:]), wx], -1)], -2)
    return torch.eye(6, dtype=r.dtype, device=r.device) + 0.5 * ad


def _equilibrated_solve(A, B):
    """A^-1 B through the Jacobi-scaled S A S (rotation against weak-prior
    rows puts cond(A) near 1e8); NaN where the solve fails."""
    s = torch.rsqrt(torch.clamp(torch.diagonal(A), min=1e-30))
    X, info = torch.linalg.solve_ex(A * s[:, None] * s[None, :], B * s[:, None])
    return torch.where(info == 0, X * s[:, None], torch.nan)


class Graph:
    """Factors as tensors: between (i, j, T, 1/sigma), prior, gps."""

    def __init__(self, n, bi, bj, bT, bw, prior_T, gps=None, device="cpu",
                 dtype=torch.float64):
        as_t = lambda a, d=dtype: torch.as_tensor(np.asarray(a), dtype=d, device=device)
        self.n, self.dtype, self.device = n, dtype, device
        self.bi, self.bj = as_t(bi, torch.int64), as_t(bj, torch.int64)
        self.bT, self.bw = as_t(bT), as_t(bw)
        self.pT = as_t(prior_T)
        self.pw = as_t(1.0 / np.asarray(SIGMAS["prior"]))
        if gps is not None:
            self.gi, self.gz = as_t(gps[0], torch.int64), as_t(gps[1])
            self.gw = as_t(1.0 / np.asarray(SIGMAS["gps"]))
        else:
            self.gi = None

    def residuals(self, X):
        Tij = geometry.inverse(X[self.bi]) @ X[self.bj]
        rb = geometry.log(geometry.inverse(self.bT) @ Tij)
        rp = geometry.log(geometry.inverse(self.pT) @ X[0])
        out = [rb * self.bw, (rp * self.pw)[None]]
        if self.gi is not None:
            out.append((X[self.gi, :3, 3] - self.gz) * self.gw)
        return out, Tij, rb, rp

    def cost(self, X):
        return 0.5 * sum(float((r * r).sum()) for r in self.residuals(X)[0])

    def normal_equations(self, X):
        n, dev, dt = self.n, self.device, self.dtype
        _, Tij, rb, rp = self.residuals(X)
        B = _jr_inv(rb)
        A = -(B @ _adjoint(geometry.inverse(Tij)))
        W2 = (self.bw ** 2)
        H = torch.zeros((n, n, 6, 6), dtype=dt, device=dev)
        g = torch.zeros((n, 6), dtype=dt, device=dev)
        AtW, BtW = A.transpose(-1, -2) * W2[:, None, :], B.transpose(-1, -2) * W2[:, None, :]
        H.index_put_((self.bi, self.bi), AtW @ A, accumulate=True)
        H.index_put_((self.bj, self.bj), BtW @ B, accumulate=True)
        Hij = AtW @ B
        H.index_put_((self.bi, self.bj), Hij, accumulate=True)
        H.index_put_((self.bj, self.bi), Hij.transpose(-1, -2), accumulate=True)
        g.index_add_(0, self.bi, (AtW @ rb[..., None])[..., 0])
        g.index_add_(0, self.bj, (BtW @ rb[..., None])[..., 0])
        Jp = _jr_inv(rp)
        PtW = Jp.T * self.pw[None, :] ** 2
        H[0, 0] += PtW @ Jp
        g[0] += PtW @ rp
        if self.gi is not None:
            R = X[self.gi, :3, :3]
            J = torch.cat([torch.zeros_like(R), R], -1)
            GtW = J.transpose(-1, -2) * (self.gw ** 2)[None, None, :]
            H.index_put_((self.gi, self.gi), GtW @ J, accumulate=True)
            g.index_add_(0, self.gi, (GtW @ (X[self.gi, :3, 3] - self.gz)[..., None])[..., 0])
        H = H.permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
        return H, g.reshape(-1)

    def solve(self, X0, max_iterations: int = 100, tol: float = 1e-12):
        """Levenberg-Marquardt from ``X0`` (n, 4, 4) to convergence."""
        X = torch.as_tensor(X0, dtype=self.dtype, device=self.device).clone()
        cost, lam = self.cost(X), 1e-6
        for _ in range(max_iterations):
            H, g = self.normal_equations(X)
            A = H + torch.diag(lam * torch.diagonal(H) + 1e-12)
            delta = _equilibrated_solve(A, -g[:, None])[:, 0].reshape(-1, 6)
            cand = X @ geometry.exp(delta)
            c = self.cost(cand) if bool(torch.isfinite(delta).all()) else float("inf")
            if np.isfinite(c) and c < cost:
                gain = cost - c
                X, cost, lam = cand, c, max(lam / 5.0, 1e-12)
                if gain < tol * max(cost, 1.0):
                    break
            else:
                lam *= 10.0
                if lam > 1e8:
                    break
        return X

    def marginals(self, X) -> torch.Tensor:
        """(n, 6, 6) diagonal blocks of H^-1 at ``X`` ([w, v] order)."""
        H, _ = self.normal_equations(X)
        eye = torch.eye(6 * self.n, dtype=H.dtype, device=H.device)
        cov = _equilibrated_solve(H, eye).reshape(self.n, 6, self.n, 6)
        k = torch.arange(self.n, device=self.device)
        return cov[k, :, k, :]
