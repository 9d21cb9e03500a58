"""Point-to-plane ICP for the reference, one pair at a time, in plain torch.

The semantics the program states (its registration module docstring):
exact nearest neighbours, correspondences gated at the correspondence
distance, Welsch IRLS weights with the scale from the gated mean square
distance sharpened once, one Gauss-Newton step on the left perturbation
T' = exp(xi) T with the Tikhonov floor 1e-6 (trace / 6 + 1), a non-finite
step leaves T, and the pair stops once |xi| <= tol or after
``max_iterations``.  The source transform and the normal equations are
matmuls, so they run in TF32 when that is switched on (the control).
"""

from __future__ import annotations

import torch

from slam_bench.reference import geometry

TOL = 1e-4


def nearest(src: torch.Tensor, tgt: torch.Tensor, gate: float, block: int = 4096):
    """(d2 (S,), index (S,)) of each source's nearest target, exact: the
    search ranks |s|^2 + |t|^2 - 2 s.t in float64 (a matmul, which TF32
    does not touch), ties to the lowest index, and the distance returned
    is recomputed from the coordinates in the sources' precision.  Sources
    with no target within ``gate`` get d2 = inf: they are gated out either
    way."""
    t64 = tgt.double()
    tt = (t64 * t64).sum(-1)
    d2 = torch.empty(len(src), dtype=src.dtype, device=src.device)
    idx = torch.empty(len(src), dtype=torch.int64, device=src.device)
    for s0 in range(0, len(src), block):
        s = src[s0:s0 + block]
        s64 = s.double()
        score = (s64 * s64).sum(-1, keepdim=True) + tt[None, :] - 2.0 * (s64 @ t64.T)
        best, arg = score.min(-1)
        q = tgt[arg]
        dd = ((s - q) ** 2).sum(-1)
        d2[s0:s0 + block] = torch.where(best <= gate * gate * 1.0001, dd, torch.inf)
        idx[s0:s0 + block] = arg
    return d2, idx


def icp(src, tgt, tgt_normals, T_init, gate: float, max_iterations: int, lowp=None):
    """(T (4, 4) float64, fitness, iterations, final |xi|) registering the
    (S, 3) source onto the (T, 3) target with normals, from ``T_init``.
    ``lowp``: a rounding applied to every per-point operand (the points,
    neighbours, normals, residuals and Jacobians; sums accumulate in
    float32), for the control in a lower precision."""
    lowp = lowp or (lambda x: x)
    T = torch.as_tensor(T_init, dtype=torch.float64, device=src.device)
    thr2 = gate * gate
    delta, it, fit = float("inf"), 0, 0.0
    n_src = max(len(src), 1)
    while it < max_iterations and delta > TOL:
        p = lowp(src @ lowp(T[:3, :3].float()).T + lowp(T[:3, 3].float()))
        d2, idx = nearest(p, tgt, gate)
        q, n = tgt[idx], tgt_normals[idx]
        d2 = lowp(d2)
        w = (d2 <= thr2).float()
        fit = float(w.sum()) / n_src
        d2z = torch.where(d2 <= thr2, d2, torch.zeros_like(d2))
        sigma2 = (w * d2z).sum() / torch.clamp(w.sum(), min=1.0)
        w1 = w * torch.exp(-d2z / torch.clamp(2.0 * sigma2, min=1e-8))
        sigma2 = (w1 * d2z).sum() / torch.clamp(w1.sum(), min=1e-6)
        w = w * torch.exp(-d2z / torch.clamp(2.0 * sigma2, min=1e-8))
        r = lowp((n * (p - q)).sum(-1))
        J = lowp(torch.cat([torch.linalg.cross(p, n), n], dim=-1))
        Jw = lowp(J * w[:, None])
        H = (Jw.T @ J).double()
        b = -(Jw.T @ r[:, None])[:, 0].double()
        damp = 1e-6 * (torch.trace(H) / 6.0 + 1.0)
        xi = torch.linalg.solve(H + damp * torch.eye(6, dtype=H.dtype, device=H.device), b)
        if not bool(torch.isfinite(xi).all()):
            xi = torch.zeros_like(xi)
        T = geometry.exp(xi) @ T
        delta = float(torch.linalg.vector_norm(xi))
        it += 1
    return T, fit, it, delta
