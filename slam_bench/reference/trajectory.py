"""Trajectory errors (ATE after rigid Umeyama alignment, RPE), host-side
numpy float64: a copy of the port's ``utils/metrics.py`` arithmetic, for
the benchmark's own sanity prints.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Rigid (optionally similarity) alignment src -> dst for (N,3) points."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    if with_scale:
        var = (sc ** 2).sum() / len(src)
        s = np.trace(np.diag(S) @ D) / var
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate(T_est: np.ndarray, T_gt: np.ndarray, align: bool = True) -> dict:
    """Absolute trajectory error of positions after optional rigid alignment."""
    p_est = np.asarray(T_est)[:, :3, 3]
    p_gt = np.asarray(T_gt)[:, :3, 3]
    if align:
        R, t, s = umeyama_alignment(p_est, p_gt)
        p_est = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return {"rmse": float(np.sqrt((err ** 2).mean())),
            "mean": float(err.mean()), "median": float(np.median(err)),
            "max": float(err.max())}


def rpe(T_est: np.ndarray, T_gt: np.ndarray, delta: int = 1) -> dict:
    """Relative pose error over ``delta``-step windows."""
    T_est = np.asarray(T_est)
    T_gt = np.asarray(T_gt)
    n = len(T_est) - delta
    trans = np.empty(n)
    rot = np.empty(n)
    for i in range(n):
        rel_est = np.linalg.inv(T_est[i]) @ T_est[i + delta]
        rel_gt = np.linalg.inv(T_gt[i]) @ T_gt[i + delta]
        e = np.linalg.inv(rel_gt) @ rel_est
        trans[i] = np.linalg.norm(e[:3, 3])
        rot[i] = np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1))
    return {"trans_rmse": float(np.sqrt((trans ** 2).mean())),
            "rot_rmse": float(np.sqrt((rot ** 2).mean()))}
