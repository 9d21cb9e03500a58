"""Noise table, factor tensors and the block layout of the normal equations.

Counterpart of ``lidar_slam_arvc_tpu/graph/factors.py``.  The sigmas are
the reference's (graphSLAM.py:13-53) in GTSAM's Pose3 tangent order
[rx, ry, rz, x, y, z].  Residual conventions (right perturbation
X <- X Exp(delta)):

  prior(i, Tp):     r = Log(Tp^-1 X_i)                 (6,)
  between(i,j,Tm):  r = Log(Tm^-1 X_i^-1 X_j)          (6,)
  gps(i, z):        r = t(X_i) - z                     (3,)

``FactorData`` holds the ACTIVE factors (slots with a nonzero weight) on
one device plus gather tables that say where each 6x6 block and gradient
row of the normal equations comes from.  The tables are built on the host
from the factor indices, so every block is a fixed-order sum of gathered
contributions: no scatter-add, whose float accumulation order on CUDA
changes from run to run.  That replaces the reference's TPU layout
(one-hot matmuls, tiled iota-masked band writes, a packed upload).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class NoiseSigmas(NamedTuple):
    """Diagonal factor sigmas (reference graphSLAM.py:13-53)."""
    prior: np.ndarray   # (6,) [rad x3, m x3]
    sm: np.ndarray      # (6,)
    odo: np.ndarray     # (6,)
    gps: np.ndarray     # (3,) [m x, y, altitude]


def _rpy_xyz(rpy_deg: float, xyz_m: float) -> np.ndarray:
    r = np.deg2rad(rpy_deg)
    return np.array([r, r, r, xyz_m, xyz_m, xyz_m], dtype=np.float64)


DEFAULT_SIGMAS = NoiseSigmas(
    prior=_rpy_xyz(10.0, 10.0),          # graphSLAM.py:13-15,32-37
    sm=_rpy_xyz(0.05, 0.05),             # graphSLAM.py:20-23,39-44
    odo=_rpy_xyz(3.0, 0.05),             # graphSLAM.py:16-19,46-51
    gps=np.array([2.5, 2.5, 3.0]),       # graphSLAM.py:24-26,53
)

FACTOR_FIELDS = ("bt_i", "bt_j", "bt_T", "bt_winv", "gps_i", "gps_z",
                 "gps_winv", "pr_i", "pr_T", "pr_winv")


class FactorData(NamedTuple):
    """Active factors and the block layout of H = J^T W^2 J.

    H's contributions are listed as [Hii (E), Hjj (E), Hij (E), Hij^T (E),
    Hgps (G), Hprior (P)] followed by one zero block; the gradient's as
    [bi (E), bj (E), bgps (G), bprior (P)] and one zero row.  Tables are
    padded with the index of that zero entry."""
    bt_i: torch.Tensor        # (E,) int64
    bt_j: torch.Tensor        # (E,) int64
    bt_T: torch.Tensor        # (E, 4, 4) measured T_i_j
    bt_winv: torch.Tensor     # (E, 6) 1/sigma whitening
    gps_i: torch.Tensor       # (G,)
    gps_z: torch.Tensor       # (G, 3)
    gps_winv: torch.Tensor    # (G, 3)
    pr_i: torch.Tensor        # (P,)
    pr_T: torch.Tensor        # (P, 4, 4)
    pr_winv: torch.Tensor     # (P, 6)
    blk_rows: torch.Tensor    # (U,) block row of each nonzero block of H
    blk_cols: torch.Tensor    # (U,) block column (every (p, p) is listed)
    blk_ix: torch.Tensor      # (U, D) contributions summed into each block
    row_ix: torch.Tensor      # (N, R) blocks of each block row; pad U
    diag_pos: torch.Tensor    # (N,) the block (p, p)
    band_pos: torch.Tensor    # (N,) the block (p, p+1), or U if none
    grad_ix: torch.Tensor     # (N, Dg) gradient contributions of each pose


def make_factor_buffers(n_between: int, n_gps: int, n_prior: int) -> dict:
    """Empty host factor buffers in the reference's slot layout: ``{field:
    numpy array}`` for each of ``FACTOR_FIELDS``, every weight zero, every
    transform the identity (float32 values, int32 indices, as the JAX
    package's ``make_factor_buffers``).  ``make_factor_data(capacity,
    device, **buffers)`` takes them; with every weight zero it holds no
    factor."""
    eye = np.eye(4, dtype=np.float32)
    return dict(
        bt_i=np.zeros(n_between, dtype=np.int32),
        bt_j=np.zeros(n_between, dtype=np.int32),
        bt_T=np.tile(eye, (n_between, 1, 1)),
        bt_winv=np.zeros((n_between, 6), dtype=np.float32),
        gps_i=np.zeros(n_gps, dtype=np.int32),
        gps_z=np.zeros((n_gps, 3), dtype=np.float32),
        gps_winv=np.zeros((n_gps, 3), dtype=np.float32),
        pr_i=np.zeros(n_prior, dtype=np.int32),
        pr_T=np.tile(eye, (n_prior, 1, 1)),
        pr_winv=np.zeros((n_prior, 6), dtype=np.float32),
    )


def _gather_table(keys: np.ndarray, n_rows: int) -> np.ndarray:
    """(n_rows, D) table whose row r lists, in increasing order, the
    positions k with keys[k] == r, padded with len(keys)."""
    keys = np.asarray(keys, dtype=np.int64)
    counts = np.bincount(keys, minlength=n_rows)
    table = np.full((n_rows, max(int(counts.max(initial=0)), 1)), len(keys),
                    dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    starts = np.cumsum(counts) - counts
    table[keys[order], np.arange(len(keys)) - starts[keys[order]]] = order
    return table


def make_factor_data(capacity: int, device, bt_i, bt_j, bt_T, bt_winv,
                     gps_i, gps_z, gps_winv, pr_i, pr_T, pr_winv,
                     dtype=torch.float32) -> FactorData:
    """FactorData on ``device`` from host factor buffers (numpy, the
    reference's slot layout) for a graph of ``capacity`` poses, its values
    in ``dtype``.  Slots whose weights are all zero are left out: they add
    nothing."""
    N = int(capacity)
    act_b = np.asarray(bt_winv).any(axis=1)
    act_g = np.asarray(gps_winv).any(axis=1)
    act_p = np.asarray(pr_winv).any(axis=1)
    i = np.asarray(bt_i, dtype=np.int64)[act_b]
    j = np.asarray(bt_j, dtype=np.int64)[act_b]
    g = np.asarray(gps_i, dtype=np.int64)[act_g]
    p = np.asarray(pr_i, dtype=np.int64)[act_p]
    for name, idx in (("between", np.concatenate([i, j])), ("gps", g),
                      ("prior", p)):
        if len(idx) and (idx.min() < 0 or idx.max() >= N):
            raise ValueError(f"{name} factor pose index outside [0, {N})")

    # H's blocks: contribution k lands at (rows[k], cols[k]); each pose
    # that no factor touches gets a zero contribution on its diagonal
    rows = np.concatenate([i, j, i, j, g, p])
    cols = np.concatenate([i, j, j, i, g, p])
    n_contrib = len(rows)
    lonely = np.setdiff1d(np.arange(N), rows[rows == cols])
    rows = np.concatenate([rows, lonely])
    cols = np.concatenate([cols, lonely])
    contrib = np.concatenate([np.arange(n_contrib),
                              np.full(len(lonely), n_contrib)])
    uniq, inv = np.unique(rows * N + cols, return_inverse=True)
    blk_ix = np.append(contrib, n_contrib)[_gather_table(inv, len(uniq))]
    blk_rows, blk_cols = uniq // N, uniq % N
    U = len(uniq)
    row_ix = _gather_table(blk_rows, N)
    diag_pos = np.searchsorted(uniq, np.arange(N) * (N + 1))
    band_key = np.arange(N) * (N + 1) + 1
    band_pos = np.minimum(np.searchsorted(uniq, band_key), U - 1)
    band_pos = np.where((uniq[band_pos] == band_key)
                        & (np.arange(N) < N - 1), band_pos, U)
    grad_ix = _gather_table(np.concatenate([i, j, g, p]), N)

    def f32(a, shape):
        return torch.as_tensor(np.asarray(a, dtype=np.float32).reshape(shape),
                               device=device, dtype=dtype)

    def i64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    return FactorData(
        bt_i=i64(i), bt_j=i64(j),
        bt_T=f32(np.asarray(bt_T)[act_b], (-1, 4, 4)),
        bt_winv=f32(np.asarray(bt_winv)[act_b], (-1, 6)),
        gps_i=i64(g), gps_z=f32(np.asarray(gps_z)[act_g], (-1, 3)),
        gps_winv=f32(np.asarray(gps_winv)[act_g], (-1, 3)),
        pr_i=i64(p), pr_T=f32(np.asarray(pr_T)[act_p], (-1, 4, 4)),
        pr_winv=f32(np.asarray(pr_winv)[act_p], (-1, 6)),
        blk_rows=i64(blk_rows), blk_cols=i64(blk_cols), blk_ix=i64(blk_ix),
        row_ix=i64(row_ix), diag_pos=i64(diag_pos), band_pos=i64(band_pos),
        grad_ix=i64(grad_ix))
