"""Block cyclic reduction for SPD block-tridiagonal systems.

Counterpart of ``lidar_slam_arvc_tpu/graph/bcr.py``.  Eliminating the
odd-indexed block unknowns level by level turns the factorisation and every
solve into log2(N) levels of batched 6x6 inverses and products (N/2^k
independent blocks per level) instead of N dependent steps.  Per level,
for diagonal blocks D_i and superdiagonal blocks E_i = M[i, i+1]
(M[i+1, i] = E_i^T), eliminating odd j gives the half-size system

    D'_k = D_2k - E_{2k-1}^T D_{2k-1}^-1 E_{2k-1} - E_2k D_{2k+1}^-1 E_2k^T
    E'_k = -E_2k D_{2k+1}^-1 E_{2k+1}
    b'_k = b_2k - E_{2k-1}^T D_{2k-1}^-1 b_{2k-1} - E_2k D_{2k+1}^-1 b_{2k+1}

Each D' is a Schur complement of an SPD matrix, hence SPD.  E has one row
per diagonal block with E[N-1] = 0, so every boundary case is a slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_slam_arvc_tpu_torch.graph.solver import _mv


class BCRLevel(NamedTuple):
    Dinv_odd: torch.Tensor   # (n/2, 6, 6)  D_{2k+1}^-1
    E_up: torch.Tensor       # (n/2, 6, 6)  E_{2k}   (couples 2k   <-> 2k+1)
    E_dn: torch.Tensor       # (n/2, 6, 6)  E_{2k+1} (couples 2k+1 <-> 2k+2)
    U: torch.Tensor          # (n/2, 6, 6)  E_{2k-1}^T D_{2k-1}^-1, U_0 = 0
    V: torch.Tensor          # (n/2, 6, 6)  E_2k D_{2k+1}^-1


def _t(a):
    return a.transpose(-1, -2)


def bcr_factor(D: torch.Tensor, E: torch.Tensor):
    """Factor the SPD block-tridiagonal matrix (D (N,6,6) diagonal, E
    (N,6,6) superdiagonal, E[N-1] = 0); N a power of two.  Returns
    (levels, Dinv_root)."""
    N = D.shape[0]
    if N & (N - 1):
        raise ValueError(f"bcr_factor needs a power-of-two block count, got {N}")
    levels = []
    zero = D.new_zeros((1, 6, 6))
    while N > 1:
        D_even, D_odd = D[0::2], D[1::2]
        E_up, E_dn = E[0::2], E[1::2]
        Dinv_odd = torch.linalg.inv_ex(D_odd)[0]
        V = E_up @ Dinv_odd
        U_rest = _t(E_dn[:-1]) @ Dinv_odd[:-1]
        U = torch.cat([zero, U_rest])
        t_up = torch.cat([zero, U_rest @ E_dn[:-1]])
        D = D_even - t_up - V @ _t(E_up)
        E = -(V @ E_dn)
        levels.append(BCRLevel(Dinv_odd, E_up, E_dn, U, V))
        N //= 2
    return levels, torch.linalg.inv_ex(D[0])[0]


def bcr_solve(levels, Dinv_root: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b from bcr_factor's output; b is (..., N, 6)."""
    odd_stack = []
    for lv in levels:
        b_even, b_odd = b[..., 0::2, :], b[..., 1::2, :]
        odd_stack.append(b_odd)
        t_up = torch.cat([torch.zeros_like(b_odd[..., :1, :]),
                          _mv(lv.U[1:], b_odd[..., :-1, :])], dim=-2)
        b = b_even - t_up - _mv(lv.V, b_odd)
    x = _mv(Dinv_root, b)
    for lv, b_odd in zip(reversed(levels), reversed(odd_stack)):
        x_next = torch.cat([x[..., 1:, :], torch.zeros_like(x[..., :1, :])],
                           dim=-2)
        x_odd = _mv(lv.Dinv_odd, b_odd - _mv(_t(lv.E_up), x)
                    - _mv(lv.E_dn, x_next))
        x = torch.stack([x, x_odd], dim=-2).reshape(
            x.shape[:-2] + (2 * x.shape[-2], 6))
    return x
