"""Triangle loop closing for the reference, in numpy, replayed round by
round from the pose estimates the program held at each round.

The semantics are those the program states (its loop-closing module
docstring): candidates are earlier poses within ``radius`` of the current
one and more than ``distance_backwards`` of path behind it; a triplet
(i, j1, j2) takes for each candidate j1 the first later candidate j2 with
1 < |j2 - j1| < 80 and 1 m < |p_j2 - p_j1| < 2 m; up to ``n_triplets`` are
drawn without replacement by a ``numpy`` generator seeded 0 once per run;
a triplet is accepted when T_ij1 T_j1j2 T_ij2^-1 is within 0.1 m and,
on the smaller of its two XYZ Euler branches, 0.05 rad of the identity.
"""

from __future__ import annotations

import numpy as np


def triplets(positions: np.ndarray, current: int, radius: float,
             distance_backwards: float) -> list:
    if len(positions) < 3:
        return []
    steps = np.linalg.norm(np.diff(positions, axis=0), axis=1)
    back = np.cumsum(steps[::-1])[::-1]
    hits = np.nonzero(back > distance_backwards)[0]
    if len(hits) == 0:
        return []
    index = int(hits[-1])
    d = np.linalg.norm(positions[:index] - positions[-1], axis=1)
    cand = np.sort(np.nonzero(d < radius)[0])
    out = []
    for k, j1 in enumerate(cand):
        rest = cand[k:]
        di = np.abs(rest - j1)
        de = np.linalg.norm(positions[rest] - positions[j1], axis=1)
        ok = np.nonzero((di > 1) & (di < 80) & (de > 1.0) & (de < 2.0))[0]
        if len(ok):
            out.append((current, int(j1), int(rest[ok[0]])))
    return out


def _euler_branches(R: np.ndarray):
    b1 = np.arcsin(np.clip(R[0, 2], -1.0, 1.0))
    out = []
    for beta in (b1, np.pi - b1):
        s = np.sign(np.cos(beta)) or 1.0
        e = np.array([np.arctan2(-s * R[1, 2], s * R[2, 2]), beta,
                      np.arctan2(-s * R[0, 1], s * R[0, 0])])
        out.append(np.arctan2(np.sin(e), np.cos(e)))
    return out


def consistent(cycle: np.ndarray) -> bool:
    e1, e2 = _euler_branches(cycle[:3, :3])
    return (np.linalg.norm(cycle[:3, 3]) < 0.1
            and min(np.linalg.norm(e1), np.linalg.norm(e2)) < 0.05)


def replay(rounds: list, register, radius: float, distance_backwards: float):
    """Accepted [i, j] pairs and their transforms over the recorded rounds.

    ``rounds``: dicts with ``index``, ``n_triplets``, ``estimate`` (n, 4, 4)
    float64 and ``T0_gps``; ``register(pairs, seeds) -> (k, 4, 4)`` float64
    T_i_j in the LiDAR frame."""
    rng = np.random.default_rng(0)
    accepted, transforms = [], []
    for r in rounds:
        est = r["estimate"]
        tri = triplets(est[:, :3, 3], r["index"], radius, distance_backwards)
        if not tri:
            continue
        n = min(len(tri), r["n_triplets"])
        tri = [tri[k] for k in rng.choice(len(tri), size=n, replace=False)]
        pairs = np.array([[t[0], t[1]] for t in tri] + [[t[0], t[2]] for t in tri])
        g_inv = np.linalg.inv(r["T0_gps"])
        lidar = est @ g_inv
        seeds = np.stack([np.linalg.inv(lidar[i]) @ lidar[j] for i, j in pairs])
        T = np.einsum("ij,njk,kl->nil", g_inv, register(pairs, seeds), r["T0_gps"])
        for k, (i, j1, j2) in enumerate(tri):
            T_j1j2 = np.linalg.inv(lidar[j1]) @ lidar[j2]
            if consistent(T[k] @ T_j1j2 @ np.linalg.inv(T[n + k])):
                accepted += [(i, j1), (i, j2)]
                transforms += [T[k], T[n + k]]
    return accepted, transforms
