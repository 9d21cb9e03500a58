"""Keyframe poses along a route: waypoints rounded at the corners, walked at
a constant speed, heading along the path, on flat ground (z = 0)."""

from __future__ import annotations

import numpy as np


def _chaikin(points: np.ndarray, rounds: int) -> np.ndarray:
    """Corner cutting: each round replaces every segment by its 1/4 and 3/4
    points, keeping the two ends."""
    for _ in range(rounds):
        a, b = points[:-1], points[1:]
        cut = np.empty((2 * len(a), 2))
        cut[0::2] = 0.75 * a + 0.25 * b
        cut[1::2] = 0.25 * a + 0.75 * b
        points = np.concatenate([points[:1], cut, points[-1:]])
    return points


def _densify(points: np.ndarray, step: float) -> np.ndarray:
    out = [points[:1]]
    for a, b in zip(points[:-1], points[1:]):
        n = max(int(np.ceil(np.linalg.norm(b - a) / step)), 1)
        out.append(a + (b - a) * (np.arange(1, n + 1) / n)[:, None])
    return np.concatenate(out)


def yaw_transform(x, y, yaw, z=0.0) -> np.ndarray:
    T = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = (x, y, z)
    return T


def keyframe_poses(waypoints: np.ndarray, n: int, spacing: float,
                   corner_rounds: int = 5) -> np.ndarray:
    """(n, 4, 4) float64 poses ``spacing`` metres apart along the rounded
    route, starting at its first waypoint."""
    curve = _densify(_chaikin(_densify(np.asarray(waypoints, float), 2.0),
                              corner_rounds), 0.05)
    seg = np.linalg.norm(np.diff(curve, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    want = spacing * np.arange(n)
    if want[-1] > s[-1] - 1.0:
        raise ValueError(f"route of {s[-1]:.0f} m is shorter than {n} "
                         f"keyframes at {spacing} m")
    x = np.interp(want, s, curve[:, 0])
    y = np.interp(want, s, curve[:, 1])
    ahead = want + 0.5
    yaw = np.arctan2(np.interp(ahead, s, curve[:, 1]) - y,
                     np.interp(ahead, s, curve[:, 0]) - x)
    return np.stack([yaw_transform(*v) for v in zip(x, y, yaw)])


def drifted(T_gt: np.ndarray, rng: np.random.Generator, p: dict) -> np.ndarray:
    """The truth re-folded from relative steps with a planar drift: a scale
    bias and Gaussian noise along each step, lateral noise, and a yaw bias
    with Gaussian noise (``p``: scale_bias, xy_sigma_m, yaw_bias_rad,
    yaw_sigma_rad)."""
    out = [T_gt[0].copy()]
    for i in range(len(T_gt) - 1):
        rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1]
        step = np.linalg.norm(rel[:2, 3])
        noise = yaw_transform(p["scale_bias"] * step + rng.normal(scale=p["xy_sigma_m"]),
                              rng.normal(scale=p["xy_sigma_m"]),
                              p["yaw_bias_rad"] + rng.normal(scale=p["yaw_sigma_rad"]))
        out.append(out[-1] @ rel @ noise)
    return np.stack(out)
