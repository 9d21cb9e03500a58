"""A campus walk: a closed path around a quad, buildings beyond the path on
both sides, trees and lamp posts beside it.

The path is a rounded rectangle of ``loop_length_m`` with the aspect
``loop_aspect``; the route walks it ``laps`` times, so every place of a
later lap is revisited within the walking pace's spacing.  The seed places
the buildings, trees and posts.
"""

from __future__ import annotations

import numpy as np


def _ring(length: float, aspect: float):
    """Corners of the loop's rectangle, centred at the origin."""
    w = length / (2.0 * (1.0 + 1.0 / aspect))
    h = w / aspect
    return w, h


def build(rng: np.random.Generator, p: dict) -> dict:
    w, h = _ring(p["loop_length_m"], p["loop_aspect"])
    boxes, cyl = [], []
    # buildings outside the path, one row per side, and a few inside
    for side in range(4):
        along = w if side % 2 == 0 else h
        a = -along / 2 - 10.0
        while a < along / 2 + 10.0:
            bw = rng.uniform(*p["building_width_m"])
            off = rng.uniform(*p["building_offset_m"])
            depth = rng.uniform(*p["building_depth_m"])
            ht = rng.uniform(*p["building_height_m"])
            if side == 0:
                boxes.append([a, h / 2 + off, 0, a + bw, h / 2 + off + depth, ht])
            elif side == 1:
                boxes.append([w / 2 + off, a, 0, w / 2 + off + depth, a + bw, ht])
            elif side == 2:
                boxes.append([a, -h / 2 - off - depth, 0, a + bw, -h / 2 - off, ht])
            else:
                boxes.append([-w / 2 - off - depth, a, 0, -w / 2 - off, a + bw, ht])
            a += bw + rng.uniform(*p["gap_m"])
    for _ in range(p["inner_buildings"]):
        bw, bd = rng.uniform(4.0, 10.0, size=2)
        cx = rng.uniform(-w / 2 + 8.0, w / 2 - 8.0 - bw)
        cy = rng.uniform(-h / 2 + 6.0, h / 2 - 6.0 - bd)
        boxes.append([cx, cy, 0, cx + bw, cy + bd, rng.uniform(3.0, 9.0)])
    # trees and lamp posts on both sides of the path
    n = int(p["loop_length_m"] / p["furniture_gap_m"])
    for k in range(n):
        s = (k + rng.uniform(0, 0.8)) / n
        x, y, nx, ny = _on_ring(s, w, h)
        side = 1.0 if rng.uniform() < 0.5 else -1.0
        d = side * rng.uniform(*p["furniture_offset_m"])
        tree = rng.uniform() < 0.6
        cyl.append([x + d * nx, y + d * ny,
                    rng.uniform(0.15, 0.45) if tree else 0.1, 0.0,
                    rng.uniform(4.0, 9.0) if tree else 4.5])
    corners = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2],
                        [-w / 2, h / 2]])
    start = np.array([[0.0, -h / 2]])
    laps = []
    for _ in range(p["laps"]):
        laps += [corners[1:], corners[:1]]
    way = np.concatenate([start] + laps + [start + [[w / 4, 0.0]]])
    return {"boxes": np.asarray(boxes, dtype=np.float64).reshape(-1, 6),
            "cylinders": np.asarray(cyl, dtype=np.float64).reshape(-1, 5),
            "waypoints": way}


def _on_ring(s: float, w: float, h: float):
    """Point at fraction s of the rectangle's perimeter and its outward
    normal."""
    per = 2 * (w + h)
    d = s * per
    if d < w:
        return -w / 2 + d, -h / 2, 0.0, -1.0
    d -= w
    if d < h:
        return w / 2, -h / 2 + d, 1.0, 0.0
    d -= h
    if d < w:
        return w / 2 - d, h / 2, 0.0, 1.0
    d -= w
    return -w / 2, h / 2 - d, -1.0, 0.0
