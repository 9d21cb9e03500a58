"""A city street grid: square blocks of buildings between streets, parked
cars along the curbs, poles and trees on the sidewalks.

The grid's geometry is fixed by the configuration; the seed places the
facades (widths, setbacks, gaps, heights), the cars and the street
furniture, so every seed gives the same route and the same kind of scene.
Streets run along x and y through every multiple of ``block_pitch_m``.
"""

from __future__ import annotations

import numpy as np


def _facades(rng, x0, x1, y_face, outward, p):
    """Buildings along one block side from x0 to x1, facade near y_face,
    extending away from the street (``outward`` = +1 or -1)."""
    boxes = []
    x = x0
    while x < x1 - 4.0:
        w = min(rng.uniform(*p["building_width_m"]), x1 - x)
        setback = rng.uniform(*p["setback_m"])
        depth = rng.uniform(*p["building_depth_m"])
        h = rng.uniform(*p["building_height_m"])
        y_a = y_face + outward * setback
        y_b = y_a + outward * depth
        boxes.append([x, min(y_a, y_b), 0.0, x + w, max(y_a, y_b), h])
        x += w + rng.uniform(*p["gap_m"])
    return boxes


def _street_side(rng, a0, a1, offset, along_x, p):
    """Cars at the curb and poles/trees on the sidewalk of one street side;
    ``offset`` is the signed distance of the curb from the centre line."""
    boxes, cyl = [], []
    s = np.sign(offset)
    pitch, keep_out = p["block_pitch_m"], p["street_width_m"] / 2 + 2.0

    def clear(v):
        """Off the crossing streets' carriageways."""
        d = v % pitch
        return keep_out < d < pitch - keep_out

    a = a0 + rng.uniform(0.0, 8.0)
    L, W, H = p["car_size_m"]
    while a < a1 - L:
        if rng.uniform() < p["car_probability"] and clear(a) and clear(a + L):
            c = offset - s * (W / 2 + 0.2)
            lo, hi = (a, a + L), (c - W / 2, c + W / 2)
            boxes.append([lo[0], hi[0], 0.0, lo[1], hi[1], H] if along_x
                         else [hi[0], lo[0], 0.0, hi[1], lo[1], H])
        a += L + rng.uniform(*p["car_gap_m"])
    a = a0 + rng.uniform(0.0, 10.0)
    while a < a1:
        if not clear(a):
            a += 1.0
            continue
        walk = offset + s * rng.uniform(1.0, 2.5)
        tree = rng.uniform() < 0.5
        r = rng.uniform(0.2, 0.4) if tree else 0.12
        h = rng.uniform(3.0, 5.0) if tree else 7.0
        cyl.append([a, walk, r, 0.0, h] if along_x else [walk, a, r, 0.0, h])
        a += rng.uniform(*p["furniture_gap_m"])
    return boxes, cyl


def build(rng: np.random.Generator, p: dict) -> dict:
    pitch, half = p["block_pitch_m"], p["street_width_m"] / 2
    (bx0, bx1), (by0, by1) = p["blocks_x"], p["blocks_y"]
    boxes, cyl = [], []
    for i in range(bx0, bx1):
        for j in range(by0, by1):
            x0, x1 = i * pitch + half + 2.0, (i + 1) * pitch - half - 2.0
            y0, y1 = j * pitch + half + 2.0, (j + 1) * pitch - half - 2.0
            # four block sides: facades face the streets
            for b in _facades(rng, x0, x1, y0, +1, p):
                boxes.append(b)
            for b in _facades(rng, x0, x1, y1, -1, p):
                boxes.append(b)
            for b in _facades(rng, y0 + 14.0, y1 - 14.0, x0, +1, p):
                boxes.append([b[1], b[0], b[2], b[4], b[3], b[5]])
            for b in _facades(rng, y0 + 14.0, y1 - 14.0, x1, -1, p):
                boxes.append([b[1], b[0], b[2], b[4], b[3], b[5]])
    for k in range(by0, by1 + 1):          # streets along x at y = k * pitch
        for s in (-1, 1):
            b, c = _street_side(rng, bx0 * pitch, bx1 * pitch,
                                k * pitch + s * (half - 2.5), True, p)
            boxes += b
            cyl += c
    for k in range(bx0, bx1 + 1):          # streets along y at x = k * pitch
        for s in (-1, 1):
            b, c = _street_side(rng, by0 * pitch, by1 * pitch,
                                k * pitch + s * (half - 2.5), False, p)
            boxes += b
            cyl += c
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 6)
    lo = np.minimum(boxes[:, :3], boxes[:, 3:])
    hi = np.maximum(boxes[:, :3], boxes[:, 3:])
    return {"boxes": np.concatenate([lo, hi], axis=1),
            "cylinders": np.asarray(cyl, dtype=np.float64).reshape(-1, 5),
            "waypoints": np.asarray(p["route_blocks"], dtype=np.float64) * pitch}
