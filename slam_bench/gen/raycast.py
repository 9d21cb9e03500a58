"""Ray casting of a spinning multi-beam LiDAR against an analytic world.

The world is a ground plane at z = 0, axis-aligned boxes (buildings,
parked cars) ``(K, 6)`` = [xmin, ymin, zmin, xmax, ymax, zmax] and
vertical cylinders (poles, trunks) ``(C, 5)`` = [cx, cy, r, zmin, zmax].
A scan is the first hit of every beam (elevation x azimuth) within the
sensor's range, in the sensor frame, with Gaussian range noise.
"""

from __future__ import annotations

import math

import torch

# rays per block of the intersection tests: bounds the (rays, primitives)
# temporaries to a few hundred MB
RAY_BLOCK = 16384


def beam_directions(elevations_deg, azimuth_steps: int, device) -> torch.Tensor:
    """(E * A, 3) unit directions in the sensor frame, beam-major."""
    el = torch.deg2rad(torch.as_tensor(elevations_deg, dtype=torch.float64,
                                       device=device))
    az = torch.arange(azimuth_steps, dtype=torch.float64, device=device) \
        * (2.0 * math.pi / azimuth_steps)
    ce, se = torch.cos(el)[:, None], torch.sin(el)[:, None]
    d = torch.stack([ce * torch.cos(az)[None, :], ce * torch.sin(az)[None, :],
                     se.expand(-1, azimuth_steps)], dim=-1)
    return d.reshape(-1, 3)


def _near(prims: torch.Tensor, xy: torch.Tensor, reach: float) -> torch.Tensor:
    """Primitives whose footprint comes within ``reach`` of ``xy``."""
    if prims.shape[0] == 0:
        return prims
    if prims.shape[1] == 6:
        dx = torch.clamp(torch.maximum(prims[:, 0] - xy[0], xy[0] - prims[:, 3]), min=0)
        dy = torch.clamp(torch.maximum(prims[:, 1] - xy[1], xy[1] - prims[:, 4]), min=0)
        return prims[dx * dx + dy * dy < reach * reach]
    d = torch.hypot(prims[:, 0] - xy[0], prims[:, 1] - xy[1]) - prims[:, 2]
    return prims[d < reach]


def _hit_boxes(o, d, boxes):
    """(R,) nearest entry distance of rays o + t d into the boxes (inf: none)."""
    if boxes.shape[0] == 0:
        return torch.full(d.shape[:1], math.inf, dtype=d.dtype, device=d.device)
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t1 = (boxes[None, :, :3] - o) * inv[:, None, :]
    t2 = (boxes[None, :, 3:] - o) * inv[:, None, :]
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    hit = (tmax >= tmin) & (tmin > 1e-6)
    return torch.where(hit, tmin, math.inf).amin(-1)


def _hit_cylinders(o, d, cyl):
    if cyl.shape[0] == 0:
        return torch.full(d.shape[:1], math.inf, dtype=d.dtype, device=d.device)
    ox = o[0] - cyl[None, :, 0]
    oy = o[1] - cyl[None, :, 1]
    dx, dy = d[:, 0:1], d[:, 1:2]
    a = torch.clamp(dx * dx + dy * dy, min=1e-12)
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - cyl[None, :, 2] ** 2
    disc = b * b - 4.0 * a * c
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
    z = o[2] + t * d[:, 2:3]
    hit = (disc >= 0) & (t > 1e-6) & (z >= cyl[None, :, 3]) & (z <= cyl[None, :, 4])
    return torch.where(hit, t, math.inf).amin(-1)


def cast(origin: torch.Tensor, dirs_world: torch.Tensor, boxes: torch.Tensor,
         cylinders: torch.Tensor, max_range: float) -> torch.Tensor:
    """(R,) first-hit distance of each ray from ``origin`` (inf: no hit
    within ``max_range``)."""
    boxes = _near(boxes, origin[:2], max_range)
    cylinders = _near(cylinders, origin[:2], max_range)
    out = []
    for r0 in range(0, dirs_world.shape[0], RAY_BLOCK):
        d = dirs_world[r0:r0 + RAY_BLOCK]
        tg = torch.where(d[:, 2] < -1e-9, -origin[2] / torch.where(
            d[:, 2] < -1e-9, d[:, 2], torch.ones_like(d[:, 2])), math.inf)
        t = torch.minimum(tg, torch.minimum(_hit_boxes(origin, d, boxes),
                                            _hit_cylinders(origin, d, cylinders)))
        out.append(torch.where(t <= max_range, t, math.inf))
    return torch.cat(out)
