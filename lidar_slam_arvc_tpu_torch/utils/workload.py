"""bench.py's synthetic stage-1 workload, as the port's card checks build it.

``chip_smoke.py`` and ``utils/moments_variants.py`` take their inputs from
here: ``voxelised_scans`` renders scans of bench.py's world
(``utils.synthetic``), crops them and voxelises them at its capacity, and
``k2_cases`` gives K2's (ball moments) two measured shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch import cloud as cl
from lidar_slam_arvc_tpu_torch.utils import synthetic

SCAN_POINTS = 12000
WORLD = {"extent": 30.0, "n_ground": 20000, "n_pillars": 40, "pillar_pts": 500}
VOXEL = 0.2
CAPACITY = 8192
RADIUS = 0.5          # normal radius at a 0.2 m voxel: max(0.3, 2.5 * 0.2)


def cloud_points(rng: np.random.Generator, B: int, n: int,
                 extent: float = 25.0) -> np.ndarray:
    """(B, n, 3) f32 points uniform in a box of half-width ``extent``,
    z in [-1, 3)."""
    p = np.empty((B, n, 3), dtype=np.float32)
    p[..., :2] = rng.uniform(-extent, extent, (B, n, 2))
    p[..., 2] = rng.uniform(-1.0, 3.0, (B, n))
    return p


def voxelised_scans(rng: np.random.Generator, dev, poses) -> cl.Cloud:
    """Scans of bench.py's world rendered at ``poses`` (N, 4, 4), cropped
    and voxelised at capacity CAPACITY, as a batched Cloud on ``dev``."""
    world = synthetic.make_world(rng, **WORLD)
    raw = [cl.from_numpy(synthetic.render_scan(world, T, rng, max_points=SCAN_POINTS),
                         65536, device=dev)
           for T in poses]
    c = cl.Cloud(torch.stack([r.points for r in raw]),
                 torch.stack([r.mask for r in raw]))
    c = cl.crop_radius_height(c, 0.5, 35.0, -1.0, 50.0)
    c, _ = cl.voxel_downsample_counted(c, VOXEL, out_capacity=CAPACITY)
    return c


def k2_cases(rng: np.random.Generator, dev) -> list[tuple[str, cl.Cloud, float]]:
    """K2's measured shapes as (tag, cloud, radius), each cloud its own
    query and target cloud: ``ragged``, B = 2, Q = T = 1000 with ~30%
    masked, r = 0.3; ``scans``, 4 voxelised scans of bench.py's trajectory,
    r = RADIUS (the normals' ball at bench.py's voxel)."""
    scans = voxelised_scans(rng, dev, synthetic.make_trajectory(4, radius=12.0))
    p = cloud_points(rng, 2, 1000, extent=2.0)
    m = rng.uniform(size=(2, 1000)) > 0.3
    ragged = cl.Cloud(torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev))
    return [("ragged", ragged, 0.3), ("scans", scans, RADIUS)]
