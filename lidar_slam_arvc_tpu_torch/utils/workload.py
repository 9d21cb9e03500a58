"""bench.py's synthetic stage-1 workload, as the port's card checks build it.

``chip_smoke.py`` and ``utils/moments_variants.py`` take their inputs from
here: ``voxelised_scans`` renders scans of bench.py's world
(``utils.synthetic``), crops them and voxelises them at its capacity, and
``k2_cases`` gives K2's (ball moments) two measured shapes.
``method_dataset`` writes the datasets on which ``chip_smoke.py`` runs the
``icp2planes`` and ``fpfh`` registration methods and ``stage2_parity.py``
runs the JAX package for its reference numbers.
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
N_SCANS = 257
# the fpfh dataset: the box world of the JAX package's method tests
# (tests/test_pipeline.py::TestOtherMethods), whose corners and edges give
# the descriptors something to match, at full scan width and reduced depth
BOX_WORLD = {"extent": 11.0, "n_ground": 14000, "n_pillars": 6,
             "pillar_pts": 600, "n_boxes": 10, "box_pts": 2000}
FPFH_SCANS = 33
FPFH_RANGE = 10.0


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


def method_dataset(directory: str, method: str) -> dict:
    """Write the dataset of a registration method's card check and return
    ``make_dataset``'s info (``T_gt`` among it).

    ``icp2planes``: bench.py's workload (N_SCANS scans of SCAN_POINTS
    points, seed 0: the scans of ``chip_smoke.py``'s phase 4) with
    ``method: icp2planes`` in both parameter files.  ``fpfh``: FPFH_SCANS
    scans of SCAN_POINTS points within FPFH_RANGE m of BOX_WORLD, seed 2, on
    a 5 m circle, voxel VOXEL."""
    if method == "icp2planes":
        return synthetic.make_dataset(
            directory, n_scans=N_SCANS, seed=0, scan_points=SCAN_POINTS,
            world_kwargs=WORLD,
            scanmatcher_params={"voxel_size": VOXEL, "method": method},
            slam_params={"method": method})
    if method == "fpfh":
        return synthetic.make_dataset(
            directory, n_scans=FPFH_SCANS, seed=2, radius=5.0,
            scan_points=SCAN_POINTS, max_range=FPFH_RANGE,
            world_kwargs=BOX_WORLD,
            scanmatcher_params={"voxel_size": VOXEL, "method": method},
            slam_params={"method": method})
    raise ValueError(f"no card dataset for method {method!r}")
