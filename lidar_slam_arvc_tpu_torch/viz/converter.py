"""Dataset converter: per-scan PCD -> PLY export (points or alpha-shape mesh).

Counterpart of ``lidar_slam_arvc_tpu/viz/converter.py`` (reference
run_converter.py:138-191): every ``sampling``-th scan of the dataset is
saved under robot0/lidar/dataply/<t>.ply, as its points or, with
``mesh=True``, as the alpha-shape surface of its points
(``viz.mapping.alpha_shape_mesh``; the reference's save_pointcloud_as_mesh,
keyframe.py:53-59, uses Open3D with alpha 0.01).
"""

from __future__ import annotations

import os

from lidar_slam_arvc_tpu_torch.io.euroc import TIME, EurocDataset
from lidar_slam_arvc_tpu_torch.io.pcd import read_pcd
from lidar_slam_arvc_tpu_torch.viz.mapping import alpha_shape_mesh, write_ply


def convert_dataset(directory: str, sampling: int = 1, mesh: bool = False,
                    alpha: float = 0.01) -> int:
    """Write the PLY files; returns how many."""
    euroc = EurocDataset(directory)
    times = euroc.read_csv("/robot0/lidar/data.csv")[TIME]
    out_dir = f"{directory}/robot0/lidar/dataply"
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for t in times[::sampling]:
        pts = read_pcd(euroc.scan_pcd_path(t))
        if mesh:
            verts, tris = alpha_shape_mesh(pts, alpha)
            write_ply(f"{out_dir}/{t}.ply", verts, faces=tris)
        else:
            write_ply(f"{out_dir}/{t}.ply", pts)
        n += 1
    kind = "mesh" if mesh else "point"
    print(f"converter: wrote {n} {kind} PLY files -> {out_dir}")
    return n
