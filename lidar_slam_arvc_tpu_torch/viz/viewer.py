"""Dataset viewer: trajectory plots + global map export.

Counterpart of ``lidar_slam_arvc_tpu/viz/viewer.py`` (reference
run_map_viewer.py:102-158): prefer the SLAM solution, else the scan
matcher's trajectory; draw the loop-closure chords; build and export the
global map.  Artifacts land in <dataset>/robot0/viz/.  The keyframe
sampling of the map is the slam parameters' ``visualization_keyframe_
sampling`` (default 10), which the JAX package's viewer never reads
(its viewer.py:19 fixes it at 10).
"""

from __future__ import annotations

import os

from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.io.pcd import write_pcd
from lidar_slam_arvc_tpu_torch.viz.mapping import build_map, write_ply
from lidar_slam_arvc_tpu_torch.viz.plots import (
    plot_trajectory, plot_trajectory_with_loop_closures,
)

DEFAULT_KEYFRAME_SAMPLING = 10


def keyframe_sampling_of(euroc: EurocDataset) -> int:
    """``visualization_keyframe_sampling`` of the slam parameters, or the
    default when the file or the key is missing."""
    try:
        params = euroc.read_slam_parameters()
    except FileNotFoundError:
        return DEFAULT_KEYFRAME_SAMPLING
    return int(params.get("visualization_keyframe_sampling",
                          DEFAULT_KEYFRAME_SAMPLING))


def view_dataset(directory: str, keyframe_sampling: int | None = None,
                 voxel_size: float | None = 0.2) -> dict:
    """Write trajectory.png, trajectory_loop_closures.png, map.ply and
    map.pcd; ``keyframe_sampling`` None reads it from the slam parameters."""
    euroc = EurocDataset(directory)
    if keyframe_sampling is None:
        keyframe_sampling = keyframe_sampling_of(euroc)
    out_dir = f"{directory}/robot0/viz"
    os.makedirs(out_dir, exist_ok=True)

    loop_pairs = []
    try:
        times, T = euroc.read_trajectory("/robot0/SLAM/solution_graphslam.csv")
        source = "SLAM"
        try:
            lc = euroc.read_csv("/robot0/SLAM/loop_closures.csv")
            loop_pairs = list(zip(lc["i"].astype(int), lc["j"].astype(int)))
        except FileNotFoundError:
            pass
    except FileNotFoundError:
        times, T = euroc.read_trajectory(
            "/robot0/scanmatcher/scanmatcher_global.csv")
        source = "scanmatcher"

    plot_trajectory(T, f"{out_dir}/trajectory.png", label=source)
    plot_trajectory_with_loop_closures(
        T, loop_pairs, f"{out_dir}/trajectory_loop_closures.png")

    cloud = build_map(directory, T, times,
                      keyframe_sampling=keyframe_sampling,
                      voxel_size=voxel_size)
    write_ply(f"{out_dir}/map.ply", cloud)
    write_pcd(f"{out_dir}/map.pcd", cloud)
    print(f"viewer: {source} trajectory ({len(T)} poses, "
          f"{len(loop_pairs)} loop closures), map {len(cloud)} points "
          f"(every {keyframe_sampling}th keyframe) -> {out_dir}")
    return {"source": source, "poses": len(T), "map_points": len(cloud),
            "keyframe_sampling": keyframe_sampling, "out_dir": out_dir}
