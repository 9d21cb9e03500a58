"""Visualization and map export (host numpy; matplotlib and scipy are
imported when a figure or a mesh is made, never at import).

Counterpart of ``lidar_slam_arvc_tpu/viz``: headless PNGs for
trajectories, loop closures, uncertainty and GPS, and PLY/PCD exports of
the global map, in place of the reference's interactive Open3D windows.
"""

from lidar_slam_arvc_tpu_torch.viz.mapping import (
    alpha_shape_mesh, build_map, write_ply,
)
from lidar_slam_arvc_tpu_torch.viz.plots import (
    plot_gps_comparison, plot_gps_osm, plot_registration, plot_trajectory,
    plot_trajectory_with_loop_closures, plot_trajectory_with_uncertainty,
)

__all__ = ["alpha_shape_mesh", "build_map", "write_ply", "plot_trajectory",
           "plot_trajectory_with_loop_closures", "plot_gps_comparison",
           "plot_registration", "plot_trajectory_with_uncertainty",
           "plot_gps_osm"]
