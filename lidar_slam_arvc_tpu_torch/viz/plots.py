"""Headless trajectory/GPS/loop-closure plotting (PNG artifacts).

Counterpart of ``lidar_slam_arvc_tpu/viz/plots.py``, figure for figure:
the reference's live matplotlib windows (graphSLAM.py:147-209,
run_map_viewer.py:52-69, tools/plottools.py) as saved figures.  Tables
are the port's ``{column: ndarray}`` dicts where the JAX package takes
DataFrames.  matplotlib is imported when a figure is drawn, never at
import; without it a plot raises ``ImportError``.
"""

from __future__ import annotations

import numpy as np

from lidar_slam_arvc_tpu_torch.geom.hostmath import quat_to_rot_np
from lidar_slam_arvc_tpu_torch.io.euroc import TIME


def _agg():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_trajectory(T: np.ndarray, path: str, label: str = "trajectory",
                    extra: dict | None = None) -> None:
    """Top-down XY plot; ``extra`` maps label -> (N,4,4) for overlays."""
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))
    p = np.asarray(T)[:, :3, 3]
    ax.plot(p[:, 0], p[:, 1], ".-", markersize=3, label=label)
    for name, Te in (extra or {}).items():
        pe = np.asarray(Te)[:, :3, 3]
        ax.plot(pe[:, 0], pe[:, 1], ".-", markersize=3, label=name)
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    ax.axis("equal")
    ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_trajectory_with_loop_closures(T: np.ndarray, loop_pairs,
                                       path: str) -> None:
    """XY trajectory + black chords for accepted loop closures
    (reference run_map_viewer.py:52-69)."""
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))
    p = np.asarray(T)[:, :3, 3]
    ax.plot(p[:, 0], p[:, 1], ".-", markersize=3, color="tab:blue")
    for (i, j) in loop_pairs:
        ax.plot([p[i, 0], p[j, 0]], [p[i, 1], p[j, 1]],
                color="black", linewidth=1.5)
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    ax.axis("equal")
    ax.set_title(f"{len(loop_pairs)} loop closures")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_trajectory_with_uncertainty(T: np.ndarray, covs: np.ndarray,
                                     path: str, scale: float = 1.0,
                                     skip: int = 1) -> None:
    """XY trajectory with per-pose 1-sigma position-uncertainty ellipses.

    Headless equivalent of the reference's GraphSLAM.plot with
    plot_uncertainty_ellipse=True (graphSLAM.py:115-145, which draws
    gtsam_plot.plot_pose3 ellipsoids from marginalCovariance).  ``covs`` is
    (N,6,6) tangent covariance in [w, v] order (PoseGraph.marginal_covariances);
    the drawn ellipse is the xy marginal of the translation block rotated
    into the world frame.
    """
    plt = _agg()
    from matplotlib.patches import Ellipse
    fig, ax = plt.subplots(figsize=(8, 8))
    T = np.asarray(T)
    covs = np.asarray(covs)
    p = T[:, :3, 3]
    ax.plot(p[:, 0], p[:, 1], ".-", markersize=3, color="tab:blue")
    for i in range(0, len(T), max(int(skip), 1)):
        # translation covariance is expressed in the body frame (right
        # perturbation); rotate into world: R Sigma_v R^T
        R = T[i, :3, :3]
        Sw = R @ covs[i, 3:, 3:] @ R.T
        S2 = Sw[:2, :2]
        w, V = np.linalg.eigh(S2)
        w = np.clip(w, 0.0, None)
        ang = float(np.degrees(np.arctan2(V[1, -1], V[0, -1])))
        ax.add_patch(Ellipse(p[i, :2], 2 * scale * np.sqrt(w[-1]),
                             2 * scale * np.sqrt(w[0]), angle=ang,
                             facecolor="none", edgecolor="tab:red",
                             linewidth=0.8, alpha=0.8))
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    ax.axis("equal")
    ax.set_title("trajectory with 1-sigma position uncertainty")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_gps_comparison(T: np.ndarray, gps: dict, correspondences,
                        path: str) -> None:
    """Estimate-vs-GPS overlay with correspondence segments
    (reference graphSLAM.py:183-209); ``gps`` has UTM ``x``/``y``."""
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))
    p = np.asarray(T)[:, :3, 3]
    ax.plot(p[:, 0], p[:, 1], marker=".", color="blue",
            label="GraphSLAM estimation")
    ax.plot(gps["x"], gps["y"], marker="o", linestyle="none",
            markersize=3, color="red", label="GPS UTM")
    for (i, k) in correspondences:
        ax.plot([p[i, 0], gps["x"][k]],
                [p[i, 1], gps["y"][k]], color="black", linewidth=1)
    ax.legend()
    ax.set_title("Correspondences (estimation, GPS)")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_gps_osm(gps: dict, path: str, expand: float = 0.001) -> bool:
    """GPS track in Web-Mercator-projected lon/lat, the figure of the
    reference's plot_gps_OSM (tools/plottools.py:245-271) without its
    OpenStreetMap basemap: the tiles need the network, so only the
    reference's offline path is ported (viz/plots.py:116-150).  ``expand``
    is kept for the reference's signature.  Returns False (no tiles)."""
    plt = _agg()
    lon = np.asarray(gps["longitude"], dtype=np.float64)
    lat = np.asarray(gps["latitude"], dtype=np.float64)
    fig, ax = plt.subplots(figsize=(8, 8), dpi=150)
    x = np.radians(lon)
    y = np.arcsinh(np.tan(np.radians(lat)))
    proj = np.column_stack([(x / (2 * np.pi)) + 0.5,
                            0.5 - y / (2 * np.pi)])
    ax.invert_yaxis()
    ax.plot(proj[:, 0], proj[:, 1], color="blue", linewidth=1)
    ax.xaxis.set_visible(False)
    ax.yaxis.set_visible(False)
    ax.set_title("GPS track (no OSM tiles)")
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return False


def compute_distance(lat1, lng1, lat2, lng2):
    """Haversine great-circle distance in meters (reference
    tools/plottools.py:174-189, R = 6373 km).  Vectorized over numpy inputs."""
    R = 6373.0 * 1000.0
    lat1, lng1, lat2, lng2 = (np.radians(np.asarray(v, dtype=np.float64))
                              for v in (lat1, lng1, lat2, lng2))
    a = (np.sin((lat2 - lat1) / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin((lng2 - lng1) / 2) ** 2)
    return R * 2 * np.arctan2(np.sqrt(a), np.sqrt(1 - a))


def _plot_points(table, xcol, ycol, xlabel, ylabel, path, title,
                 annotate_index, annotate_error, sample):
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(table[xcol], table[ycol])
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    for i in range(0, len(table[xcol]), max(int(sample), 1)):
        x = table[xcol][i]
        y = table[ycol][i]
        if annotate_index:
            ax.annotate(str(i), (x, y), fontsize=12)
        if annotate_error:
            s = 2 * np.sqrt(table["covariance_d1"][i])
            ax.annotate(f"{s:.3f}", (x, y), fontsize=12)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_gps_points(gps: dict, path: str,
                    title: str = "GPS POINTS (index, radius error in meters)",
                    annotate_index: bool = False,
                    annotate_error: bool = False, sample: int = 10) -> None:
    """lon/lat scatter with optional index / 2-sigma radius annotations
    (reference tools/plottools.py:191-216), saved headless."""
    _plot_points(gps, "longitude", "latitude", "longitude", "latitude",
                 path, title, annotate_index, annotate_error, sample)


def plot_utm_points(utm: dict, path: str,
                    title: str = "UTM POINTS (index, radius error in meters)",
                    annotate_index: bool = False,
                    annotate_error: bool = False, sample: int = 10) -> None:
    """UTM x/y scatter with the same annotation options (reference
    tools/plottools.py:218-243), saved headless."""
    _plot_points(utm, "x", "y", "x (m)", "y (m)", path, title,
                 annotate_index, annotate_error, sample)


def plot_quaternion_data(data: dict, path: str,
                         title: str = "Quaternion data to Euler",
                         annotate_time: bool = False) -> None:
    """Per-sample quaternion orientation converted to XYZ Euler angles and
    plotted against index or experiment time (reference
    tools/plottools.py:96-126; the reference's ad hoc -2.5 rad yaw shift is
    not reproduced — it was a dataset-specific mounting offset)."""
    plt = _agg()
    q = np.column_stack([data["qw"], data["qx"],
                         data["qy"], data["qz"]]).astype(np.float64)

    def euler_xyz(R):  # first branch of the XYZ mobile-axes extraction;
        # arctan2 makes the cos(beta) scaling redundant and NaN-free at
        # gimbal lock (cos(beta) >= 0 from arcsin, so signs are unchanged)
        beta = np.arcsin(np.clip(R[0, 2], -1.0, 1.0))
        alpha = np.arctan2(-R[1, 2], R[2, 2])
        gamma = np.arctan2(-R[0, 1], R[0, 0])
        return alpha, beta, gamma

    eul = np.array([euler_xyz(quat_to_rot_np(qi)) for qi in q])
    if annotate_time:
        ts = np.asarray(data[TIME], dtype=np.float64)
        xs = (ts - ts[0]) / 1e9
        xlabel = "Experiment time (s)"
    else:
        xs = np.arange(len(eul))
        xlabel = "Data index"
    fig, ax = plt.subplots(figsize=(10, 6))
    for k, color in enumerate(("red", "green", "blue")):
        ax.plot(xs, eul[:, k], color=color, linestyle="dashed", marker="o",
                markersize=3)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_xyz_data(data: dict, path: str, title: str = "XYZ",
                  annotate_time: bool = False) -> None:
    """x/y/z columns against index or time (reference
    tools/plottools.py:129-143), saved headless."""
    plt = _agg()
    if annotate_time:
        ts = np.asarray(data[TIME], dtype=np.float64)
        xs = (ts - ts[0]) / 1e9
    else:
        xs = np.arange(len(data["x"]))
    fig, ax = plt.subplots(figsize=(10, 6))
    for col, color in (("x", "red"), ("y", "green"), ("z", "blue")):
        ax.plot(xs, data[col], color=color, linestyle="dashed", marker="o",
                markersize=3, label=col)
    ax.set_title(title)
    ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_xy_data(data: dict, path: str, title: str = "XY", sample: int = 10,
                 annotate_time: bool = False,
                 annotate_index: bool = False) -> None:
    """XY scatter with optional time/index annotations (reference
    tools/plottools.py:145-158), saved headless."""
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(data["x"], data["y"], color="blue")
    n = len(data["x"])
    if annotate_time:
        ts = np.asarray(data[TIME], dtype=np.float64)
        for i in range(0, n, sample):
            ax.annotate(f"{(ts[i] - ts[0]) / 1e9:.3f}",
                        (data["x"][i], data["y"][i]), fontsize=12)
    if annotate_index:
        for i in range(0, n, sample):
            ax.annotate(str(i), (data["x"][i], data["y"][i]), fontsize=12)
    ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_registration(src_points, tgt_points, transform, path: str,
                      max_points: int = 5000) -> None:
    """Overlay of a registered pair: source (red) transformed into the
    target frame (blue) — headless equivalent of the reference's
    draw_registration_result (keyframe.py:347-358)."""
    plt = _agg()
    src = np.asarray(src_points)
    tgt = np.asarray(tgt_points)
    T = np.asarray(transform)
    if len(src) > max_points:
        src = src[np.linspace(0, len(src) - 1, max_points).astype(int)]
    if len(tgt) > max_points:
        tgt = tgt[np.linspace(0, len(tgt) - 1, max_points).astype(int)]
    moved = src @ T[:3, :3].T + T[:3, 3]
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(tgt[:, 0], tgt[:, 1], s=1, color="tab:blue", label="target")
    ax.scatter(moved[:, 0], moved[:, 1], s=1, color="tab:red",
               label="source (transformed)")
    ax.axis("equal")
    ax.legend(markerscale=8)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
