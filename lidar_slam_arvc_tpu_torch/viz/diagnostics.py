"""Dataset/solution diagnostics, headless.

Counterpart of ``lidar_slam_arvc_tpu/viz/diagnostics.py`` (reference
viewers/ parity), over the port's column dicts:

  * :func:`check_timestamps`   — per-sensor rate/Δt report
    (reference viewers/check_timestamps.py:85-123)
  * :func:`view_solutions`     — solution vs GPS overlay + end-point error
    (reference viewers/view_solutions.py:15-34)
  * :func:`compare_solutions`  — per-step delta error MEAN/STD between a
    solution and GPS/ground truth
    (reference viewers/view_solutions_sm.py:160-175)
  * :func:`view_raw_data`      — raw odometry/GPS trajectory plots
    (reference viewers/data_viewer.py)

All return dict reports and save PNGs under <dataset>/robot0/viz/.
"""

from __future__ import annotations

import os

import numpy as np

from lidar_slam_arvc_tpu_torch.io.euroc import TIME, EurocDataset
from lidar_slam_arvc_tpu_torch.io.utm import filter_gps, gps2utm
from lidar_slam_arvc_tpu_torch.viz.plots import _agg


def check_timestamps(directory: str) -> dict:
    """Per-sensor timestamp statistics + plot of inter-sample intervals."""
    euroc = EurocDataset(directory)
    sensors = {
        "lidar": "/robot0/lidar/data.csv",
        "odom": "/robot0/odom/data.csv",
        "gps0": "/robot0/gps0/data.csv",
        # IMU audited when present, skipped gracefully otherwise
        # (reference viewers/check_timestamps.py:59-72)
        "imu0": "/robot0/imu0/data.csv",
    }
    report = {}
    plt = _agg()
    fig, ax = plt.subplots(figsize=(9, 5))
    for name, path in sensors.items():
        try:
            table = euroc.read_csv(path)
        except FileNotFoundError:
            continue
        t = table[TIME] / 1e9
        dt = np.diff(t)
        report[name] = {
            "count": int(len(t)),
            "duration_s": float(t[-1] - t[0]) if len(t) > 1 else 0.0,
            "mean_dt_s": float(dt.mean()) if len(dt) else None,
            "std_dt_s": float(dt.std()) if len(dt) else None,
            "max_dt_s": float(dt.max()) if len(dt) else None,
            "rate_hz": float(1.0 / dt.mean()) if len(dt) and dt.mean() > 0 else None,
        }
        if len(dt):
            ax.plot(t[1:] - t[0], dt, ".", markersize=2, label=name)
    ax.set_xlabel("experiment time (s)")
    ax.set_ylabel("inter-sample dt (s)")
    ax.legend()
    out_dir = f"{directory}/robot0/viz"
    os.makedirs(out_dir, exist_ok=True)
    fig.savefig(f"{out_dir}/timestamps.png", dpi=120, bbox_inches="tight")
    plt.close(fig)

    # odometry distance travelled (check_timestamps.py:10-16,55)
    try:
        odo = euroc.read_csv("/robot0/odom/data.csv")
        xy = np.stack([odo["x"], odo["y"]], axis=1)
        report["odometry_distance_m"] = float(
            np.linalg.norm(np.diff(xy, axis=0), axis=1).sum())
    except FileNotFoundError:
        pass
    return report


def _load_gps_utm(euroc: EurocDataset) -> dict:
    gps = euroc.read_csv("/robot0/gps0/data.csv")
    ref = euroc.read_utm_ref("gps0")
    return gps2utm(filter_gps(gps), ref)


def view_solutions(directory: str,
                   solution_csv: str = "/robot0/SLAM/solution_graphslam.csv") -> dict:
    """Solution-vs-GPS overlay + distance travelled + end-point error."""
    euroc = EurocDataset(directory)
    times, T = euroc.read_trajectory(solution_csv)
    p = T[:, :3, 3]
    dist = float(np.linalg.norm(np.diff(p[:, :2], axis=0), axis=1).sum())
    report = {"poses": len(T), "distance_travelled_m": dist,
              "end_point_error_m": None}
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(p[:, 0], p[:, 1], ".-", markersize=3, label="solution")
    try:
        gps = _load_gps_utm(euroc)
        ax.plot(gps["x"], gps["y"], "o", markersize=3, color="red",
                label="GPS UTM")
        # end-point error (view_solutions.py:29-34)
        report["end_point_error_m"] = float(np.linalg.norm(
            p[-1, :2] - np.array([gps["x"][-1], gps["y"][-1]])))
    except FileNotFoundError:
        pass
    ax.axis("equal")
    ax.legend()
    out_dir = f"{directory}/robot0/viz"
    os.makedirs(out_dir, exist_ok=True)
    fig.savefig(f"{out_dir}/solution_vs_gps.png", dpi=120,
                bbox_inches="tight")
    plt.close(fig)
    return report


def compare_solutions(directory: str,
                      solution_csv: str = "/robot0/SLAM/solution_graphslam.csv",
                      reference_csv: str | None = None) -> dict:
    """Per-step delta error statistics vs GPS (or a reference trajectory).

    Reproduces the MEAN/STD per-step delta report of reference
    viewers/view_solutions_sm.py:160-175: compare the norm of each
    consecutive-step displacement in the solution with the corresponding
    displacement in GPS/reference.
    """
    euroc = EurocDataset(directory)
    times, T = euroc.read_trajectory(solution_csv)
    p = T[:, :2, 3]

    if reference_csv is not None:
        _, T_ref = euroc.read_trajectory(reference_csv)
        q = T_ref[:, :2, 3]
        n = min(len(p), len(q))
        p, q = p[:n], q[:n]
    else:
        gps = _load_gps_utm(euroc)
        idx = EurocDataset.get_closest_times(times, gps[TIME])
        rows = EurocDataset.get_rows_at_times(gps, idx)
        q = np.stack([rows["x"], rows["y"]], axis=1)

    dp = np.linalg.norm(np.diff(p, axis=0), axis=1)
    dq = np.linalg.norm(np.diff(q, axis=0), axis=1)
    delta = np.abs(dp - dq)
    return {"delta_error_mean_m": float(delta.mean()),
            "delta_error_std_m": float(delta.std()),
            "steps": int(len(delta))}


def view_raw_data(directory: str) -> dict:
    """Raw odometry + GPS plots (reference viewers/data_viewer.py)."""
    euroc = EurocDataset(directory)
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))
    report = {}
    try:
        odo = euroc.read_csv("/robot0/odom/data.csv")
        ax.plot(odo["x"], odo["y"], ".-", markersize=2, label="odometry")
        report["odom_rows"] = int(len(odo[TIME]))
    except FileNotFoundError:
        pass
    try:
        gps = _load_gps_utm(euroc)
        ax.plot(gps["x"], gps["y"], "o", markersize=3, color="red",
                label="GPS UTM")
        report["gps_rows"] = int(len(gps[TIME]))
    except FileNotFoundError:
        pass
    ax.axis("equal")
    ax.legend()
    out_dir = f"{directory}/robot0/viz"
    os.makedirs(out_dir, exist_ok=True)
    fig.savefig(f"{out_dir}/raw_data.png", dpi=120, bbox_inches="tight")
    plt.close(fig)
    return report
