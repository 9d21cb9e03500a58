"""Time- and motion-gated sensor sampling (counterpart of
``lidar_slam_arvc_tpu/io/sampling.py``), over the port's column dicts."""

from __future__ import annotations

import numpy as np

from lidar_slam_arvc_tpu_torch.geom.hostmath import quat_to_yaw_np
from lidar_slam_arvc_tpu_torch.io.euroc import TIME


def sample_times(sensor_times: np.ndarray, start_index: int = 10,
                 delta_time: float = 1e9) -> np.ndarray:
    """Decimate timestamps to a minimum spacing of delta_time (ns).

    Start at ``start_index``, keep a time when >= delta_time elapsed since
    the last kept one, always append the final time, and unique-sort the
    result (reference tools/sampling.py:39-58).
    """
    sensor_times = np.asarray(sensor_times)
    kept = [sensor_times[start_index]]
    t = sensor_times[start_index]
    for i in range(start_index, len(sensor_times)):
        current = sensor_times[i]
        if float(np.abs(current - t)) >= delta_time:
            kept.append(current)
            t = current
    kept.append(sensor_times[-1])
    return np.unique(np.array(kept))


def sample_odometry(odo: dict, deltaxy: float = 0.5, deltath: float = 0.2):
    """Keep odometry rows spaced by > deltaxy metres or > deltath rad of yaw.

    Row 0 is always kept; each kept row resets the gate (reference
    tools/sampling.py:8-36).  ``odo``: a column dict with ``x, y, qw, qx,
    qy, qz`` and the timestamp column.  Returns (times, the kept rows as a
    column dict)."""
    xy = np.stack([odo["x"], odo["y"]], axis=1).astype(np.float64)
    q = np.stack([odo[k] for k in ("qw", "qx", "qy", "qz")],
                 axis=1).astype(np.float64)
    yaw = quat_to_yaw_np(q)
    times = np.asarray(odo[TIME])

    keep = [0]
    ref_xy, ref_yaw = xy[0], yaw[0]
    for i in range(len(times)):
        dxy = np.linalg.norm(xy[i] - ref_xy)
        dth = abs(yaw[i] - ref_yaw)
        if dxy > deltaxy or dth > deltath:
            keep.append(i)
            ref_xy, ref_yaw = xy[i], yaw[i]
    keep = np.array(keep, dtype=np.int64)
    return times[keep], {k: np.asarray(v)[keep] for k, v in odo.items()}
