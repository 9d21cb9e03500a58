"""EUROC/ASL-format dataset access, in numpy.

Counterpart of ``lidar_slam_arvc_tpu/io/euroc.py`` with the same
directory contract.  A table is a ``{column: ndarray}`` dict instead of a
pandas DataFrame; the CSVs written are byte-identical to the pandas ones
(``io/formats.py``).
"""

from __future__ import annotations

import os

import numpy as np

from lidar_slam_arvc_tpu_torch.geom.hostmath import (
    pose_columns_from_transforms_np,
    transforms_from_pose_columns_np,
)
from lidar_slam_arvc_tpu_torch.io.formats import load_yaml, read_csv, write_csv

TIME = "#timestamp [ns]"


def trajectory_columns(times, T) -> dict:
    """Trajectory table (timestamp, x, y, z, qx, qy, qz, qw) of (N,4,4) poses."""
    T = np.asarray(T)
    xyz, q = pose_columns_from_transforms_np(T)
    return {TIME: np.asarray(times)[: len(T)],
            "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "qx": q[:, 1], "qy": q[:, 2], "qz": q[:, 3], "qw": q[:, 0]}


class EurocDataset:
    """Reader/writer for one EUROC-format dataset directory."""

    def __init__(self, directory: str):
        self.directory = directory

    # ---------------------------------------------------------------- reads

    def path(self, relative: str) -> str:
        return self.directory + relative

    def read_csv(self, filename: str) -> dict:
        return read_csv(self.directory + filename)

    def _yaml(self, relative: str) -> dict:
        with open(f"{self.directory}/robot0/{relative}") as f:
            return load_yaml(f.read())

    def read_transform(self, sensor: str) -> np.ndarray:
        """4x4 extrinsics from robot0/<sensor>/transform.yaml
        (reference eurocreader.py:15-24)."""
        return np.asarray(self._yaml(f"{sensor}/transform.yaml")["transform"],
                          dtype=np.float64).reshape(4, 4)

    def read_utm_ref(self, gpsname: str = "gps0") -> dict:
        """GPS origin from robot0/<gps>/reference.yaml (eurocreader.py:26-36)."""
        return self._yaml(f"{gpsname}/reference.yaml")

    def read_scanmatcher_parameters(self) -> dict:
        return self._yaml("scanmatcher_parameters.yaml")

    def read_slam_parameters(self) -> dict:
        return self._yaml("slam_parameters.yaml")

    def scan_pcd_path(self, scan_time) -> str:
        return f"{self.directory}/robot0/lidar/data/{scan_time}.pcd"

    # ----------------------------------------------------- time association

    @staticmethod
    def get_closest_times(master_sensor_times: np.ndarray,
                          sensor_times: np.ndarray,
                          warning_max_time_dif_s: float = 0.5e9) -> np.ndarray:
        """For each master time, the nearest sensor time (ties go left)."""
        master = np.asarray(master_sensor_times, dtype=np.int64)
        times = np.asarray(sensor_times, dtype=np.int64)
        order = np.argsort(times, kind="stable")
        sorted_times = times[order]
        pos = np.searchsorted(sorted_times, master)
        left = np.clip(pos - 1, 0, len(sorted_times) - 1)
        right = np.clip(pos, 0, len(sorted_times) - 1)
        choose_right = (np.abs(sorted_times[right] - master)
                        < np.abs(sorted_times[left] - master))
        idx = np.where(choose_right, right, left)
        out = sorted_times[idx]
        dif = np.abs(out - master)
        n_bad = int((dif > warning_max_time_dif_s).sum())
        if n_bad:
            print(f"CAUTION!!! {n_bad} associations exceed "
                  f"{warning_max_time_dif_s / 1e9:.2f}s time difference "
                  f"(max {dif.max() / 1e9:.2f}s)")
        return out

    @staticmethod
    def get_rows_at_times(table: dict, time_list: np.ndarray) -> dict:
        """Rows of ``table`` at exactly the given timestamps, in list order.

        Raises KeyError for a time the table does not hold, as pandas
        ``.loc`` does."""
        times = np.asarray(table[TIME])
        want = np.asarray(time_list)
        order = np.argsort(times, kind="stable")
        pos = np.clip(np.searchsorted(times[order], want), 0, len(times) - 1)
        rows = order[pos]
        missing = times[rows] != want
        if missing.any():
            raise KeyError(f"times not in table: {want[missing][:5].tolist()}")
        return {k: np.asarray(v)[rows] for k, v in table.items()}

    # ---------------------------------------------------------------- writes

    def _ensure_dir(self, filename: str) -> str:
        full = self.directory + filename
        os.makedirs(os.path.dirname(os.path.abspath(full)), exist_ok=True)
        return full

    def save_transforms_as_csv(self, sensor_times, transforms, filename: str) -> dict:
        """Trajectory CSV with the reference schema (index column +
        timestamp,x,y,z,qx,qy,qz,qw)."""
        cols = trajectory_columns(sensor_times, transforms)
        write_csv(self._ensure_dir(filename), cols)
        return cols

    def save_sensor_times_as_csv(self, sensor_times, filename: str) -> dict:
        cols = {TIME: np.asarray(sensor_times)}
        write_csv(self._ensure_dir(filename), cols)
        return cols

    def save_loop_closures_as_csv(self, loop_closures, filename: str) -> dict:
        """Flatten [[i, j], ...] groups (None groups skipped) into an i,j CSV
        (reference eurocreader.py:81-97)."""
        pairs = [(int(p[0]), int(p[1])) for group in loop_closures
                 if group is not None for p in group]
        cols = {"i": np.array([p[0] for p in pairs], dtype=np.int64),
                "j": np.array([p[1] for p in pairs], dtype=np.int64)}
        write_csv(self._ensure_dir(filename), cols)
        return cols

    # ------------------------------------------------------- trajectory I/O

    def read_trajectory(self, filename: str):
        """Read a trajectory CSV -> (times (N,), transforms (N,4,4))."""
        return trajectory_from_table(self.read_csv(filename))


def trajectory_from_table(table: dict):
    """(times, (N,4,4) transforms) from a trajectory table (columns x,y,z
    plus the wxyz quaternion columns qw,qx,qy,qz)."""
    times = np.asarray(table[TIME])
    xyz = np.stack([table[k] for k in ("x", "y", "z")], axis=1).astype(np.float64)
    q = np.stack([table[k] for k in ("qw", "qx", "qy", "qz")], axis=1).astype(np.float64)
    return times, transforms_from_pose_columns_np(xyz, q)
