"""The EUROC/ASL directory layout that the program reads: binary PCD scans,
CSV tables and flat YAML parameter files, written with the standard library
and numpy."""

from __future__ import annotations

import os

import numpy as np

TIME = "#timestamp [ns]"


def write_pcd(path: str, points: np.ndarray) -> None:
    """(N, 3) float32 points as a binary PCD v0.7 file."""
    points = np.ascontiguousarray(points, dtype=np.float32)
    n = len(points)
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
              "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
              "DATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(points.tobytes())


def read_pcd(path: str) -> np.ndarray:
    """(N, 3) float32 points of a binary xyz PCD as ``write_pcd`` writes it."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"DATA binary\n") + len(b"DATA binary\n")
    n = int(next(line.split()[1] for line in data[:end].decode().splitlines()
                 if line.startswith("POINTS")))
    return np.frombuffer(data, dtype=np.float32, count=3 * n,
                         offset=end).reshape(n, 3)


def _cell(v) -> str:
    if isinstance(v, (np.floating, float)):
        return repr(float(v))
    return str(int(v))


def write_csv(path: str, columns: dict, index: bool) -> None:
    """Columns as pandas ``to_csv`` lays them out (optional index column)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    names = list(columns)
    n = len(columns[names[0]])
    lines = [",".join(([""] if index else []) + names)]
    for i in range(n):
        lines.append(",".join(([str(i)] if index else [])
                              + [_cell(columns[k][i]) for k in names]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_csv(path: str) -> dict:
    """``{column: float64 or int64 array}`` of a numeric CSV with a header."""
    with open(path) as f:
        rows = [line.rstrip("\n").split(",") for line in f if line.strip()]
    out = {}
    for j, name in enumerate(rows[0]):
        cells = [r[j] for r in rows[1:]]
        try:
            out[name] = np.array([int(c) for c in cells], dtype=np.int64)
        except ValueError:
            out[name] = np.array([float(c) for c in cells], dtype=np.float64)
    return out


def write_yaml(path: str, mapping: dict) -> None:
    """A flat mapping of scalars and lists of scalars as block YAML."""
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def scalar(v):
        if v is None:
            return "null"
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, float):
            return repr(v)
        return str(v)

    lines = []
    for k, v in mapping.items():
        if isinstance(v, (list, tuple)):
            lines.append(f"{k}:")
            lines += [f"- {scalar(x)}" for x in v]
        else:
            lines.append(f"{k}: {scalar(v)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def quaternions(T: np.ndarray) -> np.ndarray:
    """(N, 4) unit quaternions [w, x, y, z] of (N, 4, 4) rigid transforms."""
    R = T[:, :3, :3]
    w = np.sqrt(np.clip(1.0 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2], 0, None)) / 2
    x = np.sqrt(np.clip(1.0 + R[:, 0, 0] - R[:, 1, 1] - R[:, 2, 2], 0, None)) / 2
    y = np.sqrt(np.clip(1.0 - R[:, 0, 0] + R[:, 1, 1] - R[:, 2, 2], 0, None)) / 2
    z = np.sqrt(np.clip(1.0 - R[:, 0, 0] - R[:, 1, 1] + R[:, 2, 2], 0, None)) / 2
    x = np.copysign(x, R[:, 2, 1] - R[:, 1, 2])
    y = np.copysign(y, R[:, 0, 2] - R[:, 2, 0])
    z = np.copysign(z, R[:, 1, 0] - R[:, 0, 1])
    q = np.stack([w, x, y, z], axis=1)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def transforms(table: dict) -> np.ndarray:
    """(N, 4, 4) float64 transforms of a trajectory table."""
    w, x, y, z = (table[k] for k in ("qw", "qx", "qy", "qz"))
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    T = np.tile(np.eye(4), (len(w), 1, 1))
    T[:, 0, 0] = 1 - 2 * (y * y + z * z)
    T[:, 0, 1] = 2 * (x * y - w * z)
    T[:, 0, 2] = 2 * (x * z + w * y)
    T[:, 1, 0] = 2 * (x * y + w * z)
    T[:, 1, 1] = 1 - 2 * (x * x + z * z)
    T[:, 1, 2] = 2 * (y * z - w * x)
    T[:, 2, 0] = 2 * (x * z - w * y)
    T[:, 2, 1] = 2 * (y * z + w * x)
    T[:, 2, 2] = 1 - 2 * (x * x + y * y)
    T[:, 0, 3], T[:, 1, 3], T[:, 2, 3] = table["x"], table["y"], table["z"]
    return T


def trajectory(times, T: np.ndarray) -> dict:
    q = quaternions(T)
    return {TIME: np.asarray(times), "x": T[:, 0, 3], "y": T[:, 1, 3],
            "z": T[:, 2, 3], "qx": q[:, 1], "qy": q[:, 2], "qz": q[:, 3],
            "qw": q[:, 0]}
