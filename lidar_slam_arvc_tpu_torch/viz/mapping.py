"""Global map construction, alpha-shape meshes and PLY files (host numpy).

Counterpart of ``lidar_slam_arvc_tpu/viz/mapping.py`` (KeyFrameManager.
build_map, reference keyframemanager.py:154-184, without the Open3D
window): keyframes are sampled, cropped, voxel-downsampled, transformed by
their global poses and concatenated into one host array, scan i always
with transform i.  The voxel key is exact: the JAX package's
``kx * 4e6 + ky * 2000 + kz`` (its mapping.py:47) merges voxels of a map
wider than 2000 voxels on an axis; here the integer triples are grouped
lexicographically, which is the reference's output order wherever its
key does not collide.
"""

from __future__ import annotations

import os

import numpy as np

from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.io.pcd import read_pcd


def build_map(directory: str, global_transforms: np.ndarray,
              scan_times: np.ndarray, keyframe_sampling: int = 10,
              radii=(0.5, 35.0), heights=(-120.0, 120.0),
              voxel_size: float | None = 0.2,
              max_points_per_scan: int = 20000) -> np.ndarray:
    """Concatenated (M, 3) global cloud from every k-th keyframe."""
    euroc = EurocDataset(directory)
    chunks = []
    for i in range(0, len(scan_times), keyframe_sampling):
        pts = read_pcd(euroc.scan_pcd_path(scan_times[i]))
        r2 = pts[:, 0] ** 2 + pts[:, 1] ** 2
        keep = ((r2 > radii[0] ** 2) & (r2 < radii[1] ** 2)
                & (pts[:, 2] > heights[0]) & (pts[:, 2] < heights[1]))
        pts = pts[keep]
        if voxel_size:
            pts = _voxel_downsample_np(pts, voxel_size)
        if len(pts) > max_points_per_scan:
            pts = pts[np.linspace(0, len(pts) - 1,
                                  max_points_per_scan).astype(int)]
        T = global_transforms[i]
        chunks.append(pts @ T[:3, :3].T + T[:3, 3])
    return (np.concatenate(chunks).astype(np.float32)
            if chunks else np.zeros((0, 3), np.float32))


def _voxel_downsample_np(pts: np.ndarray, voxel: float) -> np.ndarray:
    """Centroid of each occupied voxel, in lexicographic (kx, ky, kz) order."""
    keys = np.floor((pts - pts.min(0)) / voxel).astype(np.int64)
    _, slot, counts = np.unique(keys, axis=0, return_inverse=True,
                                return_counts=True)
    sums = np.zeros((len(counts), 3))
    np.add.at(sums, slot.reshape(-1), pts)
    return (sums / counts[:, None]).astype(np.float32)


def alpha_shape_mesh(points: np.ndarray, alpha: float):
    """3D alpha-shape surface of a point cloud: (vertices, triangles).

    Host-side equivalent of Open3D's C++
    ``TriangleMesh.create_from_point_cloud_alpha_shape`` used by the
    reference's ``save_pointcloud_as_mesh`` (keyframe.py:53-59,
    run_converter.py:185): Delaunay-tetrahedralize, keep tetrahedra whose
    circumradius is below ``alpha``, and return the boundary faces (faces
    belonging to exactly one kept tetrahedron).  Vertices are compacted to
    the used subset; ``triangles`` indexes into ``vertices``.
    """
    from scipy.spatial import Delaunay, QhullError

    pts = np.asarray(points, dtype=np.float64)
    if len(pts) < 5:
        return pts.astype(np.float32), np.zeros((0, 3), np.int32)
    try:
        tet = Delaunay(pts)
    except QhullError:
        return pts.astype(np.float32), np.zeros((0, 3), np.int32)
    s = tet.simplices                                 # (T, 4)
    a, b, c, d = (pts[s[:, k]] for k in range(4))
    # circumcenter x solves 2 (v_k - a) . x = |v_k|^2 - |a|^2, k in {b,c,d}
    A = 2.0 * np.stack([b - a, c - a, d - a], axis=1)          # (T, 3, 3)
    rhs = np.stack([(b * b).sum(1) - (a * a).sum(1),
                    (c * c).sum(1) - (a * a).sum(1),
                    (d * d).sum(1) - (a * a).sum(1)], axis=1)  # (T, 3)
    det = np.linalg.det(A)
    ok = np.abs(det) > 1e-12
    center = np.full_like(a, np.inf)
    if ok.any():
        center[ok] = np.linalg.solve(A[ok], rhs[ok][..., None])[..., 0]
    radius = np.linalg.norm(center - a, axis=1)       # inf for degenerate
    kept = s[radius < alpha]
    if len(kept) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    # the four faces of each kept tetrahedron, canonically sorted
    faces = np.concatenate([kept[:, [0, 1, 2]], kept[:, [0, 1, 3]],
                            kept[:, [0, 2, 3]], kept[:, [1, 2, 3]]])
    faces = np.sort(faces, axis=1)
    uniq, counts = np.unique(faces, axis=0, return_counts=True)
    boundary = uniq[counts == 1]
    used = np.unique(boundary)
    remap = np.zeros(len(pts), dtype=np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    return pts[used].astype(np.float32), remap[boundary].astype(np.int32)


def write_ply(path: str, points: np.ndarray, binary: bool = True,
              faces: np.ndarray | None = None) -> None:
    """Write an (N, 3) cloud — optionally with (F, 3) triangle faces as a
    mesh — as PLY (binary little-endian or ascii)."""
    points = np.asarray(points, dtype=np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fmt = "binary_little_endian" if binary else "ascii"
    face_header = ""
    if faces is not None:
        face_header = (f"element face {len(faces)}\n"
                       "property list uchar int vertex_indices\n")
    header = (
        "ply\n"
        f"format {fmt} 1.0\n"
        f"element vertex {len(points)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"{face_header}"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(np.ascontiguousarray(points).tobytes())
            if faces is not None:
                faces = np.asarray(faces, dtype="<i4")
                rec = np.empty(len(faces),
                               dtype=[("n", "u1"), ("v", "<i4", 3)])
                rec["n"] = 3
                rec["v"] = faces
                f.write(rec.tobytes())
        else:
            np.savetxt(f, points, fmt="%.6f")
            if faces is not None:
                np.savetxt(f, np.column_stack(
                    [np.full(len(faces), 3, np.int64),
                     np.asarray(faces, np.int64)]), fmt="%d")


def read_ply(path: str) -> np.ndarray:
    """Minimal PLY reader for x/y/z float vertices (round-trip of write_ply)."""
    with open(path, "rb") as f:
        binary = False
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                binary = "binary" in line
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line == "end_header":
                break
        if binary:
            return np.frombuffer(f.read(12 * n), dtype=np.float32).reshape(n, 3).copy()
        return np.loadtxt(f, dtype=np.float32, max_rows=n, ndmin=2)
