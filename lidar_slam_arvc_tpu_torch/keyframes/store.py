"""KeyframeStore: preprocessed keyframes as stacked tensors on one device.

Counterpart of ``lidar_slam_arvc_tpu/keyframes/store.py`` (the reference's
KeyFrameManager, keyframemanager/keyframemanager.py:8-184): every scan is
loaded and preprocessed at once (``pipeline.scanmatcher.load_scans`` and
``preprocess_all``; loop closing wants full resolution, voxel None), and
registration between any set of (i, j) pairs is one gather plus one
batched ICP over them (``icp_batch``; K1 for the correspondences, K2 for
the normals at load).

Methods ``icppointplane`` and ``icppointpoint``; ``icp2planes`` and
``fpfh`` are not ported yet (ROADMAP M7) and raise, as do sharded stores
and multi-process loading (M8).
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.ops._cuda import torch_device
from lidar_slam_arvc_tpu_torch.pipeline.preprocess import METHODS
from lidar_slam_arvc_tpu_torch.registration.icp import ICPParams, icp_batch
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig

REGISTRATION_METHODS = ("icppointpoint", "icppointplane", "icp2planes", "fpfh")


def _validate_method(method: str) -> str:
    if method not in REGISTRATION_METHODS:
        raise ValueError(f"unknown registration method {method!r}; "
                         f"expected one of {REGISTRATION_METHODS}")
    if method not in METHODS:
        raise NotImplementedError(f"registration method {method!r} is not "
                                  "ported yet (ROADMAP M7)")
    return method


class KeyframeStore:
    def __init__(self, directory: str, scan_times, voxel_size=None,
                 method: str = "icppointplane",
                 cfg: IcpConfig | None = None, device="cuda"):
        self.directory = directory
        self.scan_times = np.asarray(scan_times)
        self.voxel_size = voxel_size
        self.method = _validate_method(method)
        self.cfg = cfg or IcpConfig()
        self.device = torch_device(device, "KeyframeStore")
        self.points = None
        self.mask = None
        self.normals = None
        self.overflow = None   # (N,) voxels dropped per scan (capacity)
        self.n_loaded_locally = 0

    @classmethod
    def from_arrays(cls, points, mask, normals, method: str = "icppointplane",
                    cfg: IcpConfig | None = None) -> "KeyframeStore":
        """A store backed by already-preprocessed stacked tensors (N, C, 3),
        (N, C), (N, C, 3), on their device."""
        store = cls(None, np.arange(points.shape[0]), method=method, cfg=cfg,
                    device=points.device)
        store.points, store.mask, store.normals = points, mask, normals
        store.n_loaded_locally = points.shape[0]
        return store

    # -------------------------------------------------------------- loading

    def __len__(self):
        return len(self.scan_times)

    @property
    def loaded(self) -> bool:
        return self.points is not None

    def load_and_preprocess(self, keyframe_sampling: int = 1) -> "KeyframeStore":
        """Load every ``keyframe_sampling``-th scan and preprocess it on the
        store's device (reference keyframemanager.py:20-50, all at once)."""
        from lidar_slam_arvc_tpu_torch.pipeline.scanmatcher import (
            load_scans, preprocess_all,
        )
        if keyframe_sampling > 1:
            self.scan_times = self.scan_times[::keyframe_sampling]
        raw_pts, raw_mask = load_scans(EurocDataset(self.directory),
                                       self.scan_times, self.cfg.raw_capacity)
        self.points, self.mask, self.normals, self.overflow = preprocess_all(
            raw_pts, raw_mask, self.cfg, self.method, self.voxel_size,
            self.device)
        self.n_loaded_locally = len(self.scan_times)
        return self

    # ------------------------------------------------------ registration

    def _icp_params(self) -> ICPParams:
        return ICPParams(
            max_correspondence_distance=self.cfg.distance_threshold,
            max_iterations=self.cfg.max_iterations,
            source_stride=self.cfg.source_stride)

    def compute_transformation(self, i: int, j: int, Tij: np.ndarray):
        """Single-pair registration T_i_j (keyframemanager.py:52-75)."""
        return self.compute_transformations_batch(
            np.array([[i, j]]), np.asarray(Tij, dtype=np.float32)[None])[0]

    def compute_transformations_batch(self, pairs: np.ndarray,
                                      seeds: np.ndarray) -> np.ndarray:
        """Registration of (B, 2) [target i, source j] pairs from (B, 4, 4)
        seeds, in one batched ICP: returns (B, 4, 4) float64 T_i_j."""
        if not self.loaded:
            raise RuntimeError("call load_and_preprocess first")
        pairs = np.asarray(pairs)
        dev = self.points.device
        ti = torch.as_tensor(pairs[:, 0], dtype=torch.int64, device=dev)
        si = torch.as_tensor(pairs[:, 1], dtype=torch.int64, device=dev)
        seeds = torch.as_tensor(np.asarray(seeds, dtype=np.float32), device=dev)
        res = icp_batch(self.points[si], self.mask[si], self.points[ti],
                        self.mask[ti], self.normals[ti], seeds,
                        self._icp_params(),
                        "point_to_point" if self.method == "icppointpoint"
                        else "point_to_plane")
        return res.transform.cpu().numpy().astype(np.float64)
