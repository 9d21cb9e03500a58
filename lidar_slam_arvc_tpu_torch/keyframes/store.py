"""KeyframeStore: preprocessed keyframes as stacked tensors on one device.

Counterpart of ``lidar_slam_arvc_tpu/keyframes/store.py`` (the reference's
KeyFrameManager, keyframemanager/keyframemanager.py:8-184): every scan is
loaded and preprocessed at once, through stage 1's streamed path
(``pipeline.scanmatcher.load_and_preprocess_streamed``: the native PCD
parser overlapped with preprocessing; loop closing wants full resolution,
voxel None), and
registration between any set of (i, j) pairs is one batched call over
them under the store's method (reference keyframes/store.py:288-320):

* ``icppointplane``, ``icppointpoint``: one gather and one ``icp_batch``
  (K1 for the correspondences; K2 for the normals at load);
* ``icp2planes``: ``icp_two_planes`` on the ground/non-ground masks made
  at load, one ICP batch of twice the pairs;
* ``fpfh``: the FPFH descriptors of the call's distinct scans, then
  ``global_registration``, its RANSAC drawing from
  ``torch.Generator().manual_seed(0)`` on every call, as the reference
  keys every call with ``PRNGKey(0)``.

The ground planes are drawn from ``seeded_generator(seed, i)`` for scan i
(``load_and_preprocess(seed=)``, default ``PLANE_SEED`` = 0, the
reference's store seed).  ``icp_params_override`` (``from_arrays(icp_params=)``,
or ``LoopCloser(icp_params=)`` on a copy) replaces the ICP parameters that
the store's config gives, under every method.

Over a mesh of ranks (``parallel/mesh.py``) a store is sharded: rank d
keeps only its contiguous block of the scans (whole preprocessing
batches), padded with copies of the last one (``shard``, or ``load_and_preprocess(mesh=...)``, which parses
only that block's PCDs and keys each scan's draws by its index in the
whole sequence).  A registration call gathers the rows its pairs address
to every rank and runs the store's method there, so every rank computes
the same transforms; rank 0's are broadcast, so that the ranks' next
decisions rest on one result.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.ops._cuda import torch_device
from lidar_slam_arvc_tpu_torch.parallel import mesh as _mesh
from lidar_slam_arvc_tpu_torch.pipeline.preprocess import (
    METHODS as REGISTRATION_METHODS, PLANE_SEED,
)
from lidar_slam_arvc_tpu_torch.registration.global_reg import (
    GlobalRegParams, fpfh_pairs, scan_features,
)
from lidar_slam_arvc_tpu_torch.registration.icp import ICPParams, icp_batch, two_planes_pairs
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
from lidar_slam_arvc_tpu_torch.utils.profiling import span

# the fpfh RANSAC's seed on every call, as the reference's PRNGKey(0)
FPFH_SEED = 0


def _validate_method(method: str) -> str:
    if method not in REGISTRATION_METHODS:
        raise ValueError(f"unknown registration method {method!r}; "
                         f"expected one of {REGISTRATION_METHODS}")
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
        self.ground_mask = None
        self.nonground_mask = None
        self.icp_params_override: ICPParams | None = None
        self.overflow = None   # (N,) voxels dropped per scan (capacity)
        self.n_loaded_locally = 0
        self.mesh = None       # set when the scan axis is sharded

    @classmethod
    def from_arrays(cls, points, mask, normals, method: str = "icppointplane",
                    cfg: IcpConfig | None = None, ground_mask=None,
                    nonground_mask=None,
                    icp_params: ICPParams | None = None) -> "KeyframeStore":
        """A store backed by already-preprocessed stacked tensors (N, C, 3),
        (N, C), (N, C, 3), on their device; icp2planes and fpfh also need
        the (N, C) ground and non-ground masks.  ``icp_params``: the ICP
        parameters of its registrations, in place of the config's."""
        store = cls(None, np.arange(points.shape[0]), method=method, cfg=cfg,
                    device=points.device)
        store.points, store.mask, store.normals = points, mask, normals
        store.ground_mask, store.nonground_mask = ground_mask, nonground_mask
        store.icp_params_override = icp_params
        store.n_loaded_locally = points.shape[0]
        return store

    # -------------------------------------------------------------- loading

    def __len__(self):
        return len(self.scan_times)

    @property
    def loaded(self) -> bool:
        return self.points is not None

    def load_and_preprocess(self, keyframe_sampling: int = 1,
                            seed: int = PLANE_SEED,
                            mesh=None) -> "KeyframeStore":
        """Load every ``keyframe_sampling``-th scan and preprocess it on the
        store's device (reference keyframemanager.py:20-50, all at once).
        ``seed`` keys the ground planes' draws under icp2planes and fpfh.
        With a ``mesh`` of several ranks, this rank loads only its block
        of the sharded store."""
        from lidar_slam_arvc_tpu_torch.pipeline.scanmatcher import (
            load_and_preprocess_streamed,
        )
        if keyframe_sampling > 1:
            self.scan_times = self.scan_times[::keyframe_sampling]
        times, first = self.scan_times, 0
        sharded = mesh is not None and mesh.size > 1
        if sharded:
            k = self._rows_per_rank(mesh)
            first = mesh.rank * k
            times = np.concatenate([times, np.repeat(
                times[-1:], mesh.size * k - len(times))])[first:first + k]
        with span("store.load"):
            scans, overflow, _ = load_and_preprocess_streamed(
                EurocDataset(self.directory), times, self.cfg, self.method,
                self.voxel_size, seed=seed, device=self.device, first=first)
        self.points, self.mask, self.normals = scans.points, scans.mask, scans.normals
        self.ground_mask, self.nonground_mask = scans.ground_mask, scans.nonground_mask
        self.n_loaded_locally = len(times)
        if sharded:
            self.mesh = mesh
            overflow = _mesh.gather_rows(mesh, torch.as_tensor(overflow),
                                         mesh.size * len(times), first)
            overflow = overflow.cpu().numpy()[:len(self.scan_times)]
        self.overflow = overflow
        return self

    # -------------------------------------------------------- sharding

    def _rows_per_rank(self, mesh) -> int:
        """Scans per rank: whole preprocessing batches, so that a rank's
        batches are the one-rank store's (stage 1's sharded rows)."""
        from lidar_slam_arvc_tpu_torch.pipeline.scanmatcher import sharded_rows
        return sharded_rows(len(self.scan_times), mesh.size, self.cfg.batch_size)

    def shard(self, mesh) -> "KeyframeStore":
        """Keep only this rank's contiguous block of the scans, the count
        padded to whole batches on every rank with copies of the last scan
        (callers never address a padding row)."""
        if not self.loaded:
            raise RuntimeError("call load_and_preprocess first")
        if self.sharded:
            raise RuntimeError("the store is sharded already")
        k = self._rows_per_rank(mesh)
        lo = mesh.rank * k
        pad = mesh.size * k - self.points.shape[0]

        def block(a):
            if a is None:
                return None
            if pad:
                a = torch.cat([a, a[-1:].expand((pad,) + a.shape[1:])])
            return a[lo:lo + k].contiguous()

        self.points, self.mask, self.normals = (
            block(self.points), block(self.mask), block(self.normals))
        self.ground_mask, self.nonground_mask = (
            block(self.ground_mask), block(self.nonground_mask))
        self.mesh = mesh
        return self

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    def _gathered(self, scans: np.ndarray) -> "KeyframeStore":
        """A store of the listed scans' rows, gathered from the ranks
        that hold them (an exact gather: every rank gets the same bits)."""
        k = self.points.shape[0]
        lo = self.mesh.rank * k
        mine = (scans >= lo) & (scans < lo + k)
        dev = self.points.device
        rows = torch.as_tensor(scans[mine] - lo, device=dev)
        at = torch.as_tensor(np.nonzero(mine)[0], device=dev)

        def gather(a):
            if a is None:
                return None
            buf = a.new_zeros((len(scans),) + a.shape[1:])
            buf[at] = a[rows]
            return _mesh.merge_exact(self.mesh, buf)

        return KeyframeStore.from_arrays(
            gather(self.points), gather(self.mask), gather(self.normals),
            method=self.method, cfg=self.cfg, ground_mask=gather(self.ground_mask),
            nonground_mask=gather(self.nonground_mask),
            icp_params=self.icp_params_override)

    # ------------------------------------------------------ registration

    def _icp_params(self) -> ICPParams:
        if self.icp_params_override is not None:
            return self.icp_params_override
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
        seeds under the store's method, in one batched call: returns
        (B, 4, 4) float64 T_i_j (the fpfh method ignores the seeds, as the
        reference does)."""
        if not self.loaded:
            raise RuntimeError("call load_and_preprocess first")
        pairs = np.asarray(pairs)
        if self.sharded:
            scans, inv = np.unique(pairs, return_inverse=True)
            T = self._gathered(scans).compute_transformations_batch(
                inv.reshape(pairs.shape), seeds)
            return _mesh.broadcast(self.mesh, torch.as_tensor(
                T, device=self.mesh.device)).cpu().numpy()
        dev = self.points.device
        with span("sync.loop_pair_upload"):  # host-to-card copies
            ti = torch.as_tensor(pairs[:, 0], dtype=torch.int64, device=dev)
            si = torch.as_tensor(pairs[:, 1], dtype=torch.int64, device=dev)
            seeds = torch.as_tensor(np.asarray(seeds, dtype=np.float32), device=dev)
        params = self._icp_params()
        if self.method == "icp2planes":
            res = two_planes_pairs(self.points, self.normals, self.ground_mask,
                                   self.nonground_mask, si, ti, seeds, params)
        elif self.method == "fpfh":
            # the descriptors of the call's distinct scans, each once
            scans, inv = torch.unique(torch.cat([si, ti]), return_inverse=True)
            feats = scan_features(self.points[scans], self.normals[scans],
                                  self.nonground_mask[scans],
                                  self.cfg.fpfh_radius, self.cfg.batch_size)
            gp = GlobalRegParams(fpfh_radius=self.cfg.fpfh_radius, icp=params)
            res = fpfh_pairs(self.points[scans], self.mask[scans],
                             self.normals[scans], self.nonground_mask[scans],
                             feats, inv[:len(si)], inv[len(si):], gp,
                             torch.Generator().manual_seed(FPFH_SEED))
        else:
            res = icp_batch(self.points[si], self.mask[si], self.points[ti],
                            self.mask[ti], self.normals[ti], seeds, params,
                            "point_to_point" if self.method == "icppointpoint"
                            else "point_to_plane")
        with span("sync.loop_transforms"):
            return res.transform.cpu().numpy().astype(np.float64)

    # ------------------------------------------------------------- memory

    def memory_bytes(self) -> int:
        """Bytes of this process's points, mask, normals, ground and
        non-ground masks (a sharded store's own block)."""
        return sum(a.numel() * a.element_size()
                   for a in (self.points, self.mask, self.normals,
                             self.ground_mask, self.nonground_mask)
                   if a is not None)
