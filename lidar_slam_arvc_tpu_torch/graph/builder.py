"""Incremental pose-graph construction with batch re-solves.

Counterpart of ``lidar_slam_arvc_tpu/graph/builder.py`` (API parity with
reference graphslam/graphSLAM.py:56-232): ``init_graph`` / ``add_edge`` /
``add_gps_factor`` / ``add_initial_estimate`` / ``optimize`` /
``marginal_covariances`` / ``get_solution_transforms(_lidar)``.  Factors
accumulate in host numpy buffers of fixed capacity with the reference's
slot layout: between slots [0, chain_capacity) hold consecutive (j == i+1)
edges, the slots after them loop closures and chain overflow.  Each
``optimize`` moves the active factors to the device (``make_factor_data``)
and runs the dense or the PCG solver there, or, over a mesh of ranks
(``parallel/mesh.py``), the distributed Schur solve.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.graph.factors import (
    DEFAULT_SIGMAS, FACTOR_FIELDS, NoiseSigmas, make_factor_data,
)
from lidar_slam_arvc_tpu_torch.graph.pcg import marginal_blocks_pcg, solve_graph_pcg
from lidar_slam_arvc_tpu_torch.graph.solver import marginal_covariances, solve_graph
from lidar_slam_arvc_tpu_torch.ops._cuda import torch_device

SOLVERS = ("auto", "dense", "pcg", "schur")
# the largest pose capacity that optimize(solver="auto") solves densely;
# the reference's, measured on a TPU (its auto_solver docstring), kept so
# both packages pick the same solver
DENSE_MAX_POSES = 256


class PoseGraph:
    def __init__(self, T0: np.ndarray | None = None,
                 T0_gps: np.ndarray | None = None,
                 max_poses: int = 4096, max_between: int | None = None,
                 max_gps: int | None = None,
                 sigmas: NoiseSigmas = DEFAULT_SIGMAS, mesh=None,
                 chain_capacity: int | None = None, device="cuda"):
        """``mesh``: a ``parallel.mesh.DataMesh`` of the ranks that solve
        the graph together (solver 'schur'); every rank builds the same
        graph."""
        self.device = torch_device(device, "PoseGraph")
        self.mesh = mesh
        self.max_poses = max_poses
        self.max_between = max_between or (4 * max_poses)
        self.max_gps = max_gps or max_poses
        self.sigmas = sigmas
        self.T0 = np.eye(4) if T0 is None else np.asarray(T0, dtype=np.float64)
        self.T0_gps = (np.eye(4) if T0_gps is None
                       else np.asarray(T0_gps, dtype=np.float64))

        self.poses = np.tile(np.eye(4, dtype=np.float32), (max_poses, 1, 1))
        self.n_poses = 0

        self.bt_i = np.zeros(self.max_between, dtype=np.int32)
        self.bt_j = np.zeros(self.max_between, dtype=np.int32)
        self.bt_T = np.tile(np.eye(4, dtype=np.float32), (self.max_between, 1, 1))
        self.bt_winv = np.zeros((self.max_between, 6), dtype=np.float32)
        # SM+ODO chain edges need up to 2*(max_poses-1) slots; the default
        # keeps at least half of max_between for loop edges
        if chain_capacity is None:
            chain_capacity = min(2 * max_poses, self.max_between // 2)
        if not 0 <= chain_capacity <= self.max_between:
            raise ValueError(f"chain_capacity {chain_capacity} outside "
                             f"[0, max_between={self.max_between}]")
        self.chain_capacity = chain_capacity
        self.n_chain = 0
        self.n_loop = 0

        self.gps_i = np.zeros(self.max_gps, dtype=np.int32)
        self.gps_z = np.zeros((self.max_gps, 3), dtype=np.float32)
        self.gps_winv = np.zeros((self.max_gps, 3), dtype=np.float32)
        self.n_gps = 0

        self.pr_i = np.zeros(1, dtype=np.int32)
        self.pr_T = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1))
        self.pr_winv = np.zeros((1, 6), dtype=np.float32)
        self.n_prior = 0
        # solver counters since construction: optimize calls, LM steps, CG
        # iterations and host synchronisations
        self.stats = {"optimizations": 0, "lm_steps": 0, "cg_iterations": 0,
                      "host_syncs": 0}

    @classmethod
    def from_reference_state(cls, d: dict, device="cuda",
                             sigmas: NoiseSigmas = DEFAULT_SIGMAS,
                             mesh=None) -> "PoseGraph":
        """A graph holding the buffers and counters of a JAX-package
        PoseGraph, given as a dict of numpy arrays and ints: ``poses``, the
        factor buffers (``bt_*``, ``gps_*``, ``pr_*``), ``n_poses``,
        ``n_chain``, ``n_loop``, ``n_gps``, ``n_prior``,
        ``chain_capacity``, ``T0`` and ``T0_gps``."""
        poses = np.asarray(d["poses"], dtype=np.float32)
        g = cls(T0=d["T0"], T0_gps=d["T0_gps"], max_poses=poses.shape[0],
                max_between=len(d["bt_i"]), max_gps=len(d["gps_i"]),
                sigmas=sigmas, chain_capacity=int(d["chain_capacity"]),
                device=device, mesh=mesh)
        g.poses = poses.copy()
        for k in FACTOR_FIELDS:
            setattr(g, k, np.array(d[k], dtype=getattr(g, k).dtype))
        for k in ("n_poses", "n_chain", "n_loop", "n_gps", "n_prior"):
            setattr(g, k, int(d[k]))
        return g

    # ------------------------------------------------------------ building

    def init_graph(self):
        """Prior at pose 0 with T0, seeded at T0 (reference
        graphSLAM.py:79-86)."""
        self.pr_i[0] = 0
        self.pr_T[0] = self.T0.astype(np.float32)
        self.pr_winv[0] = 1.0 / self.sigmas.prior
        self.n_prior = 1
        self.poses[0] = self.T0.astype(np.float32)
        self.n_poses = max(self.n_poses, 1)

    def add_edge(self, T_ij: np.ndarray, i: int, j: int, noise_type: str):
        """Between factor i->j (reference graphSLAM.py:88-91).  Consecutive
        edges fill the chain slots while they have room; everything else
        goes to the slots after them."""
        sig = {"SM": self.sigmas.sm, "ODO": self.sigmas.odo}[noise_type]
        if j == i + 1 and self.n_chain < self.chain_capacity:
            k = self.n_chain
            self.n_chain += 1
        else:
            k = self.chain_capacity + self.n_loop
            if k >= self.max_between:
                raise RuntimeError(
                    f"between-factor capacity exceeded (chain "
                    f"{self.n_chain}/{self.chain_capacity}, loop "
                    f"{self.n_loop}/{self.max_between - self.chain_capacity}); "
                    "raise max_between")
            self.n_loop += 1
        self.bt_i[k] = i
        self.bt_j[k] = j
        self.bt_T[k] = np.asarray(T_ij, dtype=np.float32)
        self.bt_winv[k] = 1.0 / sig

    def add_gps_factor(self, utmx: float, utmy: float, altitude: float, i: int):
        """GPS unary factor (reference graphSLAM.py:93-95)."""
        if self.n_gps >= self.max_gps:
            raise RuntimeError("gps-factor capacity exceeded")
        k = self.n_gps
        self.gps_i[k] = i
        self.gps_z[k] = (utmx, utmy, altitude)
        self.gps_winv[k] = 1.0 / self.sigmas.gps
        self.n_gps += 1

    def add_initial_estimate(self, T_rel: np.ndarray, k: int):
        """Pose k seeded by composing pose k-1 with the relative transform
        (reference graphSLAM.py:97-100)."""
        self.poses[k] = (self.poses[k - 1].astype(np.float64)
                         @ np.asarray(T_rel, dtype=np.float64)).astype(np.float32)
        self.n_poses = max(self.n_poses, k + 1)

    # ----------------------------------------------------------- solving

    def _factor_data(self):
        return make_factor_data(self.max_poses, self.device,
                                **{k: getattr(self, k) for k in FACTOR_FIELDS})

    def _poses_on_device(self) -> torch.Tensor:
        return torch.as_tensor(self.poses, device=self.device)

    def auto_solver(self) -> str:
        """The solver optimize(solver='auto') picks: schur under a mesh of
        several ranks when the pose capacity divides over it in chunks of
        two poses or more; else dense up to DENSE_MAX_POSES of capacity,
        PCG beyond."""
        if (self.mesh is not None and self.mesh.size > 1
                and self.max_poses % self.mesh.size == 0
                and self.max_poses >= 2 * self.mesh.size):
            return "schur"
        return "dense" if self.max_poses <= DENSE_MAX_POSES else "pcg"

    def optimize(self, max_iterations: int = 15, solver: str = "auto") -> float:
        """Batch LM re-solve of the whole graph (replaces isam.update,
        reference graphSLAM.py:102-105).  ``solver``: 'dense' (Cholesky on
        the (6N, 6N) normal equations), 'pcg' (preconditioned CG with the
        cyclic-reduction chain preconditioner), 'schur' (distributed
        chunk-wise Schur elimination over the attached mesh, or over the
        ranks of the process group when none is attached; every rank must
        call it), 'auto' (``auto_solver``)."""
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r} ({' | '.join(SOLVERS)})")
        if solver == "auto":
            solver = self.auto_solver()
        if solver == "schur":
            from lidar_slam_arvc_tpu_torch.parallel.mesh import data_mesh
            from lidar_slam_arvc_tpu_torch.parallel.schur import schur_solve_graph
            mesh = self.mesh if self.mesh is not None else data_mesh()
            poses, cost = schur_solve_graph(
                mesh, self._poses_on_device(), self._factor_data(), self.n_poses,
                sep_capacity=self._sep_capacity(mesh.size),
                max_iterations=max_iterations, stats=self.stats)
        else:
            run = solve_graph_pcg if solver == "pcg" else solve_graph
            poses, cost = run(self._poses_on_device(), self._factor_data(),
                              self.n_poses, max_iterations=max_iterations,
                              stats=self.stats)
        self.poses = poses.cpu().numpy()
        self.stats["optimizations"] += 1
        self.stats["host_syncs"] += 1
        return float(cost)

    def _sep_capacity(self, n_devices: int) -> int:
        """Separator capacity for the Schur solve: the count of poses
        touched by active edges that cross chunks, rounded up to a power
        of two (at least 16), at most the pose capacity."""
        from lidar_slam_arvc_tpu_torch.parallel.schur import separators
        active = self.bt_winv.any(axis=1)
        n_sep = len(separators(self.bt_i[active], self.bt_j[active],
                               self.max_poses, n_devices))
        cap = 16
        while cap < n_sep:
            cap *= 2
        return min(cap, self.max_poses)

    def marginal_covariances(self, indices=None) -> np.ndarray:
        """Tangent-space [w, v] 6x6 marginal covariance blocks
        (gtsam.Marginals parity, reference graphSLAM.py:117-137).
        indices=None: every active pose, by chunked dense back-substitution;
        with indices (K,): those poses only, by matrix-free PCG.  Returns
        (n_poses, 6, 6) or (K, 6, 6) float64."""
        if indices is None:
            cov = marginal_covariances(self._poses_on_device(),
                                       self._factor_data(), self.n_poses)
            return cov[: self.n_poses].cpu().numpy().astype(np.float64)
        cov = marginal_blocks_pcg(self._poses_on_device(), self._factor_data(),
                                  self.n_poses, np.asarray(indices),
                                  stats=self.stats)
        return cov.cpu().numpy().astype(np.float64)

    # ----------------------------------------------------------- queries

    @property
    def current_estimate(self) -> np.ndarray:
        return self.poses[: self.n_poses].astype(np.float64)

    def positions(self) -> np.ndarray:
        return self.current_estimate[:, :3, 3]

    def get_solution_transforms(self) -> np.ndarray:
        """(reference graphSLAM.py:214-222)."""
        return self.current_estimate

    def get_solution_transforms_lidar(self) -> np.ndarray:
        """Solution re-based into the LiDAR frame: X_i @ T0_gps^-1
        (reference graphSLAM.py:224-232)."""
        return np.einsum("nij,jk->nik", self.current_estimate,
                         np.linalg.inv(self.T0_gps))
