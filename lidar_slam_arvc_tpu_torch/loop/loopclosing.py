"""Loop closing with triplet (triangle) consistency filtering.

Counterpart of ``lidar_slam_arvc_tpu/loop/loopclosing.py`` (logic parity
with reference graphslam/loopclosing.py:9-268).  Candidates are past poses
within ``radius_threshold`` of the current pose and at least
``distance_backwards`` of accumulated path behind it; a triplet (i, j1, j2)
needs 1 < |j2 - j1| < 80 and 1 m < |p_j2 - p_j1| < 2 m; it is accepted when
the cycle T_ij1 T_j1j2 T_ij2^-1 is near identity (|t| < 0.1 m, smaller
Euler-branch norm < 0.05 rad), with T_ij1 and T_ij2 in the graph's (GPS)
frame and T_j1j2 in the LiDAR frame, as the reference forms it (the two
frames differ only when T0_gps is not I; ROADMAP Queue 3).  The search,
the seeded numpy draws and the gate run on the host, as in the
reference; the ICPs of all drawn pairs run as one batch through the
keyframe store.  The reference pads that batch to a power of two so that
XLA reuses one compiled program; the port runs the real pairs only, and
``timings["icp_pairs"]`` counts them.
"""

from __future__ import annotations

import time

import numpy as np

from lidar_slam_arvc_tpu_torch.keyframes.store import KeyframeStore


def _rot_to_euler_both_np(R: np.ndarray):
    """Host mirror of ``geom.rotations.rot_to_euler_both`` for the gate."""
    r02 = np.clip(R[0, 2], -1.0, 1.0)
    beta1 = np.arcsin(r02)
    beta2 = np.pi - beta1
    s1 = np.sign(np.cos(beta1)) or 1.0
    s2 = np.sign(np.cos(beta2)) or 1.0
    e1 = np.array([np.arctan2(-s1 * R[1, 2], s1 * R[2, 2]), beta1,
                   np.arctan2(-s1 * R[0, 1], s1 * R[0, 0])])
    e2 = np.array([np.arctan2(-s2 * R[1, 2], s2 * R[2, 2]), beta2,
                   np.arctan2(-s2 * R[0, 1], s2 * R[0, 0])])
    wrap = lambda e: np.arctan2(np.sin(e), np.cos(e))
    return wrap(e1), wrap(e2)


class LoopCloser:
    def __init__(self, graph, store: KeyframeStore,
                 distance_backwards: float = 7.0,
                 radius_threshold: float = 5.0, seed: int = 0):
        """graph: PoseGraph; store: KeyframeStore of the preprocessed scans,
        whose registration method and ICP parameters the candidate ICPs
        use (reference loopclosing.py:180 -> keyframemanager.py:60-72)."""
        if not isinstance(store, KeyframeStore):
            raise TypeError("LoopCloser needs a KeyframeStore "
                            "(KeyframeStore.from_arrays wraps tensors)")
        self.graph = graph
        self.store = store
        self.distance_backwards = distance_backwards
        self.radius_threshold = radius_threshold
        self.rng = np.random.default_rng(seed)
        self.timings = {"candidate_search_seconds": 0.0, "icp_seconds": 0.0,
                        "icp_dispatches": 0, "icp_pairs": 0}

    # ------------------------------------------------- candidate search

    def find_index_backwards(self, positions) -> int | None:
        """Largest index with > distance_backwards of accumulated path to
        the current pose (reference loopclosing.py:223-237)."""
        steps = np.linalg.norm(np.diff(positions, axis=0), axis=1)
        back = np.cumsum(steps[::-1])[::-1]
        hits = np.nonzero(back > self.distance_backwards)[0]
        if len(hits) == 0:
            return None
        return int(hits[-1])

    def find_candidates(self) -> np.ndarray:
        """(reference loopclosing.py:213-253, vectorized)."""
        positions = self.graph.positions()
        if len(positions) < 3:
            return np.empty(0, dtype=int)
        index = self.find_index_backwards(positions)
        if index is None:
            return np.empty(0, dtype=int)
        d = np.linalg.norm(positions[:index] - positions[-1], axis=1)
        return np.nonzero(d < self.radius_threshold)[0]

    def find_feasible_triplets(self, current_index: int) -> list:
        """(reference loopclosing.py:102-117 + 131-144)."""
        positions = self.graph.positions()
        candidates = np.sort(self.find_candidates())
        triplets = []
        for k in range(len(candidates)):
            j1 = int(candidates[k])
            rest = candidates[k:]
            dindex = np.abs(rest - j1)
            deuc = np.linalg.norm(positions[rest] - positions[j1], axis=1)
            ok = (dindex > 1) & (dindex < 80) & (deuc > 1.0) & (deuc < 2.0)
            hits = np.nonzero(ok)[0]
            if len(hits):
                triplets.append([current_index, j1, int(rest[hits[0]])])
        return triplets

    # ------------------------------------------------------ ICP plumbing

    def _batched_candidate_icp(self, pairs: np.ndarray) -> np.ndarray:
        """Refined T_i_j of each (i, j) pair, in one batch: seeded from the
        graph's estimates conjugated by T0_gps, registered in the LiDAR
        frame, conjugated back (reference loopclosing.py:154-184)."""
        est = self.graph.current_estimate
        T0g = self.graph.T0_gps
        T0g_inv = np.linalg.inv(T0g)
        seeds = np.empty((len(pairs), 4, 4), dtype=np.float32)
        for k, (i, j) in enumerate(pairs):
            seeds[k] = (np.linalg.inv(est[i] @ T0g_inv)
                        @ (est[j] @ T0g_inv)).astype(np.float32)
        t0 = time.time()
        T = self.store.compute_transformations_batch(pairs, seeds)
        self.timings["icp_seconds"] += time.time() - t0
        self.timings["icp_dispatches"] += 1
        self.timings["icp_pairs"] += len(pairs)
        return np.einsum("ij,njk,kl->nil", T0g_inv, T, T0g)

    # ------------------------------------------------------- public API

    def check_distances(self, I: np.ndarray) -> bool:
        """Triangle consistency gate (reference loopclosing.py:119-129)."""
        dp = np.linalg.norm(I[:3, 3])
        e1, e2 = _rot_to_euler_both_np(I[:3, :3])
        da = min(np.linalg.norm(e1), np.linalg.norm(e2))
        return dp < 0.1 and da < 0.05

    def loop_closing_simple(self, current_index: int,
                            number_of_candidates: int) -> list:
        """Ungated loop closing (reference loopclosing.py:33-57): every ICP
        result of the drawn candidates becomes an SM edge.  Returns the
        added [i, j] pairs."""
        candidates = self.find_candidates()
        if len(candidates) == 0:
            return []
        n = min(len(candidates), number_of_candidates)
        chosen = self.rng.choice(candidates, size=n, replace=False)
        pairs = np.array([[current_index, int(j)] for j in chosen])
        T_ij = self._batched_candidate_icp(pairs)
        added = []
        for k, (i, j) in enumerate(pairs):
            self.graph.add_edge(T_ij[k], int(i), int(j), "SM")
            added.append([int(i), int(j)])
        return added

    def loop_closing_triangle(self, current_index: int,
                              number_of_triplets: int) -> list:
        """(reference loopclosing.py:58-100); returns accepted [i, j] pairs."""
        t0 = time.time()
        triplets = self.find_feasible_triplets(current_index)
        self.timings["candidate_search_seconds"] += time.time() - t0
        if not triplets:
            return []
        n = min(len(triplets), number_of_triplets)
        chosen = self.rng.choice(len(triplets), size=n, replace=False)
        triplets = [triplets[k] for k in chosen]

        pairs = np.array([[t[0], t[1]] for t in triplets]
                         + [[t[0], t[2]] for t in triplets])
        T_all = self._batched_candidate_icp(pairs)
        T_ij1, T_ij2 = T_all[:n], T_all[n:]

        # T_j1j2 in the LiDAR frame, as the reference forms it, against
        # T_ij1 and T_ij2 in the GPS frame: the gate mixes frames when
        # T0_gps is not I (ROADMAP Queue 3)
        est = self.graph.current_estimate
        T0g_inv = np.linalg.inv(self.graph.T0_gps)
        added = []
        for k, (i, j1, j2) in enumerate(triplets):
            T_j1j2 = np.linalg.inv(est[j1] @ T0g_inv) @ (est[j2] @ T0g_inv)
            if self.check_distances(T_ij1[k] @ T_j1j2 @ np.linalg.inv(T_ij2[k])):
                self.graph.add_edge(T_ij1[k], i, j1, "SM")
                self.graph.add_edge(T_ij2[k], i, j2, "SM")
                added.append([i, j1])
                added.append([i, j2])
        return added
