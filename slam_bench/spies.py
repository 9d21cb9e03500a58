"""What the benchmark reads from the program while it runs, by wrapping
functions of the program's modules for the length of a ``with`` block.
Every wrapper calls the original with the same arguments and returns its
result unchanged.

- ``Stage2Record``: at each loop-closing round, the pose estimate the
  program holds and the round's index; the marginals the program hands to
  its uncertainty render; the pose graph itself (its final factors, for
  the check's diagnostics).  Cheap (host copies of a few hundred poses), so
  it is on during the window: the check judges the window's own outputs.
- ``Work``: the valid points of every ICP and ball-moment call and the K1
  launches each ICP call made, and a profiler span around the stage-1
  registration phase.  It reads counts back from the device, so only the
  profiled sequence of a ``--trace 1`` run has it on.
"""

from __future__ import annotations

import contextlib

import torch

from slam_bench import roofline


@contextlib.contextmanager
def patched(module, name: str, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


class Stage2Record:
    def __init__(self):
        self.rounds, self.marginals, self.graph = [], None, None

    @contextlib.contextmanager
    def on(self):
        from lidar_slam_arvc_tpu_torch.loop import loopclosing
        from lidar_slam_arvc_tpu_torch.pipeline import graphslam
        self.rounds, self.marginals = [], None

        def loop_round(original):
            def wrapper(closer, current_index, number_of_triplets):
                self.graph = closer.graph
                self.rounds.append({"index": int(current_index),
                                    "n_triplets": int(number_of_triplets),
                                    "estimate": closer.graph.current_estimate,
                                    "T0_gps": closer.graph.T0_gps.copy()})
                return original(closer, current_index, number_of_triplets)
            return wrapper

        def render(original):
            def wrapper(estimate, covs, path, skip=1, *args, **kwargs):
                self.marginals = (covs.copy(), int(skip))
                return original(estimate, covs, path, skip, *args, **kwargs)
            return wrapper

        with patched(loopclosing.LoopCloser, "loop_closing_triangle", loop_round), \
                patched(graphslam, "plot_trajectory_with_uncertainty", render):
            yield self


class Work:
    """Operations and bytes that K1 and K2 calls needed (``roofline``)."""

    def __init__(self):
        self.k1 = [0.0, 0.0]
        self.k2 = [0.0, 0.0]
        self.k1_launches = 0

    @contextlib.contextmanager
    def on(self):
        from lidar_slam_arvc_tpu_torch.cloud import normals
        from lidar_slam_arvc_tpu_torch.keyframes import store
        from lidar_slam_arvc_tpu_torch.ops import _cuda
        from lidar_slam_arvc_tpu_torch.pipeline import scanmatcher

        def icp(original):
            def wrapper(src_points, src_masks, tgt_points, tgt_masks, *args, **kwargs):
                before = _cuda.launch_counts["nn_sweep"]
                res = original(src_points, src_masks, tgt_points, tgt_masks, *args, **kwargs)
                n = _cuda.launch_counts["nn_sweep"] - before
                ops, nb = roofline.k1_work(src_masks.sum(-1).tolist(),
                                           tgt_masks.sum(-1).tolist())
                self.k1[0] += n * ops
                self.k1[1] += n * nb
                return res
            return wrapper

        def moments(original):
            def wrapper(query, tgt, tgt_mask, radius, query_mask=None, *args, **kwargs):
                count, s1, s2 = original(query, tgt, tgt_mask, radius,
                                         query_mask=query_mask, *args, **kwargs)
                qm = tgt_mask if query_mask is None else query_mask
                ops, nb = roofline.k2_work(qm.reshape(-1, qm.shape[-1]).sum(-1).tolist(),
                                           tgt_mask.reshape(-1, tgt_mask.shape[-1]).sum(-1).tolist(),
                                           float((count * qm).sum()))
                self.k2[0] += ops
                self.k2[1] += nb
                return count, s1, s2
            return wrapper

        def phase(original):
            def wrapper(*args, **kwargs):
                before = _cuda.launch_counts["nn_sweep"]
                with torch.profiler.record_function("slam_bench.icp"):
                    res = original(*args, **kwargs)
                self.k1_launches += _cuda.launch_counts["nn_sweep"] - before
                return res
            return wrapper

        with patched(scanmatcher, "icp_batch", icp), patched(store, "icp_batch", icp), \
                patched(normals, "ball_moments", moments), \
                patched(scanmatcher, "match_consecutive", phase):
            yield self
