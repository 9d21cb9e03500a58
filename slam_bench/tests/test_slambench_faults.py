"""The check catches a broken timed path: a CPU run of each cell at a small
size, past the harness's look for a card, with the program broken
underneath, reads ``correct`` false; the same run unbroken reads true.

Faults: a step that returns its state unchanged (stage 1: ICP leaves every
pair at its seed; stage 2: the pose-graph solve leaves the poses), half
of every batch left out (stage 1: only the first half of each ICP group is
registered), and an answer altered where it is produced (stage 1: every
registered transform shifted 1 cm; stage 2: the triangle gate answers
"inconsistent" for every triplet).  A cell on one card has no exchange
between cards to leave out.
"""

import contextlib

import pytest
import torch

from slam_bench import run
from slam_bench.tests import tiny


@contextlib.contextmanager
def broken(fault: str):
    from lidar_slam_arvc_tpu_torch.graph import builder
    from lidar_slam_arvc_tpu_torch.loop import loopclosing
    from lidar_slam_arvc_tpu_torch.pipeline import scanmatcher
    from lidar_slam_arvc_tpu_torch.registration.icp import ICPResult
    from slam_bench.spies import patched

    def seeds_only(original):
        def icp(src, sm, tgt, tm, tn, T_inits, *a, **k):
            B = T_inits.shape[0]
            return ICPResult(T_inits.float(), torch.ones(B), torch.zeros(B),
                             torch.ones(B, dtype=torch.int32), torch.zeros(B))
        return icp

    def half_batch(original):
        def icp(src, sm, tgt, tm, tn, T_inits, *a, **k):
            h = max(T_inits.shape[0] // 2, 1)
            res = original(src[:h], sm[:h], tgt[:h], tm[:h], tn[:h], T_inits[:h], *a, **k)
            rest = T_inits[h:].float()
            B = rest.shape[0]
            return ICPResult(torch.cat([res.transform, rest]),
                             torch.cat([res.fitness, torch.ones(B)]),
                             torch.cat([res.inlier_rmse, torch.zeros(B)]),
                             torch.cat([res.iterations, torch.ones(B, dtype=torch.int32)]),
                             torch.cat([res.final_delta, torch.zeros(B)]))
        return icp

    def shifted(metres):
        def make(original):
            def icp(*a, **k):
                res = original(*a, **k)
                T = res.transform.clone()
                T[:, 0, 3] += metres
                return res._replace(transform=T)
            return icp
        return make

    def rejects(original):
        def check_distances(closer, I):
            return False
        return check_distances

    def frozen(original):
        def optimize(graph, max_iterations=15, solver="auto"):
            return 0.0
        return optimize

    with contextlib.ExitStack() as stack:
        if fault == "seeds_only":
            stack.enter_context(patched(scanmatcher, "icp_batch", seeds_only))
        elif fault == "half_batch":
            stack.enter_context(patched(scanmatcher, "icp_batch", half_batch))
        elif fault == "shifted":
            stack.enter_context(patched(scanmatcher, "icp_batch", shifted(0.01)))
        elif fault == "frozen_solve":
            stack.enter_context(patched(builder.PoseGraph, "optimize", frozen))
        elif fault == "gate_rejects":
            stack.enter_context(patched(loopclosing.LoopCloser, "check_distances", rejects))
        yield


def _run(workload, fault, check_pairs=None):
    torch.set_num_threads(4)
    ov = tiny.overrides(workload)
    if check_pairs:
        ov["traffic"]["check_pairs"] = check_pairs
    with broken(fault):
        return run.run(workload, 2 ** 32 + 5, 0.1, trace_on=False, device="cpu",
                       overrides=ov, manifest=tiny.MANIFEST)


@pytest.mark.parametrize("fault", [None, "seeds_only", "half_batch", "shifted"])
def test_stage1_faults(fault):
    out = _run("kitti00.stage1", fault, check_pairs=8)
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("fault", [None, "frozen_solve", "gate_rejects"])
def test_stage2_faults(fault):
    out = _run("nclt.stage2", fault)
    assert out["correct"] is (fault is None), out["checks"]
