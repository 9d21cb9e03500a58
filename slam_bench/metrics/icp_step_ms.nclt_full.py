"""Milliseconds per ICP step on whole scans (K1 at S = T = 65536, K6 in
two register rounds): ``icp_step_ms.stage1``'s reading in this cell,
whose manifest entry names the voxelised cell alone."""

from slam_bench import run


def read(ctx):
    return run.reader("icp_step_ms.stage1")(ctx)
