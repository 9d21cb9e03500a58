"""Kernel launches (``cudaLaunchKernel*`` calls in the trace) during the
ICP phase of the profiled sequence, per K1 launch there: one K1 launch is
one ICP iteration of one group of pairs."""

from slam_bench import trace


def read(ctx):
    lo_hi = ctx["spans"].get("icp")
    k1 = ctx["k1_launches"]
    if lo_hi is None or not k1:
        return None
    return trace.launches(ctx["events"], *lo_hi) / k1
