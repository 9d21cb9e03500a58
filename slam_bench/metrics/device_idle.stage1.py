"""Share of the profiled sequence in which nothing ran on the device:
1 - (union of kernel, copy and set intervals) / the sequence's span, in %."""

from slam_bench import trace


def read(ctx):
    lo, hi = ctx["spans"]["sequence"]
    if hi <= lo:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(ctx["events"], lo, hi) / ((hi - lo) * 1e-6))
