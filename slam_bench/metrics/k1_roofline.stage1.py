"""K1's (``nn_sweep_kernel``) share of its roofline over the profiled
sequence: the least time of the work its calls' valid points need
(``roofline.k1_work``) over its device time in the trace."""

from slam_bench import roofline, trace


def read(ctx):
    ops, n_bytes = ctx["work"].get("k1", (0.0, 0.0))
    got = roofline.share(ops, n_bytes, trace.kernel_seconds(
        ctx["events"], "nn_sweep_kernel", *ctx["spans"]["sequence"]))
    return None if got is None else got[0]
