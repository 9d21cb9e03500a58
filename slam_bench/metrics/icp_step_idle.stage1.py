"""Share of the profiled sequence's ICP steps in which nothing ran on the
device: 1 - (union of kernel, copy and set intervals inside the program's
``icp.step`` spans) / the spans' summed length, in %.  None where the
program has no such span."""

from slam_bench import trace


def read(ctx):
    steps = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in ctx["events"]
                   if e.get("cat") == "user_annotation" and e["name"] == "icp.step")
    total = sum(b - a for a, b in steps)
    if total <= 0:
        return None
    busy = trace.merged(trace.device_intervals(ctx["events"], steps[0][0], steps[-1][1]))
    # both lists sorted and each without overlaps: one sweep
    covered, k = 0.0, 0
    for a, b in steps:
        while k < len(busy) and busy[k][1] <= a:
            k += 1
        j = k
        while j < len(busy) and busy[j][0] < b:
            covered += min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
    return 100.0 * (1.0 - covered / total)
