"""Host synchronisations per ICP step in the profiled sequence:
``cuda*Synchronize`` runtime calls that start inside the program's
``icp.step`` spans, over the number of those spans.  None where the
program has no such span."""

import bisect


def read(ctx):
    steps = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in ctx["events"]
                   if e.get("cat") == "user_annotation" and e["name"] == "icp.step")
    if not steps:
        return None
    starts = [a for a, _ in steps]
    n = 0
    for e in ctx["events"]:
        if (e.get("cat") == "cuda_runtime" and e["name"].startswith("cuda")
                and "Synchronize" in e["name"]):
            k = bisect.bisect_right(starts, float(e["ts"])) - 1
            if k >= 0 and float(e["ts"]) <= steps[k][1]:
                n += 1
    return n / len(steps)
