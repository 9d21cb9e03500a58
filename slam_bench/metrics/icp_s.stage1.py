"""Stage 1's registration seconds (the profile's ``icp_seconds``), mean per
sequence of the window."""


def read(ctx):
    vals = [p["icp_seconds"] for p in ctx["profiles"]]
    return sum(vals) / len(vals) if vals else None
