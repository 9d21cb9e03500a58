"""Stage 2's pose-graph solve seconds (the profile's ``optimize_seconds``),
mean per sequence of the window."""


def read(ctx):
    vals = [p["optimize_seconds"] for p in ctx["profiles"]]
    return sum(vals) / len(vals) if vals else None
