"""Milliseconds per Levenberg-Marquardt step: the window's
``optimize_seconds`` over its ``solver_stats.lm_steps``."""


def read(ctx):
    secs = sum(p["optimize_seconds"] for p in ctx["profiles"])
    steps = sum(p["solver_stats"]["lm_steps"] for p in ctx["profiles"])
    return 1e3 * secs / steps if steps else None
