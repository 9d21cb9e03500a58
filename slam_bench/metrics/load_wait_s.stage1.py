"""Seconds the stage-1 main thread waits for the PCD decode thread (the
profile's ``pcd_wait_seconds``: its time blocked in ``pcd.wait``), mean per
sequence of the window.  None where the program does not count it."""


def read(ctx):
    vals = [p.get("pcd_wait_seconds") for p in ctx["profiles"]]
    if not vals or None in vals:
        return None
    return sum(vals) / len(vals)
