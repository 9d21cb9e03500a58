"""Milliseconds per ICP step (one trip of ``registration/icp.py``'s loop:
one K1 sweep of a group of pairs and its Gauss-Newton step): the window's
``icp_seconds`` over its ``icp_steps``.  None where the program does not
count its steps."""


def read(ctx):
    profs = ctx["profiles"]
    if not profs or any(p.get("icp_steps") is None for p in profs):
        return None
    steps = sum(p["icp_steps"] for p in profs)
    return 1e3 * sum(p["icp_seconds"] for p in profs) / steps if steps else None
