"""Share of the scans' cropped points that the capacity keeps: 100 x the
sum of ``scan_points_kept`` over the sum of ``scan_points_valid`` over the
window's profiles, in % (100: every return of every scan reaches ICP).
None where the program does not count them."""


def read(ctx):
    profs = ctx["profiles"]
    if not profs or any(p.get("scan_points_valid") is None
                        or p.get("scan_points_kept") is None for p in profs):
        return None
    valid = sum(p["scan_points_valid"] for p in profs)
    return 100.0 * sum(p["scan_points_kept"] for p in profs) / valid if valid else None
