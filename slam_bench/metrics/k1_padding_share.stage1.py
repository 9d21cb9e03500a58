"""Share of K1's swept (source slot, target slot) pairs that hold a padded
slot: 100 (1 - sum of ``k1_pairs_valid`` / sum of ``k1_pairs_swept``) over
the window's profiles, in %.  None where the program does not count them."""


def read(ctx):
    profs = ctx["profiles"]
    if not profs or any(p.get("k1_pairs_swept") is None
                        or p.get("k1_pairs_valid") is None for p in profs):
        return None
    swept = sum(p["k1_pairs_swept"] for p in profs)
    if not swept:
        return None
    return 100.0 * (1.0 - sum(p["k1_pairs_valid"] for p in profs) / swept)
