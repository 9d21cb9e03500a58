"""Stage 2's keyframe-store load + preprocess seconds (the profile's
``store_load_preprocess_seconds``), mean per sequence of the window."""


def read(ctx):
    vals = [p["store_load_preprocess_seconds"] for p in ctx["profiles"]]
    return sum(vals) / len(vals) if vals else None
