"""Stage 1's load + preprocess seconds (the profile's
``load_preprocess_seconds``), mean per sequence of the window."""


def read(ctx):
    vals = [p["load_preprocess_seconds"] for p in ctx["profiles"]]
    return sum(vals) / len(vals) if vals else None
