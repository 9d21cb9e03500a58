"""Stage 2's loop-closing seconds (the profile's
``loop_candidate_search_seconds`` + ``loop_icp_seconds``), mean per
sequence of the window."""


def read(ctx):
    vals = [p["loop_candidate_search_seconds"] + p["loop_icp_seconds"]
            for p in ctx["profiles"]]
    return sum(vals) / len(vals) if vals else None
