"""Scan sizes a configuration's generator gives, over seeds, on the card:

    python3 slam_bench/survey.py <config> <seed> [<seed> ...]

prints one JSON line per seed with the min and max over every keyframe of
the raw returns, the cropped points and the occupied 0.2 m voxels of the
cropped scan (the numbers behind a configuration's ``capacity`` and its
``measured`` ranges), and a last line over all seeds."""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slam_bench.gen import dataset, route  # noqa: E402
from slam_bench.reference import cloud  # noqa: E402


def survey(cfg: dict, seed: int, device) -> dict:
    w = dataset.world(cfg)
    m = cfg["motion"]
    T = route.keyframe_poses(w["waypoints"], m["keyframes"], m["speed_mps"] * m["delta_time_s"])
    raw, cropped, vox = [], [], []
    for pts in dataset.scans(cfg, seed, T, w, device):
        c = cloud.crop(torch.from_numpy(pts[:cfg["icp"]["raw_capacity"]]).to(device), cfg["icp"])
        raw.append(len(pts))
        cropped.append(len(c))
        vox.append(cloud.voxel_centroids(c, 0.2, 1 << 30)[1])
    span = lambda v: [min(v), max(v)]
    return {"seed": seed, "raw_returns": span(raw), "cropped_points": span(cropped),
            "voxels_0.2m": span(vox)}


def main(argv):
    with open(os.path.join(os.path.dirname(__file__), "configs", f"{argv[0]}.json")) as f:
        cfg = json.load(f)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    rows = []
    for seed in map(int, argv[1:]):
        rows.append(survey(cfg, seed, device))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({k: [min(r[k][0] for r in rows), max(r[k][1] for r in rows)]
                      for k in ("raw_returns", "cropped_points", "voxels_0.2m")}))


if __name__ == "__main__":
    main(sys.argv[1:])
