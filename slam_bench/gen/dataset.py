"""One configuration's dataset from a seed, in the layout the program reads.

``generate(cfg, seed, directory, device)`` builds the world that
``cfg["world"]["kind"]`` names (``gen/worlds/<kind>.py``), walks its route,
ray-casts every keyframe's scan on ``device`` (range noise and lost
returns from two ``torch.Generator`` calls for the whole sequence) and
writes:

- ``robot0/lidar/data.csv`` and ``robot0/lidar/data/<t>.pcd``;
- ``robot0/odom/data.csv``: the truth with the odometry drift model;
- ``robot0/gt/data.csv``: the truth;
- ``robot0/gps0/*`` when ``cfg["gps"]`` is set;
- ``robot0/scanmatcher/{lidar_times,scanmatcher_global}.csv``: a stage-1
  trajectory from the truth with the scan-matching drift model, the input
  of a stage-2 run that does not depend on the program's stage 1;
- ``robot0/scanmatcher_parameters.yaml`` and ``slam_parameters.yaml``.

The same seed gives the same files.  The seed draws what differs between
two recordings of one route: the range noise and the lost returns of
every scan (``torch.Generator(device).manual_seed(seed)``) and the GPS
noise (``np.random.default_rng([seed, 1])``).  The world and the drift
are the configuration's (``world_seed``, ``drift_seed``), the same for
every seed, so that the work of a sequence does not swing with the seed.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import torch

from slam_bench.gen import files, raycast, route


def world(cfg: dict) -> dict:
    """The configuration's world, drawn from its ``world_seed``."""
    kind = importlib.import_module(f"slam_bench.gen.worlds.{cfg['world']['kind']}")
    return kind.build(np.random.default_rng(cfg["world_seed"]), cfg["world"])


def keyframe_times(n: int, delta_time: float) -> np.ndarray:
    return 1_000_000_000 + np.arange(n, dtype=np.int64) * int(round(delta_time * 1e9))


def scans(cfg: dict, seed: int, T_gt: np.ndarray, w: dict, device):
    """Yield the (N_k, 3) float32 sensor-frame points of each keyframe."""
    s = cfg["sensor"]
    local = raycast.beam_directions(s["beams_deg"], s["azimuth_steps"], device).float()
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn((len(T_gt), local.shape[0]), generator=gen,
                        device=device, dtype=torch.float32) * s["range_noise_m"]
    # returns lost to dark, specular or glass surfaces
    lost = torch.rand((len(T_gt), local.shape[0]), generator=gen,
                      device=device) < s["dropout"]
    boxes = torch.as_tensor(w["boxes"], dtype=torch.float32, device=device)
    cyl = torch.as_tensor(w["cylinders"], dtype=torch.float32, device=device)
    for k, T in enumerate(T_gt):
        Tt = torch.as_tensor(T, dtype=torch.float32, device=device)
        origin = Tt[:3, 3] + torch.tensor([0.0, 0.0, s["mount_height_m"]],
                                          dtype=torch.float32, device=device)
        t = raycast.cast(origin, local @ Tt[:3, :3].T, boxes, cyl, s["max_range_m"])
        r = t + noise[k]
        keep = torch.isfinite(t) & (r > s["min_range_m"]) & ~lost[k]
        yield (local[keep] * r[keep, None]).cpu().numpy()


def generate(cfg: dict, seed: int, directory: str, device,
             n_keyframes: int | None = None) -> dict:
    m = cfg["motion"]
    n = n_keyframes or m["keyframes"]
    w = world(cfg)
    T_gt = route.keyframe_poses(w["waypoints"], n, m["speed_mps"] * m["delta_time_s"])
    times = keyframe_times(n, m["delta_time_s"])
    r0 = f"{directory}/robot0"
    os.makedirs(f"{r0}/lidar/data", exist_ok=True)
    counts = []
    for t, pts in zip(times, scans(cfg, seed, T_gt, w, device)):
        files.write_pcd(f"{r0}/lidar/data/{t}.pcd", pts)
        counts.append(len(pts))
    files.write_csv(f"{r0}/lidar/data.csv", {files.TIME: times}, index=False)
    files.write_csv(f"{r0}/gt/data.csv", files.trajectory(times, T_gt), index=False)

    drift = np.random.default_rng(cfg["drift_seed"])
    T_odo = route.drifted(T_gt, drift, cfg["odometry_drift"])
    files.write_csv(f"{r0}/odom/data.csv", files.trajectory(times, T_odo), index=False)
    T_sm = route.drifted(T_gt, drift, cfg["scanmatch_drift"])
    files.write_csv(f"{r0}/scanmatcher/lidar_times.csv", {files.TIME: times}, index=True)
    files.write_csv(f"{r0}/scanmatcher/scanmatcher_global.csv",
                    files.trajectory(times, T_sm), index=True)
    if cfg.get("gps"):
        rng = np.random.default_rng([seed, 1])
        g = cfg["gps"]
        lat_per_m = 1.0 / 111_132.0
        lon_per_m = 1.0 / (111_320.0 * np.cos(np.deg2rad(g["latitude"])))
        xy = T_gt[:, :2, 3] + rng.normal(scale=g["sigma_m"], size=(n, 2))
        files.write_csv(f"{r0}/gps0/data.csv", {
            files.TIME: times, "latitude": g["latitude"] + xy[:, 1] * lat_per_m,
            "longitude": g["longitude"] + xy[:, 0] * lon_per_m,
            "altitude": g["altitude"] + T_gt[:, 2, 3]}, index=False)
        files.write_yaml(f"{r0}/gps0/reference.yaml", {
            "latitude": g["latitude"], "longitude": g["longitude"],
            "altitude": g["altitude"]})
        files.write_yaml(f"{r0}/gps0/transform.yaml",
                         {"transform": np.eye(4).reshape(-1).tolist()})
    files.write_yaml(f"{r0}/scanmatcher_parameters.yaml", cfg["scanmatcher"])
    files.write_yaml(f"{r0}/slam_parameters.yaml", cfg["slam"])
    return {"T_gt": T_gt, "T_odo": T_odo, "T_sm": T_sm, "times": times,
            "raw_returns": np.asarray(counts)}


def subset(directory: str, target: str, n: int) -> None:
    """A dataset of the first ``n`` keyframes of ``directory`` (scans linked,
    tables cut), for a warm-up at the same shapes."""
    r0, t0 = f"{directory}/robot0", f"{target}/robot0"
    os.makedirs(f"{t0}/lidar/data", exist_ok=True)
    times = files.read_csv(f"{r0}/lidar/data.csv")[files.TIME][:n]
    for t in times:
        os.symlink(f"{r0}/lidar/data/{t}.pcd", f"{t0}/lidar/data/{t}.pcd")
    for rel, index in (("lidar/data.csv", False), ("odom/data.csv", False),
                       ("gt/data.csv", False), ("gps0/data.csv", False),
                       ("scanmatcher/lidar_times.csv", True),
                       ("scanmatcher/scanmatcher_global.csv", True)):
        if os.path.exists(f"{r0}/{rel}"):
            tab = files.read_csv(f"{r0}/{rel}")
            tab.pop("", None)
            files.write_csv(f"{t0}/{rel}", {k: v[:n] for k, v in tab.items()}, index)
    for rel in ("gps0/reference.yaml", "gps0/transform.yaml",
                "scanmatcher_parameters.yaml", "slam_parameters.yaml"):
        if os.path.exists(f"{r0}/{rel}"):
            os.makedirs(os.path.dirname(f"{t0}/{rel}"), exist_ok=True)
            with open(f"{r0}/{rel}") as f, open(f"{t0}/{rel}", "w") as g:
                g.write(f.read())
