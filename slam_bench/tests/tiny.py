"""Small versions of the cells for CPU runs of the harness: the sensor
thinned (stage 1: half the beams; stage 2: every beam; about half the
azimuth steps), a short route, capacity 16384 (stage 2's own: its store
keeps a uniform stride of each scan, as the cell's does)."""

import os

from slam_bench import run

# the manifest with the stage-2 cell too (measured, and left out of
# BENCHMARK.json: PERF.md section 2), so that the tests drive both stages
MANIFEST = os.path.join(os.path.dirname(__file__), "fixtures", "two_cells.json")


def overrides(workload: str, keyframes: int | None = None) -> dict:
    c = run.cell(workload, MANIFEST)
    if c["traffic"]["stage"] == 1:
        return {"config": {"sensor": {"beams_deg": c["config"]["sensor"]["beams_deg"][::2],
                                      "azimuth_steps": 1024},
                           "motion": {"keyframes": keyframes or 9},
                           "icp": {"capacity": 16384, "raw_capacity": 32768}},
                "traffic": {"warmup_keyframes": 5, "check_pairs": 3}}
    return {"config": {"sensor": {"beams_deg": c["config"]["sensor"]["beams_deg"],
                                  "azimuth_steps": 1024},
                       "world": {"loop_length_m": 32.0, "inner_buildings": 0},
                       "motion": {"keyframes": keyframes or 70},
                       "slam": {"number_of_triplets_loop_closing": 2},
                       # ten times the cell's heading drift: on a 42 m route the
                       # cell's own leaves a frozen solve or a gate rejecting
                       # every triplet 4-7 cm from the optimum, under the limit
                       "scanmatch_drift": {"scale_bias": 0.002, "xy_sigma_m": 0.005,
                                           "yaw_bias_rad": 0.0005, "yaw_sigma_rad": 0.0005},
                       "icp": {"capacity": 16384, "raw_capacity": 32768}},
            "traffic": {"warmup_keyframes": 20}}
