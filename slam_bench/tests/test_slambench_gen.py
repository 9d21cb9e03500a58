"""The generator: one seed gives the same files; scans at the
configurations' full sensor widths fall in the ranges their files state."""

import filecmp
import json
import os

import pytest
import torch

from slam_bench import run
from slam_bench.gen import dataset, files, route
from slam_bench.reference import cloud
from slam_bench.tests import tiny

CONFIGS = ("kitti00-hdl64", "nclt-hdl32")


def _tree(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("workload", ["kitti00.stage1", "nclt.stage2"])
def test_same_seed_same_files(tmp_path, workload):
    torch.set_num_threads(2)
    cfg = run.merge(run.cell(workload, tiny.MANIFEST)["config"],
                    tiny.overrides(workload, keyframes=3)["config"])
    a, b = tmp_path / "a", tmp_path / "b"
    dataset.generate(cfg, 2 ** 31 + 12345, str(a), "cpu")
    dataset.generate(cfg, 2 ** 31 + 12345, str(b), "cpu")
    names = _tree(a)
    assert names == _tree(b) and len(names) >= 8
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors
    c = tmp_path / "c"
    dataset.generate(cfg, 7, str(c), "cpu")
    assert any(not filecmp.cmp(a / n, c / n, shallow=False) for n in names)


@pytest.mark.parametrize("name", CONFIGS)
def test_scans_in_the_stated_ranges(name):
    """Three keyframes of seed 3 at full width: raw returns, and the
    cropped scan's 0.2 m voxels (stage 1) or points (the stage-2 store),
    within the ranges the file records, and under its capacities."""
    torch.set_num_threads(4)
    with open(os.path.join(run.BENCH, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    m = cfg["measured"]
    w = dataset.world(cfg)
    n = cfg["motion"]["keyframes"]
    T = route.keyframe_poses(w["waypoints"], n,
                             cfg["motion"]["speed_mps"] * cfg["motion"]["delta_time_s"])
    pick = [0, n // 2, n - 1]
    for pts in dataset.scans(cfg, 3, T[pick], w, "cpu"):
        lo, hi = m["raw_returns"]
        assert lo <= len(pts) <= hi
        c = cloud.crop(torch.from_numpy(pts[:cfg["icp"]["raw_capacity"]]), cfg["icp"])
        _, nv = cloud.voxel_centroids(c, 0.2, 10 ** 7)
        lo, hi = m["voxels_0.2m"]
        assert lo <= nv <= hi
        lo, hi = m["cropped_points"]
        assert lo <= len(c) <= hi
    # a whole scan loads, and what the file says the capacity holds fits
    assert m["raw_returns"][1] <= cfg["icp"]["raw_capacity"]
    if m.get("capacity_holds"):
        assert m[m["capacity_holds"]][1] < cfg["icp"]["capacity"]


def test_pcd_and_csv_round_trip(tmp_path):
    import numpy as np
    pts = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    files.write_pcd(str(tmp_path / "a.pcd"), pts)
    assert np.array_equal(files.read_pcd(str(tmp_path / "a.pcd")), pts)
    T = np.stack([route.yaw_transform(1.0, 2.0, y) for y in (0.1, -2.0, 3.1)])
    files.write_csv(str(tmp_path / "t.csv"), files.trajectory([1, 2, 3], T), index=True)
    assert np.allclose(files.transforms(files.read_csv(str(tmp_path / "t.csv"))), T,
                       atol=1e-12)
