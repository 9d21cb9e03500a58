"""The port's viz slice and stage-2 renders against the JAX package on the CPU.

Both packages draw with the same matplotlib, so a figure drawn from the
same arrays must decode to the same pixels; maps, meshes and PLY files
must be the same bytes.  Tables go to the JAX package as DataFrames and to
the port as column dicts.
"""

import json
import os
import re
import shutil
import sys

import matplotlib.image as mpimg
import numpy as np
import pandas as pd
import pytest
import torch

from lidar_slam_arvc_tpu.viz import diagnostics as diag_ref
from lidar_slam_arvc_tpu.viz import mapping as mapping_ref
from lidar_slam_arvc_tpu.viz import plots as plots_ref
from lidar_slam_arvc_tpu.viz import viewer as viewer_ref
from lidar_slam_arvc_tpu.viz.converter import convert_dataset as convert_ref
from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.pipeline import cli
from lidar_slam_arvc_tpu_torch.utils import synthetic
from lidar_slam_arvc_tpu_torch.viz import mapping, plots

torch.set_num_threads(1)

WORLD = {"extent": 15.0, "n_ground": 2000, "n_pillars": 5, "pillar_pts": 100,
         "n_boxes": 2}


def same_pixels(a: str, b: str) -> None:
    pa, pb = mpimg.imread(a), mpimg.imread(b)
    assert pa.shape == pb.shape and np.array_equal(pa, pb), (a, b)


def _file(path):
    with open(path, "rb") as f:
        return f.read()


def _poses(rng, n):
    T = synthetic.make_trajectory(n, radius=6.0)
    T[:, :3, 3] += rng.normal(scale=0.05, size=(n, 3))
    return T


def _plot_cases(rng):
    """name -> call(plots module, output path), drawing the same figure from
    the same arrays with either package's module."""
    n = 25
    T = _poses(rng, n)
    ts = np.arange(n) * int(1e8) + int(1e18)
    A = rng.normal(size=(n, 6, 6))
    covs = 1e-3 * A @ A.transpose(0, 2, 1)
    gps = {"#timestamp [ns]": ts,
           "latitude": 40.0 + 1e-4 * np.arange(n),
           "longitude": -3.0 + 1e-4 * np.arange(n),
           "covariance_d1": np.full(n, 2.5),
           "x": T[:, 0, 3] + rng.normal(scale=0.3, size=n),
           "y": T[:, 1, 3] + rng.normal(scale=0.3, size=n),
           "z": np.zeros(n)}
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    quat = {"#timestamp [ns]": ts, "qw": q[:, 0], "qx": q[:, 1],
            "qy": q[:, 2], "qz": q[:, 3]}
    corr = [[i, i] for i in range(0, n, 3)]
    src, tgt = rng.normal(size=(300, 3)), rng.normal(size=(320, 3))
    df = pd.DataFrame
    return {
        "trajectory": lambda m, p: m.plot_trajectory(
            T, p, label="SLAM", extra={"odometry": T[::-1]}),
        "loop_closures": lambda m, p: m.plot_trajectory_with_loop_closures(
            T, [(0, 20), (3, 24)], p),
        "uncertainty": lambda m, p: m.plot_trajectory_with_uncertainty(
            T, covs, p, skip=2),
        "gps_comparison": lambda m, p: m.plot_gps_comparison(
            T, gps if m is plots else df(gps), corr, p),
        "gps_osm": lambda m, p: m.plot_gps_osm(gps if m is plots else df(gps), p),
        "gps_points": lambda m, p: m.plot_gps_points(
            gps if m is plots else df(gps), p, annotate_index=True,
            annotate_error=True, sample=4),
        "utm_points": lambda m, p: m.plot_utm_points(
            gps if m is plots else df(gps), p, annotate_index=True,
            annotate_error=True),
        "quaternion": lambda m, p: m.plot_quaternion_data(
            quat if m is plots else df(quat), p, annotate_time=True),
        "xyz": lambda m, p: m.plot_xyz_data(gps if m is plots else df(gps), p),
        "xyz_time": lambda m, p: m.plot_xyz_data(
            gps if m is plots else df(gps), p, annotate_time=True),
        "xy": lambda m, p: m.plot_xy_data(
            gps if m is plots else df(gps), p, sample=5, annotate_time=True,
            annotate_index=True),
        "registration": lambda m, p: m.plot_registration(src, tgt, T[3], p,
                                                         max_points=200),
    }


@pytest.mark.parametrize("name", sorted(_plot_cases(np.random.default_rng(0))))
def test_plot_pixels_match_reference(tmp_path, name):
    case = _plot_cases(np.random.default_rng(0))[name]
    a, b = str(tmp_path / "ref.png"), str(tmp_path / "port.png")
    assert case(plots_ref, a) == case(plots, b)
    same_pixels(a, b)


def test_compute_distance_matches_reference(rng):
    args = [rng.uniform(-80, 80, 20), rng.uniform(-180, 180, 20),
            rng.uniform(-80, 80, 20), rng.uniform(-180, 180, 20)]
    np.testing.assert_array_equal(plots.compute_distance(*args),
                                  plots_ref.compute_distance(*args))
    assert plots.compute_distance(40.0, 0.0, 40.0, 0.0) == 0.0


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """12 scans with a slam solution (the truth) and loop closures, and
    ``visualization_keyframe_sampling`` 3."""
    d = str(tmp_path_factory.mktemp("viz") / "ds")
    info = synthetic.make_dataset(
        d, n_scans=12, seed=2, scan_points=800, world_kwargs=WORLD,
        slam_params={"visualization_keyframe_sampling": 3})
    euroc = EurocDataset(d)
    euroc.save_transforms_as_csv(info["times"], info["T_gt"],
                                 "/robot0/SLAM/solution_graphslam.csv")
    euroc.save_transforms_as_csv(info["times"], info["T_gt"][::-1],
                                 "/robot0/scanmatcher/scanmatcher_global.csv")
    euroc.save_loop_closures_as_csv([[[0, 9], [2, 11]]],
                                    "/robot0/SLAM/loop_closures.csv")
    return d, info


def _copy(dataset, tmp_path, name):
    d = str(tmp_path / name)
    shutil.copytree(dataset[0], d)
    return d


@pytest.mark.parametrize("voxel", [0.2, None])
def test_build_map_matches_reference(dataset, voxel):
    d, info = dataset
    T = _poses(np.random.default_rng(1), len(info["times"]))
    kw = dict(keyframe_sampling=3, voxel_size=voxel, max_points_per_scan=500)
    got = mapping.build_map(d, T, info["times"], **kw)
    ref = mapping_ref.build_map(d, T, info["times"], **kw)
    assert got.dtype == np.float32 and got.tobytes() == ref.tobytes()


def test_voxel_key_exact_beyond_2000_voxels():
    """Keys (0, 0, 2000) and (0, 1, 0) collide in the reference's
    ``kx 4e6 + ky 2000 + kz`` and merge there; the port keeps both
    voxels.  Below 2000 voxels a side the two agree bit for bit."""
    v = 0.01
    pts = np.array([[0, 0, 0], [0, 0, 2000.5 * v], [0, 1.5 * v, 0.5 * v]],
                   np.float32)
    assert len(mapping_ref._voxel_downsample_np(pts, v)) == 2
    got = mapping._voxel_downsample_np(pts, v)
    assert len(got) == 3
    np.testing.assert_array_equal(np.sort(got, axis=0), np.sort(pts, axis=0))
    rng = np.random.default_rng(0)
    cloud = rng.uniform(-20, 20, size=(5000, 3)).astype(np.float32)
    for voxel in (0.05, 0.2, 1.0):
        assert (mapping._voxel_downsample_np(cloud, voxel).tobytes()
                == mapping_ref._voxel_downsample_np(cloud, voxel).tobytes())


@pytest.mark.parametrize("binary", [True, False])
def test_ply_bytes_and_round_trip(tmp_path, rng, binary):
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    faces = rng.integers(0, 200, size=(50, 3))
    for f in (None, faces):
        a, b = str(tmp_path / "ref.ply"), str(tmp_path / "port.ply")
        mapping_ref.write_ply(a, pts, binary=binary, faces=f)
        mapping.write_ply(b, pts, binary=binary, faces=f)
        assert _file(a) == _file(b)
        back = mapping.read_ply(b)
        np.testing.assert_array_equal(back, mapping_ref.read_ply(a))
        np.testing.assert_allclose(back, pts, atol=0 if binary else 1e-6)


@pytest.mark.parametrize("alpha", [1e-6, 0.3, 1e12])
def test_alpha_shape_matches_reference(rng, alpha):
    pts = rng.uniform(0.0, 1.0, size=(300, 3))
    verts, tris = mapping.alpha_shape_mesh(pts, alpha)
    v_ref, t_ref = mapping_ref.alpha_shape_mesh(pts, alpha)
    np.testing.assert_array_equal(verts, v_ref)
    np.testing.assert_array_equal(tris, t_ref)
    assert (len(tris) == 0) == (alpha == 1e-6)


@pytest.mark.parametrize("mesh", [False, True])
def test_convert_matches_reference(dataset, tmp_path, mesh):
    d, dr = _copy(dataset, tmp_path, "port"), _copy(dataset, tmp_path, "ref")
    argv = ["convert", "-i", d] + (["--mesh", "--alpha", "5.0"] if mesh else [])
    keep = [str(t) for t in dataset[1]["times"][:3]]
    for root in (d, dr):          # three scans are enough for the meshes
        for name in os.listdir(f"{root}/robot0/lidar/data"):
            if name[:-4] not in keep:
                os.remove(f"{root}/robot0/lidar/data/{name}")
        pd.DataFrame({"#timestamp [ns]": np.array(keep, np.int64)}).to_csv(
            f"{root}/robot0/lidar/data.csv", index=False)
    assert cli.main(argv) == 0
    assert convert_ref(dr, mesh=mesh, alpha=5.0) == 3
    out = sorted(os.listdir(f"{d}/robot0/lidar/dataply"))
    assert out == sorted(os.listdir(f"{dr}/robot0/lidar/dataply")) and len(out) == 3
    for name in out:
        got = _file(f"{d}/robot0/lidar/dataply/{name}")
        assert got == _file(f"{dr}/robot0/lidar/dataply/{name}")
        assert (b"element face" in got) == mesh


def test_view_reads_keyframe_sampling(dataset, tmp_path):
    """``cli view`` builds the map from every 3rd keyframe, as the slam
    parameters say; the reference's viewer, told the same, writes the same
    map and trajectory figures."""
    d, dr = _copy(dataset, tmp_path, "port"), _copy(dataset, tmp_path, "ref")
    assert cli.main(["view", "-i", d]) == 0
    out = viewer_ref.view_dataset(dr, keyframe_sampling=3)
    assert out["source"] == "SLAM"
    for name in ("map.ply", "map.pcd"):
        assert _file(f"{d}/robot0/viz/{name}") == _file(f"{dr}/robot0/viz/{name}")
    for name in ("trajectory.png", "trajectory_loop_closures.png"):
        same_pixels(f"{d}/robot0/viz/{name}", f"{dr}/robot0/viz/{name}")
    tenth = mapping.build_map(d, dataset[1]["T_gt"], dataset[1]["times"],
                              keyframe_sampling=10)
    assert len(mapping.read_ply(f"{d}/robot0/viz/map.ply")) > len(tenth)


def test_diag_report_matches_reference(dataset, tmp_path, capsys):
    """The ``diag`` report equals the JAX package's.  Its floats agree to
    1e-12 relative or 1e-8 m: the reference reads the CSVs with pandas'
    default float parser, which can be 1 ulp off the correctly rounded one
    (ROADMAP Queue 3, CSV parsing), and 1 ulp of a latitude in degrees is
    ~1e-9 m once converted to UTM."""
    d, dr = _copy(dataset, tmp_path, "port"), _copy(dataset, tmp_path, "ref")
    assert cli.main(["diag", "-i", d]) == 0
    got = json.loads(capsys.readouterr().out)
    ref = {"timestamps": diag_ref.check_timestamps(dr),
           "raw_data": diag_ref.view_raw_data(dr)}
    for csv, tag in (("/robot0/SLAM/solution_graphslam.csv", "slam"),
                     ("/robot0/scanmatcher/scanmatcher_global.csv", "scanmatcher")):
        ref[f"solution_{tag}"] = diag_ref.view_solutions(dr, csv)
        ref[f"delta_{tag}"] = diag_ref.compare_solutions(dr, csv)

    def check(a, b, where=""):
        assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, where
        if isinstance(b, dict):
            assert list(a) == list(b), where
            for k in b:
                check(a[k], b[k], f"{where}/{k}")
        elif isinstance(b, float):
            assert a == pytest.approx(b, rel=1e-12, abs=1e-8), where
        else:
            assert a == b, where
    check(got, json.loads(json.dumps(ref)))
    for name in ("timestamps.png", "raw_data.png", "solution_vs_gps.png"):
        same_pixels(f"{d}/robot0/viz/{name}", f"{dr}/robot0/viz/{name}")


def test_graph_renders_and_degrades_without_matplotlib(tmp_path, monkeypatch):
    """``cli graph --device cpu`` writes uncertainty.png and
    gps_comparison.png; with matplotlib made unimportable it writes the
    same CSVs, byte for byte, and records the ImportError."""
    d = str(tmp_path / "ds")
    synthetic.make_dataset(d, n_scans=10, seed=3, scan_points=800,
                           world_kwargs=WORLD)
    argv = ["--device", "cpu", "--capacity", "512", "-i", d]
    assert cli.main(["scanmatch", *argv]) == 0
    assert cli.main(["graph", *argv]) == 0
    slam = f"{d}/robot0/SLAM"
    for name in ("uncertainty.png", "gps_comparison.png"):
        assert os.path.getsize(f"{slam}/{name}") > 1000
        os.remove(f"{slam}/{name}")
    with open(f"{d}/robot0/viz/graphslam_profile.json") as f:
        assert json.load(f)["uncertainty_error"] is None
    csvs = {n: _file(f"{slam}/{n}") for n in ("solution_graphslam.csv",
                                               "loop_closures.csv")}
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert cli.main(["graph", *argv]) == 0
    for n, data in csvs.items():
        assert _file(f"{slam}/{n}") == data, n
    assert not os.path.exists(f"{slam}/uncertainty.png")
    with open(f"{d}/robot0/viz/graphslam_profile.json") as f:
        err = json.load(f)["uncertainty_error"]
    assert re.match(r"(ModuleNotFound|Import)Error: ", err), err
