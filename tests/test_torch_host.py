"""Host layer of the PyTorch port vs the JAX package: imports, files, CSVs.

The port's own CSV/YAML code (no pandas, no PyYAML) must write the same
bytes as the JAX package's pandas/PyYAML code and read the same values.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from lidar_slam_arvc_tpu.geom import hostmath as hm_ref
from lidar_slam_arvc_tpu.io import euroc as euroc_ref
from lidar_slam_arvc_tpu.io import sampling as sampling_ref
from lidar_slam_arvc_tpu.io import utm as utm_ref
from lidar_slam_arvc_tpu.utils import metrics as metrics_ref
from lidar_slam_arvc_tpu.utils import synthetic as synthetic_ref
from lidar_slam_arvc_tpu_torch.geom import hostmath as hm
from lidar_slam_arvc_tpu_torch.io import euroc, formats, pcd, sampling, utm
from lidar_slam_arvc_tpu_torch.utils import metrics, synthetic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_transforms(rng, n):
    q = rng.normal(size=(n, 4))
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = hm_ref.quat_to_rot_np(q)
    T[:, :3, 3] = rng.normal(scale=20.0, size=(n, 3))
    return T


HOST_MODULES = ["lidar_slam_arvc_tpu_torch.viz", "lidar_slam_arvc_tpu_torch.io.rosbag",
                "lidar_slam_arvc_tpu_torch.pipeline.cli"]


@pytest.fixture(scope="module")
def fresh_imports():
    """One fresh interpreter: the host modules imported one after another,
    with the modules of matplotlib, scipy, jax, pandas and yaml loaded after
    each, then every module of the port and ``chip_smoke``.  A module loads
    the same modules whatever was imported before it, so what is loaded
    after the k-th host module contains what that module loads alone."""
    code = (
        "import importlib, json, multiprocessing, pkgutil, sys\n"
        "banned = lambda roots: sorted(m for m in sys.modules if m.split('.')[0] in roots)\n"
        "host = {}\n"
        f"for name in {HOST_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "    host[name] = banned(('matplotlib', 'scipy', 'jax', 'pandas', 'yaml'))\n"
        "import torch\n"
        "import lidar_slam_arvc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert 'lidar_slam_arvc_tpu_torch.parallel.mesh' in sys.modules\n"
        "assert 'lidar_slam_arvc_tpu_torch.compat' in sys.modules\n"
        "assert not torch.distributed.is_initialized()\n"
        "assert not multiprocessing.active_children()\n"
        "print(json.dumps({'host': host, 'all': banned(\n"
        "    ('jax', 'jaxlib', 'pandas', 'yaml', 'lidar_slam_arvc_tpu', 'matplotlib',\n"
        "     'scipy'))}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_pandas_yaml(fresh_imports):
    """Importing every module of the port (``compat`` among them) loads
    none of jax, pandas, yaml or the JAX package, nor matplotlib or scipy,
    which the port imports only when it draws a figure or makes a mesh,
    and initialises no process group and starts no process (the
    parallel/ modules; checked in a fresh interpreter)."""
    assert fresh_imports["all"] == []


@pytest.mark.parametrize("module", HOST_MODULES)
def test_host_modules_import_no_plotting_or_scipy(fresh_imports, module):
    """The viz package, the bag reader and the CLI, in a fresh
    interpreter: no matplotlib, scipy, jax, pandas or yaml at import."""
    assert fresh_imports["host"][module] == []


def test_chip_smoke_refuses_without_gpu():
    """chip_smoke.py exits non-zero and prints no result without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU refusal")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _tree_bytes(root):
    files = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                files[os.path.relpath(p, root)] = f.read()
    return files


def test_synthetic_dataset_byte_identical(tmp_path):
    """Same seed -> same PCDs, CSVs and YAMLs, byte for byte."""
    kw = dict(n_scans=5, seed=3, radius=6.0, scan_points=800,
              world_kwargs={"extent": 15.0, "n_ground": 2000,
                            "n_pillars": 5, "pillar_pts": 100, "n_boxes": 2})
    ref = synthetic_ref.make_dataset(str(tmp_path / "ref"), **kw)
    got = synthetic.make_dataset(str(tmp_path / "port"), **kw)
    a = _tree_bytes(tmp_path / "ref")
    b = _tree_bytes(tmp_path / "port")
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k] == b[k], k
    np.testing.assert_array_equal(ref["T_gt"], got["T_gt"])
    np.testing.assert_array_equal(ref["world"], got["world"])


def test_scanmatcher_csvs_byte_identical(tmp_path, rng):
    """The three scanmatcher CSVs written from the same arrays."""
    n = 40
    times = (1e9 * (1.0 + np.arange(n))).astype(np.int64)
    T = _random_transforms(rng, n)
    T[3] = np.eye(4)                       # identity row
    T[5, :3, 3] = [1e-17, -0.0, 3e16]       # exponent formatting
    ref = euroc_ref.EurocDataset(str(tmp_path / "ref"))
    got = euroc.EurocDataset(str(tmp_path / "port"))
    for ds in (ref, got):
        ds.save_sensor_times_as_csv(times, "/robot0/scanmatcher/lidar_times.csv")
        ds.save_transforms_as_csv(times, T[1:],
                                  "/robot0/scanmatcher/scanmatcher_relative.csv")
        ds.save_transforms_as_csv(times, T,
                                  "/robot0/scanmatcher/scanmatcher_global.csv")
    a = _tree_bytes(tmp_path / "ref")
    b = _tree_bytes(tmp_path / "port")
    assert sorted(a) == sorted(b) and len(a) == 3
    for k in a:
        assert a[k] == b[k], k


def test_read_csv_matches_pandas(tmp_path, rng):
    """Trajectory round trip.  The port parses floats with Python's
    correctly rounded ``float``, which equals pandas' ``round_trip``
    parser exactly; pandas' default parser may be 1 ulp off, so the
    trajectories read by the two packages agree to rtol 1e-15."""
    d = str(tmp_path)
    times = (1e9 * (1.0 + np.arange(12))).astype(np.int64)
    T = _random_transforms(rng, 12)
    written = euroc.EurocDataset(d).save_transforms_as_csv(times, T, "/t.csv")
    df = pd.read_csv(d + "/t.csv", float_precision="round_trip")
    cols = euroc.EurocDataset(d).read_csv("/t.csv")
    assert list(cols) == list(df.columns)
    for k in df.columns:
        assert cols[k].dtype == df[k].to_numpy().dtype, k
        np.testing.assert_array_equal(cols[k], df[k].to_numpy())
    for k, v in written.items():
        np.testing.assert_array_equal(cols[k], v)
    t_ref, T_ref = euroc_ref.EurocDataset(d).read_trajectory("/t.csv")
    t_got, T_got = euroc.EurocDataset(d).read_trajectory("/t.csv")
    np.testing.assert_array_equal(t_got, t_ref)
    np.testing.assert_allclose(T_got, T_ref, rtol=1e-15, atol=1e-15)


def test_yaml_subset_matches_safe_load(tmp_path):
    """The YAML-subset reader agrees with yaml.safe_load on the generated
    parameter files and on the scalar forms the subset resolves; the
    writer reproduces yaml.safe_dump."""
    d = str(tmp_path)
    synthetic.make_dataset(d, n_scans=2, scan_points=100,
                           world_kwargs={"n_ground": 200, "n_pillars": 1,
                                         "pillar_pts": 10})
    n = 0
    for root, _, names in os.walk(d):
        for name in names:
            if name.endswith(".yaml"):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                assert formats.load_yaml(text) == yaml.safe_load(text), name
                n += 1
    assert n == 4
    text = ("# comment\na: 1\nb: -2.5\nc: 1.0e-05\nd: 1e-05\ne: null\nf: ~\n"
            "g: true\nh: no\ni: 'quoted # not a comment'\nj: plain text\n"
            "k: .inf\nl: 0.5 # trailing comment\nm:\n- 1\n- two\n- 3.0\n")
    assert formats.load_yaml(text) == yaml.safe_load(text)
    mapping = {"voxel_size": 0.2, "method": "icppointplane", "start_index": 0,
               "flag": False, "none": None, "tiny": 1e-17, "big": 1e17,
               "transform": [1.0, 0.0, -0.5]}
    assert formats.dump_yaml(mapping) == yaml.safe_dump(mapping)


def test_time_association_matches_reference(rng):
    master = np.sort(rng.integers(0, 10 ** 10, 50))
    sensor = np.sort(rng.integers(0, 10 ** 10, 200))
    got = euroc.EurocDataset.get_closest_times(master, sensor)
    ref = euroc_ref.EurocDataset.get_closest_times(master, sensor)
    np.testing.assert_array_equal(got, ref)
    table = {"#timestamp [ns]": sensor, "x": rng.normal(size=200)}
    rows = euroc.EurocDataset.get_rows_at_times(table, got)
    df = euroc_ref.EurocDataset.get_df_at_times(pd.DataFrame(table), ref)
    np.testing.assert_array_equal(rows["x"], df["x"].to_numpy())
    with pytest.raises(KeyError):
        euroc.EurocDataset.get_rows_at_times(table, np.array([-1]))


def test_sample_times_matches_reference(rng):
    t = np.cumsum(rng.integers(10 ** 8, 6 * 10 ** 8, 100))
    for start, delta in ((0, 1e9), (5, 0.5e9)):
        np.testing.assert_array_equal(sampling.sample_times(t, start, delta),
                                      sampling_ref.sample_times(t, start, delta))


def test_hostmath_bitwise(rng):
    """Quaternion extraction is bit-identical (the CSV bytes depend on it)."""
    T = _random_transforms(rng, 500)
    for a, b in zip(hm.pose_columns_from_transforms_np(T),
                    hm_ref.pose_columns_from_transforms_np(T)):
        np.testing.assert_array_equal(a, b)
    q = rng.normal(size=(100, 4))
    np.testing.assert_array_equal(hm.quat_to_rot_np(q), hm_ref.quat_to_rot_np(q))


def test_metrics_match_reference(rng):
    T_gt = _random_transforms(rng, 30)
    T_est = T_gt.copy()
    T_est[:, :3, 3] += rng.normal(scale=0.05, size=(30, 3))
    assert metrics.ate(T_est, T_gt) == metrics_ref.ate(T_est, T_gt)
    assert metrics.rpe(T_est, T_gt) == metrics_ref.rpe(T_est, T_gt)


@pytest.mark.parametrize("kind", ["ascii", "binary"])
def test_pcd_round_trip(tmp_path, rng, kind):
    from lidar_slam_arvc_tpu.io.pcd import read_pcd as read_ref
    pts = rng.normal(size=(257, 3)).astype(np.float32)
    path = str(tmp_path / f"s.{kind}.pcd")
    pcd.write_pcd(path, pts, data_kind=kind)
    np.testing.assert_array_equal(pcd.read_pcd(path), read_ref(path))


def test_gps_conversion_matches_reference(tmp_path, rng):
    """filter_gps + gps2utm on the dataset's GPS table: the same rows,
    columns (in order) and values as the reference's pandas frames."""
    d = str(tmp_path)
    synthetic.make_dataset(d, n_scans=12, scan_points=100,
                           world_kwargs={"n_ground": 200, "n_pillars": 1,
                                         "pillar_pts": 10})
    ds, ds_ref = euroc.EurocDataset(d), euroc_ref.EurocDataset(d)
    table = ds.read_csv("/robot0/gps0/data.csv")
    table["latitude"][[2, 7]] = 0.0            # rows without a fix
    df = pd.DataFrame(table)
    ref_cfg = ds_ref.read_utm_ref("gps0")
    assert ds.read_utm_ref("gps0") == ref_cfg
    for zone in (None, 30):
        got = utm.gps2utm(utm.filter_gps(table), ds.read_utm_ref("gps0"), zone)
        ref = utm_ref.gps2utm(utm_ref.filter_gps(df), ref_cfg, zone)
        assert list(got) == list(ref.columns) and len(got["x"]) == 10
        for k in ref.columns:
            np.testing.assert_array_equal(got[k], ref[k].to_numpy(), k)
    lat = rng.uniform(-60, 70, 50)
    lon = rng.uniform(-180, 180, 50)
    np.testing.assert_array_equal(np.stack(utm.latlon_to_utm(lat, lon, zone=31)),
                                  np.stack(utm_ref.latlon_to_utm(lat, lon, zone=31)))
    assert utm.latlon_to_utm(38.3, -0.7) == utm_ref.latlon_to_utm(38.3, -0.7)
    np.testing.assert_array_equal(ds.read_transform("gps0"),
                                  ds_ref.read_transform("gps0"))
    assert ds.read_slam_parameters() == ds_ref.read_slam_parameters()


@pytest.mark.parametrize("groups", [
    [], [None, []], [[[38, 0], [38, 2]], None, [], [[77, 12]]],
    [[[np.int64(5), np.int64(1)]]]], ids=["empty", "no_pairs", "groups", "numpy_ints"])
def test_loop_closures_csv_byte_identical(tmp_path, groups):
    ref = euroc_ref.EurocDataset(str(tmp_path / "ref"))
    got = euroc.EurocDataset(str(tmp_path / "port"))
    for ds in (ref, got):
        ds.save_loop_closures_as_csv(groups, "/robot0/SLAM/loop_closures.csv")
    a = _tree_bytes(tmp_path / "ref")
    b = _tree_bytes(tmp_path / "port")
    assert list(a) == list(b) == [os.path.join("robot0", "SLAM", "loop_closures.csv")]
    for k in a:
        assert a[k] == b[k], (a[k], b[k])
