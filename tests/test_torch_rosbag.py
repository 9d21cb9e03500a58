"""ROS1 bag reading and EUROC ingest of the port against the JAX package
(oracle: tests/test_rosbag.py).  The bags come from the port's own writer;
the EUROC trees both packages ingest from one bag must hold the same CSV
and PCD bytes and YAML that parses to the same mapping."""

import os

import numpy as np
import pytest
import yaml

from lidar_slam_arvc_tpu.io import rosbag as rosbag_ref
from lidar_slam_arvc_tpu.io.pcd import read_pcd as read_pcd_ref
from lidar_slam_arvc_tpu_torch.io import rosbag
from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.pipeline import cli


def _make_bag(path, compression="none", n=5, extra_field=True, writer=rosbag):
    rng = np.random.default_rng(0)
    msgs, clouds = [], []
    for i in range(n):
        t = 1_000_000_000 * (i + 1) + 123
        msgs.append(("/odom", "nav_msgs/Odometry", t,
                     writer.serialize_odometry(t, (i * 0.5, 0.1 * i, 1e-17 * i),
                                               (0.0, 0.0, 0.1 * i, 1.0))))
        pts = rng.normal(size=(40 + i, 3)).astype(np.float32)
        pts[3] = np.nan                      # dropped: not finite
        clouds.append(pts[np.isfinite(pts).all(axis=1)])
        msgs.append(("/points", "sensor_msgs/PointCloud2", t,
                     writer.serialize_pointcloud2(t, pts, extra_field=extra_field)))
        msgs.append(("/fix", "sensor_msgs/NavSatFix", t,
                     writer.serialize_navsatfix(t, 38.0 + 1e-5 * i, -0.7, 50.0 + i / 3)))
    writer.write_bag(str(path), msgs, compression=compression)
    return msgs, clouds


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_roundtrip_and_same_bytes_as_reference_writer(tmp_path, compression):
    bag, bag_ref = tmp_path / "port.bag", tmp_path / "ref.bag"
    msgs, _ = _make_bag(bag, compression)
    _make_bag(bag_ref, compression, writer=rosbag_ref)
    assert bag.read_bytes() == bag_ref.read_bytes()
    got = list(rosbag.read_bag(str(bag)))
    assert got == msgs == list(rosbag_ref.read_bag(str(bag)))


def test_odometry_and_navsatfix_fields(tmp_path):
    bag = tmp_path / "t.bag"
    _make_bag(bag)
    for topic, ty, ts, raw in rosbag.read_bag(str(bag)):
        parse = {"nav_msgs/Odometry": "parse_odometry",
                 "sensor_msgs/NavSatFix": "parse_navsatfix"}.get(ty)
        if parse:
            got = getattr(rosbag, parse)(raw)
            assert got == getattr(rosbag_ref, parse)(raw) and got["stamp_ns"] == ts
    odo = [rosbag.parse_odometry(raw) for _, ty, _, raw in rosbag.read_bag(str(bag))
           if ty == "nav_msgs/Odometry"]
    assert odo[2]["x"] == pytest.approx(1.0) and odo[2]["qw"] == 1.0


@pytest.mark.parametrize("extra_field", [False, True])
def test_pointcloud_strided_fields(tmp_path, extra_field):
    bag = tmp_path / "t.bag"
    _, clouds = _make_bag(bag, extra_field=extra_field)
    got = [rosbag.parse_pointcloud2(raw) for _, ty, _, raw
           in rosbag.read_bag(str(bag)) if ty == "sensor_msgs/PointCloud2"]
    for (stamp, pts), ref in zip(got, clouds):
        np.testing.assert_array_equal(pts, ref)


def test_rejects_non_bag(tmp_path):
    p = tmp_path / "not.bag"
    p.write_bytes(b"hello world")
    with pytest.raises(ValueError, match="not a ROS bag"):
        list(rosbag.read_bag(str(p)))


def _tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_ingest_tree_matches_reference(tmp_path, compression):
    bag = tmp_path / "t.bag"
    _, clouds = _make_bag(bag, compression)
    counts = rosbag.ingest_bag(str(bag), str(tmp_path / "port"), progress=False)
    assert counts == rosbag_ref.ingest_bag(str(bag), str(tmp_path / "ref"),
                                           progress=False)
    assert counts["lidar_scans"] == 5 and counts["messages_read"] == 15
    a, b = _tree(tmp_path / "port"), _tree(tmp_path / "ref")
    assert sorted(a) == sorted(b) and len(a) == 9
    for k in a:
        if k.endswith(".yaml"):
            assert yaml.safe_load(a[k]) == yaml.safe_load(b[k]), k
        else:
            assert a[k] == b[k], k
    euroc = EurocDataset(str(tmp_path / "port"))
    times = euroc.read_csv("/robot0/lidar/data.csv")["#timestamp [ns]"]
    np.testing.assert_array_equal(read_pcd_ref(euroc.scan_pcd_path(times[0])),
                                  clouds[0])
    assert euroc.read_utm_ref("gps0")["latitude"] == 38.0


def test_cli_ingest_topic_choice(tmp_path):
    """``cli ingest`` with an explicit lidar topic; a second lidar topic in
    the bag is skipped."""
    bag = tmp_path / "t.bag"
    msgs, _ = _make_bag(bag)
    extra = [("/other", ty, t, raw) for topic, ty, t, raw in msgs
             if topic == "/points"]
    rosbag.write_bag(str(bag), extra + msgs)
    out = str(tmp_path / "ds")
    assert cli.main(["ingest", "-i", out, "--bag", str(bag),
                     "--lidar-topic", "/points"]) == 0
    assert len(os.listdir(f"{out}/robot0/lidar/data")) == 5
    assert os.path.exists(f"{out}/robot0/odom/data.csv")
    assert os.path.exists(f"{out}/robot0/gps0/reference.yaml")
