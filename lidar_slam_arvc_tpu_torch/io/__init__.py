"""Dataset layer: PCD files (and the native parser, ``io/native.py``), EUROC
CSV/YAML access, WGS84 -> UTM, ROS1 bags (``io/rosbag.py``); numpy and the
standard library."""

from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.io.pcd import read_pcd, write_pcd
from lidar_slam_arvc_tpu_torch.io.rosbag import ingest_bag, read_bag
from lidar_slam_arvc_tpu_torch.io.sampling import sample_odometry, sample_times
from lidar_slam_arvc_tpu_torch.io.utm import filter_gps, gps2utm, latlon_to_utm

__all__ = ["EurocDataset", "read_pcd", "write_pcd", "sample_times",
           "sample_odometry", "filter_gps", "gps2utm", "latlon_to_utm",
           "ingest_bag", "read_bag"]
