"""Dataset layer: PCD files, EUROC CSV/YAML access, WGS84 -> UTM (numpy +
standard library)."""

from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.io.pcd import read_pcd, write_pcd
from lidar_slam_arvc_tpu_torch.io.sampling import sample_times
from lidar_slam_arvc_tpu_torch.io.utm import filter_gps, gps2utm, latlon_to_utm

__all__ = ["EurocDataset", "read_pcd", "write_pcd", "sample_times",
           "filter_gps", "gps2utm", "latlon_to_utm"]
