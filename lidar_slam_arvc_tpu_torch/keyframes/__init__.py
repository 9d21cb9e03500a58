"""Keyframe store: preprocessed scans on the device, batched registration."""

from lidar_slam_arvc_tpu_torch.keyframes.store import KeyframeStore

__all__ = ["KeyframeStore"]
