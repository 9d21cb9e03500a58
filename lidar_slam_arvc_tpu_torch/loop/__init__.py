"""Loop closing with triangle consistency filtering."""

from lidar_slam_arvc_tpu_torch.loop.loopclosing import LoopCloser

__all__ = ["LoopCloser"]
