"""Pipeline drivers: stage 1 (scan matcher), stage 2 (graph SLAM),
preprocessing and the CLI (counterpart of ``lidar_slam_arvc_tpu.pipeline``).

``run_scanmatcher`` and ``run_graphslam`` load on first access: the
keyframe store imports ``pipeline.preprocess``, and stage 2 imports the
store, so importing the drivers here would be circular.
"""

import importlib

__all__ = ["run_scanmatcher", "run_graphslam"]

_DRIVERS = {"run_scanmatcher": "scanmatcher", "run_graphslam": "graphslam"}


def __getattr__(name):
    if name in _DRIVERS:
        module = importlib.import_module(f"{__name__}.{_DRIVERS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
