"""The port's profiling utilities: StageTimer against the JAX package's
(oracles tests/test_utils.py, tests/test_viz.py::TestProfiling), the build
counter that stands in for CompileCounter, and torch.profiler traces."""

import glob
import json
import os

import pytest
import torch

from lidar_slam_arvc_tpu.utils.profiling import StageTimer as StageTimerRef
from lidar_slam_arvc_tpu_torch.io import native
from lidar_slam_arvc_tpu_torch.utils import profiling
from lidar_slam_arvc_tpu_torch.utils.profiling import BuildCounter, StageTimer


def test_stage_timer_accumulates():
    t = StageTimer()
    with t.stage("icp", items=8):
        pass
    with t.stage("icp", items=8):
        pass
    with t.stage("load"):
        pass
    rep = t.report()
    assert rep["icp"]["items"] == 16 and rep["icp"]["seconds"] >= 0
    assert "items_per_second" not in rep["load"]
    assert "icp" in str(t) and t.rate("load") is None


def test_stage_timer_report_and_dump_match_reference(tmp_path):
    """The same counts give the same report, string and JSON bytes."""
    timers = StageTimer(), StageTimerRef()
    for t in timers:
        t.seconds.update({"load": 0.123456789, "icp": 2.5, "idle": 0.0})
        t.items.update({"load": 257, "icp": 256, "idle": 3})
    assert timers[0].report() == timers[1].report()
    assert str(timers[0]) == str(timers[1])
    timers[0].dump(str(tmp_path / "port.json"))
    timers[1].dump(str(tmp_path / "ref.json"))
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "ref.json").read_bytes())
    with pytest.raises(ZeroDivisionError):
        with timers[0].stage("failing", items=1):
            1 / 0
    assert timers[0].items["failing"] == 1     # counted even when it raises


def test_build_counter(tmp_path):
    """A build, then a cache load, of the parser into a fresh directory;
    events outside the scope are not counted."""
    c = BuildCounter()
    assert c.report() == {"libraries_built": [], "build_seconds": 0,
                          "libraries_loaded_from_cache": []}
    with c.scope():
        native._build(str(tmp_path))
        native._build(str(tmp_path))
    native._build(str(tmp_path))
    rep = c.report()
    assert rep["libraries_built"] == ["pcd_native"] and rep["build_seconds"] > 0
    assert rep["libraries_loaded_from_cache"] == ["pcd_native"]
    assert not profiling._active


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
