"""The readers of the program's own spans and counters on a recorded trace
with program spans (``fixtures/trace_program_spans.json``) and profiles
with the stage-1 counters; on the older trace and profiles, which have
neither, each reads no value and raises nothing."""

import json
import os

import pytest

from slam_bench import run, trace

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
READERS = ("icp_step_ms.stage1", "syncs_per_icp_step.stage1", "icp_step_idle.stage1",
           "load_wait_s.stage1", "k1_padding_share.stage1")


def _ctx(trace_file, profiles):
    events = trace.load(os.path.join(FIX, trace_file))
    with open(os.path.join(FIX, profiles)) as f:
        profs = json.load(f)
    return {"profiles": profs, "events": events,
            "spans": {"sequence": trace.span(events, "slam_bench.sequence"),
                      "icp": trace.span(events, "slam_bench.icp")},
            "work": {}, "k1_launches": 0}


@pytest.fixture
def ctx():
    return _ctx("trace_program_spans.json", "scanmatcher_profiles_counters.json")


def test_icp_step_ms(ctx):
    # (1.0 + 2.0) s over 400 + 600 steps
    assert run.reader("icp_step_ms.stage1")(ctx) == pytest.approx(3.0)


def test_syncs_per_icp_step(ctx):
    # syncs at 200 (first step), 500 and 550 (second); 800 is outside both,
    # and the device-side copy of a span is not a step
    assert run.reader("syncs_per_icp_step.stage1")(ctx) == pytest.approx(1.5)


def test_icp_step_idle(ctx):
    # steps [100, 300] and [400, 600]: busy 100 us in the first, 50 + 20 in
    # the second, 170 of 400 us
    assert run.reader("icp_step_idle.stage1")(ctx) == pytest.approx(100 * (1 - 170 / 400))


def test_load_wait_and_padding(ctx):
    assert run.reader("load_wait_s.stage1")(ctx) == pytest.approx(0.2)
    assert run.reader("k1_padding_share.stage1")(ctx) == pytest.approx(75.0)


@pytest.mark.parametrize("name", READERS)
def test_no_value_without_program_spans_or_counters(name):
    assert run.reader(name)(_ctx("trace.json", "scanmatcher_profiles.json")) is None


def test_null_counters_read_no_value(ctx):
    for p in ctx["profiles"]:
        p["k1_pairs_swept"] = p["k1_pairs_valid"] = None
    assert run.reader("k1_padding_share.stage1")(ctx) is None


def test_manifest_lists_each_reader():
    with open(os.path.join(run.REPO, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in READERS:
        assert per_layer[name]["workloads"] == ["kitti00.stage1"]
        assert per_layer[name]["moves"] == "stage1_fps"
