"""Per-layer metric readers on a recorded trace and profiles, the roofline
arithmetic, and the harness finding a cell, configuration, traffic file,
limits and metric that were added as new files."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from slam_bench import roofline, run, trace

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _ctx(profiles):
    events = trace.load(os.path.join(FIX, "trace.json"))
    with open(os.path.join(FIX, profiles)) as f:
        profs = json.load(f)
    return {"profiles": profs, "events": events,
            "spans": {"sequence": trace.span(events, "slam_bench.sequence"),
                      "icp": trace.span(events, "slam_bench.icp")},
            "work": {"k1": [8.0 * 4 * 30000 * 30000, 4 * (20 * 30000 + 12 * 30000)],
                     "k2": [24.0 * 1e6, 4 * 52 * 30000 + 4 * 12 * 30000]},
            "k1_launches": 2}


def test_union_of_intervals_and_idle_share():
    ctx = _ctx("scanmatcher_profiles.json")
    # device busy: [100, 170] + [300, 550] + [800, 820] = 70 + 250 + 20 us
    assert trace.busy_seconds(ctx["events"], 0, 1000) == pytest.approx(340e-6)
    assert run.reader("device_idle.stage1")(ctx) == pytest.approx(66.0)
    assert run.reader("device_idle.stage2")(ctx) == pytest.approx(66.0)
    assert trace.busy_seconds(ctx["events"], 400, 500) == pytest.approx(100e-6)


def test_profile_means_and_ratios():
    c1, c2 = _ctx("scanmatcher_profiles.json"), _ctx("graphslam_profiles.json")
    assert run.reader("load_preprocess_s.stage1")(c1) == pytest.approx(3.0)
    assert run.reader("icp_s.stage1")(c1) == pytest.approx(4.0)
    assert run.reader("store_load_s.stage2")(c2) == pytest.approx(4.0)
    assert run.reader("loop_s.stage2")(c2) == pytest.approx(2.5)
    assert run.reader("optimize_s.stage2")(c2) == pytest.approx(5.0)
    assert run.reader("lm_step_ms.stage2")(c2) == pytest.approx(1e3 * 10.0 / 250)
    # two K1 launches in the icp span [200, 900], three launches there
    assert run.reader("launches_per_icp_step.stage1")(c1) == pytest.approx(1.5)


def test_rooflines():
    ctx = _ctx("scanmatcher_profiles.json")
    ops, nb = ctx["work"]["k1"]
    # nn_sweep_kernel ran 300 us in all; the bound is the operations' time
    want = 100.0 * (ops / roofline.FP32_FLOPS) / 300e-6
    assert run.reader("k1_roofline.stage1")(ctx) == pytest.approx(want)
    assert run.reader("k1_roofline.stage2")(ctx) == pytest.approx(want)
    ops2, nb2 = ctx["work"]["k2"]
    want2 = 100.0 * max(ops2 / roofline.FP32_FLOPS, nb2 / roofline.HBM_BYTES_PER_S) / 50e-6
    assert run.reader("k2_roofline.stage1")(ctx) == pytest.approx(want2)
    # nothing to read: no value, never 0
    ctx["work"]["k2"] = [0.0, 0.0]
    assert run.reader("k2_roofline.stage1")(ctx) is None


def test_work_counts():
    assert roofline.k1_work([10, 20], [30, 40]) == (8.0 * (300 + 800), 20 * 30 + 12 * 70)
    assert roofline.k2_work([10], [10], 55) == (24.0 * 55, 52 * 10 + 12 * 10)
    t, by = roofline.bound_seconds(67e12, 1.0)
    assert (t, by) == (pytest.approx(1.0), "operations")


def test_breakdown_names_ops_and_gaps():
    ctx = _ctx("scanmatcher_profiles.json")
    b = trace.breakdown(ctx["events"], 0, 1000)
    ops = dict(b["device_ops"])
    assert ops["void nn_sweep_kernel<0>(...)"] == pytest.approx(300e-6)
    gaps = dict(b["idle_gaps"])
    # the gap [550, 800] has its midpoint inside aten::linalg_solve_ex
    assert gaps["aten::linalg_solve_ex"] == pytest.approx(250e-6)
    assert sum(gaps.values()) == pytest.approx(660e-6)


def test_new_cell_from_new_files_only(tmp_path):
    """A copy of the harness with a cell, configuration, traffic file,
    limits and metric added as files (and entries in the manifest) finds
    them; no file that was there is edited."""
    shutil.copytree(run.BENCH, tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(run.REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = {p: open(p, "rb").read() for p in
              (str(q) for q in (tmp_path / "slam_bench").rglob("*") if q.is_file())}
    new = tmp_path / "slam_bench"
    shutil.copy(new / "configs" / "nclt-hdl32.json", new / "configs" / "nclt-hdl32-wide.json")
    (new / "traffic" / "stage1_slow.json").write_text(json.dumps(
        {"stage": 1, "entry": "run_scanmatcher", "warmup_keyframes": 9, "check_pairs": 12,
         "rate_metric": "stage1_fps", "rate_unit": "frames/s"}))
    (new / "limits" / "nclt.stage1.json").write_text('{"trans_gap_m": 1.0}')
    (new / "metrics" / "pairs_per_sequence.stage1.py").write_text(
        "def read(ctx):\n    return float(ctx['profiles'][0]['pairs'])\n")
    bench["configs"].append({"name": "nclt-hdl32-wide", "source": "x",
                             "file": "slam_bench/configs/nclt-hdl32-wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "nclt.stage1", "config": "nclt-hdl32-wide",
                               "traffic": "stage1_slow", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, %r); from slam_bench import run; "
            "c = run.cell('nclt.stage1'); "
            "print(c['config']['name'], c['traffic']['stage'], c['limits']['trans_gap_m'], "
            "run.reader('pairs_per_sequence.stage1')({'profiles': [{'pairs': 7}]}))"
            % str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["nclt-hdl32", "1", "1.0", "7.0"]
    for p, data in before.items():
        assert open(p, "rb").read() == data
