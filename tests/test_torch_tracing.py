"""The port's spans and counters (``utils/profiling.py``): the span names
of stage 1 and their nesting under ``torch.profiler``, nothing recorded
and nothing allocated without a profiler, the ICP step and K1 pair
counters against a recount, the scans' point counters and the
compaction's span, and ``StageTimer``'s ``sync``.

The file imports no JAX; its ``cuda`` test runs on a card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import dataclasses
import itertools
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.io.pcd import read_pcd
from lidar_slam_arvc_tpu_torch.pipeline import scanmatcher as sm
from lidar_slam_arvc_tpu_torch.utils import profiling, synthetic
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
from lidar_slam_arvc_tpu_torch.utils.profiling import StageTimer, span

torch.set_num_threads(1)

# 9 scans: 8 pairs, two whole groups of 4 (no padded self-pairs); the
# capacity holds every voxel, so K1 sweeps padded slots
CFG = IcpConfig(raw_capacity=1024, capacity=768, batch_size=4, max_iterations=10)
WORLD = {"extent": 15.0, "n_ground": 1500, "n_pillars": 5, "pillar_pts": 100,
         "n_boxes": 2}
STAGE1_SPANS = {"scanmatch.setup", "scanmatch.load_preprocess", "scanmatch.icp",
                "scanmatch.write", "pcd.wait", "preprocess.batch", "icp.group",
                "icp.step", "icp.correspond", "icp.assemble", "icp.solve",
                "sync.icp_converged", "sync.voxel_counts", "sync.pair_upload",
                "sync.icp_results", "sync.make_transform_row"}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tracing"))
    synthetic.make_dataset(d, n_scans=9, seed=3, scan_points=600, world_kwargs=WORLD,
                           scanmatcher_params={"voxel_size": 0.2})
    return d


def _annotations(prof) -> list:
    """(name, start ns, end ns) of the host spans of a finished profile."""
    events = prof.profiler.kineto_results.events()
    cpu = type(events[0].device_type()).CPU
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in events if e.is_user_annotation() and e.device_type() == cpu]


def _inside(inner, outers) -> bool:
    return any(a <= inner[1] and inner[2] <= b for _, a, b in outers)


def _of(spans, name) -> list:
    return [s for s in spans if s[0] == name]


def test_stage1_spans_nest_under_the_profiler(dataset):
    sm.run_scanmatcher(dataset, CFG, progress=False, device="cpu")    # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = sm.run_scanmatcher(dataset, CFG, progress=False, device="cpu")
    spans = _annotations(prof)
    assert STAGE1_SPANS <= {s[0] for s in spans}
    for inner, outer in (("icp.step", "icp.group"), ("icp.group", "scanmatch.icp"),
                         ("icp.correspond", "icp.step"), ("icp.assemble", "icp.step"),
                         ("icp.solve", "icp.step"),
                         ("pcd.wait", "scanmatch.load_preprocess"),
                         ("preprocess.batch", "scanmatch.load_preprocess"),
                         ("sync.icp_results", "scanmatch.icp")):
        assert all(_inside(s, _of(spans, outer)) for s in _of(spans, inner)), inner
    # one span per trip of the ICP loop, each ending in its convergence read
    steps = _of(spans, "icp.step")
    assert len(steps) == out["profile"]["icp_steps"] > 0
    assert all(any(_inside(c, [s]) for c in _of(spans, "sync.icp_converged"))
               for s in steps)
    assert len(_of(spans, "icp.group")) == 2
    for phase in ("scanmatch.setup", "scanmatch.load_preprocess", "scanmatch.icp",
                  "scanmatch.write"):
        assert len(_of(spans, phase)) == 1


def test_no_profiler_no_span_and_no_allocation(dataset, monkeypatch):
    assert span("a") is span("b") is profiling._NO_SPAN
    made = []

    class Counting:
        def __init__(self, name):
            made.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    sm.run_scanmatcher(dataset, CFG, progress=False, device="cpu")
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("x"):
            pass
    assert made == ["x"]

    def spans(n):
        for _ in itertools.repeat(None, n):
            with span("icp.step"):
                pass
    spans(10)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        spans(10_000)
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before <= 0


@pytest.mark.parametrize("stride", [1, 2])
def test_icp_steps_and_k1_pairs_against_a_recount(dataset, monkeypatch, stride):
    """``icp_steps`` is the trips of the ICP loop (a group runs until its
    slowest pair stops: its largest iteration count), and K1's valid pairs
    recount from the masks each call received, per trip."""
    calls = []
    original = sm.icp_batch

    def spy(src_points, src_masks, tgt_points, tgt_masks, *args, **kwargs):
        res = original(src_points, src_masks, tgt_points, tgt_masks, *args, **kwargs)
        calls.append((int(res.iterations.max()), src_masks[:, ::stride].sum(-1).numpy(),
                      tgt_masks.sum(-1).numpy(), src_masks[:, ::stride].shape[1],
                      tgt_masks.shape[1]))
        return res

    monkeypatch.setattr(sm, "icp_batch", spy)
    cfg = dataclasses.replace(CFG, source_stride=stride)
    prof = sm.run_scanmatcher(dataset, cfg, progress=False, device="cpu")["profile"]
    assert len(calls) == 2
    assert prof["icp_steps"] == sum(c[0] for c in calls)
    valid = sum(trips * int(np.dot(vs, vt)) for trips, vs, vt, _, _ in calls)
    swept = sum(trips * len(vs) * S * T for trips, vs, _, S, T in calls)
    assert prof["k1_pairs_valid"] == valid
    assert prof["k1_pairs_swept"] == swept
    assert 0 < valid < swept
    assert prof["pcd_wait_seconds"] >= 0 and prof["pcd_decode_seconds"] > 0


@pytest.fixture(scope="module")
def full_dataset(tmp_path_factory):
    """The tracing dataset's scans at full resolution (voxel None)."""
    d = str(tmp_path_factory.mktemp("tracing_full"))
    synthetic.make_dataset(d, n_scans=9, seed=3, scan_points=600, world_kwargs=WORLD,
                           scanmatcher_params={"voxel_size": None})
    return d


@pytest.mark.parametrize("voxel,capacity", [(0.2, 768), (None, 768), (None, 256)],
                         ids=["voxel", "full", "full_over_capacity"])
def test_scan_point_counters_against_a_recount(dataset, full_dataset, voxel, capacity):
    """``scan_points_valid`` sums each scan's voxels (at full resolution its
    cropped points) before the capacity, ``scan_points_kept`` their minimum
    with the capacity, recounted by the benchmark's plain reference from
    the PCD files.  At full resolution each ``preprocess_batch`` holds one
    ``preprocess.compact`` span; with a voxel grid there is none."""
    from slam_bench.reference import cloud as ref_cloud
    d = dataset if voxel else full_dataset
    cfg = dataclasses.replace(CFG, capacity=capacity)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = sm.run_scanmatcher(d, cfg, progress=False, device="cpu")
    icp = {"raw_capacity": cfg.raw_capacity, "capacity": capacity,
           "min_radius": cfg.min_radius, "max_radius": cfg.max_radius,
           "min_height": cfg.min_height, "max_height": cfg.max_height}
    n = []
    for t in out["scan_times"]:
        raw = torch.from_numpy(read_pcd(EurocDataset(d).scan_pcd_path(t)))
        pts = ref_cloud.crop(raw[:cfg.raw_capacity], icp)
        n.append(ref_cloud.voxel_centroids(pts, voxel, capacity)[1] if voxel else len(pts))
    counted = out["profile"]
    assert counted["scan_points_valid"] == sum(n)
    assert counted["scan_points_kept"] == sum(min(k, capacity) for k in n)
    assert (counted["scan_points_kept"] < counted["scan_points_valid"]) == (max(n) > capacity)
    spans = _annotations(prof)
    compact, batches = _of(spans, "preprocess.compact"), _of(spans, "preprocess.batch")
    if voxel is None:
        assert len(compact) == len(batches) > 0
        assert all(_inside(c, batches) for c in compact)
    else:
        assert compact == []


def test_counters_are_null_off_the_plain_single_device_path(tmp_path):
    """Under icp2planes K1's pairs are not counted; the steps still are."""
    d = str(tmp_path)
    synthetic.make_dataset(d, n_scans=5, seed=3, scan_points=600, world_kwargs=WORLD,
                           scanmatcher_params={"voxel_size": 0.2, "method": "icp2planes"})
    prof = sm.run_scanmatcher(d, CFG, progress=False, device="cpu")["profile"]
    assert prof["k1_pairs_swept"] is None and prof["k1_pairs_valid"] is None
    assert prof["icp_steps"] > 0


def test_stage_timer_sync_accumulates(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    t = StageTimer()
    for sync in (None, "cpu", torch.device("cpu")):
        with t.stage("load", items=2, sync=sync):
            pass
    assert t.items["load"] == 6 and t.seconds["load"] >= 0 and synced == []
    card = torch.device("cuda", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.stage("icp", items=4, sync=card):
            pass
    assert synced == [card]
    assert t.report()["icp"]["items"] == 4
    names = [s[0] for s in _annotations(prof)]
    assert names.count("icp") == 1 and names.count("sync.icp") == 1
    with pytest.raises(ZeroDivisionError):
        with t.stage("failing", items=1, sync=card):
            1 / 0
    # counted when it raises, and no synchronise after the error
    assert t.items["failing"] == 1 and synced == [card]


def test_stage2_spans(tmp_path):
    """The LM steps of a dense solve and the CG loop of a PCG solve, each
    with its named host reads."""
    from lidar_slam_arvc_tpu_torch.graph import PoseGraph
    poses = np.tile(np.eye(4), (6, 1, 1))
    rel = np.eye(4)
    rel[0, 3] = 1.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for solver in ("dense", "pcg"):
            g = PoseGraph(T0=np.eye(4), max_poses=8, max_between=16, chain_capacity=16,
                          max_gps=8, device="cpu")
            g.init_graph()
            for i in range(5):
                g.add_initial_estimate(rel @ poses[i], i + 1)
                g.add_edge(rel, i, i + 1, "SM")
            g.optimize(solver=solver)
        g.marginal_covariances()
        g.marginal_covariances(indices=[0, 2])
    names = {s[0] for s in _annotations(prof)}
    assert {"graph.lm_step", "sync.lm_cost", "graph.cg", "sync.cg_live",
            "sync.cg_iterations", "graph.marginals", "sync.marginals_download",
            "sync.poses_upload", "sync.poses_download", "sync.factor_upload",
            "sync.make_transform_row", "sync.marginal_indices",
            "sync.marginal_unit_columns"} <= names


@pytest.mark.cuda
def test_every_icp_sync_is_a_named_span(tmp_path):
    """On a card: every ``cuda*Synchronize`` runtime call inside the traced
    ICP phase (``scanmatch.icp``) lies inside a ``sync.*`` span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    d = str(tmp_path)
    synthetic.make_dataset(d, n_scans=17, seed=3, scan_points=4000,
                           world_kwargs={**WORLD, "n_ground": 6000},
                           scanmatcher_params={"voxel_size": 0.2})
    cfg = IcpConfig(raw_capacity=8192, capacity=4096, batch_size=4, max_iterations=10)
    sm.run_scanmatcher(d, cfg, progress=False)                    # builds, warms
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sm.run_scanmatcher(d, cfg, progress=False)
    events = prof.profiler.kineto_results.events()
    spans = _annotations(prof)
    (icp,) = _of(spans, "scanmatch.icp")
    named = [s for s in spans if s[0].startswith("sync.")]
    syncs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
             if e.name().startswith("cuda") and "Synchronize" in e.name()
             and icp[1] <= e.start_ns() <= icp[2]]
    assert syncs, "no synchronisation traced in the ICP phase"
    steps = _of(spans, "icp.step")
    assert any(_inside(s, steps) for s in syncs)
    assert [s for s in syncs if not _inside(s, named)] == []
