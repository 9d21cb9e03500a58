"""Stage 2 of the PyTorch port vs the JAX package on the CPU: the keyframe
store, loop closing, and run_graphslam through the port's CLI.

Both packages read the same files or get the same numpy inputs.  The JAX
side runs the two TPU kernels the port replaces (K1's nn sweep, K2's ball
moments) in Pallas interpret mode, as tests/test_torch_stage1.py does: its
CPU defaults take other formulations whose f32 rounding alone moves poses
by millimetres.  Tolerances:

* loop candidates, triplets, draws, gate decisions and the
  loop_closures.csv bytes: exactly equal;
* store ICP: 1e-4 m / 1e-4 rad (tests/test_torch_stage1.py's bound);
* the SLAM solution: 5e-3 m / 5e-3 rad.  The default sigma table's weak
  prior and GPS leave directions along which f32 LM iterates drift by
  millimetres at an unchanged cost (tests/test_torch_graph.py), and the
  two packages' ICP results enter as measurements;
* ATE below max(1.5 x stage-1 ATE, 0.15 m), tests/test_pipeline.py's
  TestGraphSLAM bound.
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lidar_slam_arvc_tpu.cloud import normals as normals_ref
from lidar_slam_arvc_tpu.graph import PoseGraph as PoseGraphRef
from lidar_slam_arvc_tpu.io import EurocDataset as EurocRef
from lidar_slam_arvc_tpu.keyframes import KeyframeStore as StoreRef
from lidar_slam_arvc_tpu.keyframes import store as store_ref
from lidar_slam_arvc_tpu.loop import LoopCloser as LoopCloserRef
from lidar_slam_arvc_tpu.loop.loopclosing import _rot_to_euler_both_np as euler_ref
from lidar_slam_arvc_tpu.pipeline import graphslam as graphslam_ref
from lidar_slam_arvc_tpu.pipeline import preprocess as prep_ref
from lidar_slam_arvc_tpu.registration import ICPParams as ICPParamsRef
from lidar_slam_arvc_tpu.utils.config import IcpConfig as IcpConfigRef
from lidar_slam_arvc_tpu_torch.graph import PoseGraph
from lidar_slam_arvc_tpu_torch.graph.factors import FACTOR_FIELDS
from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.keyframes import KeyframeStore
from lidar_slam_arvc_tpu_torch.loop import LoopCloser
from lidar_slam_arvc_tpu_torch.loop.loopclosing import _rot_to_euler_both_np
from lidar_slam_arvc_tpu_torch.pipeline import cli
from lidar_slam_arvc_tpu_torch.pipeline.graphslam import run_graphslam
from lidar_slam_arvc_tpu_torch.pipeline.scanmatcher import run_scanmatcher
from lidar_slam_arvc_tpu_torch.utils import synthetic
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
from lidar_slam_arvc_tpu_torch.utils.metrics import ate

torch.set_num_threads(1)

# the dataset: 20 scans on a 3 m circle, the 0.94 m spacing of
# tests/test_loopclosing.py's 40-pose circle (N_POSES, radius 6 m), which
# the loop closer's own cases below keep
N_SCANS = 20
N_POSES = 40
CFG = dict(raw_capacity=4096, capacity=2048, batch_size=8, max_iterations=15)
STATE = FACTOR_FIELDS + ("poses", "n_poses", "n_chain", "n_loop", "n_gps",
                         "n_prior", "chain_capacity", "T0", "T0_gps")


def pose_err(T_a, T_b):
    D = np.linalg.inv(np.asarray(T_a, np.float64)) @ np.asarray(T_b, np.float64)
    R = D[..., :3, :3]
    skew = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    return (np.linalg.norm(D[..., :3, 3], axis=-1).max(),
            np.arcsin(np.clip(np.linalg.norm(skew, axis=-1) / 2, 0, 1)).max())


@pytest.fixture
def reference_kernels(monkeypatch):
    """The JAX package's store ICP on K1's original (nn_impl vpu_t) and its
    normals on K2's original, both in Pallas interpret mode."""
    monkeypatch.setattr(store_ref, "ICPParams",
                        lambda **kw: ICPParamsRef(nn_impl="vpu_t", **kw))
    monkeypatch.setattr(
        prep_ref.cl, "estimate_normals",
        lambda c, r: normals_ref.estimate_normals(c, r, impl="pallas_interpret"))


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """A closed circle of box-world scans whose triplet windows are
    satisfiable, with the port's stage-1 outputs (the CSVs stage 2 of
    either package reads; tests/test_torch_stage1.py holds the port's
    stage 1 to the JAX package's)."""
    d = str(tmp_path_factory.mktemp("stage2") / "euroc")
    info = synthetic.make_dataset(
        d, n_scans=N_SCANS, seed=9, radius=3.0, scan_points=2000,
        max_range=18.0,
        world_kwargs={"extent": 15.0, "n_ground": 6000, "n_pillars": 0,
                      "n_boxes": 15},
        scanmatcher_params={"voxel_size": 0.25, "delta_time": 1.0,
                            "start_index": 0},
        slam_params={"skip_loop_closing": 12, "skip_optimization": 12,
                     "radius_threshold": 3.0, "distance_backwards": 8.0,
                     "number_of_triplets_loop_closing": 10})
    out = run_scanmatcher(d, cfg=IcpConfig(**CFG), progress=False, device="cpu")
    return d, info, out["global"]


def test_graphslam_cli_matches_reference(stage1, tmp_path, reference_kernels):
    """The slice as a whole: run_graphslam of both packages on copies of
    one stage-1 output, the port through its CLI on the CPU."""
    d, info, sm_global = stage1
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(d, d_ref)
    shutil.copytree(d, d_port)
    out_ref = graphslam_ref.run_graphslam(d_ref, cfg=IcpConfigRef(**CFG),
                                          progress=False)
    assert cli.main(["graph", "-i", d_port, "--capacity", "2048",
                     "--batch-size", "8", "--device", "cpu"]) == 0
    assert out_ref["n_loop_closures"] >= 1
    slam = "/robot0/SLAM/"
    with open(d_port + slam + "loop_closures.csv", "rb") as f, \
            open(d_ref + slam + "loop_closures.csv", "rb") as g:
        assert f.read() == g.read()
    _, T = EurocDataset(d_port).read_trajectory(slam + "solution_graphslam.csv")
    _, T_ref = EurocRef(d_ref).read_trajectory(slam + "solution_graphslam.csv")
    assert T.shape == (N_SCANS, 4, 4)
    dpos, drot = pose_err(T, T_ref)
    assert dpos < 5e-3 and drot < 5e-3, (dpos, drot)
    err, err_sm = ate(T, info["T_gt"])["rmse"], ate(sm_global, info["T_gt"])["rmse"]
    assert err < max(1.5 * err_sm, 0.15), (err, err_sm)

    with open(d_port + "/robot0/viz/graphslam_profile.json") as f:
        prof = json.load(f)
    with open(d_ref + "/robot0/viz/graphslam_profile.json") as f:
        prof_ref = json.load(f)
    same = ("poses", "optimizations", "loop_closing_rounds",
            "loop_closures_accepted", "gps_factors", "solver", "method",
            "loop_icp_dispatches", "store_scans_loaded_locally",
            "store_reused_stage1", "mesh_devices", "process_count")
    assert {k: prof[k] for k in same} == {k: prof_ref[k] for k in same}
    assert set(prof_ref) - set(prof) == {"programs_compiled", "compile_seconds"}
    assert prof["uncertainty_error"] is None and prof_ref["uncertainty_error"] is None
    for root in (d_port, d_ref):
        for name in ("uncertainty.png", "gps_comparison.png"):
            assert os.path.getsize(root + slam + name) > 1000, (root, name)
    # the port's ICP batch holds the real pairs; the reference pads to >= 8
    assert 0 < prof["loop_icp_pairs"] < prof_ref["loop_icp_pairs"]
    assert prof["kernel_launches"]["nn_sweep"] == 0   # plain versions on the CPU
    assert prof["solver_stats"]["optimizations"] == prof["optimizations"]
    parts = (prof["optimize_seconds"] + prof["marginals_seconds"]
             + prof["loop_candidate_search_seconds"] + prof["loop_icp_seconds"]
             + prof["host_other_seconds"])
    assert abs(parts - prof["solve_loop_seconds"]) < 0.01


@pytest.mark.parametrize("voxel,reused", [(None, True), (0.3, False)],
                         ids=["full_resolution", "voxelised"])
def test_run_command_fused_handoff(tmp_path, voxel, reused):
    """``cli run`` hands stage 1's tensors to stage 2 when stage 1 ran at
    full resolution; a reloaded store then gives the same solution."""
    d = str(tmp_path / "run")
    synthetic.make_dataset(
        d, n_scans=5, seed=14, radius=4.0, scan_points=600,
        world_kwargs={"extent": 12.0, "n_ground": 2000, "n_pillars": 0,
                      "n_boxes": 8},
        scanmatcher_params={"voxel_size": voxel, "delta_time": 1.0,
                            "start_index": 0},
        slam_params={"skip_loop_closing": 4, "skip_optimization": 4,
                     "number_of_triplets_loop_closing": 2})
    argv = ["-i", d, "--capacity", "512", "--batch-size", "4", "--device", "cpu"]
    assert cli.main(["run"] + argv) == 0
    prof_path = d + "/robot0/viz/graphslam_profile.json"
    with open(prof_path) as f:
        prof = json.load(f)
    assert prof["store_reused_stage1"] is reused
    assert prof["store_scans_loaded_locally"] == (0 if reused else 5)
    _, T_fused = EurocDataset(d).read_trajectory("/robot0/SLAM/solution_graphslam.csv")
    assert cli.main(["graph"] + argv) == 0
    with open(prof_path) as f:
        assert json.load(f)["store_reused_stage1"] is False
    _, T_reload = EurocDataset(d).read_trajectory("/robot0/SLAM/solution_graphslam.csv")
    np.testing.assert_allclose(T_fused, T_reload, atol=1e-6)


def test_keyframe_store_matches_reference(stage1, reference_kernels):
    """load_and_preprocess at voxel None gives the reference's clouds and
    normals; compute_transformations_batch on the same clouds gives its
    transforms."""
    d, info, _ = stage1
    times = EurocDataset(d).read_csv("/robot0/lidar/data.csv")["#timestamp [ns]"]
    cfg_ref = IcpConfigRef(**CFG)
    ref = StoreRef(d, times, method="icppointplane", cfg=cfg_ref)
    ref.load_and_preprocess(keyframe_sampling=2)
    got = KeyframeStore(d, times, cfg=IcpConfig(**CFG), device="cpu")
    got.load_and_preprocess(keyframe_sampling=2)
    assert len(got) == len(ref) == 10
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(ref.points))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.overflow, np.asarray(ref.overflow))
    m = got.mask.numpy()
    cos = np.abs(np.sum(got.normals.numpy() * np.asarray(ref.normals), -1))[m]
    assert np.median(cos) > 1 - 1e-6 and np.mean(cos > 0.99) > 0.99

    port = KeyframeStore.from_arrays(*(torch.from_numpy(np.array(a)) for a in
                                       (ref.points, ref.mask, ref.normals)),
                                     cfg=IcpConfig(**CFG))
    T_gt = info["T_gt"][::2]
    pairs = np.array([[0, 1], [1, 2], [9, 0], [5, 4]])
    seeds = np.stack([np.linalg.inv(T_gt[i]) @ T_gt[j] @ synthetic._yaw_T(
        0.05, -0.03, 0.01) for i, j in pairs]).astype(np.float32)
    T_ref = ref.compute_transformations_batch(pairs, seeds)
    T = port.compute_transformations_batch(pairs, seeds)
    dpos, drot = pose_err(T, T_ref)
    assert dpos < 1e-4 and drot < 1e-4, (dpos, drot)
    T1 = port.compute_transformation(9, 0, seeds[2])
    np.testing.assert_allclose(T1, T[2], atol=1e-6)


def _circle_graphs(T0_gps=None):
    """A drifted 40-pose circle (tests/test_loopclosing.py's) in both
    packages."""
    T_gt = synthetic.make_trajectory(N_POSES, radius=6.0)
    g = PoseGraphRef(max_poses=64, max_between=512, max_gps=64, T0_gps=T0_gps)
    g.init_graph()
    drift = synthetic._yaw_T(0.01, 0.0, 0.003)
    for i in range(N_POSES - 1):
        rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1] @ drift
        g.add_initial_estimate(rel, i + 1)
        g.add_edge(rel, i, i + 1, "SM")
    p = PoseGraph.from_reference_state({k: copy.deepcopy(getattr(g, k))
                                        for k in STATE}, device="cpu")
    return g, p


def _fake_icp(pairs, seeds):
    """A deterministic registration: the seed moved by a pair-dependent
    offset, 0.2 m for targets j divisible by 3 (those triplets fail the
    gate), sub-millimetre otherwise."""
    out = np.empty((len(pairs), 4, 4))
    for k, (i, j) in enumerate(pairs):
        dx = 0.2 if j % 3 == 0 else 1e-4 * (j % 5)
        out[k] = seeds[k].astype(np.float64) @ synthetic._yaw_T(dx, 0.0, 1e-4 * (i % 3))
    return out


def _closers(T0_gps=None):
    g, p = _circle_graphs(T0_gps)
    dummy = np.zeros((N_POSES, 8, 3), np.float32)
    s_ref = StoreRef.from_arrays(jnp.asarray(dummy), jnp.ones((N_POSES, 8), bool),
                                 jnp.asarray(dummy))
    s = KeyframeStore.from_arrays(torch.from_numpy(dummy),
                                  torch.ones(N_POSES, 8, dtype=torch.bool),
                                  torch.from_numpy(dummy))
    s_ref.compute_transformations_batch = _fake_icp
    s.compute_transformations_batch = _fake_icp
    kw = dict(distance_backwards=8.0, radius_threshold=6.0, seed=3)
    return LoopCloserRef(g, s_ref, **kw), LoopCloser(p, s, **kw)


def test_loop_closer_matches_reference():
    """Candidates, triplets, the seeded draws, the gate and the edges it
    adds are exactly the reference's (T0_gps = I, as in the datasets)."""
    ref, got = _closers()
    g, p = ref.graph, got.graph
    np.testing.assert_array_equal(got.find_candidates(), ref.find_candidates())
    assert got.find_feasible_triplets(39) == ref.find_feasible_triplets(39)
    assert len(ref.find_feasible_triplets(39)) > 4
    for current, n in ((39, 4), (38, 10), (39, 3)):
        added = got.loop_closing_triangle(current, n)
        assert added == ref.loop_closing_triangle(current, n)
    assert 0 < got.graph.n_loop == ref.graph.n_loop < 3 * 2 * 10
    added = got.loop_closing_simple(39, 5)
    assert added == ref.loop_closing_simple(39, 5)
    for k in FACTOR_FIELDS:
        np.testing.assert_array_equal(getattr(p, k), getattr(g, k), k)
    assert got.rng.random() == ref.rng.random()
    assert set(got.timings) == set(ref.timings)
    assert got.timings["icp_dispatches"] == ref.timings["icp_dispatches"] == 4

    rng = np.random.default_rng(1)
    for _ in range(50):
        I = np.eye(4)
        I[:3, :3] = synthetic._yaw_T(0, 0, rng.normal(scale=0.03))[:3, :3]
        I[:3, 3] = rng.normal(scale=0.06, size=3)
        assert got.check_distances(I) == ref.check_distances(I)
        for a, b in zip(_rot_to_euler_both_np(I[:3, :3]), euler_ref(I[:3, :3])):
            np.testing.assert_array_equal(a, b)


def test_loop_gate_in_the_graph_frame():
    """With a GPS lever arm (T0_gps != I) the port's gate is the
    reference's: T_j1j2 in the LiDAR frame against T_ij1 and T_ij2 in the
    graph's (GPS) frame, so both reject a registration that agrees with the
    graph exactly (the frame mix-up ROADMAP Queue 3 files for both
    packages), and both accept it at T0_gps = I."""
    exact = lambda pairs, seeds: seeds.astype(np.float64)
    for T0_gps, n_added in ((synthetic._yaw_T(0.36, 0.0, 0.0), 0), (None, 10)):
        ref, got = _closers(T0_gps)
        ref.store.compute_transformations_batch = exact
        got.store.compute_transformations_batch = exact
        added = got.loop_closing_triangle(39, 10)
        assert added == ref.loop_closing_triangle(39, 10)
        assert len(added) == n_added
        for k in FACTOR_FIELDS:
            np.testing.assert_array_equal(getattr(got.graph, k),
                                          getattr(ref.graph, k), k)


def test_unported_paths_raise(stage1, tmp_path):
    d, _, _ = stage1
    for method in ("icp2planes", "fpfh"):
        store = KeyframeStore(d, [0], method=method, device="cpu")
        assert store.method == method and not store.loaded
    with pytest.raises(ValueError, match="unknown registration method"):
        KeyframeStore(d, [0], method="ndt", device="cpu")
    with pytest.raises(TypeError):
        LoopCloser(None, np.zeros((2, 8, 3)))
    # a points tensor is the array form, wrapped by KeyframeStore.from_arrays
    closer = LoopCloser(None, torch.zeros(2, 8, 3), torch.ones(2, 8, dtype=torch.bool),
                        torch.zeros(2, 8, 3))
    assert isinstance(closer.store, KeyframeStore) and closer.store.loaded
    d2 = str(tmp_path / "copy")
    shutil.copytree(d, d2)
    # a mesh needs a process group of that many ranks (cli --devices N)
    for bad in ({"mesh_devices": 2}, {"mesh_devices": 4, "shard_scans": True}):
        with pytest.raises(ValueError, match="process group has 1 rank"):
            run_graphslam(d2, cfg=IcpConfig(**bad), device="cpu")
    if not torch.cuda.is_available():
        for cmd in ("graph", "run"):
            with pytest.raises(RuntimeError, match="cuda"):
                cli.main([cmd, "-i", d2])
