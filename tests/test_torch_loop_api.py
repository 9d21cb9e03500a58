"""The port's method- and parameter-level API against the JAX package's, on
the CPU: the array form of ``LoopCloser`` and its ICP override, the
keyframe store's ``from_arrays(icp_params=)``, ``load_and_preprocess(seed=)``
and ``memory_bytes``, ``EurocDataset.path``, ``load_scans(max_workers=)``,
the solvers' ``factors`` keyword, the NamedTuple defaults, and the
quickstart.

The loop-closing cases are tests/test_loopclosing.py's, run on both
packages from the same numpy arrays (its dense 40-pose circle, capacity
2048).  The JAX side runs its ICP on K1's original (``nn_impl="vpu_t"``,
Pallas interpret mode on the CPU); the port's ICP takes the same
parameters through ``ICPParams(**params._asdict())``.  Tolerances:
candidates, triplets, gate decisions and accepted closures exactly equal;
the closures' transforms within 1e-4 m / 1e-4 rad (tests/test_torch_stage1.py's
ICP bound).
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lidar_slam_arvc_tpu.graph import PoseGraph as PoseGraphRef
from lidar_slam_arvc_tpu.io import EurocDataset as EurocRef
from lidar_slam_arvc_tpu.keyframes import KeyframeStore as StoreRef
from lidar_slam_arvc_tpu.loop import LoopCloser as LoopCloserRef
from lidar_slam_arvc_tpu.pipeline import preprocess as prep_ref
from lidar_slam_arvc_tpu.pipeline import scanmatcher as sm_ref
from lidar_slam_arvc_tpu.registration import ICPParams as ICPParamsRef
from lidar_slam_arvc_tpu.registration.icp import ICPResult as ICPResultRef
from lidar_slam_arvc_tpu_torch import cloud as cl
from lidar_slam_arvc_tpu_torch.graph import PoseGraph
from lidar_slam_arvc_tpu_torch.graph import pcg, solver
from lidar_slam_arvc_tpu_torch.graph.factors import FACTOR_FIELDS
from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.io.pcd import write_pcd
from lidar_slam_arvc_tpu_torch.keyframes import KeyframeStore
from lidar_slam_arvc_tpu_torch.loop import LoopCloser
from lidar_slam_arvc_tpu_torch.pipeline import preprocess, quickstart
from lidar_slam_arvc_tpu_torch.pipeline import scanmatcher as sm
from lidar_slam_arvc_tpu_torch.registration.icp import ICPParams, ICPResult
from lidar_slam_arvc_tpu_torch.utils import synthetic
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
from lidar_slam_arvc_tpu_torch.utils.metrics import ate

torch.set_num_threads(1)

N = 40          # tests/test_loopclosing.py's dense circle
RADIUS = 6.0
CAP = 2048
STATE = FACTOR_FIELDS + ("poses", "n_poses", "n_chain", "n_loop", "n_gps",
                         "n_prior", "chain_capacity", "T0", "T0_gps")
# tests/test_loopclosing.py's loop ICP, on K1's original in the JAX package
ICP_REF = ICPParamsRef(max_correspondence_distance=5.0, max_iterations=20,
                       src_block=512, tgt_block=512, nn_impl="vpu_t")


def pose_err(T_a, T_b):
    D = np.linalg.inv(np.asarray(T_a, np.float64)) @ np.asarray(T_b, np.float64)
    R = D[..., :3, :3]
    skew = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    return (np.linalg.norm(D[..., :3, 3], axis=-1).max(),
            np.arcsin(np.clip(np.linalg.norm(skew, axis=-1) / 2, 0, 1)).max())


@pytest.fixture(scope="module")
def scene():
    """tests/test_loopclosing.py's dense scene as numpy arrays: (T_gt,
    points (N, CAP, 3), mask (N, CAP), normals (N, CAP, 3), ground mask)."""
    rng = np.random.default_rng(7)
    world = synthetic.make_world(rng, extent=15.0, n_ground=5000,
                                 n_pillars=25, pillar_pts=200)
    T_gt = synthetic.make_trajectory(N, radius=RADIUS)
    clouds = []
    for i in range(N):
        scan = synthetic.render_scan(world, T_gt[i], rng, max_range=18.0,
                                     max_points=2500)
        c = cl.from_numpy(scan, CAP, device="cpu")
        c = cl.crop_radius_height(c, 0.5, 35.0, -1.0, 50.0)
        c = cl.voxel_downsample(c, 0.2)
        clouds.append(cl.estimate_normals(c, radius=0.4))
    pts, mask, nrm = (np.stack([getattr(c, k).numpy() for c in clouds])
                      for k in ("points", "mask", "normals"))
    ground = mask & (pts[..., 2] < -0.3)
    return T_gt, pts, mask, nrm, ground


def drifted_graphs(T_gt, drift_yaw=0.003, drift_x=0.01):
    """tests/test_loopclosing.py's drifted graph in both packages."""
    g = PoseGraphRef(max_poses=64, max_between=512, max_gps=64)
    g.init_graph()
    drift = synthetic._yaw_T(drift_x, 0.0, drift_yaw)
    for i in range(N - 1):
        rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1] @ drift
        g.add_initial_estimate(rel, i + 1)
        g.add_edge(rel, i, i + 1, "SM")
    p = PoseGraph.from_reference_state({k: copy.deepcopy(getattr(g, k))
                                        for k in STATE}, device="cpu")
    return g, p


def closers(scene, drift=(0.003, 0.01), icp=None, **kw):
    """The array-form LoopCloser of both packages, positional arguments as
    tests/test_loopclosing.py passes them."""
    T_gt, pts, mask, nrm, _ = scene
    g, p = drifted_graphs(T_gt, *drift)
    ref = LoopCloserRef(g, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(nrm),
                        icp_params=icp, **kw)
    got = LoopCloser(p, torch.from_numpy(pts), torch.from_numpy(mask),
                     torch.from_numpy(nrm),
                     icp_params=None if icp is None else ICPParams(**icp._asdict()),
                     **kw)
    return ref, got


# ------------------------------------------------ LoopCloser, array form

@pytest.mark.parametrize("case", ["no_candidates_early", "candidates_at_loop",
                                  "triplet_gates", "triangle_gate"])
def test_array_form_candidates_and_gates(scene, case):
    """tests/test_loopclosing.py:60-100 on both packages: the same
    candidates, triplets and gate decisions."""
    gates = dict(distance_backwards=8.0, radius_threshold=3.0)
    if case == "no_candidates_early":
        ref, got = closers(scene, distance_backwards=8.0, radius_threshold=2.0)
        ref.graph.n_poses = got.graph.n_poses = 10
        assert len(got.find_candidates()) == len(ref.find_candidates()) == 0
    elif case == "candidates_at_loop":
        ref, got = closers(scene, (0.0, 0.0), **gates)
        cands = got.find_candidates()
        np.testing.assert_array_equal(cands, ref.find_candidates())
        assert len(cands) > 0 and cands.min() < 5
    elif case == "triplet_gates":
        ref, got = closers(scene, (0.0, 0.0), **gates)
        triplets = got.find_feasible_triplets(N - 1)
        assert triplets == ref.find_feasible_triplets(N - 1) and triplets
    else:
        ref, got = closers(scene)
        for T in (np.eye(4), synthetic._yaw_T(0.5, 0.0, 0.0),
                  synthetic._yaw_T(0.0, 0.0, 0.2), synthetic._yaw_T(0.05, 0.0, 0.02)):
            assert got.check_distances(T) == ref.check_distances(T)
    assert got.store.method == ref.store.method == "icppointplane"
    assert got.store.icp_params_override is None


@pytest.mark.parametrize("mode", ["triangle", "simple"])
def test_array_form_loop_closing_matches_reference(scene, mode):
    """tests/test_loopclosing.py:197-217 on both packages: the same accepted
    closures, their transforms within 1e-4 m / 1e-4 rad, and the drift
    they remove."""
    T_gt = scene[0]
    ref, got = closers(scene, icp=ICP_REF, distance_backwards=8.0,
                       radius_threshold=3.0, seed=0)
    assert got.store.icp_params_override == ICPParams(**ICP_REF._asdict())
    if mode == "triangle":
        added = got.loop_closing_triangle(N - 1, number_of_triplets=6)
        assert added == ref.loop_closing_triangle(N - 1, number_of_triplets=6)
        assert len(added) >= 2, "no loop closures accepted"
    else:
        added = got.loop_closing_simple(N - 1, number_of_candidates=4)
        assert added == ref.loop_closing_simple(N - 1, number_of_candidates=4)
        assert 0 < len(added) <= 4
    g, p = ref.graph, got.graph
    assert p.n_loop == g.n_loop and got.timings["icp_pairs"] > 0
    dpos, drot = pose_err(p.bt_T, np.asarray(g.bt_T))
    assert dpos < 1e-4 and drot < 1e-4, (dpos, drot)
    for k in ("bt_i", "bt_j"):
        np.testing.assert_array_equal(getattr(p, k), np.asarray(getattr(g, k)))
    if mode == "triangle":
        before = ate(p.current_estimate, T_gt)["rmse"]
        p.optimize(max_iterations=30)
        assert ate(p.current_estimate, T_gt)["rmse"] < 0.6 * before


def test_array_form_arguments():
    pts = torch.zeros(2, 8, 3)
    mask = torch.ones(2, 8, dtype=torch.bool)
    closer = LoopCloser(None, pts, mask, pts, method="point_to_point")
    assert closer.store.method == "icppointpoint" and closer.store.points is pts
    store = KeyframeStore.from_arrays(pts, mask, pts)
    with pytest.raises(TypeError):
        LoopCloser(None, pts.numpy())
    with pytest.raises(ValueError, match="scan_masks"):
        LoopCloser(None, store, mask)
    with pytest.raises(ValueError, match="differs from the store's"):
        LoopCloser(None, store, method="point_to_point")
    assert LoopCloser(None, store, method="point_to_plane").store is store


# ---------------------------------------------------- the ICP override

def _split_store(scene, method, cfg=None, icp_params=None):
    _, pts, mask, nrm, ground = scene
    return KeyframeStore.from_arrays(
        *(torch.from_numpy(a) for a in (pts, mask, nrm)), method=method, cfg=cfg,
        ground_mask=torch.from_numpy(ground),
        nonground_mask=torch.from_numpy(mask & ~ground), icp_params=icp_params)


@pytest.mark.parametrize("method", ["icppointplane", "icppointpoint", "icp2planes"])
def test_icp_override_is_a_store_with_those_parameters(scene, method):
    """``LoopCloser(store, icp_params=)`` registers as a store built with
    those parameters, and leaves the caller's store as it was (its own
    parameters, the same tensors)."""
    T_gt = scene[0]
    cfg1 = IcpConfig(max_iterations=1)
    one_step = ICPParams(max_correspondence_distance=cfg1.distance_threshold,
                         max_iterations=1, source_stride=cfg1.source_stride)
    store = _split_store(scene, method)
    closer = LoopCloser(None, store, icp_params=one_step)
    assert closer.store is not store and store.icp_params_override is None
    assert closer.store.icp_params_override is one_step
    assert closer.store.points is store.points
    pairs = np.array([[0, 1], [5, 3], [N - 1, 0]])
    seeds = np.stack([np.linalg.inv(T_gt[i]) @ T_gt[j] @ synthetic._yaw_T(
        0.08, -0.05, 0.02) for i, j in pairs]).astype(np.float32)
    T_over = closer.store.compute_transformations_batch(pairs, seeds)
    T_built = _split_store(scene, method, cfg=cfg1).compute_transformations_batch(
        pairs, seeds)
    np.testing.assert_array_equal(T_over, T_built)
    T_own = store.compute_transformations_batch(pairs, seeds)
    assert pose_err(T_own, T_over)[0] > 1e-3      # the override changed it
    np.testing.assert_array_equal(
        _split_store(scene, method, icp_params=one_step)
        .compute_transformations_batch(pairs, seeds), T_over)


def test_memory_bytes_matches_reference(scene):
    _, pts, mask, nrm, ground = scene
    store = _split_store(scene, "icp2planes")
    ref = StoreRef.from_arrays(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(nrm),
                               method="icp2planes", ground_mask=jnp.asarray(ground),
                               nonground_mask=jnp.asarray(mask & ~ground))
    assert store.memory_bytes() == ref.memory_bytes()
    assert store.memory_bytes() == 2 * pts.nbytes + 3 * mask.nbytes
    plain = KeyframeStore.from_arrays(*(torch.from_numpy(a) for a in (pts, mask, nrm)))
    assert plain.memory_bytes() == 2 * pts.nbytes + mask.nbytes
    assert KeyframeStore(None, [0], device="cpu").memory_bytes() == 0


# ------------------------------------------------ store loading, dataset

@pytest.fixture(scope="module")
def small_dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("loop_api") / "euroc")
    synthetic.make_dataset(d, n_scans=6, seed=4, radius=6.0, scan_points=1500,
                           scanmatcher_params={"delta_time": 1.0, "start_index": 0})
    return d


def test_dataset_path(small_dataset):
    for rel in ("/robot0/lidar/data.csv", "", "/x"):
        assert EurocDataset(small_dataset).path(rel) == EurocRef(small_dataset).path(rel)


def test_store_load_seed(small_dataset):
    """``seed=0`` is the default bit for bit; ``seed=1`` keys the ground
    planes' draws as stage 1's streamed load does, the same on every call."""
    times = EurocDataset(small_dataset).read_csv("/robot0/lidar/data.csv")["#timestamp [ns]"]
    cfg = IcpConfig(raw_capacity=2048, capacity=1024, batch_size=4)
    fields = ("points", "mask", "normals", "ground_mask", "nonground_mask")

    def load(**kw):
        s = KeyframeStore(small_dataset, times, voxel_size=0.25, method="icp2planes",
                          cfg=cfg, device="cpu").load_and_preprocess(**kw)
        return [getattr(s, f) for f in fields]

    for a, b in zip(load(), load(seed=0)):
        assert torch.equal(a, b)
    one = load(seed=1)
    for a, b in zip(one, load(seed=1)):
        assert torch.equal(a, b)
    scans, _, _ = sm.load_and_preprocess_streamed(
        EurocDataset(small_dataset), times, cfg, "icp2planes", 0.25, seed=1,
        device="cpu")
    for a, f in zip(one, fields):
        assert torch.equal(a, getattr(scans, f)), f


def test_load_scans_max_workers(tmp_path, monkeypatch):
    """ASCII PCDs, which the native parser rejects, parse in Python on
    ``max_workers`` threads: the same stack as the default and as the JAX
    package's ``load_scans(max_workers=1)``."""
    rng = np.random.default_rng(2)
    times = np.arange(1, 6) * 10**9
    for k, t in enumerate(times):
        write_pcd(f"{tmp_path}/robot0/lidar/data/{t}.pcd",
                  rng.normal(scale=5.0, size=(100 + 40 * k, 3)),
                  "ascii" if k % 2 else "binary")
    pools = []
    real = sm.concurrent.futures.ThreadPoolExecutor

    def pool(max_workers):
        pools.append(max_workers)
        return real(max_workers=max_workers)

    monkeypatch.setattr(sm.concurrent.futures, "ThreadPoolExecutor", pool)
    one = sm.load_scans(EurocDataset(str(tmp_path)), times, 256, max_workers=1)
    default = sm.load_scans(EurocDataset(str(tmp_path)), times, 256)
    assert pools == [1, 4]
    monkeypatch.undo()
    ref = sm_ref.load_scans(EurocRef(str(tmp_path)), times, 256, max_workers=1)
    for a, b, r in zip(one, default, ref):
        assert a.tobytes() == b.tobytes() == np.asarray(r).tobytes()


# ---------------------------------------- the solvers' ``factors`` keyword

@pytest.mark.parametrize("fn", ["graph_cost", "solve_graph", "marginal_covariances",
                                "pcg_lm_step", "solve_graph_pcg", "marginal_blocks_pcg"])
def test_factors_keyword(fn):
    """The JAX package names the factor argument ``factors``; the port's
    call with that keyword equals its positional call."""
    T_gt = synthetic.make_trajectory(12, radius=4.0)
    g = PoseGraph(max_poses=16, max_between=32, max_gps=16, device="cpu")
    g.init_graph()
    for i in range(11):
        rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1] @ synthetic._yaw_T(0.01, 0, 0.002)
        g.add_initial_estimate(rel, i + 1)
        g.add_edge(rel, i, i + 1, "SM")
    g.add_edge(np.linalg.inv(T_gt[11]) @ T_gt[0], 11, 0, "SM")
    poses, f, n = g._poses_on_device(), g._factor_data(), g.n_poses
    if fn == "graph_cost":
        pos, kw = solver.graph_cost(poses, f), solver.graph_cost(poses, factors=f)
    else:
        run, extra = {
            "solve_graph": (solver.solve_graph, {}),
            "marginal_covariances": (solver.marginal_covariances, {"chunk": 8}),
            "pcg_lm_step": (pcg.pcg_lm_step, {"lam": 1e-3}),
            "solve_graph_pcg": (pcg.solve_graph_pcg, {}),
            "marginal_blocks_pcg": (pcg.marginal_blocks_pcg, {"indices": [0, 5, 11]}),
        }[fn]
        pos = run(poses, f, n, **extra)
        kw = run(poses, factors=f, n_active=n, **extra)
    for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (pos, kw))):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# -------------------------------------------------- NamedTuple defaults

def test_namedtuple_defaults_match_reference():
    assert ICPResult._field_defaults == ICPResultRef._field_defaults
    assert preprocess.PreprocessedScans._fields == prep_ref.PreprocessedScans._fields
    assert (preprocess.PreprocessedScans._field_defaults
            == prep_ref.PreprocessedScans._field_defaults)
    T = torch.eye(4)
    res = ICPResult(T, torch.tensor(1.0), torch.tensor(0.0))
    assert res.iterations == 0 and res.final_delta == 0.0
    scans = preprocess.PreprocessedScans(T, T, T)
    assert scans.n_voxels is scans.ground_mask is scans.nonground_mask is None


# ----------------------------------------------------------- quickstart

def test_quickstart_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``python -m lidar_slam_arvc_tpu_torch.pipeline.quickstart --device
    cpu`` cut to 8 scans of 1000 points at capacity 1024: both stages'
    outputs, an ATE within the CLI tests' bound, the viewer's artifacts."""
    d = str(tmp_path / "qs")
    monkeypatch.setitem(quickstart.SIZES, "cpu", (8, 1000, 1024, 1024))
    out = quickstart.main([d, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "scanmatcher:" in printed and "graphSLAM:" in printed
    assert out["scans"] == 8 and out["view_error"] is None
    for k in ("stage1_ate", "slam_ate", "slam_rpe"):
        assert np.isfinite(out[k]) and out[k] < 0.2, (k, out[k])
    assert out["frames_per_second"] > 0 and out["solve_loop_seconds"] > 0
    for f in ("scanmatcher/scanmatcher_global.csv", "SLAM/solution_graphslam.csv",
              "viz/trajectory.png", "viz/map.ply"):
        assert os.path.exists(f"{d}/robot0/{f}"), f
    if not torch.cuda.is_available():
        # the default device is the card: no dataset is written without one
        with pytest.raises(RuntimeError, match="cuda"):
            quickstart.main([str(tmp_path / "card")])
        assert not os.path.exists(tmp_path / "card")
