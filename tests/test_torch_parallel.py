"""The port's multi-rank library (parallel/) vs the JAX package, on the CPU.

The ranks are processes of one gloo group (``parallel.mesh.launch``), on
the CPU with the kernels' plain versions; every check of a group runs in
one spawn (``parallel._ranks.sequence``).  The JAX package's mesh
functions are too slow on a virtual CPU mesh to serve as the oracle, so
the ranks are held to its single-device functions, which its own tests
(tests/test_parallel.py) hold its mesh functions to.  Tolerances:

* sharded ICP: 1e-4 of the JAX package's ``icp_batch`` (its
  tests/test_parallel.py bound) and bit-equal to the port's one-process
  ``icp_batch`` (each rank runs whole groups of the same pairs);
* distributed assembly: H and b within 1e-6 of max|H| of the JAX
  package's ``_assemble``, the bound tests/test_torch_graph.py holds the
  port's one-process ``_assemble`` to (the JAX package's own 1e-3 holds
  between two of its functions with the same f32 arithmetic; the port's
  one-process ``_assemble`` is 0.5 from it at |H| ~ 2.6e6 and 0.07 at
  |H| ~ 290 on this graph, whose b is f32 rounding noise in both packages:
  every SM edge is its own initial estimate, so the residuals are zero in
  exact arithmetic); against the port's one-process ``_assemble``, 4 f32
  ulp of max|H| (sums of up to four terms taken in another order);
* Schur step: 2e-4 of the JAX package's dense ``_lm_step`` at lam 1e-4
  (tests/test_parallel.py); the solve's cost below half the start and
  within 5% of the JAX package's ``solve_graph``.
"""

import concurrent.futures
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lidar_slam_arvc_tpu.graph import PoseGraph as PoseGraphRef
from lidar_slam_arvc_tpu.graph import solver as solver_ref
from lidar_slam_arvc_tpu.parallel.multihost import host_scan_shard as host_scan_shard_ref
from lidar_slam_arvc_tpu.registration import ICPParams as ICPParamsRef
from lidar_slam_arvc_tpu.registration import icp_batch as icp_batch_ref
from lidar_slam_arvc_tpu.utils import synthetic as synthetic_ref
from lidar_slam_arvc_tpu_torch.cloud import estimate_normals, from_numpy
from lidar_slam_arvc_tpu_torch.graph import PoseGraph
from lidar_slam_arvc_tpu_torch.graph.factors import FACTOR_FIELDS
from lidar_slam_arvc_tpu_torch.graph.solver import _assemble
from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.keyframes import KeyframeStore
from lidar_slam_arvc_tpu_torch.parallel import _ranks, mesh, multihost
from lidar_slam_arvc_tpu_torch.parallel.dryrun import entry, tiny_pair_batch
from lidar_slam_arvc_tpu_torch.pipeline.scanmatcher import match_all
from lidar_slam_arvc_tpu_torch.registration.icp import ICPParams, icp_batch
from lidar_slam_arvc_tpu_torch.utils import synthetic
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig

torch.set_num_threads(1)

STATE = FACTOR_FIELDS + ("poses", "n_poses", "n_chain", "n_loop", "n_gps",
                         "n_prior", "chain_capacity", "T0", "T0_gps")
ICP_PARAMS = ICPParams(max_correspondence_distance=5.0, max_iterations=5)
STORE_CFG = dict(raw_capacity=4096, capacity=2048, batch_size=2,
                 max_iterations=15)
STORE_PAIRS = np.array([[3, 4], [7, 0]])      # both across the 2 blocks
LAYOUT_PARAMS = ICPParams(max_correspondence_distance=5.0, max_iterations=10)


def state(g) -> dict:
    return {k: getattr(g, k) for k in STATE}


def chain_graph():
    """tests/test_parallel.py's 16-pose graph (TestDistributedSolver)."""
    rng = np.random.default_rng(0)
    n = 16
    T_gt = synthetic_ref.make_trajectory(n, radius=5.0)
    g = PoseGraphRef(max_poses=16, max_between=64, max_gps=16)
    g.init_graph()
    for i in range(n - 1):
        rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1]
        rel[:3, 3] += rng.normal(scale=0.01, size=3)
        g.add_initial_estimate(rel, i + 1)
        g.add_edge(rel, i, i + 1, "SM")
    return g


def loop_graph(n=48, gps=True):
    """tests/test_parallel.py's 48-pose graph (TestSchurSolver): three
    loop edges, GPS on 0/20/41 (interior) and 40 (a separator)."""
    rng = np.random.default_rng(0)
    T_gt = synthetic_ref.make_trajectory(n, radius=5.0)
    g = PoseGraphRef(max_poses=64, max_between=128, max_gps=16)
    g.init_graph()
    for i in range(n - 1):
        rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1]
        rel[:3, 3] += rng.normal(scale=0.02, size=3)
        g.add_initial_estimate(rel, i + 1)
        g.add_edge(rel, i, i + 1, "SM")
    for (a, b) in [(2, 40), (5, 30), (12, 44)]:
        g.add_edge(np.linalg.inv(T_gt[a]) @ T_gt[b], a, b, "SM")
    if gps:
        for i in (0, 20, 40, 41):
            z = T_gt[i][:3, 3] + rng.normal(scale=0.1, size=3)
            g.add_gps_factor(z[0], z[1], z[2], i)
    return g


def exchange_rows(size: int) -> np.ndarray:
    """(size, 3, 2) rows per rank, with -0.0, NaN and denormals."""
    rows = np.arange(size * 6, dtype=np.float32).reshape(size, 3, 2) + 0.5
    rows[0, 1, 0] = -0.0
    rows[-1, 2, 1] = np.nan
    rows[-1, 0, 0] = np.float32(1e-42)
    return rows


@pytest.fixture(scope="module")
def pair_batch():
    return tuple(t.numpy() for t in tiny_pair_batch(batch=8, cap=256, seed=3,
                                                     device="cpu"))


@pytest.fixture(scope="module")
def store_data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("store") / "euroc")
    info = synthetic.make_dataset(
        d, n_scans=8, seed=7, radius=8.0, scan_points=2000,
        scanmatcher_params={"voxel_size": 0.2, "method": "icppointplane",
                            "delta_time": 1.0, "start_index": 0})
    times = EurocDataset(d).read_csv("/robot0/lidar/data.csv")["#timestamp [ns]"]
    T = info["T_gt"]
    seeds = np.stack([np.linalg.inv(T[i]) @ T[j] for i, j in STORE_PAIRS]).astype(np.float32)
    return d, times, seeds


@pytest.fixture(scope="module")
def layout_stack():
    """tests/test_pipeline_mesh.py's sharded-stack layout data: 13 scans of
    512 points (over 4 ranks: K = 4 scans each, 3 padding rows, the
    cyclic wrap row) and the true relative seeds."""
    rng = np.random.default_rng(3)
    n_scans, cap = 13, 512
    world = synthetic.make_world(rng, extent=8.0, n_ground=800, n_pillars=6,
                                 pillar_pts=60)
    T_gt = synthetic.make_trajectory(n_scans, radius=5.0)
    clouds = []
    for i in range(n_scans):
        scan = synthetic.render_scan(world, T_gt[i], rng, max_range=10.0,
                                     max_points=cap)
        clouds.append(estimate_normals(from_numpy(scan, cap, device="cpu"), radius=0.6))
    stack = tuple(torch.stack([getattr(c, f) for c in clouds]).numpy()
                  for f in ("points", "mask", "normals"))
    seeds = np.stack([np.linalg.inv(T_gt[i]) @ T_gt[i + 1]
                      for i in range(n_scans - 1)]).astype(np.float32)
    return stack, seeds


@pytest.fixture(scope="module")
def groups(pair_batch, store_data, layout_stack):
    """Two groups, launched side by side (their spawns overlap): 2 ranks
    (exchange, sharded ICP, assembly, the sharded store, counters) and 4
    ranks (exchange, assembly, the Schur step and solve, a separator
    overflow, the sharded stack layout, counters)."""
    d, times, seeds = store_data
    (points, mask, normals), layout_seeds = layout_stack
    two = (_ranks.sequence,
           (_ranks.exchange, (exchange_rows(2),)),
           (_ranks.sharded_icp, (pair_batch, ICP_PARAMS)),
           (_ranks.assemble, (state(chain_graph()),)),
           (_ranks.store_pairs, (d, times, STORE_CFG, "icppointplane",
                                 STORE_PAIRS, seeds)),
           (_ranks.counters, ()))
    four = (_ranks.sequence,
            (_ranks.exchange, (exchange_rows(4),)),
            (_ranks.assemble, (state(chain_graph()),)),
            (_ranks.schur_step, (state(loop_graph()), 1e-4, 32)),
            (_ranks.schur_solve, (state(loop_graph(gps=False)), 32, 8)),
            (_ranks.schur_solve, (state(loop_graph()), 8, 2)),
            (_ranks.sharded_stack, (points, mask, normals, layout_seeds,
                                    LAYOUT_PARAMS, 2)),
            (_ranks.counters, ()))
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        runs = [ex.submit(mesh.launch, n, *call, device="cpu", timeout_s=120)
                for n, call in ((2, two), (4, four))]
        return [r.result() for r in runs]


@pytest.fixture(scope="module")
def two_ranks(groups):
    return groups[0]


@pytest.fixture(scope="module")
def four_ranks(groups):
    return groups[1]


# ------------------------------------------------------------ no group

def test_resolve_mesh_rules():
    assert not torch.distributed.is_initialized()
    assert mesh.resolve_mesh(1) is None
    assert mesh.resolve_mesh(0) is None            # every rank: one
    with pytest.raises(ValueError, match="mesh_devices=2 but the process "
                                         "group has 1 rank"):
        mesh.resolve_mesh(2)
    m = mesh.data_mesh()
    assert (m.size, m.rank, m.shape) == (1, 0, {"data": 1})
    with pytest.raises(ValueError, match="needs 3 ranks"):
        mesh.data_mesh(3)
    a = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(mesh.shard_batch(m, a)[0], a)
    two = m._replace(size=2, rank=1)
    np.testing.assert_array_equal(mesh.shard_batch(two, a)[0], a[3:])
    with pytest.raises(ValueError, match="do not divide"):
        mesh.shard_batch(two, a[:5])
    assert mesh.choose_backend(torch.device("cpu"), 4)[0] == "gloo"


@pytest.mark.parametrize("n", [1, 2, 7, 13, 103, 257])
def test_host_scan_shard_matches_reference(n):
    for pc in (1, 2, 3, 4, 8):
        for pi in range(pc):
            np.testing.assert_array_equal(
                multihost.host_scan_shard(n, pi, pc), host_scan_shard_ref(n, pi, pc))


def test_multihost_single_process_and_assemble(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    rep = multihost.initialize(device="cpu")
    assert rep["process_count"] == 1 and rep["process_index"] == 0
    assert not multihost.in_torchrun_group()
    assert not torch.distributed.is_initialized()
    m = mesh.data_mesh()
    got = multihost.assemble_global_scans(m, {"p": np.ones((4, 3))}, 4)
    assert got["p"].shape == (4, 3)
    with pytest.raises(ValueError, match="expected 4 / 2 = 2"):
        multihost.assemble_global_scans(m._replace(size=2), {"p": np.ones((3, 3))}, 4)


def test_entry_runs():
    fn, args = entry("cpu")
    out = fn(*args)
    assert out.shape == (2, 4, 4) and bool(torch.isfinite(out).all())


# ----------------------------------------------------------- two ranks

def test_ranks_are_torch_only(two_ranks, four_ranks):
    """The spawned ranks imported no JAX, no JAX-package module and no
    test module, and ran on gloo on the CPU."""
    for results in (two_ranks, four_ranks):
        for r in results:
            c = r[-1]
            assert c["foreign_modules"] == [] and c["backend"] == "gloo"
            assert c["device"] == "cpu"


@pytest.mark.parametrize("size", [2, 4])
def test_exact_gather_halo_and_counters(size, two_ranks, four_ranks):
    results = two_ranks if size == 2 else four_ranks
    rows = exchange_rows(size)
    whole = rows.reshape(size * 3, 2)
    for r, res in enumerate(results):
        ex = res[0]
        np.testing.assert_array_equal(ex["gathered"].view(np.int32), whole.view(np.int32))
        np.testing.assert_array_equal(ex["halo"].view(np.int32),
                                      rows[(r + 1) % size, 0].view(np.int32))
        moved = {k: ex["after"][k]["calls"] - ex["before"][k]["calls"]
                 for k in ex["after"]}
        assert moved == {"reduce": 0, "gather": 1, "halo": 1, "broadcast": 0,
                         "barrier": 0}
        assert ex["after"]["gather"]["bytes"] - ex["before"]["gather"]["bytes"] \
            == whole.nbytes


def test_sharded_icp_matches_reference_and_one_process(two_ranks, pair_batch):
    ref = icp_batch_ref(*(jnp.asarray(a) for a in pair_batch),
                        ICPParamsRef(max_correspondence_distance=5.0,
                                     max_iterations=5, nn_impl="vpu_t"),
                        "point_to_plane")
    one = icp_batch(*(torch.from_numpy(a) for a in pair_batch), ICP_PARAMS,
                    "point_to_plane")
    for res in two_ranks:
        got = res[1]
        np.testing.assert_allclose(got["transform"], np.asarray(ref.transform),
                                   atol=1e-4)
        for k, v in one._asdict().items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("size", [2, 4])
def test_distributed_assemble_matches(size, two_ranks, four_ranks):
    g = chain_graph()
    H_ref, b_ref = map(np.asarray, solver_ref._assemble(
        jnp.asarray(g.poses), g._factor_data(), jnp.int32(g.n_poses)))
    p = PoseGraph.from_reference_state(state(g), device="cpu")
    H1, b1 = (t.numpy() for t in _assemble(torch.from_numpy(p.poses),
                                           p._factor_data(), p.n_poses))
    scale = np.abs(H_ref).max()
    ulp4 = 4 * np.spacing(np.float32(scale))
    results = two_ranks if size == 2 else four_ranks
    for res in results:
        a = res[1] if size == 4 else res[2]
        np.testing.assert_allclose(a["H"] / scale, H_ref / scale, atol=1e-6)
        np.testing.assert_allclose(a["b"] / scale, b_ref / scale, atol=1e-6)
        np.testing.assert_allclose(a["H"], H1, atol=ulp4, rtol=0)
        np.testing.assert_allclose(a["b"], b1, atol=ulp4, rtol=0)
        # one distributed LM step does not raise the cost
        assert a["cost1"] <= a["cost0"] + 1e-6


def test_sharded_store_matches_one_rank(two_ranks, store_data):
    """The store sharded over 2 ranks, each loading only its block of 4
    scans, registers the pairs bit for bit as one store holding every scan
    (the rows each pair addresses are gathered exactly; the pairs cross
    the blocks)."""
    d, times, seeds = store_data
    one = KeyframeStore(d, times, cfg=IcpConfig(**STORE_CFG), device="cpu")
    T1 = one.load_and_preprocess().compute_transformations_batch(STORE_PAIRS, seeds)
    for res in two_ranks:
        got = res[3]
        np.testing.assert_array_equal(got["T"], T1)
        assert got["rows"] == 4 and got["loaded"] == 4


def test_failing_rank_fails_the_launch():
    """A rank that raises while the other waits in a collective fails the
    launch with its message, within the failure grace, not a hang."""
    t0 = time.time()
    with pytest.raises(mesh.RankError, match="only rank 1") as exc:
        mesh.launch(2, _ranks.fail_on, [1], "only rank 1", device="cpu",
                    timeout_s=60)
    assert 1 in exc.value.errors
    assert time.time() - t0 < 60


# ---------------------------------------------------------- four ranks

def test_schur_step_matches_dense(four_ranks):
    g = loop_graph()
    ref, _ = solver_ref._lm_step(jnp.asarray(g.poses), g._factor_data(),
                                 jnp.int32(g.n_poses), jnp.float32(1e-4))
    ref = np.asarray(ref)
    first = four_ranks[0][2]
    for res in four_ranks:
        st = res[2]
        assert st["n_sep"] <= 32
        np.testing.assert_allclose(st["poses"][:g.n_poses], ref[:g.n_poses],
                                   atol=2e-4)
        np.testing.assert_array_equal(st["poses"], first["poses"])


def test_schur_solve_converges(four_ranks):
    g = loop_graph(gps=False)
    _, c_dense = solver_ref.solve_graph(jnp.asarray(g.poses), g._factor_data(),
                                        g.n_poses, max_iterations=8)
    for res in four_ranks:
        so = res[3]
        assert so["cost"] < 0.5 * so["cost0"]
        assert so["cost"] <= 1.05 * float(c_dense) + 1e-6


def test_separator_overflow_raises_in_every_rank(four_ranks):
    for res in four_ranks:
        assert "separator count" in res[4]["error"], res[4]


def test_sharded_stack_layout(four_ranks, layout_stack):
    """13 scans over 4 ranks (padding rows, the cyclic wrap row, 3 pairs
    whose source is a halo): every pair bit-equal to the one-process
    matcher on the same clouds."""
    (points, mask, normals), seeds = layout_stack
    n = points.shape[0]
    T1, _, _, _ = match_all(*(torch.from_numpy(a) for a in (points, mask, normals)),
                            torch.arange(1, n), torch.arange(0, n - 1),
                            torch.from_numpy(seeds), LAYOUT_PARAMS,
                            "point_to_plane", 2)
    for res in four_ranks:
        got = res[5]
        assert got["T"].shape == (n - 1, 4, 4) and (got["fitness"] > 0.5).all()
        np.testing.assert_array_equal(got["T"], T1.numpy())
