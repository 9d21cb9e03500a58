"""The icp2planes registration method of the PyTorch port vs the JAX
package on the CPU: Euler angles, the RANSAC ground plane and the split,
the two-plane ICP, stage 1 under ``method: icp2planes``, the keyframe
store's dispatch and the CLI under this method.

Both packages get the same numpy inputs.  The ground plane draws from
``jax.random`` in the reference and from a torch generator in the port;
the parity tests inject the reference's own draws (its
``jax.random.categorical`` indices) into the port.  The JAX side runs the
two TPU kernels the port replaces (K1, K2) in Pallas interpret mode, as
tests/test_torch_stage1.py does.  Tolerances:

* Euler rotations and transforms: 1e-6 (f32 sin/cos of both sides);
* the plane with the reference's draws: 1e-5 (the hypotheses' counts are
  integers, the least-squares refinement sums in another f32 order; it
  measured 1.2e-7), the ground/non-ground masks equal;
* the two-plane ICP: 1e-4 m / 1e-4 rad, tests/test_torch_stage1.py's ICP
  bound; the one batch of 2B pairs equals the two ICPs run apart;
* stage 1 end to end: relative transforms within 5e-3 m / 1e-3 rad and
  the same pairs fallen back to their seed.  The draws are the
  reference's, so what is left is f32 rounding in the ground ICP, whose
  x, y and yaw only the Tikhonov floor holds: the fused tz, alpha and beta
  inherit its drift there (measured: 3.0e-3 m and 4.3e-5 rad on the worst
  pair).  The reference's own spread over three keys on this dataset is
  1.45e-2 m (``stage2_parity.py``'s key offsets; the other pairs agree
  exactly across its keys).
"""

import importlib
import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu import cloud as cl_ref
from lidar_slam_arvc_tpu.cloud import normals as normals_ref
from lidar_slam_arvc_tpu.io import EurocDataset as EurocRef
from lidar_slam_arvc_tpu.pipeline import preprocess as prep_ref
from lidar_slam_arvc_tpu.pipeline import scanmatcher as sm_ref
from lidar_slam_arvc_tpu.registration import ICPParams as ICPParamsRef
from lidar_slam_arvc_tpu.registration import icp_two_planes as two_planes_ref
from lidar_slam_arvc_tpu.utils.config import IcpConfig as IcpConfigRef
from lidar_slam_arvc_tpu_torch import cloud as cl
from lidar_slam_arvc_tpu_torch.cloud import plane
from lidar_slam_arvc_tpu_torch.geom import se3
from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.keyframes import KeyframeStore
from lidar_slam_arvc_tpu_torch.pipeline import cli
from lidar_slam_arvc_tpu_torch.pipeline import preprocess as prep
from lidar_slam_arvc_tpu_torch.pipeline import scanmatcher as sm
from lidar_slam_arvc_tpu_torch.registration import ICPParams, icp_batch, icp_two_planes
from lidar_slam_arvc_tpu_torch.utils import synthetic
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
from lidar_slam_arvc_tpu_torch.utils.metrics import ate

torch.set_num_threads(1)
# both packages' geom/__init__ export functions named like their modules
rotations = importlib.import_module("lidar_slam_arvc_tpu_torch.geom.rotations")
rot_ref = importlib.import_module("lidar_slam_arvc_tpu.geom.rotations")
se3_ref = importlib.import_module("lidar_slam_arvc_tpu.geom.se3")
# the port's registration/__init__ exports a function named like its icp module
icp_mod = importlib.import_module("lidar_slam_arvc_tpu_torch.registration.icp")

CAP = 1024
PARAMS_REF = ICPParamsRef(max_correspondence_distance=5.0, max_iterations=25,
                          nn_impl="vpu_t")
PARAMS = ICPParams(**PARAMS_REF._asdict())
ITERS = 1000


def pose_err(T_a, T_b):
    D = np.linalg.inv(np.asarray(T_a, np.float64)) @ np.asarray(T_b, np.float64)
    R = D[..., :3, :3]
    skew = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    return (np.linalg.norm(D[..., :3, 3], axis=-1),
            np.arcsin(np.clip(np.linalg.norm(skew, axis=-1) / 2, 0, 1)))


def reference_sample(c, key, seed_height=-0.5):
    """The reference's (ITERS, 3) triplet indices for its cloud ``c``
    (numpy points and mask) under ``key``: its logits and guard."""
    pts, mask = (np.asarray(a) for a in c)
    cand = mask & (pts[:, 2] < seed_height)
    logits = np.where(cand, 0.0, -np.inf) if cand.any() else np.zeros(len(cand))
    return np.array(jax.random.categorical(key, jnp.asarray(logits, jnp.float32),
                                             shape=(ITERS, 3)))


@pytest.fixture(scope="module")
def scans():
    """Four voxelised scans of bench.py's world with normals, made by the
    port (K2's plain version) and handed to both packages as the JAX
    package's Clouds."""
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng, extent=20.0, n_ground=8000,
                                 n_pillars=0, n_boxes=12)
    T = synthetic.make_trajectory(40, radius=8.0)[:4]
    out = []
    for Ti in T:
        c = cl.from_numpy(synthetic.render_scan(world, Ti, rng, max_points=2500),
                          CAP, device="cpu")
        c = cl.crop_radius_height(c, 0.5, 35.0, -1.0, 50.0)
        c = cl.estimate_normals(cl.voxel_downsample(c, 0.2), 0.5)
        out.append(cl_ref.Cloud(*(jnp.asarray(x.numpy())
                                  for x in (c.points, c.mask, c.normals))))
    return out, T


def _port(clouds):
    return cl.Cloud(*(torch.from_numpy(np.stack([np.array(getattr(c, f)) for c in clouds]))
                      for f in ("points", "mask", "normals")))


def test_euler_to_rot_and_transform_from_euler_match_reference():
    rng = np.random.default_rng(1)
    abg = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    abg[0] = 0.0
    abg[1] = [0.3, np.pi / 2, -0.2]                     # gimbal lock
    pos = rng.normal(size=(64, 3)).astype(np.float32)
    R_ref, T_ref = map(np.asarray, jax.jit(lambda pos, abg: (
        rot_ref.euler_to_rot(abg), se3_ref.transform_from_euler(pos, abg)))(pos, abg))
    R = rotations.euler_to_rot(torch.from_numpy(abg)).numpy()
    np.testing.assert_allclose(R, R_ref, atol=1e-6)
    T = se3.transform_from_euler(torch.from_numpy(pos), torch.from_numpy(abg)).numpy()
    np.testing.assert_allclose(T, T_ref, atol=1e-6)


@pytest.mark.parametrize("case", ["scan0", "scan1", "scan3", "no_candidates",
                                  "degenerate_first"])
def test_ransac_plane_and_split_match_reference(scans, case):
    """The plane from the reference's draws, its refinement and the split.
    ``no_candidates``: every point above the seed height, so both packages
    draw over all rows (the guard) and keep hypothesis 0's plane;
    ``degenerate_first``: hypothesis 0 is one point thrice (a zero normal
    whose 'plane' holds every candidate): its count of -1 keeps it from
    winning."""
    clouds, _ = scans
    c = clouds[int(case[-1]) if case.startswith("scan") else 2]
    key = jax.random.PRNGKey(17)
    if case == "no_candidates":
        c = cl_ref.Cloud(c.points + jnp.asarray([0.0, 0.0, 5.0]), c.mask, c.normals)
    idx = reference_sample((c.points, c.mask), key)
    if case == "degenerate_first":
        idx[0] = idx[1, 0]
    ref = np.asarray(prep_ref.cl.ransac_ground_plane(c, key) if case != "degenerate_first"
                     else _plane_from_sample_ref(c, idx))
    got = plane.ransac_ground_plane(_port([c]), sample_idx=torch.from_numpy(idx)[None])
    np.testing.assert_allclose(got[0].numpy(), ref, atol=1e-5)
    g_ref, ng_ref = cl_ref.split_by_plane(c, jnp.asarray(ref), 0.4)
    g, ng = plane.split_by_plane(_port([c]), got, 0.4)
    np.testing.assert_array_equal(g.mask[0].numpy(), np.asarray(g_ref.mask))
    np.testing.assert_array_equal(ng.mask[0].numpy(), np.asarray(ng_ref.mask))
    if case.startswith("scan"):
        assert 50 < int(g.mask.sum()) < int(c.mask.sum())
        lsq_ref = cl_ref.refine_plane_lsq(c.points, g_ref.mask, jnp.zeros(4))
        lsq = plane.refine_plane_lsq(_port([c]).points, g.mask, torch.zeros(1, 4))
        np.testing.assert_allclose(lsq[0].numpy(), np.asarray(lsq_ref), atol=1e-5)


def _plane_from_sample_ref(c, idx):
    """The reference's ransac_ground_plane body on given indices (its
    draw replaced), for a sample it would not draw itself."""
    pts = c.points
    cand = c.mask & (pts[:, 2] < -0.5)
    p0, p1, p2 = (pts[idx[:, k]] for k in range(3))
    n = jnp.cross(p1 - p0, p2 - p0)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)
    d = -jnp.sum(n * p0, axis=-1)
    dist = jnp.abs(jnp.dot(n, pts.T, precision=jax.lax.Precision.HIGHEST) + d[:, None])
    inlier = (dist < 0.01) & cand[None, :]
    counts = jnp.where(norm[:, 0] > 1e-9, jnp.sum(inlier, axis=1), -1)
    best = jnp.argmax(counts)
    assert int(best) != 0 and int(jnp.sum(inlier[0])) > int(counts[best])
    fallback = jnp.concatenate([n[best], d[best][None]])
    return cl_ref.refine_plane_lsq(pts, inlier[best], fallback=fallback)


def test_ground_draws_do_not_depend_on_the_batch(scans):
    """Scan i's plane draws from its own generator, so the masks of a
    stack preprocessed in batches of 2 and of 3 are equal."""
    clouds, _ = scans
    raw = np.zeros((4, 4096, 3), np.float32)
    raw_mask = np.zeros((4, 4096), bool)
    for k, c in enumerate(clouds):
        m = np.asarray(c.mask)
        raw[k, :m.sum()] = np.asarray(c.points)[m]
        raw_mask[k, :m.sum()] = True
    outs = [sm.preprocess_all(raw, raw_mask, IcpConfig(capacity=CAP, batch_size=b),
                              "icp2planes", None, seed=3, device="cpu")[0] for b in (2, 3)]
    for f in ("ground_mask", "nonground_mask", "normals"):
        np.testing.assert_array_equal(getattr(outs[0], f).numpy(),
                                      getattr(outs[1], f).numpy())
    assert (outs[0].ground_mask & outs[0].nonground_mask).sum() == 0
    assert outs[0].ground_mask.sum(1).min() > 50


def _split_ref(c, k):
    p = cl_ref.ransac_ground_plane(c, jax.random.PRNGKey(k))
    return cl_ref.split_by_plane(c, p, 0.4)


def test_icp_two_planes_matches_reference(scans):
    """Two pairs (scan 1 onto 0, 3 onto 2) on the reference's clouds and
    masks; the one ICP batch of 2B pairs equals the two ICPs apart."""
    clouds, T = scans
    split = [_split_ref(c, k) for k, c in enumerate(clouds)]
    seeds = np.stack([np.linalg.inv(T[i]) @ T[i + 1] @ synthetic._yaw_T(0.06, -0.04, 0.02)
                      for i in (0, 2)]).astype(np.float32)
    ref = [two_planes_ref(split[j][0], split[i][0], split[j][1], split[i][1],
                          jnp.asarray(seeds[k]), PARAMS_REF)
           for k, (i, j) in enumerate([(0, 1), (2, 3)])]
    port = lambda ks, half: _port([split[k][half] for k in ks])   # noqa: E731
    sg, tg, sng, tng = port([1, 3], 0), port([0, 2], 0), port([1, 3], 1), port([0, 2], 1)
    got = icp_two_planes(sg, tg, sng, tng, torch.from_numpy(seeds), PARAMS)
    T_ref = np.stack([np.asarray(r.transform) for r in ref])
    dpos, drot = pose_err(got.transform.numpy(), T_ref)
    assert dpos.max() < 1e-4 and drot.max() < 1e-4, (dpos, drot)
    np.testing.assert_allclose(got.fitness.numpy(), [float(r.fitness) for r in ref], atol=2e-3)
    assert np.abs(got.iterations.numpy() - [int(r.iterations) for r in ref]).max() <= 2
    assert pose_err(got.transform.numpy(),
                    [np.linalg.inv(T[i]) @ T[i + 1] for i in (0, 2)])[0].max() < 0.05

    apart = [icp_batch(s.points, s.mask, t.points, t.mask, t.normals,
                       torch.from_numpy(seeds), PARAMS) for s, t in ((sg, tg), (sng, tng))]
    t1, t2 = (se3.t2v(r.transform) for r in apart)
    fused = se3.transform_from_euler(torch.stack([t2[:, 0], t2[:, 1], t1[:, 2]], -1),
                                     torch.stack([t1[:, 3], t1[:, 4], t2[:, 5]], -1))
    np.testing.assert_array_equal(got.transform.numpy(), fused.numpy())
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  (apart[0].iterations + apart[1].iterations).numpy())
    np.testing.assert_array_equal(got.fitness.numpy(), apart[1].fitness.numpy())


@pytest.fixture
def reference_draws(monkeypatch):
    """Make the port's ground planes draw the reference's triplets: scan i
    of a run seeded s takes key i of split(PRNGKey(s), n_keys), as the
    reference's streamed preprocessing keys it.  Returns a setter for
    n_keys (the scan count padded to the batch)."""
    state = {}
    real = plane.ransac_ground_plane

    def planted(c, generators, **kw):
        idx = []
        for k, (seed, i) in enumerate(generators):
            keys = jax.random.split(jax.random.PRNGKey(seed), state["n_keys"])
            idx.append(reference_sample((c.points[k].numpy(), c.mask[k].numpy()),
                                        keys[i]))
        return real(c, sample_idx=torch.from_numpy(np.stack(idx)), **kw)

    monkeypatch.setattr(sm, "seeded_generator", lambda seed, i: (seed, i))
    monkeypatch.setattr(prep.cl, "ransac_ground_plane", planted)
    monkeypatch.setattr(sm_ref, "ICPParams",
                        lambda **kw: ICPParamsRef(nn_impl="vpu_t", **kw))
    monkeypatch.setattr(
        prep_ref.cl, "estimate_normals",
        lambda c, r: normals_ref.estimate_normals(c, r, impl="pallas_interpret"))
    return lambda n: state.update(n_keys=n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("planes") / "euroc")
    info = synthetic.make_dataset(
        d, n_scans=7, seed=1, radius=8.0, scan_points=2500,
        world_kwargs={"extent": 20.0, "n_ground": 8000, "n_pillars": 0,
                      "n_boxes": 15},
        scanmatcher_params={"voxel_size": 0.25, "method": "icp2planes"})
    return d, info


def test_scanmatcher_icp2planes_matches_reference(dataset, tmp_path, reference_draws):
    """The slice as a whole: stage 1 of both packages under icp2planes, the
    port through its CLI with the reference's plane draws injected."""
    d, info = dataset
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(d, d_ref)
    shutil.copytree(d, d_port)
    reference_draws(8)                   # 7 scans padded to batches of 4
    out_ref = sm_ref.run_scanmatcher(d_ref, cfg=IcpConfigRef(capacity=CAP),
                                     progress=False)
    assert cli.main(["scanmatch", "-i", d_port, "--capacity", str(CAP),
                     "--device", "cpu"]) == 0
    path = "/robot0/scanmatcher/scanmatcher_relative.csv"
    _, T_rel = EurocDataset(d_port).read_trajectory(path)
    _, T_rel_ref = EurocRef(d_ref).read_trajectory(path)
    dpos, drot = pose_err(T_rel, T_rel_ref)
    assert dpos.max() < 5e-3 and drot.max() < 1e-3, (dpos, drot)
    seeds = sm.relative_odometry(sm.prepare_experiment_data(
        EurocDataset(d), 0, 1.0)[3]).astype(np.float32).astype(np.float64)
    fell_ref = [np.array_equal(a, b) for a, b in zip(out_ref["relative"], seeds)]
    with open(d_port + "/robot0/viz/scanmatcher_profile.json") as f:
        prof = json.load(f)
    assert prof["pairs_fallback_to_seed"] == sum(fell_ref)
    _, T_glob = EurocDataset(d_port).read_trajectory("/robot0/scanmatcher/scanmatcher_global.csv")
    assert ate(T_glob, info["T_gt"])["rmse"] < 0.2


def test_store_registers_through_two_planes(dataset, monkeypatch):
    """The store under icp2planes loads the split scans and registers a
    known pair through the two-plane ICP (a spy counts the calls)."""
    d, info = dataset
    calls = []
    real = icp_mod.icp_two_planes
    monkeypatch.setattr(icp_mod, "icp_two_planes",
                        lambda *a, **kw: calls.append(len(a[-2])) or real(*a, **kw))
    times = EurocDataset(d).read_csv("/robot0/lidar/data.csv")["#timestamp [ns]"]
    store = KeyframeStore(d, times, method="icp2planes",
                          cfg=IcpConfig(capacity=2048), device="cpu")
    store.load_and_preprocess()
    assert store.ground_mask.shape == store.mask.shape
    assert (store.ground_mask & ~store.mask).sum() == 0
    T_gt = info["T_gt"]
    pairs = np.array([[0, 1], [4, 6]])
    seeds = np.stack([np.linalg.inv(T_gt[i]) @ T_gt[j] @ synthetic._yaw_T(0.05, -0.03, 0.01)
                      for i, j in pairs]).astype(np.float32)
    T = store.compute_transformations_batch(pairs, seeds)
    assert calls == [2]
    dpos, drot = pose_err(T, [np.linalg.inv(T_gt[i]) @ T_gt[j] for i, j in pairs])
    assert dpos.max() < 0.05 and drot.max() < 0.01, (dpos, drot)


def test_run_cli_under_icp2planes(tmp_path):
    """``cli run`` under icp2planes at full resolution on a small closed
    circle: stage 2's store reuses stage 1's tensors and masks (same seed)
    and closes loops with the two-plane ICP; ``cli graph`` reloads the
    store."""
    d = str(tmp_path / "run")
    info = synthetic.make_dataset(
        d, n_scans=20, seed=14, radius=3.0, scan_points=600,
        world_kwargs={"extent": 12.0, "n_ground": 2000, "n_pillars": 0,
                      "n_boxes": 8},
        scanmatcher_params={"voxel_size": None, "method": "icp2planes"},
        slam_params={"method": "icp2planes", "skip_loop_closing": 5,
                     "skip_optimization": 5, "number_of_triplets_loop_closing": 2})
    argv = ["-i", d, "--capacity", "512", "--batch-size", "4", "--device", "cpu"]
    assert cli.main(["run"] + argv) == 0
    with open(d + "/robot0/viz/graphslam_profile.json") as f:
        prof = json.load(f)
    assert prof["method"] == "icp2planes" and prof["store_reused_stage1"] is True
    assert prof["loop_icp_pairs"] > 0
    _, T = EurocDataset(d).read_trajectory("/robot0/SLAM/solution_graphslam.csv")
    assert ate(T, info["T_gt"])["rmse"] < 0.2
    assert cli.main(["graph"] + argv) == 0
    with open(d + "/robot0/viz/graphslam_profile.json") as f:
        assert json.load(f)["store_reused_stage1"] is False


def test_stage2_reuses_stage1_only_under_the_store_seed(tmp_path, monkeypatch):
    """``run_scanmatcher(seed=)`` keys stage 1's ground-plane draws and
    travels with its tensors; stage 2 reuses them only when they were drawn
    under the seed its store draws from (``PLANE_SEED``)."""
    from lidar_slam_arvc_tpu_torch.pipeline import graphslam
    d = str(tmp_path / "seed")
    synthetic.make_dataset(
        d, n_scans=4, seed=14, radius=3.0, scan_points=600,
        world_kwargs={"extent": 12.0, "n_ground": 2000, "n_pillars": 0,
                      "n_boxes": 8},
        scanmatcher_params={"voxel_size": None, "method": "icp2planes"})
    cfg = IcpConfig(raw_capacity=1024, capacity=512, batch_size=4)
    keyed = []
    real = sm.seeded_generator
    monkeypatch.setattr(sm, "seeded_generator",
                        lambda *s: keyed.append(s) or real(*s))
    pre = {}
    for seed in (prep.PLANE_SEED, prep.PLANE_SEED + 1):
        pre[seed] = sm.run_scanmatcher(d, cfg=cfg, progress=False, device="cpu",
                                       return_preprocessed=True,
                                       seed=seed)["preprocessed"]
        assert pre[seed]["seed"] == seed
    assert keyed == [(s, i) for s in (prep.PLANE_SEED, prep.PLANE_SEED + 1)
                     for i in range(4)]
    times = pre[prep.PLANE_SEED]["scan_times"]
    assert graphslam._reusable(pre[prep.PLANE_SEED], "icp2planes", cfg, times)
    assert not graphslam._reusable(pre[prep.PLANE_SEED + 1], "icp2planes", cfg, times)
