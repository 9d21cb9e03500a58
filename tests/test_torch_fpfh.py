"""The fpfh registration method of the PyTorch port vs the JAX package on
the CPU: the feature searches (``nn2_search``, ``nn_search_xla`` at 33
dims), FPFH descriptors, the 3-point transform, the RANSAC registration,
stage 1 under ``method: fpfh``, the keyframe store's dispatch and the CLI.

Both packages get the same numpy inputs; draw-dependent functions get the
reference's own draws (its ``jax.random.categorical`` indices).
Tolerances:

* feature searches: indices equal on well-separated features (the
  matmul form's cancellation at |f|^2 ~ 3e4 leaves ~3e-3 of f32 error in
  d2, so near-equal features could swap); d2 within 1e-6 x (|s|^2 + |t|^2)
  (a few f32 roundings of the larger term);
* FPFH: every valid row within 1e-4 of the reference (measured 1.5e-5 at
  most, ulp(100) = 7.6e-6: on the CPU no pair changes bin);
* the 3-point transform: 1e-5;
* RANSAC with the reference's features and draws: T within 1e-4, score
  within 1e-4 relative;
* stage 1 end to end, with the reference's draws for the ground planes
  and the RANSAC hypotheses: relative transforms within 1e-3 m / 1e-3 rad
  (tests/test_torch_stage1.py's end-to-end bound) and the same pairs
  fallen back to their seed.  At this size the method itself often fails
  (RANSAC lands metres off, in the reference as in the port); with the
  same draws both fail alike.  Without them the reference's own results
  spread over its keys by metres here (its three keys on 5 box-world scans
  at capacity 2048: up to 14.3 m on one pair), so no tolerance short of
  that would hold draws of another generator.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu import cloud as cl_ref
from lidar_slam_arvc_tpu.cloud.fpfh import compute_fpfh as fpfh_ref
from lidar_slam_arvc_tpu.io import EurocDataset as EurocRef
from lidar_slam_arvc_tpu.pipeline import scanmatcher as sm_ref
from lidar_slam_arvc_tpu.utils.config import IcpConfig as IcpConfigRef
from lidar_slam_arvc_tpu.ops import nn2_search as nn2_ref
from lidar_slam_arvc_tpu.ops import nn_search as nn_ref
from lidar_slam_arvc_tpu.registration import global_reg as greg_ref
from lidar_slam_arvc_tpu_torch import cloud as cl
from lidar_slam_arvc_tpu_torch.cloud.fpfh import compute_fpfh
from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.keyframes import KeyframeStore
from lidar_slam_arvc_tpu_torch.ops.nn import nn2_search, nn_search_xla
from lidar_slam_arvc_tpu_torch.pipeline import cli
from lidar_slam_arvc_tpu_torch.pipeline import scanmatcher as sm
from lidar_slam_arvc_tpu_torch.registration import global_reg
from lidar_slam_arvc_tpu_torch.utils import synthetic
from lidar_slam_arvc_tpu_torch.utils.metrics import ate
from lidar_slam_arvc_tpu_torch.utils.workload import BOX_WORLD
from test_torch_plane import reference_draws  # noqa: F401  (a fixture)

torch.set_num_threads(1)

CAP = 1024


def pose_err(T_a, T_b):
    D = np.linalg.inv(np.asarray(T_a, np.float64)) @ np.asarray(T_b, np.float64)
    R = D[..., :3, :3]
    skew = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    return (np.linalg.norm(D[..., :3, 3], axis=-1),
            np.arcsin(np.clip(np.linalg.norm(skew, axis=-1) / 2, 0, 1)))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.fixture(scope="module")
def scene():
    """tests/test_global_reg.py's box world: two scans 2.3 m and 0.6 rad
    apart, voxelised at 0.2 m into capacity CAP, normals at r = 0.4, made
    by the port and handed to both packages as the JAX package's Clouds."""
    rng = np.random.default_rng(11)
    world = synthetic.make_world(rng, **BOX_WORLD)
    T_i, T_j = synthetic._yaw_T(0.0, 0.0, 0.0), synthetic._yaw_T(2.0, 1.0, 0.6)
    clouds = []
    for T in (T_i, T_j):
        c = cl.from_numpy(synthetic.render_scan(world, T, rng, max_range=10.0,
                                                max_points=3000), CAP, device="cpu")
        c = cl.crop_radius_height(c, 0.5, 35.0, -1.0, 50.0)
        c = cl.estimate_normals(cl.voxel_downsample(c, 0.2), radius=0.4)
        clouds.append(cl_ref.Cloud(*(jnp.asarray(x.numpy())
                                     for x in (c.points, c.mask, c.normals))))
    return clouds, np.linalg.inv(T_i) @ T_j


@pytest.fixture(scope="module")
def reference_features(scene):
    """The JAX package's FPFH of the scene's two clouds."""
    return [fpfh_ref(c, 1.0, query_block=256, tgt_block=256) for c in scene[0]]


@pytest.mark.parametrize("D", [3, 33])
def test_feature_searches_match_reference(D):
    """nn2_search and nn_search_xla at D = 3 and at the features' 33, on
    well-separated rows (a random lattice offset), with masked targets and
    exact duplicates (a tie: d2_2 == d2_1, the first index wins)."""
    rng = np.random.default_rng(D)
    tgt = (rng.integers(0, 40, (600, D)) * 2.5).astype(np.float32)
    tgt[300:320] = tgt[0:20]
    src = (tgt[rng.integers(0, 600, 400)]
           + rng.normal(scale=0.05, size=(400, D))).astype(np.float32)
    mask = rng.uniform(size=600) > 0.2
    mask[:20] = True
    mask[300:320] = True
    i1, a1, a2 = nn2_ref(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
                         src_block=128, tgt_block=256)
    j1, b1, b2 = nn2_search(*_t(src, tgt, mask), src_block=96)
    np.testing.assert_array_equal(j1.numpy(), np.asarray(i1))
    scale = 1e-6 * (np.sum(src ** 2, -1) + np.sum(tgt ** 2, -1)[j1.numpy()])
    assert (np.abs(b1.numpy() - np.asarray(a1)) <= scale).all()
    assert (np.abs(b2.numpy() - np.asarray(a2)) <= scale).all()
    dup = np.isin(j1.numpy(), np.arange(20))
    assert dup.any() and (b2.numpy()[dup] == b1.numpy()[dup]).all()
    k, e = nn_ref(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask))
    k2, e2 = nn_search_xla(*_t(src, tgt, mask))
    np.testing.assert_array_equal(k2.numpy(), np.asarray(k))
    assert (np.abs(e2.numpy() - np.asarray(e)) <= scale).all()
    # batched as the port's registration calls them
    jb, _, _ = nn2_search(*(x[None].expand(2, *x.shape) for x in _t(src, tgt, mask)))
    np.testing.assert_array_equal(jb.numpy(), np.stack([j1.numpy()] * 2))


def test_fpfh_matches_reference(scene, reference_features):
    clouds, _ = scene
    c = clouds[0]
    ref = np.asarray(reference_features[0])
    port = cl.Cloud(*(x[None] for x in _t(c.points, c.mask, c.normals)))
    got = compute_fpfh(port, 1.0)
    assert got.shape == (1, CAP, 33)
    m = np.asarray(c.mask)
    np.testing.assert_allclose(got[0].numpy()[m], ref[m], atol=1e-4)
    assert (got[0].numpy()[~m] == 0).all()
    # query blocks of another size give the same numbers
    small = compute_fpfh(port, 1.0, max_pairs=1 << 16)
    np.testing.assert_array_equal(small.numpy(), got.numpy())


def test_three_point_transform_matches_reference():
    rng = np.random.default_rng(5)
    ps = rng.normal(scale=3.0, size=(64, 3, 3)).astype(np.float32)
    T_true = synthetic._yaw_T(1.0, -2.0, 0.7, 0.3).astype(np.float32)
    qs = (ps @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    ref = np.asarray(jax.jit(greg_ref._three_point_transform)(ps, qs))
    got = global_reg._three_point_transform(*_t(ps, qs)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, np.broadcast_to(T_true, got.shape), atol=1e-4)


def test_ransac_registration_matches_reference(scene, reference_features):
    """The reference's features, correspondences and hypothesis draws in
    both packages: the same winning transform and score."""
    clouds, T_gt = scene
    feats = reference_features
    src, tgt = clouds[1], clouds[0]
    key = jax.random.PRNGKey(3)
    params = greg_ref.GlobalRegParams(fpfh_radius=1.0)
    T_ref, score_ref = greg_ref.ransac_feature_registration(
        src, feats[1], tgt, feats[0], key, params)
    _, mutual = greg_ref._feature_correspondences(feats[1], src.mask, feats[0], tgt.mask)
    logits = jnp.where(mutual, 0.0, -jnp.inf)
    sel = jax.random.categorical(key, logits, shape=(params.num_hypotheses, 3))
    port = [cl.Cloud(*(x[None] for x in _t(c.points, c.mask, c.normals))) for c in (src, tgt)]
    f_src, f_tgt = (x[None] for x in _t(feats[1], feats[0]))
    _, mutual_port = global_reg._feature_correspondences(f_src, port[0].mask, f_tgt,
                                                         port[1].mask)
    np.testing.assert_array_equal(mutual_port[0].numpy(), np.asarray(mutual))
    T, score = global_reg.ransac_feature_registration(
        port[0], f_src, port[1], f_tgt, global_reg.GlobalRegParams(fpfh_radius=1.0),
        sel=torch.from_numpy(np.array(sel))[None])
    dpos, drot = pose_err(T[0].numpy(), np.asarray(T_ref))
    assert dpos < 1e-4 and drot < 1e-4, (dpos, drot)
    np.testing.assert_allclose(float(score[0]), float(score_ref), rtol=1e-4)
    # from the port's own draws, the coarse transform then ICP register
    # the pair (the coarse one lands ~0.7 m off at this capacity)
    res = global_reg.global_registration(
        port[0], port[1], global_reg.GlobalRegParams(fpfh_radius=1.0),
        torch.Generator().manual_seed(0), src_feat=f_src, tgt_feat=f_tgt)
    dpos, drot = pose_err(res.transform[0].numpy(), T_gt)
    assert dpos < 0.05 and drot < 0.01, (dpos, drot)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fpfh") / "euroc")
    info = synthetic.make_dataset(
        d, n_scans=5, seed=2, radius=5.0, scan_points=2500, max_range=10.0,
        world_kwargs=BOX_WORLD,
        scanmatcher_params={"voxel_size": 0.25, "method": "fpfh"},
        slam_params={"method": "fpfh"})
    return d, info


@pytest.fixture
def reference_ransac(monkeypatch):
    """Make the port's fpfh matcher draw the reference's hypotheses: group
    g of pairs keys pair k with split(PRNGKey(g), B)[k] over the mutual
    matches, as the reference's matcher does (the port's group generator
    is seeded g, and its correspondences equal the reference's here)."""
    def planted(points, mask, normals, ngm, feats, si, ti, params, generator):
        _, mutual = global_reg._feature_correspondences(
            feats[si], ngm[si], feats[ti], ngm[ti])
        keys = jax.random.split(jax.random.PRNGKey(generator.initial_seed()), len(si))
        sel = np.stack([np.array(jax.random.categorical(
            keys[k], jnp.where(jnp.asarray(m.numpy()), 0.0, -jnp.inf),
            shape=(params.num_hypotheses, 3))) for k, m in enumerate(mutual)])
        return global_reg.global_registration(
            cl.Cloud(points[si], mask[si], normals[si]),
            cl.Cloud(points[ti], mask[ti], normals[ti]), params,
            src_nonground=cl.Cloud(points[si], ngm[si], normals[si]),
            tgt_nonground=cl.Cloud(points[ti], ngm[ti], normals[ti]),
            src_feat=feats[si], tgt_feat=feats[ti], sel=torch.from_numpy(sel))

    monkeypatch.setattr(sm, "fpfh_pairs", planted)


def test_scanmatcher_fpfh_matches_reference(dataset, tmp_path, reference_draws,
                                            reference_ransac):
    """The slice as a whole: stage 1 of both packages under fpfh, the port
    through its CLI with the reference's draws injected."""
    d, info = dataset
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(d, d_ref)
    shutil.copytree(d, d_port)
    reference_draws(8)                    # 5 scans padded to batches of 4
    out_ref = sm_ref.run_scanmatcher(d_ref, cfg=IcpConfigRef(capacity=CAP),
                                     progress=False)
    assert cli.main(["scanmatch", "-i", d_port, "--capacity", str(CAP),
                     "--device", "cpu"]) == 0
    path = "/robot0/scanmatcher/scanmatcher_relative.csv"
    _, T_rel = EurocDataset(d_port).read_trajectory(path)
    _, T_rel_ref = EurocRef(d_ref).read_trajectory(path)
    dpos, drot = pose_err(T_rel, T_rel_ref)
    assert dpos.max() < 1e-3 and drot.max() < 1e-3, (dpos, drot)
    seeds = sm.relative_odometry(sm.prepare_experiment_data(
        EurocDataset(d), 0, 1.0)[3]).astype(np.float32).astype(np.float64)
    fell_ref = [np.array_equal(a, b) for a, b in zip(out_ref["relative"], seeds)]
    with open(d_port + "/robot0/viz/scanmatcher_profile.json") as f:
        assert json.load(f)["pairs_fallback_to_seed"] == sum(fell_ref)


def test_store_registers_through_fpfh(scene, monkeypatch):
    """The store under fpfh registers the scene's pair (2.3 m and 0.6 rad
    apart, an identity seed: the method ignores it) through FPFH + RANSAC
    + ICP, computing each distinct scan's descriptors once (spies count the
    calls)."""
    clouds, T_gt = scene
    calls = {"reg": [], "fpfh": []}
    real_reg, real_fpfh = global_reg.global_registration, global_reg.compute_fpfh
    monkeypatch.setattr(global_reg, "global_registration", lambda *a, **kw: calls[
        "reg"].append(a[0].points.shape[0]) or real_reg(*a, **kw))
    monkeypatch.setattr(global_reg, "compute_fpfh", lambda c, r: calls["fpfh"].append(
        c.points.shape[0]) or real_fpfh(c, r))
    c = cl.Cloud(*(torch.stack(x) for x in zip(*(_t(k.points, k.mask, k.normals)
                                                   for k in clouds))))
    ground, nonground = cl.split_by_plane(
        c, cl.ransac_ground_plane(c, torch.Generator().manual_seed(0)), 0.4)
    store = KeyframeStore.from_arrays(c.points, c.mask, c.normals, method="fpfh",
                                      ground_mask=ground.mask,
                                      nonground_mask=nonground.mask)
    T = store.compute_transformations_batch(np.array([[0, 1], [0, 1]]),
                                            np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)))
    assert calls == {"reg": [2], "fpfh": [2]}
    dpos, drot = pose_err(T, np.stack([T_gt, T_gt]))
    assert dpos.max() < 0.05 and drot.max() < 0.01, (dpos, drot)


def test_graph_cli_under_fpfh(dataset, tmp_path):
    """``cli scanmatch`` then ``cli graph`` under fpfh: stage 2 loads its
    store with the ground split and writes its CSVs."""
    d0, info = dataset
    d = str(tmp_path / "graph")
    shutil.copytree(d0, d)
    argv = ["-i", d, "--capacity", "512", "--batch-size", "4", "--device", "cpu"]
    assert cli.main(["scanmatch"] + argv) == 0
    assert cli.main(["graph"] + argv) == 0
    with open(d + "/robot0/viz/graphslam_profile.json") as f:
        prof = json.load(f)
    assert prof["method"] == "fpfh" and prof["store_scans_loaded_locally"] == 5
    _, T = EurocDataset(d).read_trajectory("/robot0/SLAM/solution_graphslam.csv")
    assert T.shape == (5, 4, 4) and np.isfinite(T).all()
    assert ate(T, info["T_gt"])["rmse"] < 10.0
