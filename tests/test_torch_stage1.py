"""Stage 1 of the PyTorch port vs the JAX package on the CPU: ICP and the
whole scan matcher through its CLI.

Both packages get the same numpy inputs; the JAX side runs as its own
tests run it on the CPU.  Tolerances:

* transforms within 1e-4 m / 1e-4 rad and iterations within +-1: the two
  packages sum the normal equations in different f32 orders, so a pair can
  cross ``convergence_tol`` one step earlier or later, and a step near the
  exit moves the pose by ~convergence_tol;
* end to end, relative transforms within 1e-3 m / 1e-3 rad: per-pair ICP
  differences as above, plus normals from differently ordered moment sums.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lidar_slam_arvc_tpu import cloud as cl_ref
from lidar_slam_arvc_tpu.cloud import normals as normals_ref
from lidar_slam_arvc_tpu.io import EurocDataset as EurocRef
from lidar_slam_arvc_tpu.pipeline import preprocess as prep_ref
from lidar_slam_arvc_tpu.pipeline import scanmatcher as sm_ref
from lidar_slam_arvc_tpu.pipeline.scanmatcher import run_scanmatcher as run_ref
from lidar_slam_arvc_tpu.registration import ICPParams as ICPParamsRef
from lidar_slam_arvc_tpu.registration import icp as icp_ref
from lidar_slam_arvc_tpu.registration import icp_batch as icp_batch_ref
from lidar_slam_arvc_tpu.utils.config import IcpConfig as IcpConfigRef
from lidar_slam_arvc_tpu_torch import cloud as cl
from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.pipeline import cli
from lidar_slam_arvc_tpu_torch.pipeline import scanmatcher as sm
from lidar_slam_arvc_tpu_torch.pipeline.scanmatcher import run_scanmatcher
from lidar_slam_arvc_tpu_torch.registration import ICPParams, icp, icp_batch
from lidar_slam_arvc_tpu_torch.utils import synthetic
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
from lidar_slam_arvc_tpu_torch.utils.metrics import ate

torch.set_num_threads(1)

CAP = 2048
# the reference runs its TPU correspondence kernel (K1's original) in
# Pallas interpret mode, so both sides score the same per-coordinate d2
PARAMS_REF = ICPParamsRef(max_correspondence_distance=5.0, max_iterations=25,
                          nn_impl="vpu_t")
PARAMS = ICPParams(**PARAMS_REF._asdict())


def pose_err(T_a, T_b):
    """(position error, rotation angle) of T_a^-1 T_b.  The angle comes
    from the skew part (arcsin |vee(D - D^T)| / 2), which stays accurate
    for the small angles compared here; arccos of the trace would turn the
    f32 rounding of a rotation matrix into ~3e-4 rad."""
    delta = np.linalg.inv(np.asarray(T_a, np.float64)) @ np.asarray(T_b, np.float64)
    dpos = np.linalg.norm(delta[..., :3, 3], axis=-1)
    D = delta[..., :3, :3]
    skew = np.stack([D[..., 2, 1] - D[..., 1, 2], D[..., 0, 2] - D[..., 2, 0],
                     D[..., 1, 0] - D[..., 0, 1]], axis=-1)
    return dpos, np.arcsin(np.clip(np.linalg.norm(skew, axis=-1) / 2, 0, 1))


@pytest.fixture(scope="module")
def scene():
    """tests/test_icp.py's scene at reduced size, preprocessed once by the
    JAX package; the port gets the same clouds through from_arrays."""
    rng = np.random.default_rng(42)
    world = synthetic.make_world(rng, extent=20.0, n_ground=6000,
                                 n_pillars=20, pillar_pts=300)
    T_j = synthetic._yaw_T(0.6, 0.25, 0.08)
    scans = [synthetic.render_scan(world, T, rng, max_points=1500)
             for T in (np.eye(4), T_j)]
    clouds = []
    for s in scans:
        c = cl_ref.from_numpy(s, CAP)
        c = cl_ref.crop_radius_height(c, 0.5, 35.0, -1.0, 50.0)
        c = cl_ref.voxel_downsample(c, 0.15)
        clouds.append(cl_ref.estimate_normals(c, radius=0.4))
    return clouds[0], clouds[1], T_j


def _port(c):
    return cl.from_arrays(np.asarray(c.points), np.asarray(c.mask),
                          np.asarray(c.normals), device="cpu")


def _close(T_got, T_ref, it_got=None, it_ref=None):
    dpos, drot = pose_err(T_got, T_ref)
    assert np.max(dpos) < 1e-4, dpos
    assert np.max(drot) < 1e-4, drot
    if it_got is not None:
        assert np.all(np.abs(np.asarray(it_got, np.int64)
                             - np.asarray(it_ref, np.int64)) <= 1)


@pytest.mark.parametrize("method", ["point_to_plane", "point_to_point"])
def test_icp_matches_reference(scene, method):
    ci, cj, T_gt = scene
    T0 = (T_gt @ synthetic._yaw_T(0.1, -0.08, 0.03)).astype(np.float32)
    ref = icp_ref(cj, ci, jnp.asarray(T0), PARAMS_REF, method)
    got = icp(_port(cj), _port(ci), torch.from_numpy(T0), PARAMS, method)
    assert int(got.iterations) > 1
    _close(got.transform.numpy(), np.asarray(ref.transform),
           got.iterations, ref.iterations)
    np.testing.assert_allclose(float(got.fitness), float(ref.fitness), atol=2e-3)
    assert pose_err(got.transform.numpy(), T_gt)[0] < 0.08


@pytest.mark.parametrize("method", ["point_to_plane", "point_to_point"])
def test_icp_batch_matches_reference(scene, method):
    """Three pairs converging after different numbers of iterations (one a
    self-pair at identity, as the pipeline pads groups): each pair's
    iterations and final_delta are its own."""
    ci, cj, T_gt = scene
    seeds = np.stack([T_gt @ synthetic._yaw_T(0.1, -0.08, 0.03),
                      T_gt @ synthetic._yaw_T(-0.02, 0.01, 0.0),
                      np.eye(4)]).astype(np.float32)
    src = [cj, cj, ci]
    stack = lambda cs, f: np.stack([np.asarray(getattr(c, f)) for c in cs])
    args = [stack(src, "points"), stack(src, "mask"),
            stack([ci] * 3, "points"), stack([ci] * 3, "mask"),
            stack([ci] * 3, "normals"), seeds]
    ref = icp_batch_ref(*(jnp.asarray(a) for a in args), PARAMS_REF, method)
    got = icp_batch(*(torch.from_numpy(a) for a in args), PARAMS, method)
    _close(got.transform.numpy(), np.asarray(ref.transform),
           got.iterations, ref.iterations)
    assert len(set(got.iterations.tolist())) > 1
    assert (got.final_delta.numpy() <= PARAMS.convergence_tol).all()


@pytest.mark.parametrize("kw", [
    {"source_stride": 3}, {"exact_metrics": True}, {"max_iterations": 0},
    {"robust": False}, {"convergence_tol": 0.0, "max_iterations": 4},
    {"coarse_factor": 2, "coarse_iterations": 3}], ids=str)
def test_icp_options_match_reference(scene, kw):
    """Every ICPParams option the port carries, against the reference."""
    ci, cj, T_gt = scene
    T0 = (T_gt @ synthetic._yaw_T(0.05, 0.05, 0.02)).astype(np.float32)
    pr = PARAMS_REF._replace(**kw)
    ref = icp_ref(cj, ci, jnp.asarray(T0), pr, "point_to_plane")
    got = icp(_port(cj), _port(ci), torch.from_numpy(T0),
              ICPParams(**pr._asdict()), "point_to_plane")
    _close(got.transform.numpy(), np.asarray(ref.transform),
           got.iterations, ref.iterations)
    np.testing.assert_allclose(float(got.fitness), float(ref.fitness),
                               atol=2e-3)
    np.testing.assert_allclose(float(got.inlier_rmse),
                               float(ref.inlier_rmse), rtol=1e-2)
    assert float(got.final_delta) == pytest.approx(float(ref.final_delta),
                                                   abs=1e-4)


@pytest.mark.parametrize("nn_impl", ["vpu", "vpu2", "mxu", "vpu_tq", "pruned",
                                     "xla"])
def test_icp_nn_impl_matches_reference(scene, nn_impl):
    """Every other correspondence search against the reference run with
    the same nn_impl (its Pallas kernels in interpret mode, its XLA sweep
    for 'xla'); 'pruned' at the reference's block rows, min(512, src_block)
    and min(512, tgt_block)."""
    ci, cj, T_gt = scene
    T0 = (T_gt @ synthetic._yaw_T(0.1, -0.08, 0.03)).astype(np.float32)
    pr = PARAMS_REF._replace(nn_impl=nn_impl, src_block=256)
    ref = icp_ref(cj, ci, jnp.asarray(T0), pr, "point_to_plane")
    got = icp(_port(cj), _port(ci), torch.from_numpy(T0),
              ICPParams(**pr._asdict()), "point_to_plane")
    assert int(got.iterations) > 1
    _close(got.transform.numpy(), np.asarray(ref.transform),
           got.iterations, ref.iterations)
    np.testing.assert_allclose(float(got.fitness), float(ref.fitness),
                               atol=2e-3)


def test_pruned_with_coarse_to_fine_raises_as_reference(scene):
    ci, cj, _ = scene
    pr = PARAMS_REF._replace(nn_impl="pruned", coarse_factor=2,
                             coarse_iterations=3)
    with pytest.raises(ValueError) as ref_err:
        icp_ref(cj, ci, jnp.eye(4), pr)
    with pytest.raises(ValueError) as err:
        icp(_port(cj), _port(ci), torch.eye(4), ICPParams(**pr._asdict()))
    assert str(err.value) == str(ref_err.value)


def test_unknown_nn_impl_raises(scene):
    """A stated difference: the reference takes its XLA sweep for a name
    it does not know; the port refuses it."""
    ci, cj, _ = scene
    with pytest.raises(ValueError, match="unknown nn_impl 'vpu3'"):
        icp(_port(cj), _port(ci), torch.eye(4),
            PARAMS._replace(nn_impl="vpu3"))


@pytest.fixture(scope="module")
def sequence():
    """Five consecutive scans of the scene's world, preprocessed once by the
    JAX package, with noisy relative seeds (pairs i+1 -> i)."""
    rng = np.random.default_rng(7)
    # boxes, not pillars: see the dataset fixture below
    world = synthetic.make_world(rng, extent=20.0, n_ground=6000,
                                 n_pillars=0, n_boxes=15)
    T = synthetic.make_trajectory(40, radius=8.0)[:5]
    clouds = []
    for Ti in T:
        c = cl_ref.from_numpy(synthetic.render_scan(world, Ti, rng,
                                                    max_points=1500), CAP)
        c = cl_ref.crop_radius_height(c, 0.5, 35.0, -1.0, 50.0)
        c = cl_ref.voxel_downsample(c, 0.15)
        clouds.append(cl_ref.estimate_normals(c, radius=0.4))
    stack = {f: np.stack([np.asarray(getattr(c, f)) for c in clouds])
             for f in ("points", "mask", "normals")}
    seeds = np.stack([np.linalg.inv(T[i]) @ T[i + 1] @ synthetic._yaw_T(
        0.05, -0.03, 0.01) for i in range(4)]).astype(np.float32)
    return stack, seeds


@pytest.mark.parametrize("nn_impl", ["vpu_t", "pruned"])
def test_match_all_matches_reference(sequence, nn_impl):
    """The slice as a whole: the port's match_all against the reference's
    _match_all_fused (bench.py's matcher) on the same preprocessed scans,
    pairs and seeds, in groups of 2 at source stride 2."""
    stack, seeds = sequence
    idx_src, idx_tgt = np.arange(1, 5), np.arange(0, 4)
    pr = PARAMS_REF._replace(nn_impl=nn_impl, source_stride=2)
    ref = sm_ref._match_all_fused(
        *(jnp.asarray(stack[f]) for f in ("points", "mask", "normals")),
        jnp.asarray(idx_src), jnp.asarray(idx_tgt), jnp.asarray(seeds), pr,
        "point_to_plane", 2)
    got = sm.match_all(*(torch.from_numpy(stack[f])
                         for f in ("points", "mask", "normals")),
                       torch.from_numpy(idx_src), torch.from_numpy(idx_tgt),
                       torch.from_numpy(seeds), ICPParams(**pr._asdict()),
                       "point_to_plane", 2)
    _close(got[0].numpy(), np.asarray(ref[0]), got[2], ref[2])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=2e-3)
    assert (got[3].numpy() <= PARAMS.convergence_tol).all()
    with pytest.raises(ValueError, match="whole groups"):
        sm.match_all(*(torch.from_numpy(stack[f])
                       for f in ("points", "mask", "normals")),
                     torch.from_numpy(idx_src[:3]), torch.from_numpy(idx_tgt[:3]),
                     torch.from_numpy(seeds[:3]), ICPParams(), "point_to_plane", 2)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("euroc_torch"))
    # boxes instead of pillars: a pillar thinner than the normal ball has
    # two near-equal covariance eigenvalues, whose eigenvector (the normal)
    # turns with f32 rounding; that alone moves a pose by ~1-2 mm
    info = synthetic.make_dataset(
        d, n_scans=10, seed=1, radius=8.0, scan_points=3000,
        world_kwargs={"n_pillars": 0, "n_boxes": 15},
        scanmatcher_params={"voxel_size": 0.3, "method": "icppointplane",
                            "delta_time": 1.0, "start_index": 0})
    return d, info


def test_scanmatcher_cli_matches_reference(dataset, tmp_path, monkeypatch):
    """run_scanmatcher of both packages on one dataset: lidar_times.csv
    byte-identical, relative transforms within 1e-3 m / 1e-3 rad, and the
    port's trajectory within 0.2 m ATE of the ground truth.  The port runs
    through its CLI on the CPU (the kernels' plain versions).  The
    reference runs its two TPU kernels (the ones the port replaces) in
    Pallas interpret mode: its CPU defaults take other formulations (the
    matmul form of d2, raw-origin moments) whose f32 rounding alone moves
    the poses by ~2 mm."""
    d, info = dataset
    d_ref = str(tmp_path / "ref")
    shutil.copytree(d, d_ref)
    monkeypatch.setattr(sm_ref, "ICPParams",
                        lambda **kw: ICPParamsRef(nn_impl="vpu_t", **kw))
    monkeypatch.setattr(
        prep_ref.cl, "estimate_normals",
        lambda c, r: normals_ref.estimate_normals(c, r, impl="pallas_interpret"))
    run_ref(d_ref, cfg=IcpConfigRef(capacity=CAP), progress=False)
    assert cli.main(["scanmatch", "-i", d, "--capacity", str(CAP),
                     "--device", "cpu"]) == 0
    sm = "/robot0/scanmatcher/"
    with open(d + sm + "lidar_times.csv", "rb") as f, \
            open(d_ref + sm + "lidar_times.csv", "rb") as g:
        assert f.read() == g.read()
    _, T_rel = EurocDataset(d).read_trajectory(sm + "scanmatcher_relative.csv")
    _, T_rel_ref = EurocRef(d_ref).read_trajectory(sm + "scanmatcher_relative.csv")
    assert T_rel.shape == (9, 4, 4)
    dpos, drot = pose_err(T_rel, T_rel_ref)
    assert dpos.max() < 1e-3 and drot.max() < 1e-3, (dpos.max(), drot.max())
    _, T_glob = EurocDataset(d).read_trajectory(sm + "scanmatcher_global.csv")
    assert ate(T_glob, info["T_gt"])["rmse"] < 0.2


def test_scanmatcher_config_conversion_and_guards(dataset):
    d, _ = dataset
    cfg = IcpConfig(**dataclasses.asdict(IcpConfigRef(capacity=CAP)))
    assert cfg == IcpConfig(capacity=CAP)
    # a mesh needs a process group of that many ranks (cli --devices N)
    for bad in ({"mesh_devices": 2}, {"mesh_devices": 4, "shard_scans": True}):
        with pytest.raises(ValueError, match="process group has 1 rank"):
            run_scanmatcher(d, cfg=IcpConfig(**bad), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["scanmatch", "-i", d])
