"""Geometry and cloud ops of the PyTorch port vs the JAX package (CPU).

Inputs come from a seeded numpy Generator and go through both packages as
numpy arrays.  Each tolerance is stated with its reason.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu import cloud as cl_ref
from lidar_slam_arvc_tpu import geom as geom_ref
from lidar_slam_arvc_tpu.ops import eigh3 as eigh3_ref
from lidar_slam_arvc_tpu.pipeline.preprocess import preprocess_batch as prep_ref
from lidar_slam_arvc_tpu.utils.config import IcpConfig as IcpConfigRef
from lidar_slam_arvc_tpu_torch import cloud as cl
from lidar_slam_arvc_tpu_torch.geom import se3
from lidar_slam_arvc_tpu_torch.ops import eigh3
from lidar_slam_arvc_tpu_torch.pipeline.preprocess import preprocess_batch
from lidar_slam_arvc_tpu_torch.utils import synthetic
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig

torch.set_num_threads(1)

# f32 elementwise algebra on values of magnitude <= ~30: the two packages
# may associate or fuse differently, a few ulp of 30 m
GEOM_ATOL = 2e-5


def t(a):
    return torch.from_numpy(np.asarray(a))


def n(x):
    return np.asarray(x)


def _scan(rng, n_points=3000):
    world = synthetic.make_world(rng, extent=20.0, n_ground=6000,
                                 n_pillars=20, pillar_pts=300)
    T = synthetic._yaw_T(0.3, -0.2, 0.1)
    return synthetic.render_scan(world, T, rng, max_points=n_points)


def test_se3_matches_reference(rng):
    xi = (rng.normal(size=(64, 6)) * [0.5, 0.5, 0.5, 3, 3, 3]).astype(np.float32)
    xi[:4] *= 1e-7                      # the series branches
    Tb = se3.se3_exp(t(xi[::-1].copy()))
    pts = rng.normal(scale=20.0, size=(64, 50, 3)).astype(np.float32)

    @jax.jit
    def reference(xi, Tb, pts):
        """The reference's functions compiled as one program."""
        Ta = geom_ref.se3_exp(xi)
        return (geom_ref.so3_exp(xi[:, :3]), Ta, geom_ref.compose(Ta, Tb),
                geom_ref.inverse(Ta), geom_ref.transform_points(Ta, pts))

    R_ref, Ta_ref, TaTb_ref, inv_ref, pts_ref = reference(xi, n(Tb), pts)
    np.testing.assert_allclose(n(se3.so3_exp(t(xi[:, :3]))), n(R_ref), atol=1e-6)
    Ta = se3.se3_exp(t(xi))
    np.testing.assert_allclose(n(Ta), n(Ta_ref), atol=GEOM_ATOL)
    np.testing.assert_allclose(n(se3.compose(Ta, Tb)), n(TaTb_ref), atol=GEOM_ATOL)
    np.testing.assert_allclose(n(se3.inverse(Ta)), n(inv_ref), atol=GEOM_ATOL)
    np.testing.assert_allclose(n(se3.transform_points(Ta, t(pts))), n(pts_ref),
                               atol=1e-4)


def test_crop_exact(rng):
    pts = rng.uniform(-40, 40, size=(2000, 3)).astype(np.float32)
    mask = rng.uniform(size=2000) > 0.1
    args = (0.5, 35.0, -1.0, 50.0)
    got = cl.crop_radius_height(cl.Cloud(t(pts), t(mask)), *args)
    ref = cl_ref.crop_radius_height(
        cl_ref.Cloud(jnp.asarray(pts), jnp.asarray(mask)), *args)
    np.testing.assert_array_equal(n(got.mask), n(ref.mask))


@pytest.mark.parametrize("out_capacity", [None, 300, 1000])
def test_compact_counted_exact(rng, out_capacity):
    pts = rng.normal(size=(1024, 3)).astype(np.float32)
    mask = rng.uniform(size=1024) > 0.4
    got, n_got = cl.compact_counted(cl.Cloud(t(pts), t(mask)), out_capacity)
    ref, n_ref = cl_ref.compact_counted(
        cl_ref.Cloud(jnp.asarray(pts), jnp.asarray(mask)), out_capacity)
    np.testing.assert_array_equal(n(got.points), n(ref.points))
    np.testing.assert_array_equal(n(got.mask), n(ref.mask))
    assert int(n_got) == int(n_ref)
    with pytest.raises(ValueError):
        cl.compact_counted(cl.Cloud(t(pts), t(mask)), 2048)


@pytest.mark.parametrize("capacity,out_capacity", [(65536, 32767), (46340, 40000)])
def test_compact_counted_exact_below_the_int32_limit(rng, capacity, out_capacity):
    """Just below capacity x out_capacity = 2^31, the last shapes the JAX
    package's int32 selection takes, the port's int64 selection keeps the
    same points bit for bit (a 90%-valid cloud, so the stride runs).  At
    2^31 the JAX package refuses and the port does not
    (``test_torch_full_resolution.py`` holds the port there)."""
    pts = rng.normal(scale=20.0, size=(capacity, 3)).astype(np.float32)
    mask = rng.uniform(size=capacity) < 0.9
    got, n_got = cl.compact_counted(cl.Cloud(t(pts), t(mask)), out_capacity)
    ref, n_ref = cl_ref.compact_counted(
        cl_ref.Cloud(jnp.asarray(pts), jnp.asarray(mask)), out_capacity)
    np.testing.assert_array_equal(n(got.points), n(ref.points))
    np.testing.assert_array_equal(n(got.mask), n(ref.mask))
    assert int(n_got) == int(n_ref) > out_capacity
    if capacity * capacity >= 2 ** 31:
        with pytest.raises(ValueError):
            cl_ref.compact_counted(cl_ref.Cloud(jnp.asarray(pts), jnp.asarray(mask)))
        assert int(cl.compact_counted(cl.Cloud(t(pts), t(mask)))[0].mask.sum()) == int(n_got)


@pytest.mark.parametrize("case", ["scan", "sign_bit", "truncated"])
def test_voxel_downsample_matches_reference(rng, case):
    """Mask and n_voxels exact, same row order; centroids within 1e-5 m
    (the reference sums each voxel in f32 by a segmented scan, the port in
    float64: a few f32 ulp of coordinates up to ~35 m)."""
    voxel, cap = 0.2, 4096
    pts = _scan(rng, 3000)
    if case == "sign_bit":
        # x-extent beyond 1024 cells: keys of far cells carry the int32
        # sign bit and sort first, in both packages
        voxel = 0.05
        pts = pts * np.float32([3.0, 1.0, 1.0])
    if case == "truncated":
        cap = 1000
    c = cl.from_numpy(pts, 4096, device="cpu")
    got, n_got = cl.voxel_downsample_counted(c, voxel, out_capacity=cap)
    assert got.points.is_contiguous()      # the kernels take only these
    ref, n_ref = cl_ref.voxel_downsample_counted(
        cl_ref.Cloud(jnp.asarray(n(c.points)), jnp.asarray(n(c.mask))),
        voxel, out_capacity=cap)
    assert int(n_got) == int(n_ref)
    np.testing.assert_array_equal(n(got.mask), n(ref.mask))
    np.testing.assert_allclose(n(got.points), n(ref.points), atol=1e-5)
    if case == "sign_bit":
        # the first voxel lies 1024+ cells from the minimum x
        x0 = n(c.points)[n(c.mask), 0].min()
        assert n(got.points)[0, 0] - x0 >= 1024 * voxel - voxel
    if case == "truncated":
        assert int(n_got) > cap


def test_voxel_batched_equals_single(rng):
    scans = [_scan(rng, 1500) for _ in range(3)]
    cs = [cl.from_numpy(s, 2048, device="cpu") for s in scans]
    batch = cl.Cloud(torch.stack([c.points for c in cs]),
                     torch.stack([c.mask for c in cs]))
    got, nv = cl.voxel_downsample_counted(batch, 0.2, out_capacity=1500)
    for i, c in enumerate(cs):
        one, n1 = cl.voxel_downsample_counted(c, 0.2, out_capacity=1500)
        assert torch.equal(got.points[i], one.points)
        assert int(nv[i]) == int(n1)


def test_eigh3_matches_reference(rng):
    """Same closed form, same f32 operations: agreement to f32 rounding."""
    A = rng.normal(size=(256, 3, 3)).astype(np.float32)
    A = A @ np.swapaxes(A, 1, 2)
    ev_ref, v_ref = map(n, jax.jit(lambda A: (
        eigh3_ref.eigvals_sym3(A), eigh3_ref.smallest_eigenvector_sym3(A)))(A))
    np.testing.assert_allclose(n(eigh3.eigvals_sym3(t(A))), ev_ref, atol=1e-4)
    v = n(eigh3.smallest_eigenvector_sym3(t(A)))
    assert np.abs(np.sum(v * v_ref, axis=1)).min() > 0.9999


def test_estimate_normals_matches_reference(rng):
    """|n . n_ref| > 0.9999 on rows with >= 5 neighbours whose two smallest
    covariance eigenvalues are well separated (elsewhere the eigenvector is
    ill-conditioned and f32 summation order may turn it)."""
    c = cl.from_numpy(_scan(rng, 3000), 4096, device="cpu")
    c, _ = cl.voxel_downsample_counted(c, 0.2)
    radius = 0.5
    got = cl.estimate_normals(c, radius)
    ref = jax.jit(lambda p, m: cl_ref.estimate_normals(
        cl_ref.Cloud(p, m), radius, impl="pallas_interpret"))(n(c.points), n(c.mask))
    from lidar_slam_arvc_tpu_torch.cloud.normals import _cov_from_moments
    from lidar_slam_arvc_tpu_torch.ops.moments import ball_moments
    count, s1, s2 = ball_moments(c.points, c.points, c.mask, radius,
                                 query_mask=c.mask)
    ev = np.linalg.eigvalsh(n(_cov_from_moments(count, s1, s2)).astype(np.float64))
    ok = n(c.mask) & (n(count) >= 5) & (ev[:, 1] - ev[:, 0] > 0.05 * ev[:, 2])
    assert ok.sum() > 500
    dots = np.abs(np.sum(n(got.normals) * n(ref.normals), axis=1))
    assert dots[ok].min() > 0.9999
    # orientation rule and the degenerate fallback are exact
    m = n(c.mask)
    facing = np.sum(n(got.normals) * n(c.points), axis=1)
    assert (facing[m & (n(count) >= 3)] <= 0).all()
    np.testing.assert_array_equal(n(got.normals)[n(count) < 3],
                                  np.tile([0.0, 0.0, 1.0], ((n(count) < 3).sum(), 1)))


@pytest.mark.parametrize("method,voxel", [("icppointplane", 0.2),
                                          ("icppointpoint", None)])
def test_preprocess_batch_matches_reference(rng, method, voxel):
    """Voxel path: as test_voxel_downsample (mask exact, 1e-5 m) and normals
    as test_estimate_normals on well-conditioned rows.  Compaction path:
    exact."""
    cfg_ref = IcpConfigRef(raw_capacity=4096, capacity=2048)
    cfg = IcpConfig(**dataclasses.asdict(cfg_ref))
    raw = [cl.from_numpy(_scan(rng, 2500), 4096, device="cpu") for _ in range(2)]
    pts = np.stack([n(c.points) for c in raw])
    msk = np.stack([n(c.mask) for c in raw])
    got = preprocess_batch(t(pts), t(msk), cfg, method, voxel)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    ref = prep_ref(jnp.asarray(pts), jnp.asarray(msk), keys, cfg_ref, method,
                   voxel)
    np.testing.assert_array_equal(n(got.mask), n(ref.mask))
    np.testing.assert_array_equal(n(got.n_voxels), n(ref.n_voxels))
    if voxel is None:
        np.testing.assert_array_equal(n(got.points), n(ref.points))
        assert not n(got.normals).any()
    else:
        np.testing.assert_allclose(n(got.points), n(ref.points), atol=1e-5)
        # the reference's CPU normals come from raw-origin moments
        # (radius_accumulate); compare where the covariance is well
        # conditioned
        dots = np.abs(np.sum(n(got.normals) * n(ref.normals), axis=-1))
        m = n(got.mask)
        assert np.median(dots[m]) > 0.9999
        assert (dots[m] > 0.99).mean() > 0.97
