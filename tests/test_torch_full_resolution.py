"""Stage 1 at full resolution (``voxel_size`` None) in the port, on the CPU:
the compaction at capacities whose product reaches 2^31 (the JAX package
refuses them; the port selects in int64), the normals of balls of three
nearly collinear points (far out, a full-resolution scan has many), and
one preprocessed and registered pair against the benchmark's plain reference
(``slam_bench/reference``: plain torch, float64 normals, importing neither
package).  The file imports no JAX; its ``cuda`` test (K7 against its
plain version) runs on a card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_full_resolution.py
"""

import numpy as np
import pytest
import torch

from lidar_slam_arvc_tpu_torch import cloud as cl
from lidar_slam_arvc_tpu_torch.cloud.normals import _cov_from_moments
from lidar_slam_arvc_tpu_torch.ops import _cuda
from lidar_slam_arvc_tpu_torch.ops.eigh3 import (
    OFF_F64, resolved_normals, resolved_normals_plain, smallest_eigenvector_sym3,
    smallest_eigenvector_sym3_f64,
)
from lidar_slam_arvc_tpu_torch.ops.moments import ball_moments
from lidar_slam_arvc_tpu_torch.pipeline.preprocess import preprocess_batch
from lidar_slam_arvc_tpu_torch.registration.icp import ICPParams, icp_batch
from lidar_slam_arvc_tpu_torch.utils import synthetic
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
from slam_bench.reference import cloud as ref_cloud
from slam_bench.reference import geometry as ref_geometry
from slam_bench.reference import icp as ref_icp

torch.set_num_threads(1)

WHOLE_SCAN = 65536      # a whole HDL-32E scan's capacity: 65536^2 = 2^32


def _stride_oracle(mask: np.ndarray, k: int) -> np.ndarray:
    """Indices kept from a (N,) mask: rank r among the n valid points is
    kept iff floor((r + 1) k / n) > floor(r k / n), in Python integers."""
    idx = np.flatnonzero(mask)
    n = len(idx)
    k = min(k, n)
    return np.array([i for r, i in enumerate(idx)
                     if (r + 1) * k // max(n, 1) > r * k // max(n, 1)], dtype=np.int64)


@pytest.mark.parametrize("out_capacity", [WHOLE_SCAN, 40000])
def test_compact_counted_beyond_int32(out_capacity):
    """(2, 65536) clouds, 85% and 40% valid, into 65536 and 40000 slots
    (65536 x 40000 >= 2^31 too): the kept points are exactly the stride
    rule's and the reference's ``uniform``, in order, and n is the valid
    count before the capacity."""
    rng = np.random.default_rng(7)
    pts = rng.normal(scale=20.0, size=(2, WHOLE_SCAN, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, WHOLE_SCAN)) < np.array([[0.85], [0.40]])
    got, n = cl.compact_counted(cl.Cloud(torch.from_numpy(pts), torch.from_numpy(mask)),
                                out_capacity)
    assert got.points.shape == (2, out_capacity, 3)
    for b in range(2):
        keep = _stride_oracle(mask[b], out_capacity)
        k = len(keep)
        assert int(n[b]) == int(mask[b].sum())
        assert k == min(int(mask[b].sum()), out_capacity)
        np.testing.assert_array_equal(got.mask[b].numpy(), np.arange(out_capacity) < k)
        np.testing.assert_array_equal(got.points[b, :k].numpy(), pts[b, keep])
        assert not got.points[b, k:].any()
        ref, n_ref = ref_cloud.uniform(torch.from_numpy(pts[b][mask[b]]), out_capacity)
        assert n_ref == int(n[b])
        np.testing.assert_array_equal(got.points[b, :k].numpy(), ref.numpy())
    # the 85% cloud overflows 40000 slots, so the stride is exercised
    if out_capacity < WHOLE_SCAN:
        assert int(n[0]) > out_capacity


def _raw_pair(seed: int, raw_capacity: int):
    """Two consecutive synthetic scans (box world, ~3000 returns each) and
    the odometry seed between them."""
    rng = np.random.default_rng(seed)
    world = synthetic.make_world(rng, extent=15.0, n_ground=6000, n_pillars=6,
                                 pillar_pts=300, n_boxes=3)
    poses = synthetic.make_trajectory(40, radius=6.0)[:2]     # ~0.9 m apart
    scans = [synthetic.render_scan(world, T, rng, max_range=14.0, max_points=3000)
             for T in poses]
    pts = np.zeros((2, raw_capacity, 3), np.float32)
    mask = np.zeros((2, raw_capacity), bool)
    for i, s in enumerate(scans):
        pts[i, :len(s)], mask[i, :len(s)] = s, True
    seed_T = (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)
    return pts, mask, seed_T


@pytest.mark.parametrize("capacity", [4096, 1536])
def test_full_resolution_pair_matches_the_plain_reference(capacity):
    """``preprocess_batch`` at voxel None then ``icp_batch``, against the
    reference's ``preprocess`` and ``icp`` on the same raw scans.

    The points kept are the same bits (crop and stride rule are exact; at
    capacity 1536 the stride keeps about half of each scan).  The normals
    are not: the port solves f32 moments (K2's plain version and a 3x3
    eigen-solve in f32), the reference float64 covariances, and the two
    round a neighbour's squared distance differently, so a ball of a few
    points can gain or lose one at its rim and turn its normal entirely
    (here a handful of points, |cos| down to 0.29).  So 90% of the
    normals are held to |cos| > 1 - 1e-5 (they read 1 - 5e-8), and the
    pose to 1e-3 m and 1e-4 rad (it reads 1.4e-5 m and 8.6e-7 rad at
    capacity 4096, 3.1e-6 m and 5.7e-8 rad at 1536)."""
    cfg = IcpConfig(raw_capacity=4096, capacity=capacity, batch_size=1,
                    normal_radius=0.6, distance_threshold=5.0, max_iterations=30)
    pts, mask, seed_T = _raw_pair(11, cfg.raw_capacity)
    out = preprocess_batch(torch.from_numpy(pts), torch.from_numpy(mask), cfg,
                           "icppointplane", None)
    icp = {"raw_capacity": cfg.raw_capacity, "capacity": capacity,
           "min_radius": cfg.min_radius, "max_radius": cfg.max_radius,
           "min_height": cfg.min_height, "max_height": cfg.max_height,
           "normal_radius": cfg.normal_radius}
    ref = [ref_cloud.preprocess(torch.from_numpy(pts[i][mask[i]]), icp, None)
           for i in range(2)]
    for i, (r_pts, r_nrm, r_n) in enumerate(ref):
        k = len(r_pts)
        assert int(out.n_voxels[i]) == r_n and int(out.mask[i].sum()) == k
        np.testing.assert_array_equal(out.points[i, :k].numpy(), r_pts.numpy())
        # same plane either way: |cos| of the angle between the normals
        cos = (out.normals[i, :k].double() * r_nrm.double()).sum(-1).abs()
        assert float(torch.quantile(cos, 0.1)) > 1 - 1e-5
    if capacity < 3000:
        assert all(r_n > capacity for _, _, r_n in ref)

    params = ICPParams(max_correspondence_distance=cfg.distance_threshold,
                       max_iterations=cfg.max_iterations)
    res = icp_batch(out.points[1:], out.mask[1:], out.points[:1], out.mask[:1],
                    out.normals[:1], torch.from_numpy(seed_T)[None], params,
                    "point_to_plane")
    T_ref, fit, _, _ = ref_icp.icp(ref[1][0], ref[0][0], ref[0][1], torch.from_numpy(seed_T),
                                   cfg.distance_threshold, cfg.max_iterations)
    dt, dr = ref_geometry.gaps(res.transform.double().numpy(), T_ref.numpy()[None])
    assert float(dt.max()) < 1e-3 and float(dr.max()) < 1e-4, (dt, dr)
    assert abs(float(res.fitness[0]) - fit) < 1e-3


def _thin_triangles(rng, n: int) -> np.ndarray:
    """(n, 3, 3): n sets of three points 0.24 m long and 0.5-2 mm wide,
    centred at 0 in random orientations, as a ball far out holds them at
    full resolution."""
    h = rng.uniform(0.0005, 0.002, n)
    tri = np.zeros((n, 3, 3))
    tri[:, :, 0] = [-0.12, 0.12, 0.02]
    tri[:, 1, 1], tri[:, 2, 1] = h, -h
    tri -= tri.mean(1, keepdims=True)
    return tri @ np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]


def test_normals_of_three_point_balls():
    """Balls of exactly 3 points, 10-30 m out: their two small covariance
    eigenvalues nearly meet, and the f32 closed form alone (the JAX
    package's) returns most of these normals more than 1e-3 off in |cos|,
    some nearly at right angles.  The port's are within 1 - 1e-3 in |cos|
    of the reference's float64 normals of the same points (they read
    1 - 1.5e-4 at worst; the rest is the f32 moments' rounding)."""
    rng = np.random.default_rng(3)
    k = 200
    centre = np.stack([rng.uniform(10, 30, k), np.arange(k) - k / 2.0,
                       rng.uniform(-1, 1, k)], 1)
    pts = (centre[:, None, :] + _thin_triangles(rng, k)).reshape(-1, 3).astype(np.float32)
    c = cl.from_numpy(pts, len(pts), device="cpu")
    count, s1, s2 = ball_moments(c.points, c.points, c.mask, 0.3, query_mask=c.mask)
    assert bool((count == 3).all())
    ref = ref_cloud.normals(torch.from_numpy(pts), 0.3).double()
    got = cl.estimate_normals(c, 0.3).normals.double()
    f32 = smallest_eigenvector_sym3(_cov_from_moments(count, s1, s2)).double()
    assert float((got * ref).sum(-1).abs().min()) > 1 - 1e-3
    cos_f32 = (f32 * ref).sum(-1).abs()
    assert float((cos_f32 < 1 - 1e-3).double().mean()) > 0.5 and float(cos_f32.min()) < 0.5


def _covariances(rng, n: int) -> torch.Tensor:
    """f32 symmetric 3x3 blocks: n random covariances, n of three points
    (``_thin_triangles``: rank 2, the smallest eigenvalue 0), n nearly
    isotropic ones and 8 zero ones (masked rows)."""
    a = rng.normal(scale=0.1, size=(n, 3, 3))
    tri = _thin_triangles(rng, n)
    R = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    near = R @ np.apply_along_axis(np.diag, 1, 1.0 + 1e-6 * rng.uniform(size=(n, 3)))
    cov = np.concatenate([a @ np.swapaxes(a, 1, 2), np.swapaxes(tri, 1, 2) @ tri / 3.0,
                          near @ np.swapaxes(R, 1, 2), np.zeros((8, 3, 3))])
    return torch.from_numpy(0.5 * (cov + np.swapaxes(cov, 1, 2)))


def test_float64_eigenvector_against_eigh():
    """The float64 closed form against ``torch.linalg.eigh`` in float64:
    |cos| within 1e-9 of 1 on every block but the zero ones (the f32 form
    is up to ~1 off on the rank-2 ones), which give +z, as the f32 form
    does."""
    A = _covariances(np.random.default_rng(5), 500)
    v = smallest_eigenvector_sym3_f64(A)
    ref = torch.linalg.eigh(A)[1][..., 0]
    assert v.dtype == torch.float64
    assert float((v[:-8] * ref[:-8]).sum(-1).abs().min()) > 1 - 1e-9
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
    assert torch.equal(v[-8:], ez.expand(8, 3))
    assert torch.equal(smallest_eigenvector_sym3(A[-8:].float()), ez.float().expand(8, 3))


def test_resolved_normals_take_the_float64_normal_where_f32_departs():
    """The plain version, which the CPU runs: rows whose f32 normal lies
    within 1 - OFF_F64 in |cos| of the float64 solve keep their f32 bits;
    the others get the float64 normal, so every row ends within
    1 - OFF_F64 of it."""
    cov = _covariances(np.random.default_rng(6), 300).float().reshape(2, -1, 3, 3)
    f32 = smallest_eigenvector_sym3(cov)
    got = resolved_normals(cov)
    exact = smallest_eigenvector_sym3_f64(cov)
    kept = (f32.double() * exact).sum(-1).abs() >= 1 - OFF_F64
    assert 0 < int(kept.sum()) < kept.numel()
    assert torch.equal(got[kept], f32[kept])
    assert torch.equal(got[~kept], exact[~kept].float())
    assert float((got.double() * exact).sum(-1).abs().min()) >= 1 - OFF_F64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_k7_matches_its_plain_version(dev):
    """K7 (``csrc/normal_solve.cu``) against ``resolved_normals_plain`` on
    the CPU.  Every row within 1 - OFF_F64 in |cos| of the host's float64
    solve (1e-7 of slack: the card's and the host's float64 acos and cos
    differ in the last bit).  Where the host replaced a row, K7 replaced
    it too on all but a few rows (their f32 forms can fall either side of
    the threshold: the card's acosf and cosf are not the host's), and to
    within 5e-7 (next to a double eigenvalue the last bit of float64
    turns the vector by up to ~2e-7).  Where both kept the f32 normal and
    the two small eigenvalues lie a tenth of the largest apart, within
    1e-5 (the f32 forms differ there by a few ulps of the eigenvalue).  One launch; a wrong dtype or a
    non-contiguous tensor raises before any launch."""
    cov = _covariances(np.random.default_rng(7), 20000).float().reshape(4, -1, 3, 3)
    ref = resolved_normals_plain(cov)
    f32 = smallest_eigenvector_sym3(cov)
    exact = smallest_eigenvector_sym3_f64(cov)
    n0 = _cuda.launch_counts["normal_solve"]
    got = resolved_normals(cov.to(dev))
    torch.cuda.synchronize()
    assert _cuda.launch_counts["normal_solve"] == n0 + 1
    got = got.cpu()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert float((got.double() * exact).sum(-1).abs().min()) >= 1 - OFF_F64 - 1e-7
    replaced = ~torch.eq(ref, f32).all(-1)
    near = (got - exact.float()).abs().amax(-1) <= 5e-7
    assert int(replaced.sum()) > 1000
    assert int((replaced & ~near).sum()) <= int(replaced.sum()) // 100
    ev = torch.linalg.eigvalsh(cov.double())
    separated = ((ev[..., 1] - ev[..., 0]) > 0.1 * ev[..., 2]) & ~replaced
    assert int(separated.sum()) > 10000
    torch.testing.assert_close(got[separated], ref[separated], rtol=0, atol=1e-5)
    for bad in (cov.to(dev).double(), cov.to(dev).transpose(0, 1)):
        with pytest.raises(ValueError):
            resolved_normals(bad)
    assert _cuda.launch_counts["normal_solve"] == n0 + 1
