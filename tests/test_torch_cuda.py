"""The port's CUDA kernels and its stage 1 on a card, against the plain
PyTorch versions.

Every test here needs a CUDA GPU and skips without one.  The file imports
no JAX, so it also runs on a GPU machine that has only the port's
dependencies (torch, numpy):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from lidar_slam_arvc_tpu_torch import cloud as cl
from lidar_slam_arvc_tpu_torch.ops import _cuda
from lidar_slam_arvc_tpu_torch.ops.moments import (
    TILE, ball_moments, ball_moments_plain, scored_pairs, summation_tolerance)
from lidar_slam_arvc_tpu_torch.ops import nn_pruned
from lidar_slam_arvc_tpu_torch.ops.nn import (
    nn_search, nn_search_plain, nn_search_vals, nn_search_vals_plain)
from lidar_slam_arvc_tpu_torch.pipeline.scanmatcher import run_scanmatcher
from lidar_slam_arvc_tpu_torch.utils import synthetic
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
from lidar_slam_arvc_tpu_torch.utils.metrics import ate

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


# (B, S, T) of the sweep tests.  The sweep splits T across a cluster of up
# to 8 CTAs of 128 sources each: 131 and 1001 are no multiple of the split,
# 5 is smaller than it (empty ranges), and 77, 257, 300 and 1000 are no
# multiple of the 128 sources of a CTA.
SWEEP_SHAPES = [(4, 1000, 3000), (1, 77, 131), (2, 2048, 64), (1, 300, 1001),
                (1, 77, 5), (3, 257, 700)]


def _sweep_clouds(rng, dev, B, S, T):
    """Sources, targets and a mask on the card: the second half of the
    targets repeats the first (ties), ~30% masked targets, a third of the
    sources on targets; at every boundary of the cluster's target ranges
    the first target of a range duplicates the last of the one before,
    both valid, with a source on it, so the tie crosses the split."""
    src = (rng.normal(size=(B, S, 3)) * 10).astype(np.float32)
    tgt = (rng.normal(size=(B, T, 3)) * 10).astype(np.float32)
    tgt[:, T // 2:] = tgt[:, : T - T // 2]
    src[:, : S // 3] = tgt[:, rng.integers(0, T, S // 3)]
    mask = rng.uniform(size=(B, T)) > 0.3
    chunk = _cuda.sweep_geometry(B, S, T, dev)["chunk"]
    for n, edge in enumerate(range(chunk, T, chunk)):
        tgt[:, edge] = tgt[:, edge - 1]
        mask[:, edge - 1: edge + 1] = True
        src[:, (S - 1 - n) % S] = tgt[:, edge]
    return src, tgt, mask


@pytest.mark.parametrize("B,S,T", SWEEP_SHAPES)
def test_nn_kernel_matches_plain(rng, dev, B, S, T):
    """Indices equal and d2 bit-equal (same non-contracted arithmetic),
    with masked and duplicated targets (ties go to the lowest index, also
    across the split of the target axis); every target masked in the last
    row of a batch."""
    src, tgt, mask = _sweep_clouds(rng, dev, B, S, T)
    if B > 1:
        mask[-1] = False
    s, tg, m = t(src, dev), t(tgt, dev), t(mask, dev)
    n0 = _cuda.launch_counts["nn_sweep"]
    i_k, d_k = nn_search(s, tg, m)
    i_p, d_p = nn_search_plain(s, tg, m)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["nn_sweep"] == n0 + 1
    assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p)
    i1, d1 = nn_search(s[0], tg[0], m[0])
    assert torch.equal(i1, i_k[0]) and torch.equal(d1, d_k[0])
    if B > 1:
        assert (i_k[-1] == 0).all()


@pytest.mark.parametrize("impl,key", [("vpu", "nn_sweep_vpu"),
                                      ("vpu2", "nn_sweep_vpu2"),
                                      ("mxu", "nn_sweep_mxu")])
@pytest.mark.parametrize("B,S,T", SWEEP_SHAPES)
def test_k3_kernel_matches_plain(rng, dev, impl, key, B, S, T):
    """K3 in each d2 form: indices equal and d2 bit-equal to the plain
    version (same rounded operations in the same order), masked and
    duplicated targets included, ties across the split; every target
    masked in one row."""
    src, tgt, mask = _sweep_clouds(rng, dev, B, S, T)
    mask[0] = False
    s, tg, m = t(src, dev), t(tgt, dev), t(mask, dev)
    n0 = _cuda.launch_counts[key]
    i_k, d_k = nn_search(s, tg, m, impl)
    i_p, d_p = nn_search_plain(s, tg, m, impl)
    torch.cuda.synchronize()
    assert _cuda.launch_counts[key] == n0 + 1
    assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p)
    assert (i_k[0] == 0).all()


@pytest.mark.parametrize("B,S,T", SWEEP_SHAPES)
def test_k4_kernel_matches_plain(rng, dev, B, S, T):
    """K4: d2 bit-equal to K1's; q and n exactly the winner's point and
    normal (real coordinates for a masked winner), ties across the
    split included."""
    src, tgt, mask = _sweep_clouds(rng, dev, B, S, T)
    nrm = rng.normal(size=(B, T, 3)).astype(np.float32)
    mask[0] = False
    s, tg, m, n = t(src, dev), t(tgt, dev), t(mask, dev), t(nrm, dev)
    n0 = _cuda.launch_counts["nn_sweep_vals"]
    got = nn_search_vals(s, tg, m, n)
    ref = nn_search_vals_plain(s, tg, m, n)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["nn_sweep_vals"] == n0 + 1
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert torch.equal(got[0], nn_search(s, tg, m)[1])


@pytest.mark.parametrize("sb,tb,case", [
    (512, 512, "scatter"), (128, 256, "scatter"), (100, 200, "scatter"),
    (1024, 512, "scatter"), (512, 2048, "one_block"), (128, 128, "far"),
    (128, 128, "gate_0.3")])
def test_k5_kernel_matches_plain(rng, dev, sb, tb, case):
    """K5 on Morton-sorted clouds: idx equal and d2 bit-equal to the plain
    version (same visiting and skipping rules), invalid rows (0, 0); within
    the gate d2 agrees with K1 and the index with K1's where unique.
    Source blocks of 100 rows split unevenly over the cluster's CTAs;
    'one_block' has a single target block; 'far' puts the target 100 m
    away, so every target block is pruned to 1e12 and only the first is
    scored; 'gate_0.3' gates at 0.3 m, whose square is not exact in f32."""
    B, S, T, gate = 3, 1500, 2600, 4.0
    if case == "one_block":
        T = 1500
    tgt = rng.uniform(-15, 15, (B, T, 3)).astype(np.float32)
    src = tgt[:, rng.integers(0, T, S)] + rng.normal(
        scale=0.3, size=(B, S, 3)).astype(np.float32)
    if case == "far":
        tgt[..., 0] += 100.0
        gate = 2.0
    elif case == "gate_0.3":
        gate = 0.3
    sm = rng.uniform(size=(B, S)) > 0.1
    tm = rng.uniform(size=(B, T)) > 0.1
    ss, sv, _ = nn_pruned.morton_sort(t(src, dev), t(sm, dev), sb)
    ts, tv, _ = nn_pruned.morton_sort(t(tgt, dev), t(tm, dev), tb)
    n0 = _cuda.launch_counts["nn_pruned"]
    i_k, d_k = nn_pruned.nn_search_pruned_presorted(ss, sv, ts, tv, gate, sb, tb)
    i_p, d_p = nn_pruned.nn_search_pruned_presorted_plain(ss, sv, ts, tv, gate, sb, tb)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["nn_pruned"] == n0 + 1
    assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p)
    assert not i_k[~sv].any() and not d_k[~sv].any()
    if case == "far":
        perm, tile_d2, t2 = nn_pruned.prepare(ss, sv, ts, tv, gate, sb, tb)
        assert bool((tile_d2 == 1e12).all())
        *_, tiles, _ = nn_pruned.pruned_sweep_plain(ss, sv, ts, t2, perm, tile_d2,
                                                   sb, tb, count_visits=True)
        assert tiles == int(sv.reshape(B, -1, sb).any(-1).sum())
    i1, d1 = nn_search(ss, ts, tv)
    inside = sv & (d1 <= gate * gate)
    assert bool(inside.any()) == (case != "far")
    if not inside.any():
        return
    assert float((d_k - d1)[inside].abs().max()) <= 1e-3
    differ = inside & (i_k != i1)
    # a different index only on a near-tie: its per-coordinate distance
    # equals K1's to the matmul form's rounding
    q = torch.take_along_dim(ts, i_k.long()[..., None], dim=1)
    d_pick = ((q - ss) ** 2).sum(-1)
    assert not differ.any() or float((d_pick - d1)[differ].abs().amax()) <= 1e-3


@pytest.mark.parametrize("case", ["blob", "clusters", "voxelised"])
def test_moments_kernel_matches_plain(rng, dev, case):
    """Counts exact (same d2 and the inclusive <= test); S1/S2 per row
    within ``summation_tolerance`` (the kernel sums sequentially per
    thread, the plain version by torch reductions); masked query rows zero.
    'clusters' makes the kernel skip every cross-cluster tile; 'voxelised'
    is a key-sorted scan."""
    if case == "blob":
        pts = rng.normal(scale=1.5, size=(2, 2000, 3)).astype(np.float32)
        qm = rng.uniform(size=(2, 2000)) > 0.2
        p, m, r = t(pts, dev), t(qm, dev), 0.5
    elif case == "clusters":
        pts = rng.normal(scale=0.4, size=(1, 1024, 3)).astype(np.float32)
        pts[:, 512:] += 100.0
        p, m, r = t(pts, dev), torch.ones((1, 1024), dtype=torch.bool, device=dev), 0.8
    else:
        world = synthetic.make_world(rng, extent=20.0, n_ground=6000,
                                     n_pillars=20, pillar_pts=300)
        c = cl.from_numpy(synthetic.render_scan(world, np.eye(4), rng,
                                                max_points=4000), 4096, device=dev)
        c, _ = cl.voxel_downsample_counted(
            cl.Cloud(c.points[None], c.mask[None]), 0.2, out_capacity=4096)
        p, m, r = c.points, c.mask, 0.5
    n0 = _cuda.launch_counts["ball_moments"]
    got = ball_moments(p, p, m, r, query_mask=m)
    ref = ball_moments_plain(p, p, m, r, query_mask=m)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["ball_moments"] == n0 + 1
    assert torch.equal(got[0], ref[0])
    for k, (a, b) in enumerate(zip(got[1:], ref[1:]), start=1):
        err = (a - b).abs().amax(-1)
        assert bool((err <= summation_tolerance(ref[0], r, k)).all()), err.max()
    assert not got[0][~m].any()


K2_MAX_TILES = 4096   # kMaxTiles in csrc/ball_moments.cu: its list of tiles


def _moments_inputs(rng, dev, case):
    """(query, tgt, tgt_mask, radius, query_mask) on the card for one edge
    of K2's launch geometry; queries near (a quarter on) the targets."""
    B, Q, T, r = {"ragged_scalar_loads": (2, 333, 1001, 0.5),
                  "unaligned": (1, 300, 1024, 0.5),
                  "tgt_below_one_tile": (2, 500, 100, 0.5),
                  "fewer_tiles_than_cluster": (1, 1000, 600, 0.4),
                  "masked_batch_rows": (3, 700, 900, 0.5),
                  "radius_scores_every_tile": (2, 400, 1500, 100.0),
                  "unbatched_no_query_mask": (1, 250, 777, 0.5),
                  "one_query_block": (3, 40, 300, 0.5),
                  "most_tiles": (1, 64, K2_MAX_TILES * TILE, 0.5)}[case]
    tgt = rng.normal(scale=1.5, size=(B, T, 3)).astype(np.float32)
    q = rng.normal(scale=1.5, size=(B, Q, 3)).astype(np.float32)
    q[:, : Q // 4] = tgt[:, rng.integers(0, T, Q // 4)]
    tm = rng.uniform(size=(B, T)) > 0.3
    qm = rng.uniform(size=(B, Q)) > 0.2
    if case == "masked_batch_rows":
        tm[1] = False      # every target of row 1 masked: counts 0
        qm[2] = False      # every query of row 2 masked: zeros
    tgt_t = t(tgt, dev)
    if case == "unaligned":   # a contiguous view 12 bytes into its storage
        buf = torch.zeros((1, T + 1, 3), device=dev)
        buf[:, 1:] = tgt_t
        tgt_t = buf[:, 1:]
        assert tgt_t.is_contiguous() and tgt_t.data_ptr() % 16 == 12
    if case == "unbatched_no_query_mask":
        return t(q[0], dev), tgt_t[0], t(tm[0], dev), r, None
    return t(q, dev), tgt_t, t(tm, dev), r, t(qm, dev)


@pytest.mark.parametrize("case", ["ragged_scalar_loads", "unaligned",
                                  "tgt_below_one_tile", "fewer_tiles_than_cluster",
                                  "masked_batch_rows", "radius_scores_every_tile",
                                  "unbatched_no_query_mask", "one_query_block",
                                  "most_tiles"])
def test_moments_kernel_geometry_cases(rng, dev, case):
    """K2 at the edges of its launch geometry: Q and T no multiple of the
    query block or the tile (T % 4 != 0 and an unaligned cloud take the
    scalar loads), T below one tile, fewer tiles than CTAs in the cluster
    (CTAs that own no box), whole batch rows masked, a radius at which no
    tile is skipped, an unbatched call without a query mask, one query
    block per row (a cluster of one CTA), the most target tiles its list
    holds.  Counts exact,
    S1/S2 within ``summation_tolerance``, masked query rows zero, one
    launch per call, and a second run bit-equal to the first."""
    q, tgt, tm, r, qm = _moments_inputs(rng, dev, case)
    B = q.shape[0] if q.dim() == 3 else 1
    Q, T = q.shape[-2], tgt.shape[-2]
    geo = _cuda.moments_geometry(B, Q, T)
    n_tiles = -(-T // geo["tile"])
    if case == "ragged_scalar_loads":
        assert Q % geo["queries_per_cta"] and T % geo["tile"] and not geo["vector_loads"]
    if case == "tgt_below_one_tile":
        assert n_tiles == 1
    if case == "fewer_tiles_than_cluster":
        assert n_tiles < geo["cluster"]
    if case == "one_query_block":
        assert geo["cluster"] == 1 and geo["grid"] == (1, B)
    if case == "most_tiles":
        assert n_tiles == K2_MAX_TILES
    if case == "radius_scores_every_tile":
        tiles, _ = scored_pairs(q, tgt, tm, r, qm)
        assert tiles == B * n_tiles * -(-Q // geo["queries_per_cta"])
    n0 = _cuda.launch_counts["ball_moments"]
    got = ball_moments(q, tgt, tm, r, query_mask=qm)
    again = ball_moments(q, tgt, tm, r, query_mask=qm)
    ref = ball_moments_plain(q, tgt, tm, r, query_mask=qm)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["ball_moments"] == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[0], ref[0])
    for k, (a, b) in enumerate(zip(got[1:], ref[1:]), start=1):
        err = (a - b).abs().amax(-1)
        assert bool((err <= summation_tolerance(ref[0], r, k)).all()), err.max()
    if qm is not None:
        assert not any(x[~qm].any() for x in got)
    if case == "masked_batch_rows":
        assert not got[0][1].any() and (ref[0][0] > 0).any()


def test_wrappers_reject_bad_inputs(dev):
    p = torch.zeros((1, 8, 3), device=dev)
    m = torch.ones((1, 8), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        nn_search(p.double(), p.double(), m)
    with pytest.raises(ValueError):
        nn_search(p[:, ::2], p, m)
    with pytest.raises(ValueError):
        nn_search(p, p, m.cpu())
    with pytest.raises(ValueError):
        nn_search_vals(p, p, m, p.double())
    with pytest.raises(ValueError):
        nn_pruned.nn_search_pruned_presorted(p, m, p, m, 1.0, 2048, 8)
    with pytest.raises(ValueError):
        ball_moments(p, p, m.float(), 0.5)
    with pytest.raises(ValueError):
        ball_moments(p.transpose(1, 2).contiguous().transpose(1, 2), p, m, 0.5)
    # one target more than K2's list of tiles holds: refused, no fallback
    T = K2_MAX_TILES * TILE + 1
    with pytest.raises(ValueError):
        _cuda.moments_geometry(1, 8, T)
    n0 = _cuda.launch_counts["ball_moments"]
    with pytest.raises(RuntimeError):
        ball_moments(p, torch.zeros((1, T, 3), device=dev),
                     torch.ones((1, T), dtype=torch.bool, device=dev), 0.5)
    assert _cuda.launch_counts["ball_moments"] == n0


def test_voxel_deterministic_and_equal_to_cpu(rng, dev):
    """No atomics: two runs on the card are bit-equal, and the card's
    centroids equal the CPU's to float64-rounding (cast to f32)."""
    pts = rng.uniform(-25, 25, size=(2, 20000, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 20000)) > 0.1
    c = cl.Cloud(t(pts, dev), t(mask, dev))
    a, na = cl.voxel_downsample_counted(c, 0.5, out_capacity=8192)
    b, nb = cl.voxel_downsample_counted(c, 0.5, out_capacity=8192)
    assert torch.equal(a.points, b.points) and torch.equal(na, nb)
    h, nh = cl.voxel_downsample_counted(cl.Cloud(t(pts, "cpu"), t(mask, "cpu")),
                                        0.5, out_capacity=8192)
    assert torch.equal(a.mask.cpu(), h.mask) and torch.equal(na.cpu(), nh)
    torch.testing.assert_close(a.points.cpu(), h.points, rtol=0, atol=1e-5)


def test_stage1_card_matches_cpu(tmp_path, dev):
    """run_scanmatcher on the card (kernels) and on the CPU (plain
    versions) of one small dataset: both kernels launched, both
    trajectories within 0.2 m ATE, relative transforms within 5e-3 m.  The
    moment sums differ in order, which turns the normals of the few
    near-degenerate neighbourhoods (box edges) and so moves a pose by
    ~1-2 mm."""
    d = str(tmp_path)
    info = synthetic.make_dataset(
        d, n_scans=9, seed=2, radius=8.0, scan_points=3000,
        world_kwargs={"n_pillars": 0, "n_boxes": 15},
        scanmatcher_params={"voxel_size": 0.3})
    cfg = IcpConfig(raw_capacity=4096, capacity=4096)
    _cuda.reset_launch_counts()
    gpu = run_scanmatcher(d, cfg=cfg, progress=False, device=dev)
    assert _cuda.launch_counts["nn_sweep"] > 0
    assert _cuda.launch_counts["ball_moments"] > 0
    cpu = run_scanmatcher(d, cfg=cfg, progress=False, device="cpu")
    dpos = np.linalg.norm(gpu["relative"][:, :3, 3] - cpu["relative"][:, :3, 3],
                          axis=1)
    assert dpos.max() < 5e-3, dpos
    for out in (gpu, cpu):
        assert ate(out["global"], info["T_gt"])["rmse"] < 0.2


def test_pose_graph_solve_refuses_tf32(dev):
    """The solvers' 6x6 products are f32 matmuls: a solve on the card with
    TF32 matmuls switched on raises instead of rounding them."""
    from lidar_slam_arvc_tpu_torch.graph import PoseGraph
    g = PoseGraph(max_poses=8, device=dev)
    g.init_graph()
    for i in range(5):
        rel = synthetic._yaw_T(1.0, 0.0, 0.05)
        g.add_initial_estimate(rel, i + 1)
        g.add_edge(rel, i, i + 1, "SM")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for solver in ("dense", "pcg"):
            with pytest.raises(RuntimeError, match="f32 matmuls"):
                g.optimize(solver=solver)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert np.isfinite(g.optimize(solver="pcg"))


def test_raw_moment_normals_refuse_tf32_and_match_k2(dev, rng):
    """``radius_accumulate`` raises under TF32 matmuls (its raw moments
    cancel in S2/n - m m^T), under ``allow_tf32`` and under
    ``set_float32_matmul_precision("high")`` alike; in full f32 its
    normals (``impl="xla"``) agree with K2's on a smooth sheet."""
    from lidar_slam_arvc_tpu_torch.ops.nn import radius_accumulate
    pts = rng.uniform(-3, 3, size=(300, 3)).astype(np.float32)
    pts[:, 2] = 0.3 * np.sin(pts[:, 0])
    c = cl.from_numpy(pts, 512, device=dev)
    for switch in (lambda: setattr(torch.backends.cuda.matmul, "allow_tf32", True),
                   lambda: torch.set_float32_matmul_precision("high")):
        switch()
        try:
            with pytest.raises(RuntimeError, match="f32 matmuls"):
                radius_accumulate(c.points, c.points, c.mask, 0.8)
        finally:
            torch.set_float32_matmul_precision("highest")
            torch.backends.cuda.matmul.allow_tf32 = False
    m = c.mask.cpu().numpy()
    a = cl.estimate_normals(c, 0.8, impl="xla").normals.cpu().numpy()[m]
    b = cl.estimate_normals(c, 0.8, impl="auto").normals.cpu().numpy()[m]
    assert np.abs(np.sum(a * b, axis=1)).min() > 0.999
    with pytest.raises(ValueError):
        cl.estimate_normals(c, 0.8, impl="pallas_interpret")


def test_singular_preconditioner_block_is_nonfinite(dev):
    """A singular 6x6 block through each PCG preconditioner's set-up (BCR,
    block tridiagonal, Jacobi) gives a non-finite preconditioner on the
    card, as LU gives on the CPU, so the LM rejects the step; the other
    blocks' inverses stay finite."""
    from lidar_slam_arvc_tpu_torch.graph import bcr, pcg, solver
    g = torch.Generator().manual_seed(0)
    M = torch.randn(8, 6, 6, generator=g, dtype=torch.float32)
    D = (M @ M.transpose(-1, -2) + 6.0 * torch.eye(6)).to(dev)
    E = (0.1 * torch.randn(8, 6, 6, generator=g)).to(dev)
    E[-1] = 0.0
    D[[0, 3]] = 0.0      # inverted directly: 3 by BCR, 0 by the tridiagonal
    b = torch.ones(8, 6, device=dev)
    levels, root = bcr.bcr_factor(D, E)
    assert not torch.isfinite(bcr.bcr_solve(levels, root, b)).all()
    Uinv, W = pcg._build_tridiag_precond(D, E)
    assert not torch.isfinite(pcg._apply_tridiag_precond(Uinv, W, E, b)).all()
    Minv = solver.inv_or_nan(D)
    assert torch.isnan(Minv[[0, 3]]).all()
    assert torch.isfinite(Minv[1:3]).all() and torch.isfinite(Minv[4:]).all()


@pytest.mark.parametrize("method", ["icp2planes", "fpfh"])
def test_m7_stage1_card_matches_cpu(tmp_path, dev, method):
    """run_scanmatcher under icp2planes and fpfh on the card and on the CPU
    of test_stage1_card_matches_cpu's dataset: the draws come from CPU
    generators, so both devices fit the same ground planes (masks equal but
    for points at the split's threshold); K1 and K2 launched; under
    icp2planes the relative transforms within 1e-2 m (the ground ICP's
    free x/y/yaw turns f32 rounding into millimetres,
    tests/test_torch_plane.py).  Under fpfh
    one match that differs between the devices shifts every later
    hypothesis draw, so the card's FPFH, feature search and registration
    are held in chip_smoke.py's phase 11 instead."""
    d = str(tmp_path)
    synthetic.make_dataset(
        d, n_scans=9, seed=2, radius=8.0, scan_points=3000,
        world_kwargs={"n_pillars": 0, "n_boxes": 15},
        scanmatcher_params={"voxel_size": 0.3, "method": method})
    cfg = IcpConfig(raw_capacity=4096, capacity=4096)
    _cuda.reset_launch_counts()
    gpu = run_scanmatcher(d, cfg=cfg, progress=False, device=dev,
                          return_preprocessed=True)
    assert _cuda.launch_counts["nn_sweep"] > 0
    assert _cuda.launch_counts["ball_moments"] > 0
    cpu = run_scanmatcher(d, cfg=cfg, progress=False, device="cpu",
                          return_preprocessed=True)
    for k in ("ground_mask", "nonground_mask"):
        a, b = (out["preprocessed"][k].cpu().numpy() for out in (gpu, cpu))
        assert (a != b).mean() < 1e-3
    assert np.isfinite(gpu["relative"]).all()
    if method == "icp2planes":
        dpos = np.linalg.norm(gpu["relative"][:, :3, 3] - cpu["relative"][:, :3, 3],
                              axis=1)
        assert dpos.max() < 1e-2, dpos


@pytest.mark.parametrize("capacity", [4096, 2048])
def test_icp2planes_card_matches_cpu_on_a_box_world(tmp_path, dev, capacity):
    """icp2planes on the card and on the CPU of six box-world scans
    (voxel 0.2 m, up to 3,330 voxels a scan).  Both devices keep the same
    clouds and draw the same planes (masks equal but for points at the
    split's threshold).  At capacity 4096 nothing is dropped and every
    pair agrees within 1e-2 m.  At 2048 each scan keeps the 2048 voxels
    lowest in key order, a slab of it, and some pairs become bistable: the
    ground plane's draws pick the ICP's basin (on the CPU the JAX
    package's own keys put pair 1 0.021 m or 0.889 m off the truth, and
    the port's seeds 0 and 1 do the same), and so can f32 rounding.  There
    a pair may move between the devices only if it also moves between CPU
    seeds 0, 1 and 2, and it must land in a basin a CPU seed reaches: within
    1e-2 m, or a tenth of the seeds' spread, of one of their results (the
    far basin of pair 1 is flat: the card and CPU seed 1 settle 5 cm
    apart in it, 0.88 m from the near one)."""
    from lidar_slam_arvc_tpu_torch.utils.workload import BOX_WORLD
    d = str(tmp_path)
    info = synthetic.make_dataset(
        d, n_scans=6, seed=2, radius=5.0, scan_points=4000, max_range=10.0,
        world_kwargs=BOX_WORLD,
        scanmatcher_params={"voxel_size": 0.2, "method": "icp2planes"})
    cfg = IcpConfig(raw_capacity=8192, capacity=capacity)
    gpu = run_scanmatcher(d, cfg=cfg, progress=False, device=dev,
                          return_preprocessed=True)
    seeds = range(3) if capacity == 2048 else range(1)
    cpu = [run_scanmatcher(d, cfg=cfg, progress=False, device="cpu",
                           return_preprocessed=s == 0, seed=s) for s in seeds]
    g, c = gpu["preprocessed"], cpu[0]["preprocessed"]
    assert torch.equal(g["mask"].cpu(), c["mask"])
    assert float((g["points"].cpu() - c["points"]).abs().max()) < 1e-5
    for k in ("ground_mask", "nonground_mask"):
        assert (g[k].cpu() != c[k]).float().mean() < 1e-3
    T = info["T_gt"]
    rel_gt = np.einsum("nij,njk->nik", np.linalg.inv(T[:-1]), T[1:])
    pos = [o["relative"][:, :3, 3] for o in (gpu, *cpu)]
    moved = np.linalg.norm(pos[0] - pos[1], axis=1)
    print(f"capacity {capacity}: pair error to the truth, card "
          f"{np.linalg.norm(pos[0] - rel_gt[:, :3, 3], axis=1)}, CPU seeds "
          f"{[np.linalg.norm(p - rel_gt[:, :3, 3], axis=1) for p in pos[1:]]}; "
          f"card - CPU seed 0 {moved}")
    if capacity == 4096:
        assert moved.max() < 1e-2, moved
    else:
        spread = np.max([np.linalg.norm(p - pos[1], axis=1) for p in pos[2:]], axis=0)
        nearest = np.min([np.linalg.norm(pos[0] - p, axis=1) for p in pos[1:]], axis=0)
        print(f"CPU seeds 1-2 - seed 0 {spread}; card - nearest CPU seed {nearest}")
        assert np.all((moved < 1e-2) | (spread > 1e-2)), (moved, spread)
        assert np.all(nearest < np.maximum(1e-2, 0.1 * spread)), (nearest, spread)
