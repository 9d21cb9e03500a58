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
