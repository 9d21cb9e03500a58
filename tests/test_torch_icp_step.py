"""The ICP step's two forms: K6 (``ops/icp_step.py``, ``csrc/icp_step.cu``)
on a card, and the eager step, its plain version, on the CPU.

On the CPU (tier 1): ``icp_batch``'s loop, driven through ``icp_step``'s
plain version, gives the result of the eager loop (``_eager_icp``: each
trip transforms, searches, gathers and steps on whole tensors) bit for
bit, under every loop form (convergence, fixed iterations, the coarse
phase, exact metrics) and every search form.  The eager loop searches
without the source mask, as the ICP did before its search took one, so
the same test holds the mask's contract (a masked source's index 0 and
d2 0.0 never reach the result) under every form.  The ``cuda`` tests hold the
kernel to the eager step on the card.  The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_icp_step.py
"""

import importlib

import numpy as np
import pytest
import torch

from lidar_slam_arvc_tpu_torch import cloud as cl
from lidar_slam_arvc_tpu_torch.geom.se3 import transform_points
from lidar_slam_arvc_tpu_torch.ops import _cuda
from lidar_slam_arvc_tpu_torch.ops.icp_step import (
    _advance, _gathered, _metrics, _update, icp_step, icp_step_plain,
)
from lidar_slam_arvc_tpu_torch.ops.icp_step import geometry as icp_geometry
from lidar_slam_arvc_tpu_torch.ops.nn import nn_search, nn_search_vals
from lidar_slam_arvc_tpu_torch.ops.nn_pruned import morton_sort, pad_rows
from lidar_slam_arvc_tpu_torch.parallel.dryrun import tiny_pair_batch
from lidar_slam_arvc_tpu_torch.pipeline.scanmatcher import run_scanmatcher
from lidar_slam_arvc_tpu_torch.registration.icp import ICPParams, ICPResult, icp_batch
from lidar_slam_arvc_tpu_torch.utils import profiling, synthetic
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig

# registration/__init__ exports a function named like its icp module
icp_mod = importlib.import_module("lidar_slam_arvc_tpu_torch.registration.icp")

torch.set_num_threads(1)

F32_EPS = torch.finfo(torch.float32).eps
BASE = ICPParams(max_correspondence_distance=5.0, max_iterations=8)
# (name, params, method): every loop form and every search form
LOOPS = [
    ("converge", BASE, "point_to_plane"),
    ("point_to_point", BASE, "point_to_point"),
    ("fixed_plain_weights", BASE._replace(convergence_tol=0.0, robust=False,
                                         max_iterations=5), "point_to_plane"),
    ("coarse_exact", BASE._replace(coarse_factor=2, coarse_iterations=3,
                                   exact_metrics=True, source_stride=2), "point_to_plane"),
    ("fixed_coarse_p2p", BASE._replace(convergence_tol=0.0, coarse_factor=2,
                                       coarse_iterations=2, max_iterations=3),
     "point_to_point"),
    ("vpu_tq", BASE._replace(nn_impl="vpu_tq"), "point_to_plane"),
    ("vpu_tq_p2p", BASE._replace(nn_impl="vpu_tq"), "point_to_point"),
    ("pruned", BASE._replace(nn_impl="pruned", src_block=256, tgt_block=256),
     "point_to_plane"),
    ("xla", BASE._replace(nn_impl="xla"), "point_to_plane"),
    ("no_iterations", BASE._replace(max_iterations=0), "point_to_plane"),
]


@pytest.fixture(scope="module")
def pairs():
    """4 odometry-seeded scan pairs at capacity 512, on the CPU."""
    return tiny_pair_batch(batch=4, cap=512, seed=1, device="cpu")


def _equal(a: ICPResult, b: ICPResult) -> bool:
    return all(torch.equal(torch.as_tensor(x), torch.as_tensor(y)) for x, y in zip(a, b))


def _eager_icp(src, sm, tgt, tm, tn, seeds, params: ICPParams, method: str) -> ICPResult:
    """The ICP as a plain eager loop: each trip transforms the sources,
    searches, gathers by index and takes the eager step, frozen pairs kept
    by ``torch.where``; with ``convergence_tol`` 0 every trip's result is
    taken whole."""
    stride = params.source_stride
    src, sm = src[:, ::stride], sm[:, ::stride]
    if params.nn_impl == "pruned":
        src, sm, _ = morton_sort(src, sm, min(512, params.src_block))
        tgt, tm, order = morton_sort(tgt, tm, min(512, params.tgt_block))
        tn = torch.take_along_dim(pad_rows(tn, order.shape[1]), order[..., None], dim=1)
    src, sm, tgt, tm, tn = (x.contiguous() for x in (src, sm, tgt, tm, tn))
    mask_f = sm.float()
    thr2 = params.max_correspondence_distance ** 2
    # only the pruned search reads the source mask here
    search_by = icp_mod._search(params, tgt, tm, tn)
    by_mask = sm if params.nn_impl == "pruned" else None

    def search(p):
        return search_by(p, by_mask)

    def step(T, pts, m):
        p = transform_points(T, pts)
        d2, idx, q, n = search(p)
        if idx is not None:
            q, n = _gathered(idx, tgt, tn)
        return _update(T, p, d2, q, n, m, thr2, params.robust, method == "point_to_plane")

    def phase(T, pts, m, max_iters, tol):
        B = T.shape[0]
        fit, rmse = torch.zeros(B), torch.full((B,), torch.inf)
        if params.convergence_tol > 0:
            it, delta = torch.zeros(B, dtype=torch.int32), torch.full((B,), torch.inf)
            state = (T, delta, fit, rmse, it, (it < max_iters) & (delta > tol))
            while bool(state[5].any()):
                state = _advance(state, step(state[0], pts, m), max_iters, tol)
            T, delta, fit, rmse, it, _ = state
            return T, it, delta, fit, rmse
        delta = torch.zeros(B)
        for _ in range(max_iters):
            T, delta, fit, rmse = step(T, pts, m)
        return T, torch.full((B,), max_iters, dtype=torch.int32), delta, fit, rmse

    T = seeds.float()
    iters = torch.zeros(T.shape[0], dtype=torch.int32)
    if params.coarse_factor > 1 and params.coarse_iterations > 0:
        f = params.coarse_factor
        T, it_c, _, _, _ = phase(T, src[:, ::f], mask_f[:, ::f], params.coarse_iterations,
                                 10.0 * params.convergence_tol)
        iters = iters + it_c
    T, it_f, delta, fit, rmse = phase(T, src, mask_f, params.max_iterations,
                                      params.convergence_tol)
    if params.exact_metrics or params.max_iterations == 0:
        _, fit, rmse = _metrics(search(transform_points(T, src))[0], mask_f, thr2)
    return ICPResult(T, fit, rmse, iters + it_f, torch.where(it_f > 0, delta, 0.0))


@pytest.mark.parametrize("name,params,method", LOOPS, ids=[c[0] for c in LOOPS])
def test_card_loop_with_the_plain_step_is_the_eager_loop(pairs, monkeypatch, name,
                                                         params, method):
    """``icp_batch``'s loop on CPU tensors (``icp_step`` runs its plain
    version there) is the eager loop, bit for bit, with one ``icp_step``
    call per trip; and it leaves the caller's seeds unwritten."""
    seeds = pairs[-1].clone()
    eager = _eager_icp(*pairs, params, method)
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return icp_step(*args, **kwargs)

    monkeypatch.setattr(icp_mod, "icp_step", counted)
    steps0 = profiling.counts["icp_steps"]
    got = icp_batch(*pairs, params, method)
    assert profiling.counts["icp_steps"] - steps0 == len(calls)
    assert _equal(got, eager), name
    assert torch.equal(pairs[-1], seeds)
    if params.max_iterations:
        assert calls


MASKED_SEARCHES = [("k1", BASE), ("k1_p2p", BASE), ("k4", BASE._replace(nn_impl="vpu_tq")),
                   ("vpu", BASE._replace(nn_impl="vpu")), ("mxu", BASE._replace(nn_impl="mxu")),
                   ("k1_coarse_exact", LOOPS[3][1])]


@pytest.mark.parametrize("layout", ["prefix", "scattered", "one_pair_masked"])
@pytest.mark.parametrize("name,params", MASKED_SEARCHES, ids=[c[0] for c in MASKED_SEARCHES])
def test_source_mask_leaves_the_transforms_bit_identical(pairs, monkeypatch, layout, name,
                                                          params):
    """``icp_batch`` with the source mask passed to the search (K1, K3, K4:
    index 0 and d2 0.0 for a masked source) gives the transforms, fitness,
    RMSE, iterations and final deltas of the search without it, bit for
    bit, on the voxel grid's prefix masks, on scattered masks (icp2planes'
    ground and non-ground rows) and with a pair whose sources are all
    masked."""
    src, sm, tgt, tm, tn, seeds = (x.clone() for x in pairs)
    if layout == "scattered":
        rng = np.random.default_rng(5)
        sm &= torch.from_numpy(rng.uniform(size=sm.shape) > 0.4)
        tm &= torch.from_numpy(rng.uniform(size=tm.shape) > 0.4)
    elif layout == "one_pair_masked":
        sm[2] = False
    method = "point_to_point" if name.endswith("p2p") else "point_to_plane"
    real_k1, real_k4 = icp_mod._nn_search, icp_mod._nn_search_vals
    seen = []

    def spy(src_mask_seen):
        def wrap(real):
            def call(*args):
                seen.append(args[-1] is not None)
                return real(*args[:-1], None if not src_mask_seen else args[-1])
            return call
        return wrap

    for masked in (True, False):
        monkeypatch.setattr(icp_mod, "_nn_search", spy(masked)(real_k1))
        monkeypatch.setattr(icp_mod, "_nn_search_vals", spy(masked)(real_k4))
        got = icp_batch(src, sm, tgt, tm, tn, seeds, params, method)
        if masked:
            with_mask = got
    assert seen and all(seen)
    for a, b in zip(with_mask, got):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b), name
    if layout == "one_pair_masked":
        assert float(with_mask.fitness[2]) == 0.0


def test_plain_step_advances_state_in_place(pairs):
    """``icp_step_plain``: the state tensors themselves are written (a
    frozen pair keeps its pose, fitness and count), and the returned
    sources are the new poses applied to the sources."""
    src, sm, tgt, tm, tn, seeds = pairs
    B = src.shape[0]
    T = seeds.clone()
    state = (T, torch.full((B,), torch.inf), torch.zeros(B), torch.full((B,), torch.inf),
             torch.zeros(B, dtype=torch.int32), torch.tensor([True, False, True, True]))
    p = transform_points(T, src)
    idx, d2 = nn_search(p, tgt, tm)
    out = icp_step_plain(src, p, sm.float(), d2, idx, None, None, tgt, tn, state,
                         thr2=25.0, robust=True, point_to_plane=True, max_iters=8,
                         tol=1e-4)
    assert state[0] is T
    assert torch.equal(T[1], seeds[1]) and state[2][1] == 0 and state[4][1] == 0
    assert state[4].tolist() == [1, 0, 1, 1] and bool(state[5][0])
    assert not torch.equal(T[0], seeds[0])
    assert torch.equal(out, transform_points(T, src))


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        icp_step(torch.zeros((1, 4, 3), device="meta"), *([None] * 9), thr2=1.0,
                 robust=True, point_to_plane=True, max_iters=1, tol=0.0)


# ---------------------------------------------------------------- the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _step_inputs(dev, by_value: bool):
    """One step's inputs on the card for 6 pairs (S = T = 3000: no multiple
    of a CTA's 256 threads): pair 0 plain, pair 1 frozen, pair 2 with every
    source masked, pair 3 a non-finite system (a NaN target point behind a
    gated correspondence), pair 4 at its last allowed iteration, pair 5 a
    copy of pair 0."""
    src, sm, tgt, tm, tn, seeds = (x.to(dev) for x in tiny_pair_batch(
        batch=6, cap=3000, seed=4, device="cpu"))
    for x in (src, sm, tgt, tm, tn, seeds):
        x[5] = x[0]
    sm[2] = False
    B = src.shape[0]
    T = seeds.clone()
    p = transform_points(T, src)
    if by_value:
        d2, q, n = nn_search_vals(p, tgt, tm, tn)
        idx = None
        s = int(torch.nonzero(sm[3] & (d2[3] < 1.0))[0])
        q[3, s] = float("nan")
    else:
        idx, d2 = nn_search(p, tgt, tm)
        q = n = None
        s = int(torch.nonzero(sm[3] & (d2[3] < 1.0))[0])
        tgt = tgt.clone()
        tgt[3, idx[3, s]] = float("nan")
    state = (T, torch.full((B,), torch.inf, device=dev), torch.zeros(B, device=dev),
             torch.full((B,), torch.inf, device=dev),
             torch.tensor([0, 3, 0, 0, 7, 0], dtype=torch.int32, device=dev),
             torch.tensor([True, False, True, True, True, True], device=dev))
    return src, p, sm.float(), d2, idx, q, n, tgt, tn, state


def _clone(state):
    return tuple(x.clone() for x in state)


def _assert_near_the_eager_step(got, ref, ref64):
    """K6's state ``got`` against the eager f32 step's ``ref`` and the
    float64 step's ``ref64``: T, delta, fitness and RMSE each within 10x
    the eager f32 step's distance from float64 plus 16 f32 ulps of its
    size, non-finite entries equal; it and active exactly."""
    for name, g, r, r64 in zip(("T", "delta", "fit", "rmse"), got, ref, ref64):
        g, r = g.cpu().double(), r.cpu().double()
        fin = torch.isfinite(r64)      # a frozen pair's delta and rmse are inf
        assert torch.equal(g[~fin], r64[~fin]) and torch.equal(r[~fin], r64[~fin]), name
        e_got = float((g - r64)[fin].abs().max())
        e_ref = float((r - r64)[fin].abs().max())
        floor = 16 * F32_EPS * float(r64[fin].abs().max())
        assert e_got <= 10 * e_ref + floor, (name, e_got, e_ref)
    assert torch.equal(got[4], ref[4]) and torch.equal(got[5], ref[5])


def _f64(x):
    if x is None:
        return None
    return x.cpu().double() if x.is_floating_point() else x.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("by_value", [False, True], ids=["index", "values"])
@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("method", ["point_to_plane", "point_to_point"])
def test_k6_step_matches_the_eager_step(dev, method, robust, by_value):
    """K6 against the eager step on the same inputs.  T, delta, fitness and
    RMSE differ from the eager f32 step only by the order of f32 sums: each
    lies within 10x the eager f32 step's own distance from the same step in
    float64, plus 16 f32 ulps of its size.  it and active exactly; the
    frozen pair untouched, the masked pair and the non-finite system at T
    unchanged with delta 0; a pair's result independent of its place in
    the group; the returned sources transform_points of the new T, bit for
    bit."""
    inputs = _step_inputs(dev, by_value)
    src, p, mask, d2, idx, q, n, tgt, tn, state = inputs
    T0 = state[0].clone()
    kw = dict(thr2=25.0, robust=robust, point_to_plane=method == "point_to_plane",
              max_iters=8, tol=1e-4)
    ref = _clone(state)
    icp_step_plain(*inputs[:9], ref, **kw)
    ref64 = tuple(_f64(x) for x in state)
    icp_step_plain(*(_f64(x) for x in inputs[:9]), ref64, **kw)
    got = _clone(state)
    n0 = _cuda.launch_counts["icp_step"]
    got_p = icp_step(*inputs[:9], got, **kw)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["icp_step"] == n0 + 1
    _assert_near_the_eager_step(got, ref, ref64)
    T, delta, fit, rmse, it, active = got
    assert it.tolist() == [1, 3, 1, 1, 8, 1] and not bool(active[4])
    for b in (1, 2, 3):
        assert torch.equal(T[b], T0[b]), b
    assert float(delta[2]) == 0.0 and float(delta[3]) == 0.0 and float(fit[2]) == 0.0
    assert not torch.equal(T[0], T0[0])
    assert torch.equal(T[0], T[5]) and torch.equal(got_p[0], got_p[5])
    assert torch.equal(got_p, transform_points(T, src))


WHOLE_SCAN = 65536   # a whole HDL-32E scan at full resolution


@pytest.mark.cuda
def test_k6_two_register_rounds_match_the_eager_step(dev):
    """K6 at S = T = 65536, B = 4: 8 CTAs a pair of 8192 sources, each
    loaded in two register rounds of 4096 (the path a whole scan takes;
    S <= 32768 is one round).  ~60,000 valid points a scan, so every CTA
    but the last holds valid sources in both rounds.  Full-resolution
    scans (crop, compaction, K2 normals at 0.3 m), K1's correspondences
    from the odometry seeds, point-to-plane with robust weights, against
    the eager step as above; the next sources bit for bit."""
    assert icp_geometry(WHOLE_SCAN) == {"cluster": 8, "slice": 8192, "rounds": 2,
                                        "threads": 256}
    rng = np.random.default_rng(5)
    world = synthetic.make_world(rng, extent=30.0, n_ground=150000, n_pillars=40,
                                 pillar_pts=2500)
    poses = synthetic.make_trajectory(60, radius=12.0)[:5]
    raw = [cl.from_numpy(synthetic.render_scan(world, T, rng, max_points=60000),
                         WHOLE_SCAN, device=dev) for T in poses]
    c = cl.Cloud(torch.stack([r.points for r in raw]), torch.stack([r.mask for r in raw]))
    c = cl.crop_radius_height(c, 0.5, 35.0, -1.0, 50.0)
    c, n = cl.compact_counted(c, WHOLE_SCAN)
    c = cl.estimate_normals(c, 0.3)
    assert int(n.min()) > 7 * 8192
    src, sm, tgt, tm, tn = (x.contiguous() for x in (
        c.points[1:], c.mask[1:], c.points[:-1], c.mask[:-1], c.normals[:-1]))
    seeds = torch.as_tensor(np.stack([np.linalg.inv(poses[i]) @ poses[i + 1]
                                      for i in range(4)]), dtype=torch.float32, device=dev)
    p = transform_points(seeds, src)
    idx, d2 = nn_search(p, tgt, tm)
    B = 4
    state = (seeds, torch.full((B,), torch.inf, device=dev), torch.zeros(B, device=dev),
             torch.full((B,), torch.inf, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev),
             torch.ones(B, dtype=torch.bool, device=dev))
    inputs = (src, p, sm.float(), d2, idx, None, None, tgt, tn)
    kw = dict(thr2=100.0, robust=True, point_to_plane=True, max_iters=30, tol=1e-4)
    ref = _clone(state)
    icp_step_plain(*inputs, ref, **kw)
    ref64 = tuple(_f64(x) for x in state)
    icp_step_plain(*(_f64(x) for x in inputs), ref64, **kw)
    got = _clone(state)
    got_p = icp_step(*inputs, got, **kw)
    torch.cuda.synchronize()
    _assert_near_the_eager_step(got, ref, ref64)
    assert not torch.equal(got[0], seeds)
    assert torch.equal(got_p, transform_points(got[0], src))


CARD_LOOPS = [c for c in LOOPS if c[0] in ("converge", "point_to_point",
                                             "fixed_plain_weights", "coarse_exact",
                                             "vpu_tq", "pruned")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,params,method", CARD_LOOPS, ids=[c[0] for c in CARD_LOOPS])
def test_icp_batch_card_matches_cpu(pairs, dev, name, params, method):
    """Whole ``icp_batch`` on the card (K1/K4/K5 and K6) against the same
    call on the CPU (the eager step): poses within 1e-4 m / rad, fitness
    within 1e-3, and one K6 launch per loop trip."""
    cpu = icp_batch(*pairs, params, method)
    n0 = _cuda.launch_counts["icp_step"]
    steps0 = profiling.counts["icp_steps"]
    card = icp_batch(*(x.to(dev) for x in pairs), params, method)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["icp_step"] - n0 == profiling.counts["icp_steps"] - steps0 > 0
    torch.testing.assert_close(card.transform.cpu(), cpu.transform, rtol=0, atol=1e-4)
    torch.testing.assert_close(card.fitness.cpu(), cpu.fitness, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_two_card_runs_are_bit_equal(pairs, dev):
    """No atomics: a group registered twice gives the same bits."""
    args = [x.to(dev) for x in pairs]
    a = icp_batch(*args, BASE, "point_to_plane")
    b = icp_batch(*args, BASE, "point_to_plane")
    assert _equal(a, b)


@pytest.mark.cuda
def test_wrapper_refuses_bad_inputs_without_a_launch(dev):
    src, p, mask, d2, idx, q, n, tgt, tn, state = _step_inputs(dev, False)
    kw = dict(thr2=25.0, robust=True, point_to_plane=True, max_iters=8, tol=1e-4)
    n0 = _cuda.launch_counts["icp_step"]
    bad = [
        dict(d2=d2.double()),                       # dtype
        dict(mask=mask.bool()),                     # dtype
        dict(p=p[:, :-1]),                          # shape
        dict(idx=idx.long()),                       # dtype
        dict(tgt=tgt.cpu()),                        # device
        dict(src=src.transpose(0, 1).contiguous().transpose(0, 1)),  # not contiguous
        dict(q=p, n=p),                             # both forms
        dict(idx=None),                             # neither form
        dict(state=(state[0][:, :3],) + state[1:]),  # shape
        dict(state=state[:5] + (state[5].int(),)),   # dtype
    ]
    for change in bad:
        args = dict(src=src, p=p, mask=mask, d2=d2, idx=idx, q=q, n=n, tgt=tgt, tn=tn,
                    state=state)
        args.update(change)
        with pytest.raises(ValueError):
            icp_step(args["src"], args["p"], args["mask"], args["d2"], args["idx"],
                     args["q"], args["n"], args["tgt"], args["tn"], args["state"], **kw)
    assert _cuda.launch_counts["icp_step"] == n0


@pytest.mark.cuda
def test_run_scanmatcher_launches_k6_once_per_icp_step(tmp_path, dev):
    """Stage 1 on the card: one K6 launch per ICP loop trip, one K1 launch
    per trip, both in the profile's kernel launches."""
    d = str(tmp_path)
    synthetic.make_dataset(d, n_scans=9, seed=2, radius=8.0, scan_points=3000,
                           world_kwargs={"n_pillars": 0, "n_boxes": 15},
                           scanmatcher_params={"voxel_size": 0.3})
    cfg = IcpConfig(raw_capacity=4096, capacity=4096)
    prof = run_scanmatcher(d, cfg=cfg, progress=False, device=dev)["profile"]
    launches = prof["kernel_launches"]
    assert launches["icp_step"] == prof["icp_steps"] == launches["nn_sweep"] > 0
