"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives ``lidar_slam_arvc_tpu_torch`` (never JAX) through eight phases, one
line each, and exits non-zero on any failure:

1. device: name, power limit, TF32 flags; build the CUDA kernels (nvcc).
2. K1 (csrc/nn_sweep.cu) vs its plain PyTorch version on the card: batch
   4 at S=2048/T=8192 and S=T=8192, plus a ragged 77 x 131 case, ~30%
   masked targets and duplicated targets (ties).  Indices equal, d2
   bit-equal.  Times of both and the launch geometry (grid, cluster size =
   the split of the target axis, sources per thread).
3. K2 (csrc/ball_moments.cu) vs its plain version: 4 voxelised synthetic
   scans at capacity 8192, r = 0.5, plus a ragged case.  Counts exact;
   S1/S2 within the summation-order bound ``ops.moments.summation_tolerance``;
   masked rows zero; two runs bit-equal.  Launch geometry, tiles and pairs
   scored, the FLOP bound and the issue-rate bound of K2's own loop (issue
   slots per pair from its SASS, ``utils/sass.py``).
4. stage 1 end to end: a synthetic EUROC dataset at bench.py's workload
   (257 scans x 12,000 points), ``pipeline.cli.main(["scanmatch", ...])``
   in process, once to warm up and once timed; the three CSVs, K1's and
   K2's launch counts, ATE < 0.2 m against ground truth.
5. K3 (csrc/nn_sweep.cu, d2 forms vpu / vpu2 / mxu) and K4
   (csrc/nn_sweep_vals.cu) vs their plain versions at phase 2's shapes:
   indices equal, d2 bit-equal, K4's q and n equal; geometry as phase 2.
   Fails if the grid at B=4, S=2048, T=8192 has fewer than 132 CTAs.
6. K5 (csrc/nn_pruned.cu) vs its plain version on 4 voxelised scan pairs
   at capacity 8192, source stride 4, gate 10 m, plus a ragged case: idx
   equal, d2 bit-equal; within the gate d2 agrees with K1's and the index
   is K1's wherever that nearest neighbour is unique; geometry.
7. stage 1 under every nn_impl: phase 4's dataset preprocessed once, then
   ``pipeline.scanmatcher.match_all`` (bench.py's matcher: batch 4, 30
   iterations, tol 1e-4, gate 10 m, source stride 4) with nn_impl auto
   (K1), vpu, vpu2, mxu (K3), vpu_tq (K4) and pruned (K5), each with the
   launch counts set to 0 just before and read just after: relative
   transforms within 1e-3 m / 1e-3 rad of the K1 run, ATE < 0.2 m, no pair
   fallen back to its seed, its kernel launched.
   Then "phase 2/3/5/6 profile" lines: the CUDA kernels one wrapper call of
   each phase launches and their device time, from torch.profiler traces
   taken only now, after every timed phase: a profiler session stays
   attached and slows every later launch from the host, and with it the
   host-bound ICP runs.  Fails if a sweep or K2 call launches other than
   one kernel or a K5 call more than two.
8. the last line: {"ok": true, "device": {...}}.

Before the last line it prints the card's name and power limit as
nvidia-smi reports them and one JSON line of per-kernel results: time of
the wrapper (CUDA events over back-to-back calls), plain-version time and
the bound (the larger of the bytes the function must move over the HBM
rate and its FP32 operations over the FP32 peak, NVIDIA's H100 SXM data
sheet), from this run's inputs.  The sweeps need sm_90a (thread block
clusters).
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lidar_slam_arvc_tpu_torch.geom.se3 import transform_points  # noqa: E402
from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset  # noqa: E402
from lidar_slam_arvc_tpu_torch.ops import _cuda, nn_pruned  # noqa: E402
from lidar_slam_arvc_tpu_torch.ops.moments import (  # noqa: E402
    ball_moments, ball_moments_plain, scored_pairs, summation_tolerance)
from lidar_slam_arvc_tpu_torch.ops.nn import (  # noqa: E402
    nn_search, nn_search_plain, nn_search_vals, nn_search_vals_plain)
from lidar_slam_arvc_tpu_torch.pipeline import cli  # noqa: E402
from lidar_slam_arvc_tpu_torch.pipeline import scanmatcher as sm  # noqa: E402
from lidar_slam_arvc_tpu_torch.registration.icp import ICPParams  # noqa: E402
from lidar_slam_arvc_tpu_torch.utils import sass, synthetic  # noqa: E402
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig  # noqa: E402
from lidar_slam_arvc_tpu_torch.utils.metrics import ate  # noqa: E402
from lidar_slam_arvc_tpu_torch.utils.workload import (  # noqa: E402
    CAPACITY, RADIUS, SCAN_POINTS, VOXEL, WORLD, cloud_points, k2_cases,
    voxelised_scans)

N_SCANS = 257
STRIDE = 4            # bench.py's default source stride
GATE = 10.0           # bench.py's correspondence gate (m)
# the K5 d2 against K1's within the gate: the matmul form |t|^2 - 2 s.t
# cancels terms of ~10^3 at the scans' 25 m range (the reference's own
# test, tests/test_nn_pruned.py, holds it to the same 1e-3)
MATMUL_ATOL = 1e-3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12          # H100 SXM, FP32 outside the tensor cores
SM_CLOCK_HZ = 1.98e9        # H100 SXM boost clock
# nn_impl -> the launch-count key (and JSON name) of the kernel it selects
NN_IMPLS = {"auto": "nn_sweep", "vpu": "nn_sweep_vpu", "vpu2": "nn_sweep_vpu2",
            "mxu": "nn_sweep_mxu", "vpu_tq": "nn_sweep_vals",
            "pruned": "nn_pruned"}
MIN_SWEEP_CTAS = 132        # the H100 SXM's SMs: the S2048 sweep must fill them
MAX_K5_LAUNCHES = 2         # kernels one K5 call may launch (its preparation included)
PROFILE_REPS = 20           # wrapper calls per torch.profiler trace
PROFILE_ATTEMPTS = 3        # traces taken before an empty one fails


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_profile(fn, reps: int = PROFILE_REPS):
    """(CUDA kernels per call of ``fn``, their device ms per call, kernels
    recorded), from a torch.profiler trace of ``reps`` calls after one
    warm-up.  The trace can miss a record (9 of 10 in one run), so the
    count per call is the recorded count over ``reps``, rounded, and the
    time per call is the mean time per recorded kernel times that count.
    The first trace of a process has come back empty (once, with the
    kernels just built), so an empty trace is taken again, up to
    PROFILE_ATTEMPTS traces; fails when none holds device activity."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    else:
        fail(f"torch.profiler recorded no device activity in "
             f"{PROFILE_ATTEMPTS} traces")
    per_call = round(len(kernels) / reps)
    per_kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) / len(kernels) / 1e3
    return per_call, per_kernel_ms * per_call, len(kernels)


# (phase, label, call, most kernels a call may launch), profiled after phase 7
PROFILES = []


def profile_later(phase: int, label: str, fn, max_kernels: int) -> None:
    PROFILES.append((phase, label, fn, max_kernels))


def phase_profiles():
    """The registered wrapper calls under torch.profiler, one line per
    phase; fails on a call that launches no kernel or too many."""
    lines = {}
    for phase, label, fn, max_kernels in PROFILES:
        n, dev_ms, rec = kernel_profile(fn)
        if not 1 <= n <= max_kernels:
            fail(f"phase {phase} {label}: {n} kernels per call, expected 1"
                 + (f" to {max_kernels}" if max_kernels > 1 else ""))
        lines.setdefault(phase, []).append(
            f"{label}: {n} kernel(s) per call ({rec} in {PROFILE_REPS}), "
            f"device {dev_ms:.4f} ms")
    for phase, items in sorted(lines.items()):
        print(f"phase {phase} profile (torch.profiler, after phase 7): "
              + "; ".join(items))


def geometry_text(g: dict) -> str:
    per = (f"{g['rows_per_thread']} sources/thread" if "rows_per_thread" in g
           else f"{g['rows_per_cta']} rows/CTA on {g['threads_per_row']} threads each")
    return (f"grid {g['grid'][0]}x{g['grid'][1]} = {g['grid'][0] * g['grid'][1]} "
            f"CTAs of {g['threads']} threads, cluster {g['cluster']}, {per}")


def bound_ms(n_bytes: float, flops: float):
    """(least time in ms, what bounds it) on an H100 SXM at its peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.library()
    info = _cuda.build_info
    regs = " | ".join(line.split("ptxas info    : ")[-1].strip()
                      for line in info["log"].splitlines()
                      if "Used" in line)
    print(f"phase 1 device: torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {name}; nvidia-smi: {smi}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; kernels built in "
          f"{info['seconds']:.2f}s (cached={info['cached']}); ptxas: {regs}")
    return name, smi


def _nn_cases(rng, dev):
    """Phase 2's and 5's inputs: (tag, src, tgt, mask, normals) on the card,
    B = 4, ~30% masked targets, 10% duplicated targets (ties), a quarter
    of the sources on targets."""
    cases = []
    for tag, B, S, T in (("ragged", 4, 77, 131), ("S2048", 4, 2048, 8192),
                         ("S8192", 4, 8192, 8192)):
        src = cloud_points(rng, B, S)
        tgt = cloud_points(rng, B, T)
        dup = rng.integers(0, T, T // 10)
        tgt[:, rng.integers(0, T, T // 10)] = tgt[:, dup]
        src[:, : S // 4] = tgt[:, rng.integers(0, T, S // 4)]
        mask = rng.uniform(size=(B, T)) > 0.3
        nrm = rng.normal(size=(B, T, 3)).astype(np.float32)
        cases.append((tag, *(torch.from_numpy(a).to(dev)
                             for a in (src, tgt, mask, nrm))))
    return cases


def _sweep_bound(s, t, m, flops_per_pair, extra_in=(), outs=()):
    B, S = s.shape[:2]
    return bound_ms(nbytes(s, t, m, *extra_in, *outs),
                    B * S * t.shape[1] * flops_per_pair)


def phase_k1(cases):
    results = {}
    max_err = 0.0
    for tag, s, t, m, _ in cases:
        B, S = s.shape[:2]
        T = t.shape[1]
        i_k, d_k = nn_search(s, t, m)
        i_p, d_p = nn_search_plain(s, t, m)
        torch.cuda.synchronize()
        if not torch.equal(i_k, i_p):
            fail(f"K1 {tag}: indices differ in "
                 f"{int((i_k != i_p).sum())} of {B * S} rows")
        if not torch.equal(d_k, d_p):
            fail(f"K1 {tag}: d2 not bit-equal (max |diff| "
                 f"{float((d_k - d_p).abs().max())})")
        max_err = max(max_err, float((d_k - d_p).abs().max()))
        reps = 20 if S * T >= 2 ** 24 else 50
        results[tag] = (cuda_ms(lambda: nn_search(s, t, m), reps),
                        cuda_ms(lambda: nn_search_plain(s, t, m), 5),
                        _sweep_bound(s, t, m, 8, outs=(i_k, d_k)),
                        _cuda.sweep_geometry(B, S, T, s.device))
        profile_later(2, f"nn_sweep {tag}", lambda s=s, t=t, m=m: nn_search(s, t, m), 1)
    print("phase 2 K1 nn_sweep vs plain: indices equal, d2 bit-equal; "
          + "; ".join(f"B=4 {tag}: wrapper {k:.4f} ms, plain {p:.4f} ms, "
                      f"bound {b[0]:.4f} ms ({b[1]}); {geometry_text(g)}"
                      for tag, (k, p, b, g) in results.items()))
    # K1's main path is phase 4 (source stride 1): S = T = 8192
    k, p, (b, by), *_ = results["S8192"]
    return {"max_abs_err": max_err, "ms": k, "plain_ms": p, "bound_ms": b,
            "bound_by": by, "all": results}


def _k2_issue_slots(vector_loads: bool) -> tuple[float, float]:
    """(issue slots every scored pair costs, issue slots more for a
    neighbour) in K2's hot loop (utils/sass.py: its instructions over its
    ball compares, the accumulations behind the branch apart), in the
    instantiation that the phase-3 scans take (16-byte loads or scalar)."""
    funcs, _ = sass.disassemble()
    tag = f"Lb{int(vector_loads)}EEEv"   # the last template argument: VEC
    names = [n for n in funcs if "ball_moments_kernel" in n and tag in n]
    if len(names) != 1:
        fail(f"K2's kernel not found once in the SASS ({names})")
    slots, branch, *_ = sass.issue_slots_per_pair(funcs[names[0]])
    if slots is None:
        fail("K2's hot loop has no ball compare (FSETP) in the SASS")
    return slots, branch


def phase_k2(rng, dev):
    cases = k2_cases(rng, dev)
    c = cases[-1][1]
    max_err = 0.0
    times = {}
    for tag, cloud, r in cases:
        args = (cloud.points, cloud.points, cloud.mask, r)
        ck, s1k, s2k = ball_moments(*args, query_mask=cloud.mask)
        again = ball_moments(*args, query_mask=cloud.mask)
        cp, s1p, s2p = ball_moments_plain(*args, query_mask=cloud.mask)
        torch.cuda.synchronize()
        if not torch.equal(ck, cp):
            fail(f"K2 {tag}: counts differ in {int((ck != cp).sum())} rows")
        if not all(torch.equal(a, b) for a, b in zip((ck, s1k, s2k), again)):
            fail(f"K2 {tag}: two runs differ")
        if bool(s1k[~cloud.mask].any()) or bool(s2k[~cloud.mask].any()) or \
                bool(ck[~cloud.mask].any()):
            fail(f"K2 {tag}: masked query rows are not zero")
        e1 = (s1k - s1p).abs().amax(-1)
        e2 = (s2k - s2p).abs().amax(-1)
        if bool((e1 > summation_tolerance(cp, r, 1)).any()) or \
                bool((e2 > summation_tolerance(cp, r, 2)).any()):
            fail(f"K2 {tag}: S1/S2 beyond the summation-order bound "
                 f"(max |diff| S1 {float(e1.max())}, S2 {float(e2.max())})")
        max_err = max(max_err, float(e1.max()), float(e2.max()))
        def call(args=args, m=cloud.mask):
            return ball_moments(*args, query_mask=m)
        times[tag] = (cuda_ms(call, 20),
                      cuda_ms(lambda: ball_moments_plain(*args, query_mask=cloud.mask), 3))
        profile_later(3, f"ball_moments {tag}", call, 1)
    # the work this data needs: 8 operations per scored (query, target)
    # pair, 16 more per neighbour (count, S1, S2)
    B, Q = c.mask.shape
    geo = _cuda.moments_geometry(B, Q, Q)
    tiles, pairs = scored_pairs(c.points, c.points, c.mask, RADIUS, c.mask)
    neighbours = float(ck.sum())
    b, by = bound_ms(nbytes(c.points, c.points, c.mask, c.mask) + ck.numel() * 40,
                     8.0 * pairs + 16.0 * neighbours)
    # the issue rate of K2's own loop: 4 warp-instructions a cycle an SM;
    # every scored pair runs the path to its ball compare, a neighbour also
    # the accumulations behind the branch
    path, branch = _k2_issue_slots(geo["vector_loads"])
    slots = path + branch * neighbours / pairs
    issue_ms = pairs * slots / (_cuda.sm_count(dev) * 128 * SM_CLOCK_HZ) * 1e3
    n_valid = int(c.mask.sum())
    n_all = B * -(-Q // geo["queries_per_cta"]) * -(-Q // geo["tile"])
    print(f"phase 3 K2 ball_moments vs plain: counts exact, max |S1/S2 diff| "
          f"{max_err:.3g} (within the stated bound), masked rows zero, two runs "
          f"bit-equal; B=4 scans at capacity {CAPACITY} ({n_valid} valid "
          f"points), r={RADIUS}: wrapper {times['scans'][0]:.4f} ms, plain "
          f"{times['scans'][1]:.4f} ms, FLOP bound {b:.4f} ms ({by}), issue-rate "
          f"bound {issue_ms:.4f} ms ({slots:.3f} issue slots per pair: {path:.3f} "
          f"on every scored pair, {branch:.3f} more on each neighbour); {tiles} "
          f"of {n_all} tiles scored, {pairs} pairs, {int(neighbours)} neighbours; "
          f"grid {geo['grid'][0]}x{geo['grid'][1]} CTAs of {geo['threads']} "
          f"threads, cluster {geo['cluster']}, {geo['queries_per_cta']} queries "
          f"per CTA on {geo['lanes']} threads each, tile {geo['tile']}, "
          f"{'16-byte' if geo['vector_loads'] else 'scalar'} loads, "
          f"{geo['smem']} B dynamic smem; ragged B=2 Q=T=1000: wrapper "
          f"{times['ragged'][0]:.4f} ms, plain {times['ragged'][1]:.4f} ms")
    return {"max_abs_err": max_err, "ms": times["scans"][0],
            "plain_ms": times["scans"][1], "bound_ms": b, "bound_by": by}


def _rows(path):
    with open(path) as f:
        return sum(1 for _ in f) - 1


def phase_stage1(tmp, smi):
    d = os.path.join(tmp, "euroc")
    t0 = time.time()
    info = synthetic.make_dataset(
        d, n_scans=N_SCANS, seed=0, scan_points=SCAN_POINTS,
        world_kwargs=WORLD,
        scanmatcher_params={"voxel_size": VOXEL, "method": "icppointplane"})
    gen_s = time.time() - t0
    argv = ["scanmatch", "-i", d, "--capacity", str(CAPACITY)]
    if cli.main(argv) != 0:
        fail("stage 1 warm-up run returned non-zero")
    _cuda.reset_launch_counts()
    if cli.main(argv) != 0:
        fail("stage 1 timed run returned non-zero")
    launches = dict(_cuda.launch_counts)
    smd = f"{d}/robot0/scanmatcher"
    rows = (_rows(f"{smd}/lidar_times.csv"),
            _rows(f"{smd}/scanmatcher_relative.csv"),
            _rows(f"{smd}/scanmatcher_global.csv"))
    if rows != (N_SCANS, N_SCANS - 1, N_SCANS):
        fail(f"stage 1 CSV rows {rows}, expected "
             f"({N_SCANS}, {N_SCANS - 1}, {N_SCANS})")
    for k in ("nn_sweep", "ball_moments"):
        if launches[k] <= 0:
            fail(f"stage 1 did not launch kernel {k}")
    euroc = EurocDataset(d)
    _, T_glob = euroc.read_trajectory("/robot0/scanmatcher/scanmatcher_global.csv")
    err = ate(T_glob, info["T_gt"])
    if not np.isfinite(T_glob).all() or err["rmse"] >= VOXEL:
        fail(f"stage 1 ATE rmse {err['rmse']} m is not below {VOXEL} m")
    with open(f"{d}/robot0/viz/scanmatcher_profile.json") as f:
        prof = json.load(f)
    fps_e2e = prof["pairs"] / (prof["load_preprocess_seconds"]
                               + prof["icp_seconds"])
    print(f"phase 4 stage 1 ({N_SCANS} scans x {SCAN_POINTS} points, capacity "
          f"{CAPACITY}, raw capacity 65536, voxel {VOXEL}): CSV rows {rows}; "
          f"load+preprocess {prof['load_preprocess_seconds']} s, ICP "
          f"{prof['icp_seconds']} s, ICP {prof['frames_per_second']} "
          f"frames/s, end-to-end {fps_e2e:.3f} frames/s; ICP iterations mean "
          f"{prof['icp_iterations_mean']:.3f} max {prof['icp_iterations_max']}; "
          f"{prof['pairs_fallback_to_seed']} pairs fell back to their seed; "
          f"ATE rmse {err['rmse']:.5f} m; launches {launches}; "
          f"{prof['scans_over_capacity']} scans over capacity; dataset "
          f"generated in {gen_s:.1f} s; card {smi}")
    return launches, d, info["T_gt"]


def phase_k3_k4(cases):
    """K3 in each form and K4 against their plain versions."""
    out = {}
    for impl in ("vpu", "vpu2", "mxu"):
        key = NN_IMPLS[impl]
        max_err, times = 0.0, {}
        for tag, s, t, m, _ in cases:
            i_k, d_k = nn_search(s, t, m, impl)
            i_p, d_p = nn_search_plain(s, t, m, impl)
            torch.cuda.synchronize()
            if not torch.equal(i_k, i_p):
                fail(f"K3 {impl} {tag}: indices differ in "
                     f"{int((i_k != i_p).sum())} rows")
            if not torch.equal(d_k, d_p):
                fail(f"K3 {impl} {tag}: d2 not bit-equal (max |diff| "
                     f"{float((d_k - d_p).abs().max())})")
            max_err = max(max_err, float((d_k - d_p).abs().max()))
            reps = 20 if s.shape[1] * t.shape[1] >= 2 ** 24 else 50
            flops = {"vpu": 9, "vpu2": 8, "mxu": 7}[impl]
            times[tag] = (cuda_ms(lambda: nn_search(s, t, m, impl), reps),
                          cuda_ms(lambda: nn_search_plain(s, t, m, impl), 5),
                          _sweep_bound(s, t, m, flops, outs=(i_k, d_k)))
            profile_later(5, f"{key} {tag}",
                          lambda s=s, t=t, m=m, impl=impl: nn_search(s, t, m, impl), 1)
        out[key] = times, max_err
    max_err, times = 0.0, {}
    for tag, s, t, m, n in cases:
        got = nn_search_vals(s, t, m, n)
        ref = nn_search_vals_plain(s, t, m, n)
        torch.cuda.synchronize()
        for name, a, b in zip(("d2", "q", "n"), got, ref):
            if not torch.equal(a, b):
                fail(f"K4 {tag}: {name} differs from the plain version "
                     f"(max |diff| {float((a - b).abs().max())})")
        if not torch.equal(got[0], nn_search(s, t, m)[1]):
            fail(f"K4 {tag}: d2 differs from K1's")
        reps = 20 if s.shape[1] * t.shape[1] >= 2 ** 24 else 50
        times[tag] = (cuda_ms(lambda: nn_search_vals(s, t, m, n), reps),
                      cuda_ms(lambda: nn_search_vals_plain(s, t, m, n), 5),
                      _sweep_bound(s, t, m, 8, extra_in=(n,), outs=got))
        profile_later(5, f"nn_sweep_vals {tag}",
                      lambda s=s, t=t, m=m, n=n: nn_search_vals(s, t, m, n), 1)
    out["nn_sweep_vals"] = times, max_err
    # every form and K4 launch with the one geometry of nn_sweep.cuh
    geo = {tag: _cuda.sweep_geometry(*s.shape[:2], t.shape[1], s.device)
           for tag, s, t, *_ in cases}
    print("phase 5 K3 nn_sweep (vpu, vpu2, mxu) and K4 nn_sweep_vals vs plain: "
          "indices equal, d2 bit-equal, K4 q and n equal; launch geometry "
          "(every form): " + "; ".join(f"{tag} {geometry_text(g)}"
                                       for tag, g in geo.items()) + "; "
          + "; ".join(
              f"{key} {tag}: wrapper {k:.4f} ms, plain {p:.4f} ms, bound "
              f"{b[0]:.4f} ms ({b[1]})"
              for key, (times, _) in out.items()
              for tag, (k, p, b) in times.items()))
    g = geo["S2048"]
    if g["grid"][0] * g["grid"][1] < MIN_SWEEP_CTAS:
        fail(f"the sweep's grid at B=4, S=2048, T=8192 has "
             f"{g['grid'][0] * g['grid'][1]} CTAs, fewer than {MIN_SWEEP_CTAS}")
    # the main path of K3 and K4 is phase 7 (source stride 4): S=2048, T=8192
    res = {}
    for key, (times, err) in out.items():
        k, p, (b, by) = times["S2048"]
        res[key] = {"max_abs_err": err, "ms": k, "plain_ms": p,
                    "bound_ms": b, "bound_by": by}
    return res


def _pruned_pairs(rng, dev):
    """Phase 6's inputs as ICP gives them to K5: 4 consecutive pairs of
    bench.py's trajectory, the source (scan i+1) strided by 4 and the
    target (scan i) Morton-sorted, the source sorted by its raw coordinates
    and then moved into the target's frame by the true relative pose."""
    T = synthetic.make_trajectory(N_SCANS, radius=12.0)[:5]
    c = voxelised_scans(rng, dev, T)
    rel = torch.from_numpy(np.stack([np.linalg.inv(T[i]) @ T[i + 1]
                                     for i in range(4)]).astype(np.float32)).to(dev)
    ss, sv, _ = nn_pruned.morton_sort(c.points[1:, ::STRIDE].contiguous(),
                                      c.mask[1:, ::STRIDE].contiguous())
    ts, tv, _ = nn_pruned.morton_sort(c.points[:4], c.mask[:4])
    return transform_points(rel, ss).contiguous(), sv, ts, tv


def phase_k5(rng, dev):
    scans = _pruned_pairs(rng, dev)
    rs, rt = (torch.from_numpy(cloud_points(rng, 2, n, extent=12.0)).to(dev)
              for n in (1000, 1300))
    rsm, rtm = (torch.from_numpy(rng.uniform(size=(2, n)) > f).to(dev)
                for n, f in ((1000, 0.1), (1300, 0.3)))
    ragged = (*nn_pruned.morton_sort(rs, rsm)[:2], *nn_pruned.morton_sort(rt, rtm)[:2])
    times, max_err, notes = {}, 0.0, []
    for tag, (ss, sv, ts, tv) in (("ragged", ragged), ("scans", scans)):
        i_k, d_k = nn_pruned.nn_search_pruned_presorted(ss, sv, ts, tv, GATE)
        i_p, d_p = nn_pruned.nn_search_pruned_presorted_plain(ss, sv, ts, tv, GATE)
        torch.cuda.synchronize()
        if not torch.equal(i_k, i_p):
            fail(f"K5 {tag}: indices differ in {int((i_k != i_p).sum())} rows")
        if not torch.equal(d_k, d_p):
            fail(f"K5 {tag}: d2 not bit-equal (max |diff| "
                 f"{float((d_k - d_p).abs().max())})")
        # against K1 (exhaustive, per-coordinate d2) within the gate
        i1, d1 = nn_search(ss, ts, tv)
        inside = sv & (d1 <= GATE * GATE)
        err_in = float((d_k - d1)[inside].abs().max())
        if err_in > MATMUL_ATOL:
            fail(f"K5 {tag}: d2 differs from K1's by {err_in} within the gate")
        differ = inside & (i_k != i1)
        q = torch.take_along_dim(ts, i_k.long()[..., None], dim=1)
        d_pick = ((q - ss) ** 2).sum(-1)
        tie_err = (float((d_pick - d1)[differ].abs().amax())
                   if bool(differ.any()) else 0.0)
        if tie_err > MATMUL_ATOL:
            fail(f"K5 {tag}: {int(differ.sum())} indices differ from K1's "
                 f"beyond a near-tie ({tie_err})")
        perm, tile_d2, t2 = nn_pruned.prepare(ss, sv, ts, tv, GATE, 512, 512)
        *_, tiles, rows = nn_pruned.pruned_sweep_plain(
            ss, sv, ts, t2, perm, tile_d2, 512, 512, count_visits=True)
        n_all = perm.numel()
        b = bound_ms(nbytes(ss, sv, ts, tv, i_k, d_k), 7.0 * rows * 512)
        def call(ss=ss, sv=sv, ts=ts, tv=tv):
            return nn_pruned.nn_search_pruned_presorted(ss, sv, ts, tv, GATE)
        profile_later(6, f"nn_pruned {tag}", call, MAX_K5_LAUNCHES)
        geo = _cuda.pruned_geometry(*ss.shape[:2], ts.shape[1], 512, 512, ss.device)
        times[tag] = (
            cuda_ms(call, 50),
            cuda_ms(lambda: nn_pruned.nn_search_pruned_presorted_plain(
                ss, sv, ts, tv, GATE), 5), b)
        max_err = max(max_err, float((d_k - d_p).abs().max()))
        notes.append(f"{tag} B={ss.shape[0]} Sp={ss.shape[1]} Tp={ts.shape[1]}: "
                     f"{int(inside.sum())} rows within the gate, max |d2 - K1 d2| "
                     f"{err_in:.3g}, {int(differ.sum())} near-tie indices "
                     f"differ from K1's; {tiles} of {n_all} tiles scored; wrapper "
                     f"{times[tag][0]:.4f} ms, plain {times[tag][1]:.4f} ms, "
                     f"bound {b[0]:.4f} ms ({b[1]}); {geometry_text(geo)}")
    print("phase 6 K5 nn_pruned vs plain: idx equal, d2 bit-equal; " + "; ".join(notes))
    k, p, (b, by) = times["scans"]
    return {"max_abs_err": max_err, "ms": k, "plain_ms": p, "bound_ms": b,
            "bound_by": by}


def _pose_err(T_a, T_b):
    """(position error, rotation angle from the skew part) of T_a^-1 T_b."""
    D = np.linalg.inv(T_a) @ T_b
    R = D[:, :3, :3]
    skew = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                     R[:, 1, 0] - R[:, 0, 1]], axis=-1)
    return (np.linalg.norm(D[:, :3, 3], axis=-1),
            np.arcsin(np.clip(np.linalg.norm(skew, axis=-1) / 2, 0, 1)))


def phase_nn_impls(d, T_gt, dev):
    """Stage 1 at bench.py's ICP settings under every nn_impl."""
    euroc = EurocDataset(d)
    prm = euroc.read_scanmatcher_parameters()
    cfg = IcpConfig(capacity=CAPACITY, source_stride=STRIDE)
    scan_times, _, _, odo, _ = sm.prepare_experiment_data(euroc, 0, prm["delta_time"])
    raw_pts, raw_mask = sm.load_scans(euroc, scan_times, cfg.raw_capacity)
    points, mask, normals, _ = sm.preprocess_all(
        raw_pts, raw_mask, cfg, prm["method"], prm["voxel_size"], dev)
    idx_src, idx_tgt, seeds = sm.consecutive_pairs(
        points.shape[0], cfg.batch_size, sm.relative_odometry(odo))
    n_pairs = points.shape[0] - 1
    args = (points, mask, normals, torch.from_numpy(idx_src).to(dev),
            torch.from_numpy(idx_tgt).to(dev), torch.from_numpy(seeds).to(dev))
    runs, launches, lines = {}, {}, []
    for impl, key in NN_IMPLS.items():
        params = ICPParams(max_correspondence_distance=GATE, max_iterations=30,
                           convergence_tol=1e-4, source_stride=STRIDE,
                           nn_impl=impl)
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.time()
        T, fit, iters, delta = sm.match_all(*args, params, "point_to_plane",
                                            cfg.batch_size)
        T = T.cpu().numpy().astype(np.float64)[:n_pairs]
        icp_s = time.time() - t0
        launches[key] = _cuda.launch_counts[key]
        if launches[key] <= 0:
            fail(f"stage 1 nn_impl={impl} did not launch {key}")
        bad = sm.fell_back(fit.cpu().numpy()[:n_pairs],
                           delta.cpu().numpy()[:n_pairs], cfg.min_fitness, params)
        if bad.any():
            fail(f"stage 1 nn_impl={impl}: {int(bad.sum())} pairs fell back "
                 f"to their seed")
        T_glob = np.empty((n_pairs + 1, 4, 4))
        T_glob[0] = np.eye(4)
        for i in range(n_pairs):
            T_glob[i + 1] = T_glob[i] @ T[i]
        err = ate(T_glob, T_gt)["rmse"]
        if not np.isfinite(T).all() or err >= VOXEL:
            fail(f"stage 1 nn_impl={impl}: ATE rmse {err} m")
        runs[impl] = T
        dpos, drot = _pose_err(runs["auto"], T)
        if dpos.max() > 1e-3 or drot.max() > 1e-3:
            fail(f"stage 1 nn_impl={impl}: relative transforms differ from "
                 f"the K1 run by {dpos.max()} m / {drot.max()} rad")
        it = iters.cpu().numpy()[:n_pairs]
        lines.append(f"{impl} ({key} x{launches[key]}): ICP {icp_s:.4f} s, "
                     f"{n_pairs / icp_s:.3f} frames/s, iterations mean "
                     f"{it.mean():.3f} max {int(it.max())}, ATE {err:.5f} m, "
                     f"max vs K1 {dpos.max():.3g} m / {drot.max():.3g} rad")
    print(f"phase 7 stage 1 under every nn_impl ({n_pairs} pairs, capacity "
          f"{CAPACITY}, stride {STRIDE}, gate {GATE} m, batch "
          f"{cfg.batch_size}, 30 iterations, tol 1e-4; 0 fallbacks each): "
          + "; ".join(lines))
    return launches


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name, smi = phase_device()
    rng = np.random.default_rng(0)
    cases = _nn_cases(rng, dev)
    res = {"nn_sweep": phase_k1(cases), "ball_moments": phase_k2(rng, dev)}
    with tempfile.TemporaryDirectory() as tmp:
        stage1, d, T_gt = phase_stage1(tmp, smi)
        res.update(phase_k3_k4(cases))
        res["nn_pruned"] = phase_k5(rng, dev)
        launches = phase_nn_impls(d, T_gt, dev)
    phase_profiles()
    # K1's and K2's main path is phase 4, the CLI at source stride 1
    launches.update(nn_sweep=stage1["nn_sweep"],
                    ball_moments=stage1["ball_moments"])
    pallas = "lidar_slam_arvc_tpu/ops/"
    meta = [
        ("nn_sweep", "nn_sweep.cu", "nn_pallas.py:107"),
        ("ball_moments", "ball_moments.cu", "moments_pallas.py:43"),
        ("nn_sweep_vpu", "nn_sweep.cu", "nn_pallas.py:79"),
        ("nn_sweep_vpu2", "nn_sweep.cu", "nn_pallas.py:93"),
        ("nn_sweep_mxu", "nn_sweep.cu", "nn_pallas.py:246"),
        ("nn_sweep_vals", "nn_sweep_vals.cu", "nn_pallas.py:135"),
        ("nn_pruned", "nn_pruned.cu", "nn_pruned.py:85"),
    ]
    kernels = [
        {"name": key, "route": "cuda",
         "source": f"lidar_slam_arvc_tpu_torch/csrc/{src}",
         "replaces": pallas + tpu, "launches": launches[key],
         "max_abs_err": res[key]["max_abs_err"], "ms": res[key]["ms"],
         "plain_ms": res[key]["plain_ms"], "bound_ms": res[key]["bound_ms"],
         "bound_by": res[key]["bound_by"], "library_ms": None}
        for key, src, tpu in meta]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
