"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives ``lidar_slam_arvc_tpu_torch`` (never JAX) through fifteen phases,
one line each, and exits non-zero on any failure:

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
   in process (the streamed load: the native PCD parser overlapped with
   preprocessing), once to warm up and once timed; the three CSVs, K1's
   and K2's launch counts, ATE < 0.2 m against ground truth, no pair fallen
   back to its seed, no PCD left to the Python parser.
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
8. stage 2 end to end on phase 4's dataset: ``pipeline.cli.main(["graph",
   ...])`` twice, store at full resolution (voxel None) and capacity 8192,
   pose capacity 512 (PCG with the cyclic-reduction preconditioner), the
   synthetic slam parameters (10 triplets, cadence 10), launch counts set
   to 0 before each run and read after it; and once more on a copy with
   ground-truth scan matching and no loop closing (the "model" run: what
   the sigma table makes of the odometry, whose translation it trusts as
   much as the scan matcher's, and the GPS).  Fails unless the solution
   has 257 rows, stage 2 launched K1 and K2 and ran a loop-closure ICP
   pair, the solver is pcg, the run accepted the (i, j) closures the JAX
   package accepts on this dataset, in its order (REFERENCE_CLOSURES),
   and its ATE is the JAX package's (REFERENCE_FULL_ATE; both from
   ``stage2_parity.py full --capacity 8192``), the model run's ATE is the
   JAX package's on the same inputs (REFERENCE_MODEL_ATE, from
   ``stage2_parity.py model``), both ATEs to 1e-3 m, and both CSVs are
   byte-identical across the runs.  Prints the profile's seconds, the
   closures accepted, the ICP batch sizes and the solver's LM steps, CG
   iterations and host synchronisations; times the run's last optimize
   again from its start under the PCG and the dense solver (they must
   agree); then holds K1 (loop pairs, S=T=8192, at every batch size the
   run used and at 20) and K2 (4 compacted scans, r = 0.3) against their
   plain versions at stage 2's shapes, with times and bounds.
9. the pose-graph solvers alone on SLAM-shaped graphs of 256, 512, 1024
   and 2048 poses (``utils/graph_profile.solver_graph``): ms per LM step of the dense (up to 1024) and the PCG
   step; dense and PCG agree at 256 and 512 (tests/test_graph.py's
   TestPCGSolver bounds); at 256 the dense chunked marginals and the PCG
   blocks are within 5e-2 of a float64 inverse; every card solve is
   within 1e-3 of the same code in float64 on the CPU in cost (relative)
   and 1e-2 m in positions (the f32 stop rule ends LM at the f32 floor,
   which leaves millimetres along the weakly anchored directions).  A
   singular 6x6 block through the BCR, tridiagonal and Jacobi
   preconditioners and a graph with no prior through the dense marginals
   must give non-finite results.
   Then "phase 2/3/5/6 profile" lines: the CUDA kernels one wrapper call of
   each phase launches and their device time, from torch.profiler traces
   taken only now, after every timed phase (phases 7-9 included): a profiler session stays
   attached and slows every later launch from the host, and with it the
   host-bound ICP runs.  Fails if a sweep or K2 call launches other than
   one kernel or a K5 call more than two.
10. the icp2planes method at full width (run before phase 9): phase 4's
   scans with ``method: icp2planes`` in both parameter files
   (``utils.workload.method_dataset``), ``cli scanmatch`` then ``cli
   graph`` (store at voxel None, capacity 8192), each with the launch
   counts set to 0 just before and read just after: K1 and K2 launched in
   both, the store's loop-closure ICP through the two-plane path, both
   ATEs and the fallbacks held to the JAX package's runs on the same
   dataset over three keys (``stage2_parity.py icp2planes``: within the
   keys' spread or 1e-3 m, whichever is larger); K1 held bit-equal to its
   plain version on the first and the last input the ICP gave it at each
   batch shape of each run (stage 1's ground and non-ground rows, the
   loop-closure batches), with each shape's launch geometry; prints
   seconds, the ground split's share of preprocessing, launches and the
   closures beside the reference's.
11. the fpfh method at full width and reduced depth (run before phase 9):
   33 box-world scans, ``cli scanmatch`` twice: CSVs byte-identical, K1
   and K2 launched, the share of pairs within 0.5 m, the fallbacks and the
   ATE held to the JAX package's (``stage2_parity.py fpfh``: within the
   keys' spread); one cloud's FPFH and one pair's ``nn2_search`` on the
   card against the same functions on the CPU; the store's fpfh
   registration of four overlapping pairs against the truth; K1 held to
   its plain version on the ICP's inputs of the first run and of the
   store's registration, as in phase 10; FPFH ms per cloud and RANSAC ms
   per pair.
12. the host paths on phase 4's dataset (run before phase 9): the 257
   PCDs parsed by the native batch parser and by the Python parser (arrays
   byte-equal, seconds of each over 3 runs); load+preprocess by the
   streamed path and by the two-phase path (load, then preprocess; both
   split), in turns over 3 runs each, the stacks bit-equal on the card;
   ``match_consecutive`` at phase 4's shape with a checkpoint, cut back to
   half its groups and resumed, bit-equal to the uninterrupted run; phase
   8's renders (uncertainty.png, gps_comparison.png) or the ImportError
   recorded without matplotlib, any other error failing; ``cli view``,
   ``diag`` (file and count checks), ``convert`` (257 PLYs), ``convert
   --mesh`` on 4 scans, and ``cli ingest`` of a bz2 bag of the first 20
   scans, their odometry and GPS written by the port's ``write_bag``
   (PCDs byte-equal to the dataset's), then ``cli scanmatch`` of the
   ingested tree on the card (K1 and K2 launched, ATE < 0.2 m, within 1e-3
   m / rad of phase 4's pairs); the seconds of each.
13. multi-device (run before phase 9): 2 ranks spawned on the one card
   (both on cuda:0, so gloo, printed), at full width: (a)
   ``sharded_icp_batch`` of phase 4's first 8 pairs (S = T = 8192) within
   1e-5 of one process's ``icp_batch`` (bit-equal or not printed), K1
   launched in each rank; (b) ``cli scanmatch --devices 2``, then with
   ``--shard-scans``, each within 1e-5 of phase 4's CSV, ATE < 0.2 m, no
   pair fallen back, K1 and K2 launched in each rank, each rank's scans
   loaded (all, or its block of 132), rank 0 alone writing, seconds and
   frames/s of each layout (two ranks sharing one card: not a scaling
   number); (c) the keyframe store sharded over the ranks (each loading
   its block) registering phase 8's loop pairs bit-equal to one store;
   (d) ``cli graph --devices 2`` on phase 4's dataset: solver schur, K1
   and K2 launched in each rank, phase 8's closures in order, positions
   within 3e-2 m of phase 8's solution, its ATE beside the reference's;
   (e) on phase 9's 512-pose graph the Schur step within 2e-4 of the
   dense step at lam 1e-4, ms per LM step of Schur, dense and PCG; (f) a
   separator capacity below the graph's count raises ``ValueError`` in
   both ranks, a hang past 120 s failing the phase.  Prints the
   collective calls and bytes of (b) and (d) and the phase's seconds; the
   ranks' own output goes to files.
14. the public API (run after phase 13, before phase 9), on phase 4's
   dataset, one line per part: (a) every name of ``geom.__all__`` on the
   card against the same call on the CPU (f32; bounds API_*_ATOL) and
   against the float64 host mirrors of ``geom/hostmath.py`` where one
   exists, and ``global_transforms`` of phase 4's 256 relative transforms
   against stage 1's written float64 fold (1e-4 m, 2e-5 rad), timed with
   CUDA events, its kernels profiled after phase 9; (b) on phase 4's first
   batch (4 scans, cropped and voxelised on the card) ``voxel_downsample``
   bit-equal to ``voxel_downsample_counted(...)[0]``, ``num_valid`` and
   ``to_numpy`` against the mask, ``cloud.from_numpy`` with no device on
   the card; (c) ``radius_accumulate`` on that batch (B=4, Q=T=8192,
   r=0.5) on the card against the CPU: counts equal outside the f32
   rounding band of r^2 (computed in float64), S1/S2 within 1e-5 of count
   x max|p|^k; ``estimate_normals(impl="xla")`` against ``impl="auto"``
   (K2) on a smooth sheet |n.n'| > 0.999 (the gate), and on phase 4's
   pillar scans the share within 1 degree (a record); ``impl=
   "pallas_interpret"`` raising ``ValueError``; ``radius_accumulate``'s
   wrapper ms beside K2's at the same shape; (d) ``IcpConfig.from_yaml``
   of a nested ``icp_parameters.yaml`` the phase writes, and phase 4's
   global transforms through ``compat`` (unstack, relative, global,
   stack) within 1e-9 of themselves and of the card's float64
   ``global_transforms``, with no jax, pandas or yaml imported.
15. the method-level API (after phase 14, before phase 9), one line per
   part, each with the launch counts set to 0 just before its run and read
   just after: (a) ``pipeline.quickstart.main`` on the card at its size
   (40 scans x 8000 points, raw capacity 16384, capacity 8192): ATE, RPE,
   stage-1 frames/s, stage-2 solve+loop seconds, K1/K2 launches of each
   stage; fails unless stage-1 ATE < 0.2 m, the SLAM solution is finite
   and K1 and K2 launched; (b) an array-form ``LoopCloser`` over phase 8's
   store tensors (phase 4's 257 scans at voxel None, capacity 8192) with
   an ICP override (gate 2 m, 15 iterations, source stride 4), on a graph
   of the true poses with a small drift, closing at pose 250: the card's
   accepted closures equal the CPU's and their transforms agree within
   1e-4 m / 1e-4 rad, K1 launched; the same override through a store
   leaves the store's own parameters (``icp_params_override`` None) and
   gives the array form's transforms bit for bit; (c) ``memory_bytes()``
   equal to the sum of the store's tensors' bytes (icppointplane and
   icp2planes stores), ``load_and_preprocess(seed=0)`` bit-equal to the
   default under icp2planes (24 scans), and ``EurocDataset.path``.
16. the last line: {"ok": true, "device": {...}}.

Before the last line it prints the card's name and power limit as
nvidia-smi reports them and one JSON line of per-kernel results: time of
the wrapper (CUDA events over back-to-back calls), plain-version time and
the bound (the larger of the bytes the function must move over the HBM
rate and its FP32 operations over the FP32 peak, NVIDIA's H100 SXM data
sheet), from this run's inputs; K1's and K2's entries also carry a
``stage2`` object with the same numbers at stage 2's shapes and the
launches of phase 8's first run.  The sweeps need sm_90a (thread block
clusters).
"""

import concurrent.futures
import contextlib
import importlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lidar_slam_arvc_tpu_torch import compat, geom  # noqa: E402
from lidar_slam_arvc_tpu_torch.cloud import (  # noqa: E402
    Cloud, compact_counted, crop_radius_height, estimate_normals, from_numpy, num_valid,
    to_numpy, voxel_downsample, voxel_downsample_counted)
from lidar_slam_arvc_tpu_torch.cloud.cloud import pad_numpy  # noqa: E402
from lidar_slam_arvc_tpu_torch.cloud.fpfh import compute_fpfh  # noqa: E402
from lidar_slam_arvc_tpu_torch.geom import hostmath  # noqa: E402
from lidar_slam_arvc_tpu_torch.geom import se3 as geom_se3  # noqa: E402
from lidar_slam_arvc_tpu_torch.geom.se3 import transform_points  # noqa: E402
from lidar_slam_arvc_tpu_torch.graph import PoseGraph, make_factor_data  # noqa: E402
from lidar_slam_arvc_tpu_torch.graph import bcr, pcg, solver  # noqa: E402
from lidar_slam_arvc_tpu_torch.graph.factors import FACTOR_FIELDS  # noqa: E402
from lidar_slam_arvc_tpu_torch.io import native, rosbag  # noqa: E402
from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset  # noqa: E402
from lidar_slam_arvc_tpu_torch.io.pcd import read_pcd  # noqa: E402
from lidar_slam_arvc_tpu_torch.keyframes import KeyframeStore  # noqa: E402
from lidar_slam_arvc_tpu_torch.loop import LoopCloser  # noqa: E402
from lidar_slam_arvc_tpu_torch.ops import _cuda, nn_pruned  # noqa: E402
from lidar_slam_arvc_tpu_torch.ops.moments import (  # noqa: E402
    ball_moments, ball_moments_plain, scored_pairs, summation_tolerance)
from lidar_slam_arvc_tpu_torch.ops.nn import (  # noqa: E402
    nn2_search, nn_search, nn_search_plain, nn_search_vals, nn_search_vals_plain,
    radius_accumulate)
from lidar_slam_arvc_tpu_torch.parallel import _ranks  # noqa: E402
from lidar_slam_arvc_tpu_torch.parallel import mesh as _mesh  # noqa: E402
from lidar_slam_arvc_tpu_torch.pipeline import cli, quickstart  # noqa: E402
from lidar_slam_arvc_tpu_torch.pipeline import scanmatcher as sm  # noqa: E402
from lidar_slam_arvc_tpu_torch.pipeline.graphslam import run_graphslam  # noqa: E402
from lidar_slam_arvc_tpu_torch.registration.global_reg import (  # noqa: E402
    GlobalRegParams, ransac_feature_registration)
from lidar_slam_arvc_tpu_torch.registration.icp import ICPParams  # noqa: E402
from lidar_slam_arvc_tpu_torch.utils import sass, synthetic, workload  # noqa: E402
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig  # noqa: E402
from lidar_slam_arvc_tpu_torch.utils.graph_profile import solver_graph  # noqa: E402
from lidar_slam_arvc_tpu_torch.utils.metrics import ate  # noqa: E402
from lidar_slam_arvc_tpu_torch.viz.mapping import read_ply  # noqa: E402
from lidar_slam_arvc_tpu_torch.utils.workload import (  # noqa: E402
    CAPACITY, RADIUS, SCAN_POINTS, VOXEL, WORLD, cloud_points, k2_cases,
    voxelised_scans)

# registration/__init__ exports a function named like its icp module
icp_mod = importlib.import_module("lidar_slam_arvc_tpu_torch.registration.icp")

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
    with open(f"{d}/robot0/viz/scanmatcher_profile.json") as f:
        warm = json.load(f)
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
    if prof["pairs_fallback_to_seed"] or prof["pcd_files_python_parsed"]:
        fail(f"stage 1: {prof['pairs_fallback_to_seed']} pairs fell back to "
             f"their seed, {prof['pcd_files_python_parsed']} PCDs parsed in Python")
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
          f"{prof['scans_over_capacity']} scans over capacity; streamed load "
          f"(native parser, {prof['pcd_files_python_parsed']} PCDs in Python); "
          f"the warm-up run built {warm['libraries_built']} in "
          f"{warm['build_seconds']} s and loaded {warm['libraries_loaded_from_cache']} "
          f"from _build/; dataset "
          f"generated in {gen_s:.1f} s; card {smi}")
    return launches, d, info["T_gt"], err["rmse"]


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
    scans, _ = sm.preprocess_all(
        raw_pts, raw_mask, cfg, prm["method"], prm["voxel_size"], device=dev)
    points, mask, normals = scans.points, scans.mask, scans.normals
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

STAGE2_CAPACITY = 8192      # stage 2's store: full-resolution scans, compacted
# stage 2's ATE on phase 4's dataset with ground-truth scan matching and
# no loop closing: what the reference's sigma table makes of the biased
# odometry and the GPS (the JAX package on the CPU, ``stage2_parity.py
# model``)
REFERENCE_MODEL_ATE = 0.2712940349558227
# the JAX package's full stage 2 on phase 4's dataset (its own stage 1,
# loop closing, store capacity 8192; ``stage2_parity.py full --capacity
# 8192`` on the CPU): the (i, j) closures it accepts, which the card's run
# must accept, in order, and its ATE
REFERENCE_CLOSURES = [(250, 0), (250, 4), (250, 1), (250, 5), (255, 4), (255, 8),
                      (255, 2), (255, 6), (255, 1), (255, 5), (255, 3), (255, 7),
                      (255, 5), (255, 9), (255, 0), (255, 4)]
REFERENCE_FULL_ATE = 0.2845012263381373
# the card's ATEs must be the reference's to this; the port on the CPU
# gives both to 5e-6 m, and at store capacity 2048 the two packages'
# full runs differ by 1.1e-4 m (the card's stage 1 is the port's, not the
# JAX package's)
REFERENCE_ATE_TOL = 1e-3
STAGE2_PAIRS = 20           # loop-closure ICP batch: 2 x 10 triplets at most
SOLVER_CAPACITIES = (256, 512, 1024, 2048)
DENSE_MAX = 1024            # dense LM steps are timed up to this capacity
STEP_REPS = 3               # LM steps timed per solver and capacity


def _stage2_kernel_shapes(d, T_gt, dev, batch_sizes):
    """K1 and K2 held against their plain versions at the shapes stage 2
    gives them: 20 full-resolution scans (10 at the start of the circle,
    10 at its end) compacted to capacity 8192; K2 over 4 of them at the
    normal radius 0.3 m, K1 over loop-closure pairs (end scan onto start
    scan, moved by the true relative pose) at every batch size of the
    run's ICP batches (``batch_sizes``) and at the largest the loop closer
    forms, 20; K1 is timed at the run's largest batch."""
    euroc = EurocDataset(d)
    times = euroc.read_csv("/robot0/scanmatcher/lidar_times.csv")["#timestamp [ns]"]
    pick = np.concatenate([np.arange(10), np.arange(N_SCANS - 10, N_SCANS)])
    raw_pts, raw_mask = sm.load_scans(euroc, times[pick], 65536)
    c = Cloud(torch.from_numpy(raw_pts).to(dev), torch.from_numpy(raw_mask).to(dev))
    c = crop_radius_height(c, 0.5, 35.0, -1.0, 50.0)
    c, _ = compact_counted(c, out_capacity=STAGE2_CAPACITY)
    r = IcpConfig().normal_radius
    q, qm = c.points[:4].contiguous(), c.mask[:4].contiguous()
    ck, s1k, s2k = ball_moments(q, q, qm, r, query_mask=qm)
    cp, s1p, s2p = ball_moments_plain(q, q, qm, r, query_mask=qm)
    torch.cuda.synchronize()
    if not torch.equal(ck, cp):
        fail(f"phase 8 K2 at stage 2's shape: counts differ in {int((ck != cp).sum())} rows")
    e1, e2 = (s1k - s1p).abs().amax(-1), (s2k - s2p).abs().amax(-1)
    if bool((e1 > summation_tolerance(cp, r, 1)).any()) or \
            bool((e2 > summation_tolerance(cp, r, 2)).any()):
        fail("phase 8 K2 at stage 2's shape: S1/S2 beyond the summation-order bound")
    _, pairs = scored_pairs(q, q, qm, r, qm)
    k2 = {"ms": cuda_ms(lambda: ball_moments(q, q, qm, r, query_mask=qm), 20),
          "plain_ms": cuda_ms(lambda: ball_moments_plain(q, q, qm, r, query_mask=qm), 3),
          "max_abs_err": max(float(e1.max()), float(e2.max())),
          "bound": bound_ms(nbytes(q, q, qm, qm) + ck.numel() * 40,
                            8.0 * pairs + 16.0 * float(ck.sum())),
          "shape": f"B=4, Q=T={STAGE2_CAPACITY} compacted scans, r={r}"}
    rel = np.stack([np.linalg.inv(T_gt[pick[k]]) @ T_gt[pick[10 + k]]
                    for k in range(10)] * 2).astype(np.float32)
    tgt, tm = c.points[np.tile(np.arange(10), 2)], c.mask[np.tile(np.arange(10), 2)]
    src = transform_points(torch.from_numpy(rel).to(dev),
                           c.points[np.tile(np.arange(10, 20), 2)]).contiguous()
    tgt, tm = tgt.contiguous(), tm.contiguous()
    err, geo = 0.0, []
    for b in sorted(set(batch_sizes) | {STAGE2_PAIRS}):
        g = _cuda.sweep_geometry(b, STAGE2_CAPACITY, STAGE2_CAPACITY, dev)
        geo.append(f"B={b} grid {g['grid']} cluster {g['cluster']}")
        i_k, d_k = nn_search(src[:b], tgt[:b], tm[:b])
        i_p, d_p = nn_search_plain(src[:b], tgt[:b], tm[:b])
        torch.cuda.synchronize()
        if not torch.equal(i_k, i_p) or not torch.equal(d_k, d_p):
            fail(f"phase 8 K1 at stage 2's shape, B={b}: differs from the "
                 f"plain version ({int((i_k != i_p).sum())} indices)")
        err = max(err, float((d_k - d_p).abs().max()))
    b = max(batch_sizes)
    src, tgt, tm = src[:b], tgt[:b], tm[:b]
    i_k, d_k = nn_search(src, tgt, tm)
    k1 = {"ms": cuda_ms(lambda: nn_search(src, tgt, tm), 10),
          "plain_ms": cuda_ms(lambda: nn_search_plain(src, tgt, tm), 2),
          "max_abs_err": err,
          "bound": _sweep_bound(src, tgt, tm, 8, outs=(i_k, d_k)),
          "shape": f"B={b}, S=T={STAGE2_CAPACITY} (plain-equal at "
                   + ", ".join(geo) + ")"}
    return {"nn_sweep": k1, "ball_moments": k2}


def _stage2_model(d, T_gt):
    """(ATE, wall s) of stage 2 on the card on a copy of the dataset with
    ground-truth scan matching and no loop closing."""
    dm = d + "_model"
    shutil.copytree(d, dm)
    synthetic.write_model_inputs(dm, T_gt)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        out = run_graphslam(dm)
    wall = time.time() - t0
    shutil.rmtree(dm)
    return ate(out["solution"], T_gt)["rmse"], wall


@contextlib.contextmanager
def _stage2_spies():
    """Record, during one stage-2 run, the pose graph with its poses and
    iteration limit at each optimize, and the pairs of each loop-closure
    ICP batch."""
    rec = {"optimize": [], "icp_batches": [], "icp_pairs": []}
    optimize, batch = PoseGraph.optimize, KeyframeStore.compute_transformations_batch

    def optimize_spy(self, max_iterations=15, solver="auto"):
        rec["optimize"].append((self, self.poses.copy(), max_iterations))
        return optimize(self, max_iterations, solver)

    def batch_spy(self, pairs, seeds):
        rec["icp_batches"].append(len(pairs))
        rec["icp_pairs"].append((np.array(pairs), np.array(seeds, dtype=np.float32)))
        return batch(self, pairs, seeds)

    PoseGraph.optimize = optimize_spy
    KeyframeStore.compute_transformations_batch = batch_spy
    try:
        yield rec
    finally:
        PoseGraph.optimize = optimize
        KeyframeStore.compute_transformations_batch = batch


def _final_optimize(rec, T_gt):
    """The run's last optimize (every closure in the graph) again from the
    poses it started from, under each solver, alternated PCG, dense, PCG,
    dense: {solver: [(wall s, LM steps, CG iterations, cost)]}.  Dense and
    PCG must agree to phase 9's bounds (tests/test_graph.py's
    TestPCGSolver)."""
    g, poses0, iters = rec["optimize"][-1]
    out, ends = {"pcg": [], "dense": []}, {}
    for name in ("pcg", "dense", "pcg", "dense"):
        g.poses = poses0.copy()
        before = dict(g.stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cost = g.optimize(max_iterations=iters, solver=name)
        wall = time.perf_counter() - t0
        out[name].append((wall, g.stats["lm_steps"] - before["lm_steps"],
                          g.stats["cg_iterations"] - before["cg_iterations"], cost))
        ends[name] = ate(g.get_solution_transforms_lidar()[:N_SCANS], T_gt)["rmse"]
    c_d, c_p = out["dense"][-1][3], out["pcg"][-1][3]
    if abs(c_d - c_p) >= 0.05 * max(abs(c_d), 1.0) or abs(ends["dense"] - ends["pcg"]) >= 0.02:
        fail(f"phase 8 final optimize: dense (cost {c_d}, ATE {ends['dense']}) and "
             f"PCG (cost {c_p}, ATE {ends['pcg']}) disagree")
    return out, ends


def phase_stage2(d, T_gt, ate_stage1, smi, dev):
    """Stage 2 through ``cli graph`` twice on phase 4's dataset."""
    argv = ["graph", "-i", d, "--capacity", str(STAGE2_CAPACITY)]
    slam = f"{d}/robot0/SLAM"
    runs = []
    for k in range(2):
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()) as out, \
                (_stage2_spies() if k == 0 else contextlib.nullcontext({})) as rec:
            rc = cli.main(argv)   # its per-step progress stays out of the log
        wall = time.time() - t0
        if rc != 0:
            fail("stage 2 returned non-zero")
        summary = out.getvalue().strip().splitlines()[-1].split("\r")[-1]
        launches = dict(_cuda.launch_counts)
        files = {}
        for name in ("solution_graphslam.csv", "loop_closures.csv"):
            with open(f"{slam}/{name}", "rb") as f:
                files[name] = f.read()
        with open(f"{d}/robot0/viz/graphslam_profile.json") as f:
            runs.append((launches, files, json.load(f), wall, summary, rec))
    (launches, files, prof, wall, summary, rec), (_, files2, prof2, wall2, _, _) = runs
    for name in files:
        if files[name] != files2[name]:
            fail(f"stage 2: {name} differs between two runs")
    rows = _rows(f"{slam}/solution_graphslam.csv")
    if rows != N_SCANS:
        fail(f"stage 2 solution has {rows} rows, expected {N_SCANS}")
    for k in ("nn_sweep", "ball_moments"):
        if launches[k] <= 0:
            fail(f"stage 2 did not launch kernel {k}")
    if prof["loop_icp_pairs"] <= 0:
        fail("stage 2 ran no loop-closure ICP pair")
    if prof["solver"] != "pcg":
        fail(f"stage 2 solver {prof['solver']}, expected pcg at {N_SCANS} poses")
    with open(f"{slam}/loop_closures.csv") as f:
        closures = [tuple(int(v) for v in row.split(",")[1:])
                    for row in f.read().split()[1:]]
    if closures != REFERENCE_CLOSURES or \
            prof["loop_closures_accepted"] != len(REFERENCE_CLOSURES):
        fail(f"stage 2 accepted the closures {closures}, the reference "
             f"{REFERENCE_CLOSURES} on this dataset")
    _, T_sol = EurocDataset(d).read_trajectory("/robot0/SLAM/solution_graphslam.csv")
    err = ate(T_sol, T_gt)["rmse"]
    if not np.isfinite(T_sol).all() or abs(err - REFERENCE_FULL_ATE) > REFERENCE_ATE_TOL:
        fail(f"stage 2 ATE rmse {err} m, the reference's {REFERENCE_FULL_ATE} m")
    ate_model, wall_model = _stage2_model(d, T_gt)
    if abs(ate_model - REFERENCE_MODEL_ATE) > REFERENCE_ATE_TOL:
        fail(f"stage 2 model run: ATE rmse {ate_model} m, the reference's "
             f"{REFERENCE_MODEL_ATE} m")
    final, ends = _final_optimize(rec, T_gt)
    shapes = _stage2_kernel_shapes(d, T_gt, dev, rec["icp_batches"])
    keys = ("store_load_preprocess_seconds", "solve_loop_seconds",
            "optimize_seconds", "loop_candidate_search_seconds",
            "loop_icp_seconds", "marginals_seconds", "host_other_seconds")
    print(f"phase 8 stage 2 (cli graph x2, {N_SCANS} poses, pose capacity "
          f"512, store capacity {STAGE2_CAPACITY} at voxel None; CSVs "
          f"byte-identical across the runs): '{summary}'; solver {prof['solver']}; "
          f"{prof['loop_closures_accepted']} closures accepted in "
          f"{prof['loop_closing_rounds']} rounds, the reference's: "
          + " ".join(f"{i}-{j}" for i, j in closures)
          + f"; {prof['loop_icp_pairs']} ICP pairs in batches of "
          f"{rec['icp_batches']}; ATE rmse {err:.7f} m (the reference's "
          f"{REFERENCE_FULL_ATE:.7f} +- {REFERENCE_ATE_TOL}; stage 1 {ate_stage1:.5f}); "
          f"model run (ground-truth scan matching, no loop closing) ATE "
          f"{ate_model:.7f} m against the reference's {REFERENCE_MODEL_ATE:.7f} "
          f"m, wall {wall_model:.3f} s; launches K1 "
          f"{launches['nn_sweep']}, K2 {launches['ball_moments']}; solver "
          f"stats {prof['solver_stats']}; run 1 " + ", ".join(
              f"{k} {prof[k]}" for k in keys) + f", wall {wall:.3f} s; run 2 "
          + ", ".join(f"{k} {prof2[k]}" for k in keys) + f", wall {wall2:.3f} s; "
          + f"final optimize (optimize {len(rec['optimize'])} of the run, "
          f"{rec['optimize'][-1][2]} iterations) again from its start: "
          + "; ".join(f"{name} " + ", ".join(
              f"{w:.4f} s ({n} LM steps, {cg} CG iterations, "
              f"{1e3 * w / max(n, 1):.3f} ms/LM step, cost {c:.6g})"
              for w, n, cg, c in v) + f", ATE {ends[name]:.6f} m"
              for name, v in final.items()) + "; "
          + "; ".join(f"{k} at {v['shape']}: plain-equal, wrapper {v['ms']:.4f} "
                      f"ms, plain {v['plain_ms']:.4f} ms, bound {v['bound'][0]:.4f} "
                      f"ms ({v['bound'][1]})" for k, v in shapes.items())
          + f"; card {smi}")
    for k in shapes:
        shapes[k]["launches"] = launches[k]
    return shapes, rec


def _step_ms(step, poses, reps: int) -> float:
    """Wall ms per LM step (each step ends in reading its cost on the
    host, as the solve does), after one warm-up step."""
    step(poses)[1].item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        poses, cost = step(poses)
        cost.item()
    return (time.perf_counter() - t0) / reps * 1e3


def _singular_checks(dev) -> str:
    """A singular 6x6 block through each PCG preconditioner's set-up (BCR,
    block tridiagonal, Jacobi) and a graph with no prior (H singular: the
    reference's ``cho_factor`` gives NaN) through the dense marginals: every
    result must be non-finite on the card, as on the CPU."""
    g = torch.Generator().manual_seed(0)
    M = torch.randn(8, 6, 6, generator=g)
    D = (M @ M.transpose(-1, -2) + 6.0 * torch.eye(6)).to(dev)
    E = (0.1 * torch.randn(8, 6, 6, generator=g)).to(dev)
    E[-1] = 0.0
    D[[0, 3]] = 0.0      # inverted directly: 3 by BCR, 0 by the tridiagonal
    b = torch.ones(8, 6, device=dev)
    Uinv, W = pcg._build_tridiag_precond(D, E)
    Minv = solver.inv_or_nan(D)
    finite = {"bcr": bool(torch.isfinite(bcr.bcr_solve(*bcr.bcr_factor(D, E), b)).all()),
              "tridiag": bool(torch.isfinite(pcg._apply_tridiag_precond(Uinv, W, E, b)).all()),
              "jacobi": not bool(torch.isnan(Minv[[0, 3]]).all())}
    if not bool(torch.isfinite(Minv[1:3]).all() and torch.isfinite(Minv[4:]).all()):
        fail("phase 9: Jacobi inverted a regular 6x6 block to a non-finite one")
    T = synthetic.make_trajectory(8, radius=4.0)
    pg = PoseGraph(max_poses=8, device=dev)
    for i in range(7):
        rel = np.linalg.inv(T[i]) @ T[i + 1]
        pg.add_initial_estimate(rel, i + 1)
        pg.add_edge(rel, i, i + 1, "SM")
    finite["marginals"] = not bool(np.isnan(pg.marginal_covariances()).all())
    if any(finite.values()):
        fail(f"phase 9: a singular block gave a finite result on the card: {finite}")
    return ("a singular 6x6 block gives a non-finite BCR, tridiagonal and Jacobi "
            "preconditioner, a graph with no prior all-NaN dense marginals")


def phase_solvers(dev, capacities=SOLVER_CAPACITIES, dense_max=DENSE_MAX):
    """The pose-graph solvers alone: ms per LM step, dense against PCG,
    marginal blocks, and every card solve against the same code in
    float64 on the CPU."""
    lines = []
    for n in capacities:
        g, T = solver_graph(n, dev)
        arrays = {k: getattr(g, k) for k in FACTOR_FIELDS}
        f = make_factor_data(n, dev, **arrays)
        f64 = make_factor_data(n, "cpu", dtype=torch.float64, **arrays)
        p0 = torch.as_tensor(g.poses, device=dev)
        p64 = torch.as_tensor(g.poses, dtype=torch.float64)
        solvers = {"pcg": (pcg.solve_graph_pcg,
                           lambda p: pcg.pcg_lm_step(p, f, n, 1e-6))}
        if n <= dense_max:
            solvers["dense"] = (solver.solve_graph,
                                lambda p: solver._lm_step(p, f, n, 1e-6))
        res = {}
        for name, (solve, step) in solvers.items():
            ms = _step_ms(step, p0, STEP_REPS)
            stats = {}
            t0 = time.perf_counter()
            poses, cost = solve(p0, f, n, stats=stats)
            torch.cuda.synchronize()
            solve_s = time.perf_counter() - t0
            poses = poses.cpu().numpy()
            poses64, cost64 = solve(p64, f64, n)
            poses64 = poses64.numpy()
            dpos = float(np.abs(poses[:, :3, 3] - poses64[:, :3, 3]).max())
            if not np.isfinite(poses).all() or \
                    abs(float(cost) - float(cost64)) > 1e-3 * max(float(cost64), 1.0) \
                    or dpos > 1e-2:
                fail(f"phase 9 {name} at {n} poses: the card's f32 solve "
                     f"(cost {float(cost)}) differs from float64 on the CPU "
                     f"(cost {float(cost64)}, max position diff {dpos} m)")
            res[name] = (ms, solve_s, float(cost), poses, stats, dpos)
        if n in (256, 512):
            c_d, c_p = res["dense"][2], res["pcg"][2]
            e_d = ate(res["dense"][3].astype(np.float64), T)["rmse"]
            e_p = ate(res["pcg"][3].astype(np.float64), T)["rmse"]
            if abs(c_d - c_p) >= 0.05 * max(abs(c_d), 1.0) or abs(e_d - e_p) >= 0.02:
                fail(f"phase 9 at {n} poses: dense (cost {c_d}, ATE {e_d}) and "
                     f"PCG (cost {c_p}, ATE {e_p}) disagree")
        note = ""
        if n == 256:
            g.poses = res["dense"][3]
            idx = np.arange(0, n, 16)
            t0 = time.perf_counter()
            dense = g.marginal_covariances()[idx]
            t_dense = time.perf_counter() - t0
            t0 = time.perf_counter()
            blocks = g.marginal_covariances(indices=idx)
            t_pcg = time.perf_counter() - t0
            # both against a float64 inverse of H at the same poses, in
            # correlation form; cond(H) ~ 5e8 puts each f32 path's floor
            # at a few percent (tests/test_graph.py::TestMarginals)
            H64, _ = solver._assemble(torch.as_tensor(g.poses, dtype=torch.float64),
                                      f64, n)
            cov64 = np.linalg.inv(H64.numpy() + 1e-9 * np.eye(6 * n))
            truth = np.stack([cov64[6 * i:6 * i + 6, 6 * i:6 * i + 6] for i in idx])
            dd = np.sqrt(np.einsum("kii,kjj->kij", truth, truth))
            errs = [float((np.abs(c - truth) / (5e-2 * (dd + np.abs(truth)))).max())
                    for c in (dense, blocks)]
            if not np.isfinite(blocks).all() or max(errs) > 1.0:
                fail(f"phase 9 marginals at 256: dense chunked / PCG blocks "
                     f"beyond 5e-2 of the float64 inverse ({errs})")
            note = (f"; marginals of {len(idx)} poses: dense chunked (all "
                    f"poses) {t_dense:.3f} s, PCG blocks {t_pcg:.3f} s, "
                    f"max |diff| vs float64 {errs[0] * 5e-2:.3g} and "
                    f"{errs[1] * 5e-2:.3g} of (correlation + 1)")
        lines.append(f"{n}: " + ", ".join(
            f"{name} {ms:.3f} ms/LM step, solve {solve_s:.3f} s "
            f"({st.get('lm_steps', 0)} LM steps, {st.get('cg_iterations', 0)} "
            f"CG iterations, {st.get('host_syncs', 0)} host syncs), cost "
            f"{cost:.6g}, max position diff vs float64 CPU {dpos:.3g} m"
            for name, (ms, solve_s, cost, _, st, dpos) in res.items()) + note)
    print("phase 9 pose-graph solvers (SLAM-shaped chain, loops every 40 "
          "poses, GPS every 5; f32 on the card; dense and PCG agree at 256 "
          "and 512; every solve within 1e-3 in cost and 1e-2 m of float64 on the CPU): "
          + "; ".join(lines) + "; " + _singular_checks(dev))

# The JAX package's runs on the datasets of phases 10 and 11
# (``stage2_parity.py icp2planes`` / ``fpfh`` on the CPU): each number is
# [key 0, key 1, key 2] over three ``jax.random`` keys; a card run must
# land within the keys' spread (max - min) of key 0 (its draws come from
# torch, so it is one more key), in phase 10 within 1e-3 m if that is
# larger (PLANES_ATE_FLOOR: the two-plane ICP's ground half leaves x, y
# and yaw to f32 rounding, and the card's stage 1 is the port's)
REF_PLANES_ATE1 = [0.006688306900330926, 0.006798973462319791, 0.006730164392021736]
REF_PLANES_FALLBACKS = [0, 0, 0]
REF_PLANES_ATE2 = [0.28503296013422014, 0.28504610170549355, 0.2850087891951949]
# the (i, j) closures all three keys accepted, in order
REF_PLANES_CLOSURES = [(250, 0), (250, 4), (250, 1), (250, 5), (255, 4), (255, 8),
                       (255, 2), (255, 6), (255, 1), (255, 5), (255, 3), (255, 7),
                       (255, 5), (255, 9), (255, 0), (255, 4)]
REF_FPFH_ATE1 = [0.0017819840623159219, 0.0017994864586416731, 0.0017911573194031205]
REF_FPFH_FALLBACKS = [0, 0, 0]
REF_FPFH_SHARE = [1.0, 1.0, 1.0]  # pairs within 0.5 m of the true motion
PLANES_ATE_FLOOR = 1e-3
# phase 11: the card's FPFH against the same function on the CPU.  A bin
# edge can send a pair to the next bin (atan2, floor and the cross products
# round differently), which moves a row by ~100/k (k ~ 60 neighbours) in
# two bins; the first run on the H100 measured no such row: 0 of 4271 rows
# beyond 1e-4, the largest row difference 1.53e-5 (2 ulp of 100), so a row
# may differ by 1e-4 and at most 0.1% of the rows (4 here) may flip a bin
FPFH_ROW_TOL = 1e-4         # a row differs when any entry is off by more
FPFH_ROWS_DIFFERING = 1e-3  # share of valid rows that may differ
STORE_FPFH_PAIRS = ((0, 1), (1, 2), (2, 3), (3, 4))


def _within_spread(name: str, got: float, ref: list, floor: float = 0.0) -> str:
    tol = max(max(ref) - min(ref), floor)
    if not np.isfinite(got) or abs(got - ref[0]) > tol:
        fail(f"{name} {got} m, the reference's {ref[0]} m +- {tol} (keys {ref})")
    return f"{got:.7f} m (the reference's {ref[0]:.7f} +- {tol:.2e}, keys {ref})"


@contextlib.contextmanager
def _k1_inputs():
    """Record, during one run, the inputs of the first and the last K1
    call the ICP makes at each shape (B, S, T): {shape: [first, last]},
    each (src, tgt, tgt_mask).  The spy keeps references (no copies, no
    launches): the ICP makes a fresh source each iteration and never
    writes its targets."""
    rec = {}
    real = icp_mod.nn_search

    def spy(src, tgt, tgt_mask, impl="vpu_t"):
        if impl != "vpu_t":
            fail(f"the ICP searched with {impl}, not K1")
        calls = rec.setdefault((src.shape[0], src.shape[1], tgt.shape[-2]), [None, None])
        calls[1] = (src, tgt, tgt_mask)
        if calls[0] is None:
            calls[0] = calls[1]
        return real(src, tgt, tgt_mask, impl)

    icp_mod.nn_search = spy
    try:
        yield rec
    finally:
        icp_mod.nn_search = real


def _hold_k1(label: str, rec: dict, dev) -> str:
    """K1 against its plain version on every recorded input of a run (the
    run's own clouds, poses and split masks): indices equal, d2
    bit-equal.  Returns the shapes, the valid targets per row and each
    shape's launch geometry."""
    if not rec:
        fail(f"{label}: the ICP made no K1 call")
    notes = []
    for (b, n_src, n_tgt), calls in sorted(rec.items()):
        for k, (src, tgt, tm) in zip(("first", "last"), calls):
            i_k, d_k = nn_search(src, tgt, tm)
            i_p, d_p = nn_search_plain(src, tgt, tm)
            torch.cuda.synchronize()
            if not torch.equal(i_k, i_p) or not torch.equal(d_k, d_p):
                fail(f"{label}: K1 at B={b}, S={n_src}, T={n_tgt} ({k} call) differs "
                     f"from the plain version ({int((i_k != i_p).sum())} indices)")
        g = _cuda.sweep_geometry(b, n_src, n_tgt, dev)
        valid = calls[0][2].sum(-1).tolist()
        notes.append(f"B={b}, S={n_src}, T={n_tgt} (first and last call; valid targets "
                     f"per row {min(valid)}-{max(valid)}) grid {g['grid']} cluster "
                     f"{g['cluster']}")
    return f"{label} K1 plain-equal at " + "; ".join(notes)


def _method_dataset(tmp, method):
    d = os.path.join(tmp, method)
    t0 = time.time()
    info = workload.method_dataset(d, method)
    return d, info["T_gt"], time.time() - t0


def _scanmatch(d, extra=()):
    """``cli scanmatch`` with the launch counts set to 0 just before and
    read just after: (launches, profile, stdout)."""
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cli.main(["scanmatch", "-i", d, "--capacity", str(CAPACITY), *extra])
    launches = dict(_cuda.launch_counts)
    if rc != 0:
        fail(f"cli scanmatch on {os.path.basename(d)} returned non-zero")
    with open(f"{d}/robot0/viz/scanmatcher_profile.json") as f:
        return launches, json.load(f), out.getvalue()


def _preprocess_seconds(raw, method, dev):
    cfg = IcpConfig(capacity=CAPACITY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scans, _ = sm.preprocess_all(*raw, cfg, method, VOXEL, device=dev)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, scans


def phase_planes(tmp, smi, dev):
    """Stage 1 and stage 2 under icp2planes at full width (phase 4's scans)."""
    d, T_gt, gen_s = _method_dataset(tmp, "icp2planes")
    with _k1_inputs() as rec1:
        launches, prof, _ = _scanmatch(d)
    for k in ("nn_sweep", "ball_moments"):
        if launches[k] <= 0:
            fail(f"phase 10 stage 1 did not launch kernel {k}")
    _, T_glob = EurocDataset(d).read_trajectory("/robot0/scanmatcher/scanmatcher_global.csv")
    ate1 = _within_spread("phase 10 stage-1 ATE", ate(T_glob, T_gt)["rmse"], REF_PLANES_ATE1,
                          PLANES_ATE_FLOOR)
    fb = prof["pairs_fallback_to_seed"]
    if not min(REF_PLANES_FALLBACKS) <= fb <= max(REF_PLANES_FALLBACKS):
        fail(f"phase 10: {fb} pairs fell back to their seed, the reference "
             f"{REF_PLANES_FALLBACKS} over its keys")
    # the ground split's share of preprocessing, timed apart on the card
    euroc = EurocDataset(d)
    times = euroc.read_csv("/robot0/lidar/data.csv")["#timestamp [ns]"]
    raw = sm.load_scans(euroc, times, IcpConfig().raw_capacity)
    split = [_preprocess_seconds(raw, m, dev)[0] for m in ("icp2planes", "icppointplane")
             for _ in range(2)]
    t_split, t_plain = min(split[:2]), min(split[2:])

    slam = f"{d}/robot0/SLAM"
    calls = []
    real = icp_mod.icp_two_planes
    icp_mod.icp_two_planes = lambda *a, **kw: calls.append(len(a[-2])) or real(*a, **kw)
    try:
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()), _k1_inputs() as rec2:
            rc = cli.main(["graph", "-i", d, "--capacity", str(STAGE2_CAPACITY)])
        wall = time.time() - t0
        launches2 = dict(_cuda.launch_counts)
    finally:
        icp_mod.icp_two_planes = real
    if rc != 0:
        fail("phase 10 stage 2 returned non-zero")
    with open(f"{d}/robot0/viz/graphslam_profile.json") as f:
        prof2 = json.load(f)
    if prof2["method"] != "icp2planes" or prof2["loop_icp_pairs"] <= 0 or not calls:
        fail(f"phase 10 stage 2 ran no two-plane loop-closure ICP ({prof2['method']}, "
             f"{prof2['loop_icp_pairs']} pairs, {len(calls)} calls)")
    for k in ("nn_sweep", "ball_moments"):
        if launches2[k] <= 0:
            fail(f"phase 10 stage 2 did not launch kernel {k}")
    with open(f"{slam}/loop_closures.csv") as f:
        closures = [tuple(int(v) for v in row.split(",")[1:])
                    for row in f.read().split()[1:]]
    _, T_sol = euroc.read_trajectory("/robot0/SLAM/solution_graphslam.csv")
    ate2 = _within_spread("phase 10 stage-2 ATE", ate(T_sol, T_gt)["rmse"], REF_PLANES_ATE2,
                          PLANES_ATE_FLOOR)
    held = (_hold_k1("stage 1", rec1, dev) + "; "
            + _hold_k1("stage 2 loop ICP", rec2, dev))
    print(f"phase 10 icp2planes ({N_SCANS} scans x {SCAN_POINTS} points, voxel {VOXEL}, "
          f"capacity {CAPACITY}; dataset {gen_s:.1f} s): stage 1 (cli scanmatch) "
          f"load+preprocess {prof['load_preprocess_seconds']} s (preprocessing alone "
          f"{t_split:.4f} s with the ground split, {t_plain:.4f} s without: split share "
          f"{(t_split - t_plain) / t_split:.1%}), ICP {prof['icp_seconds']} s, "
          f"{prof['frames_per_second']} ICP frames/s, ICP iterations mean "
          f"{prof['icp_iterations_mean']:.3f} max {prof['icp_iterations_max']}, "
          f"{fb} pairs fell back (the reference {REF_PLANES_FALLBACKS}), ATE {ate1}; "
          f"launches K1 {launches['nn_sweep']}, K2 {launches['ball_moments']}; "
          f"stage 2 (cli graph, store capacity {STAGE2_CAPACITY} at voxel None): ATE "
          f"{ate2}; {prof2['loop_closures_accepted']} closures "
          + " ".join(f"{i}-{j}" for i, j in closures) + ", the reference's "
          + " ".join(f"{i}-{j}" for i, j in REF_PLANES_CLOSURES)
          + f"; {prof2['loop_icp_pairs']} loop ICP pairs in two-plane batches of "
          f"{calls}; store {prof2['store_load_preprocess_seconds']} s, solve+loop "
          f"{prof2['solve_loop_seconds']} s, loop ICP {prof2['loop_icp_seconds']} s, "
          f"wall {wall:.3f} s; launches K1 {launches2['nn_sweep']}, K2 "
          f"{launches2['ball_moments']}; {held}; card {smi}")


def phase_fpfh(tmp, smi, dev):
    """Stage 1 under fpfh at full width, reduced depth (the box world)."""
    d, T_gt, gen_s = _method_dataset(tmp, "fpfh")
    runs = []
    for k in range(2):
        with (_k1_inputs() if k == 0 else contextlib.nullcontext({})) as rec:
            launches, prof, _ = _scanmatch(d)
        if k == 0:
            held = _hold_k1("stage 1", rec, dev)
        files = {}
        for name in ("lidar_times.csv", "scanmatcher_relative.csv",
                     "scanmatcher_global.csv"):
            with open(f"{d}/robot0/scanmatcher/{name}", "rb") as f:
                files[name] = f.read()
        runs.append((launches, prof, files))
    (launches, prof, files), (_, prof_b, files_b) = runs
    for name in files:
        if files[name] != files_b[name]:
            fail(f"phase 11: {name} differs between two runs")
    for k in ("nn_sweep", "ball_moments"):
        if launches[k] <= 0:
            fail(f"phase 11 stage 1 did not launch kernel {k}")
    euroc = EurocDataset(d)
    _, T_glob = euroc.read_trajectory("/robot0/scanmatcher/scanmatcher_global.csv")
    _, T_rel = euroc.read_trajectory("/robot0/scanmatcher/scanmatcher_relative.csv")
    rel_gt = np.einsum("nij,njk->nik", np.linalg.inv(T_gt[:-1]), T_gt[1:])
    share = float((np.linalg.norm(T_rel[:, :3, 3] - rel_gt[:, :3, 3], axis=1) < 0.5).mean())
    if share < min(REF_FPFH_SHARE) - (max(REF_FPFH_SHARE) - min(REF_FPFH_SHARE)):
        fail(f"phase 11: {share:.3f} of the pairs within 0.5 m, the reference "
             f"{REF_FPFH_SHARE} over its keys")
    ate1 = _within_spread("phase 11 stage-1 ATE", ate(T_glob, T_gt)["rmse"], REF_FPFH_ATE1)
    fb = prof["pairs_fallback_to_seed"]
    if not min(REF_FPFH_FALLBACKS) <= fb <= max(REF_FPFH_FALLBACKS):
        fail(f"phase 11: {fb} pairs fell back, the reference {REF_FPFH_FALLBACKS}")

    # the main path's shapes: the first 4 scans preprocessed on the card
    times = euroc.read_csv("/robot0/lidar/data.csv")["#timestamp [ns]"]
    raw = sm.load_scans(euroc, times[:5], IcpConfig().raw_capacity)
    _, scans = _preprocess_seconds(raw, "fpfh", dev)
    radius = IcpConfig().fpfh_radius
    ng = Cloud(scans.points[:4], scans.nonground_mask[:4], scans.normals[:4])
    f_card = compute_fpfh(ng, radius)
    one = Cloud(*(x[:1].cpu() for x in (ng.points, ng.mask, ng.normals)))
    f_cpu = compute_fpfh(one, radius)[0].numpy()
    m = one.mask[0].numpy()
    row = np.abs(f_card[0].cpu().numpy() - f_cpu).max(axis=1)[m]
    hist = {t: int((row > t).sum()) for t in (1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)}
    if (row > FPFH_ROW_TOL).mean() > FPFH_ROWS_DIFFERING or not np.isfinite(row).all():
        fail(f"phase 11: card FPFH rows beyond {FPFH_ROW_TOL} of the CPU's: {hist} of "
             f"{m.sum()} (max {row.max()})")
    ms_fpfh = cuda_ms(lambda: compute_fpfh(ng, radius), 3, warmup=1) / 4
    # one pair's feature search, card against the CPU
    src_f, tgt_f = f_card[1:2], f_card[0:1]
    i_k, d1_k, d2_k = nn2_search(src_f, tgt_f, ng.mask[:1])
    i_c, d1_c, d2_c = nn2_search(src_f.cpu(), tgt_f.cpu(), ng.mask[:1].cpu())
    scale = 1e-5 * (torch.sum(src_f.cpu() ** 2, -1) + torch.sum(tgt_f.cpu() ** 2, -1).amax())
    clear = (d2_c - d1_c > 2 * scale)[0].numpy()
    same = (i_k.cpu() == i_c)[0].numpy()
    d_err = float(torch.maximum((d1_k.cpu() - d1_c).abs() / scale,
                                (d2_k.cpu() - d2_c).abs() / scale).max())
    if not same[clear].all() or d_err > 1.0:
        fail(f"phase 11 nn2_search: card differs from the CPU on "
             f"{int((~same[clear]).sum())} clear rows, d2 error {d_err} x tolerance")
    # RANSAC of the 4 consecutive pairs, as stage 1 groups them
    gp = GlobalRegParams(fpfh_radius=radius, icp=ICPParams(max_correspondence_distance=10.0))
    s_idx, t_idx = [1, 2, 3, 4], [0, 1, 2, 3]
    f_all = compute_fpfh(Cloud(scans.points, scans.nonground_mask, scans.normals), radius)
    src = Cloud(scans.points[s_idx], scans.nonground_mask[s_idx], scans.normals[s_idx])
    tgt = Cloud(scans.points[t_idx], scans.nonground_mask[t_idx], scans.normals[t_idx])
    ms_ransac = cuda_ms(lambda: ransac_feature_registration(
        src, f_all[s_idx], tgt, f_all[t_idx], gp, torch.Generator().manual_seed(0)),
        3, warmup=1) / 4
    # the store's fpfh registration on overlapping pairs, against the truth
    store = KeyframeStore.from_arrays(scans.points, scans.mask, scans.normals,
                                      method="fpfh", cfg=IcpConfig(capacity=CAPACITY),
                                      ground_mask=scans.ground_mask,
                                      nonground_mask=scans.nonground_mask)
    pairs = np.array(STORE_FPFH_PAIRS)
    with _k1_inputs() as rec:
        T_store = store.compute_transformations_batch(
            pairs, np.tile(np.eye(4, dtype=np.float32), (len(pairs), 1, 1)))
    held += "; " + _hold_k1("the store's fpfh", rec, dev)
    e_pos, e_rot = _pose_err(T_store, np.stack([np.linalg.inv(T_gt[i]) @ T_gt[j]
                                                for i, j in pairs]))
    if e_pos.max() > 0.1 or e_rot.max() > 0.02:
        fail(f"phase 11: the store's fpfh registration is off the truth: "
             f"{e_pos} m, {e_rot} rad")
    print(f"phase 11 fpfh ({len(T_gt)} box-world scans x {SCAN_POINTS} points within "
          f"{workload.FPFH_RANGE} m, voxel {VOXEL}, capacity {CAPACITY}, radius {radius}; "
          f"dataset {gen_s:.1f} s): cli scanmatch x2, CSVs byte-identical; "
          f"load+preprocess {prof['load_preprocess_seconds']} / "
          f"{prof_b['load_preprocess_seconds']} s, registration (FPFH + RANSAC + ICP) "
          f"{prof['icp_seconds']} / {prof_b['icp_seconds']} s, "
          f"{prof['frames_per_second']} / {prof_b['frames_per_second']} frames/s; "
          f"{share:.3f} of the pairs within 0.5 m (the reference {REF_FPFH_SHARE}), "
          f"{fb} fell back, ATE {ate1}; launches K1 {launches['nn_sweep']}, K2 "
          f"{launches['ball_moments']}; FPFH {ms_fpfh:.3f} ms per cloud (B=4, "
          f"{int(ng.mask.sum(1).max())} non-ground points at most), card vs CPU rows "
          f"beyond [1e-4, 1e-3, 1e-2, 0.1, 1, 10]: {list(hist.values())} of {int(m.sum())}, "
          f"max {row.max():.3g}; nn2_search S=T={CAPACITY}, D=33: indices equal on "
          f"{int(clear.sum())} clear rows ({int((~same).sum())} differ in all), d2 within "
          f"{d_err:.3f} x 1e-5 (|s|^2 + |t|^2); RANSAC {ms_ransac:.3f} ms per pair "
          f"(B=4, 8192 hypotheses); store fpfh pairs {pairs.tolist()} off the truth by "
          + ", ".join(f"{p:.4f} m / {r:.4f} rad" for p, r in zip(e_pos, e_rot))
          + f"; {held}; card {smi}")


# phase 12: the host paths on phase 4's dataset
PARSE_RUNS = 3              # timed runs of each parser / load path
MESH_SCANS = 4              # scans of the convert --mesh check
MESH_ALPHA = "1.0"          # its alpha-shape radius (m)
BAG_SCANS = 20              # scans of the bag ingested and scan-matched


def _python_parse(paths, raw):
    """The port's loader before the native parser: ``read_pcd`` and
    ``pad_numpy`` in a pool of 4 threads."""
    pts = np.zeros((len(paths), raw, 3), dtype=np.float32)

    def one(i):
        pts[i] = pad_numpy(read_pcd(paths[i]), raw)[0]
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        list(ex.map(one, range(len(paths))))
    return pts


def _spread(xs) -> str:
    return f"min {min(xs):.4f} max {max(xs):.4f} s over {len(xs)}"


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _host_parse(paths, raw):
    """The native batch parser against the Python parse: equal arrays."""
    t_nat, t_py = [], []
    for _ in range(PARSE_RUNS):
        t, (nat, counts) = _timed(lambda: native.read_pcd_batch(paths, raw))
        t_nat.append(t)
        t, py = _timed(lambda: _python_parse(paths, raw))
        t_py.append(t)
        if (counts < 0).any() or nat.tobytes() != py.tobytes():
            fail("phase 12: the native parse differs from the Python parse")
    return (f"parse alone of {len(paths)} PCDs (raw capacity {raw}): native "
            f"batch {_spread(t_nat)}, Python {_spread(t_py)} (arrays "
            f"byte-equal)")


def _host_load(euroc, times, cfg, method, dev):
    """Streamed load+preprocess against the two-phase path (load, then
    preprocess), in turns: equal stacks."""
    rec = {"load": [], "preprocess": [], "two-phase": [], "streamed": []}
    for r in range(PARSE_RUNS):
        for path in (("two", "stream") if r % 2 == 0 else ("stream", "two")):
            if path == "two":
                t_load, raw = _timed(lambda: sm.load_scans(euroc, times, cfg.raw_capacity))
                t_pre, (two, _) = _timed(lambda: sm.preprocess_all(
                    *raw, cfg, method, VOXEL, device=dev))
                rec["load"].append(t_load)
                rec["preprocess"].append(t_pre)
                rec["two-phase"].append(t_load + t_pre)
            else:
                t, (stream, _, n_py) = _timed(lambda: sm.load_and_preprocess_streamed(
                    euroc, times, cfg, method, VOXEL, device=dev))
                rec["streamed"].append(t)
                if n_py:
                    fail(f"phase 12: {n_py} PCDs went to the Python parser")
        for name, a, b in zip(two._fields, stream, two):
            if (a is None) != (b is None) or (b is not None and not torch.equal(a, b)):
                fail(f"phase 12: streamed and two-phase {name} differ on the card")
        del raw
    line = ("load+preprocess of the stack (bit-equal on the card): "
            + "; ".join(f"{k} {_spread(v)}" for k, v in rec.items()))
    return line, stream


def _host_resume(d, euroc, scans, cfg, tmp):
    """match_consecutive at phase 4's shape, checkpointed, cut back to half
    its groups and resumed: the uninterrupted transforms, bit for bit."""
    prm = euroc.read_scanmatcher_parameters()
    _, _, _, odo, _ = sm.prepare_experiment_data(euroc, prm["start_index"],
                                                 prm["delta_time"])
    args = (scans.points, scans.mask, scans.normals, sm.relative_odometry(odo),
            cfg, prm["method"])
    ck = os.path.join(tmp, "checkpoint.npz")
    t_fused, (fused, _) = _timed(lambda: sm.match_consecutive(*args, progress=False))
    t_ck, (full, _) = _timed(lambda: sm.match_consecutive(
        *args, progress=False, checkpoint_path=ck, checkpoint_key=1))
    saved = dict(np.load(ck))
    groups = int(saved["batches_done"])
    saved["batches_done"] = groups // 2
    saved["transforms"][groups // 2 * cfg.batch_size:] = 0.0
    np.savez(ck, **saved)
    t_res, (resumed, st) = _timed(lambda: sm.match_consecutive(
        *args, progress=False, checkpoint_path=ck, checkpoint_key=1))
    if not (np.array_equal(full, fused) and np.array_equal(resumed, fused)):
        fail("phase 12: checkpointed or resumed transforms differ from the "
             "uninterrupted run")
    skipped = int((st["iterations"] < 0).sum())
    return (f"resume ({len(fused)} pairs, {groups} groups): checkpointed run "
            f"and a run resumed at group {groups // 2} ({skipped} pairs read "
            f"back) bit-equal to the uninterrupted one; seconds fused "
            f"{t_fused:.4f}, checkpointed {t_ck:.4f}, resumed {t_res:.4f}")


def _host_renders(d):
    """Phase 8's ``cli graph`` renders, or the recorded ImportError."""
    with open(f"{d}/robot0/viz/graphslam_profile.json") as f:
        err = json.load(f)["uncertainty_error"]
    if err is None:
        sizes = {n: os.path.getsize(f"{d}/robot0/SLAM/{n}")
                 for n in ("uncertainty.png", "gps_comparison.png")}
        if min(sizes.values()) <= 1000:
            fail(f"phase 12: stage 2's renders are empty: {sizes}")
        return f"renders: phase 8's cli graph wrote {sizes} (bytes)"
    if not err.startswith(("ImportError", "ModuleNotFoundError")):
        fail(f"phase 12: stage 2's renders failed: {err}")
    return f"renders: not written, matplotlib missing ({err})"


def _cli_seconds(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        t, rc = _timed(lambda: cli.main(argv))
    if rc != 0:
        fail(f"phase 12: cli {' '.join(argv[:1])} returned non-zero")
    return t, out.getvalue()


def _bag_of(d, n_scans, bag):
    """A ROS1 bag of the dataset's first ``n_scans`` scans, their odometry
    and GPS, written by the port's ``write_bag``."""
    euroc = EurocDataset(d)
    times = euroc.read_csv("/robot0/lidar/data.csv")["#timestamp [ns]"][:n_scans]
    odo = euroc.read_csv("/robot0/odom/data.csv")
    gps = euroc.read_csv("/robot0/gps0/data.csv")
    msgs = []
    for k, t in enumerate(odo["#timestamp [ns]"]):
        if t <= times[-1]:
            msgs.append(("/odom", "nav_msgs/Odometry", int(t), rosbag.serialize_odometry(
                int(t), [odo[c][k] for c in "xyz"],
                [odo[c][k] for c in ("qx", "qy", "qz", "qw")])))
    for k, t in enumerate(times):
        msgs.append(("/points", "sensor_msgs/PointCloud2", int(t),
                     rosbag.serialize_pointcloud2(int(t), read_pcd(euroc.scan_pcd_path(t)))))
        msgs.append(("/fix", "sensor_msgs/NavSatFix", int(t), rosbag.serialize_navsatfix(
            int(t), gps["latitude"][k], gps["longitude"][k], gps["altitude"][k])))
    msgs.sort(key=lambda m: m[2])
    rosbag.write_bag(bag, msgs, compression="bz2")
    return times, len(msgs)


def _host_commands(d, T_gt, tmp):
    """cli view, convert, convert --mesh and diag on phase 4's dataset; cli
    ingest of a bag of its first scans, then cli scanmatch of the tree."""
    n = N_SCANS
    out, secs = [], {}
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    if have_mpl:
        secs["view"], _ = _cli_seconds(["view", "-i", d])
        viz = f"{d}/robot0/viz"
        for name in ("trajectory.png", "trajectory_loop_closures.png", "map.ply", "map.pcd"):
            if not os.path.getsize(f"{viz}/{name}"):
                fail(f"phase 12: cli view wrote an empty {name}")
        n_map = len(read_ply(f"{viz}/map.ply"))
        if not (n_map > 0 and read_pcd(f"{viz}/map.pcd").shape == (n_map, 3)):
            fail(f"phase 12: cli view's map.ply and map.pcd disagree ({n_map} points)")
        secs["diag"], text = _cli_seconds(["diag", "-i", d])
        report = json.loads(text)
        if (report["timestamps"]["lidar"]["count"] != n
                or report["solution_slam"]["poses"] != n
                or report["delta_scanmatcher"]["steps"] != n - 1):
            fail(f"phase 12: cli diag's counts are off: {report}")
        out.append(f"view map {n_map} points, diag SLAM end-point error "
                   f"{report['solution_slam']['end_point_error_m']:.4f} m")
    else:
        for cmd in ("view", "diag"):
            try:
                cli.main([cmd, "-i", d])
            except ImportError:
                continue
            fail(f"phase 12: cli {cmd} ran without matplotlib")
        out.append("view and diag raise ImportError (no matplotlib)")
    secs["convert"], _ = _cli_seconds(["convert", "-i", d])
    plys = os.listdir(f"{d}/robot0/lidar/dataply")
    if len(plys) != n:
        fail(f"phase 12: cli convert wrote {len(plys)} PLYs for {n} scans")
    dm = os.path.join(tmp, "mesh")
    os.makedirs(f"{dm}/robot0/lidar/data")
    times = EurocDataset(d).read_csv("/robot0/lidar/data.csv")["#timestamp [ns]"][:MESH_SCANS]
    for t in times:
        shutil.copy(f"{d}/robot0/lidar/data/{t}.pcd", f"{dm}/robot0/lidar/data/")
    with open(f"{dm}/robot0/lidar/data.csv", "w") as f:
        f.write("#timestamp [ns]\n" + "".join(f"{t}\n" for t in times))
    secs["convert --mesh"], _ = _cli_seconds(["convert", "-i", dm, "--mesh",
                                              "--alpha", MESH_ALPHA])
    faces = []
    for t in times:
        with open(f"{dm}/robot0/lidar/dataply/{t}.ply", "rb") as f:
            head = f.read(400).decode("ascii", "ignore")
        faces.append(int(head.split("element face ")[1].split()[0]))
    if min(faces) <= 0:
        fail(f"phase 12: cli convert --mesh wrote empty meshes: {faces}")
    out.append(f"convert {len(plys)} PLYs, --mesh {MESH_SCANS} scans at alpha "
               f"{MESH_ALPHA} m: {faces} faces")

    bag, di = os.path.join(tmp, "scans.bag"), os.path.join(tmp, "ingested")
    t_bag = time.perf_counter()
    b_times, n_msgs = _bag_of(d, BAG_SCANS, bag)
    t_bag = time.perf_counter() - t_bag
    secs["ingest"], _ = _cli_seconds(["ingest", "-i", di, "--bag", bag])
    if (sorted(os.listdir(f"{di}/robot0/lidar/data"))
            != sorted(f"{t}.pcd" for t in b_times)):
        fail("phase 12: cli ingest did not write one PCD per scan")
    for t in b_times:
        if (read_pcd(f"{di}/robot0/lidar/data/{t}.pcd").tobytes()
                != read_pcd(f"{d}/robot0/lidar/data/{t}.pcd").tobytes()):
            fail(f"phase 12: ingested scan {t} differs from the dataset's")
    for name in ("scanmatcher_parameters.yaml", "slam_parameters.yaml"):
        shutil.copy(f"{d}/robot0/{name}", f"{di}/robot0/")
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    secs["scanmatch (ingested)"], _ = _cli_seconds(
        ["scanmatch", "-i", di, "--capacity", str(CAPACITY)])
    if _cuda.launch_counts["nn_sweep"] <= 0 or _cuda.launch_counts["ball_moments"] <= 0:
        fail("phase 12: cli scanmatch of the ingested tree did not launch K1 and K2")
    _, T_ing = EurocDataset(di).read_trajectory("/robot0/scanmatcher/scanmatcher_global.csv")
    _, T_rel = EurocDataset(di).read_trajectory("/robot0/scanmatcher/scanmatcher_relative.csv")
    _, T_rel4 = EurocDataset(d).read_trajectory("/robot0/scanmatcher/scanmatcher_relative.csv")
    err = ate(T_ing, T_gt[:BAG_SCANS])["rmse"]
    dpos, drot = _pose_err(T_rel, T_rel4[:BAG_SCANS - 1])
    if len(T_ing) != BAG_SCANS or err >= VOXEL or dpos.max() > 1e-3 or drot.max() > 1e-3:
        fail(f"phase 12: the ingested tree's stage 1: {len(T_ing)} poses, ATE "
             f"{err} m, {dpos.max()} m / {drot.max()} rad from phase 4's pairs")
    out.append(f"bag of {BAG_SCANS} scans ({n_msgs} messages, bz2, built in "
               f"{t_bag:.3f} s) ingested byte-equal, its stage 1 ATE {err:.5f} m, "
               f"{dpos.max():.3g} m / {drot.max():.3g} rad from phase 4's pairs")
    return ("commands: " + "; ".join(out) + "; seconds "
            + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))


def phase_host(d, T_gt, smi, dev, tmp):
    """The host paths on phase 4's dataset: the parse alone, streamed
    against two-phase load+preprocess, resume, stage 2's renders and the
    remaining commands."""
    euroc = EurocDataset(d)
    times = euroc.read_csv("/robot0/scanmatcher/lidar_times.csv")["#timestamp [ns]"]
    cfg = IcpConfig(capacity=CAPACITY)
    paths = [euroc.scan_pcd_path(t) for t in times]
    parse = _host_parse(paths, cfg.raw_capacity)
    load, scans = _host_load(euroc, times, cfg, "icppointplane", dev)
    resume = _host_resume(d, euroc, scans, cfg, tmp)
    renders = _host_renders(d)
    commands = _host_commands(d, T_gt, tmp)
    print(f"phase 12 host paths ({N_SCANS} scans x {SCAN_POINTS} points, "
          f"capacity {CAPACITY}, voxel {VOXEL}): {parse}; {load}; {resume}; "
          f"{renders}; {commands}; card {smi}")


# ---------------------------------------------------------------- phase 13

MESH_RANKS = 2              # ranks sharing the one card in phase 13
MESH_TIMEOUT_S = 120.0      # a rank waiting longer in a collective fails the phase
MESH_PAIRS = 8              # phase 13 (a): phase 4's first pairs
MESH_ICP_REPS = 5           # (a): warm calls timed
MESH_ICP_ATOL = 1e-5        # (a), (b): against one process
MESH_SLAM_ATOL = 3e-2       # (d): positions against phase 8's solution
MESH_STEP_ATOL = 2e-4       # (e): the Schur step against the dense one
SEP_TOO_SMALL = 4           # (f): below the 512-pose graph's 9 separators


def _mesh_cli(argv, logs):
    """``cli.main(argv)`` with the reports of the ranks it launches (their
    output in ``logs``): (reports, wall s)."""
    got = []
    launch = cli.launch_stages

    def spy(a, n, device):
        got.extend(launch(a, n, device, log_dir=logs))
        return got

    cli.launch_stages = spy
    t0 = time.time()
    try:
        rc = cli.main(argv)
    finally:
        cli.launch_stages = launch
    if rc != 0 or len(got) != MESH_RANKS:
        fail(f"phase 13: {' '.join(argv)} returned {rc} with {len(got)} rank reports")
    return got, time.time() - t0


def _mesh_ranks_ok(label, reports, stage, kernels):
    """Every rank on the card under gloo, torch only, its kernels
    launched; rank 0 alone wrote."""
    for r in reports:
        prof = r[stage]["profile"]
        if r["backend"] != "gloo" or not r["device"].startswith("cuda") \
                or r["foreign_modules"]:
            fail(f"phase 13 {label} rank {r['rank']}: backend {r['backend']} on "
                 f"{r['device']}, imported {r['foreign_modules']}")
        for k in kernels:
            if prof["kernel_launches"][k] <= 0:
                fail(f"phase 13 {label} rank {r['rank']} did not launch {k}")
        if bool(r[stage]["written"]) != (r["rank"] == 0):
            fail(f"phase 13 {label} rank {r['rank']} wrote {r[stage]['written']}")


def _collectives(prof) -> str:
    return ", ".join(f"{k} {v['calls']} calls {v['bytes']} B"
                     for k, v in prof["collectives"].items() if v["calls"])


def _mesh_stage1(d, T_gt, tmp, logs):
    """(b): ``cli scanmatch --devices 2``, then with ``--shard-scans``,
    each against phase 4's one-process CSV."""
    euroc = EurocDataset(d)
    _, rel1 = euroc.read_trajectory("/robot0/scanmatcher/scanmatcher_relative.csv")
    k = sm.sharded_rows(N_SCANS, MESH_RANKS, IcpConfig().batch_size)
    out = []
    for shard in (False, True):
        dm = os.path.join(tmp, f"mesh_sm_{int(shard)}")
        shutil.copytree(d, dm)
        argv = ["scanmatch", "-i", dm, "--capacity", str(CAPACITY), "--devices",
                str(MESH_RANKS)] + (["--shard-scans"] if shard else [])
        reports, wall = _mesh_cli(argv, logs)
        label = "--shard-scans" if shard else "replicated stack"
        _mesh_ranks_ok(label, reports, "scanmatch", ("nn_sweep", "ball_moments"))
        for r in reports:
            want = k if shard else N_SCANS
            if r["scanmatch"]["scans_loaded_locally"] != want:
                fail(f"phase 13 {label} rank {r['rank']} loaded "
                     f"{r['scanmatch']['scans_loaded_locally']} scans, expected {want}")
        em = EurocDataset(dm)
        _, rel = em.read_trajectory("/robot0/scanmatcher/scanmatcher_relative.csv")
        _, T = em.read_trajectory("/robot0/scanmatcher/scanmatcher_global.csv")
        diff = float(np.abs(rel - rel1).max())
        err = ate(T, T_gt)["rmse"]
        prof = reports[0]["scanmatch"]["profile"]
        if diff > MESH_ICP_ATOL or err >= VOXEL or prof["pairs_fallback_to_seed"]:
            fail(f"phase 13 {label}: relative transforms {diff} from phase 4's, ATE "
                 f"{err} m, {prof['pairs_fallback_to_seed']} pairs fell back")
        secs = prof["load_preprocess_seconds"] + prof["icp_seconds"]
        out.append(
            f"{label}: max |diff| vs phase 4 {diff:.3g} (bit-equal {diff == 0.0}), "
            f"ATE {err:.5f} m, 0 fallbacks, scans loaded per rank "
            f"{[r['scanmatch']['scans_loaded_locally'] for r in reports]}, "
            f"launches per rank "
            f"{[(r['scanmatch']['profile']['kernel_launches']['nn_sweep'], r['scanmatch']['profile']['kernel_launches']['ball_moments']) for r in reports]} "
            f"(K1, K2), load+preprocess {prof['load_preprocess_seconds']} s, ICP "
            f"{prof['icp_seconds']} s, {prof['frames_per_second']} ICP frames/s, "
            f"{prof['pairs'] / secs:.3f} frames/s end to end, command {wall:.3f} s "
            f"(two ranks sharing one card: not a scaling number); collectives "
            f"{_collectives(prof)}")
    return "; ".join(out)


def _mesh_stage2(d, T_gt, tmp, logs):
    """(d): ``cli graph --devices 2`` against phase 8's run."""
    _, sol8 = EurocDataset(d).read_trajectory("/robot0/SLAM/solution_graphslam.csv")
    dm = os.path.join(tmp, "mesh_graph")
    shutil.copytree(d, dm)
    reports, wall = _mesh_cli(["graph", "-i", dm, "--capacity", str(STAGE2_CAPACITY),
                               "--devices", str(MESH_RANKS)], logs)
    _mesh_ranks_ok("graph", reports, "graph", ("nn_sweep", "ball_moments"))
    prof = reports[0]["graph"]["profile"]
    if prof["solver"] != "schur" or prof["mesh_devices"] != MESH_RANKS:
        fail(f"phase 13 graph: solver {prof['solver']} over {prof['mesh_devices']} ranks")
    with open(f"{dm}/robot0/SLAM/loop_closures.csv") as f:
        closures = [tuple(int(v) for v in row.split(",")[1:])
                    for row in f.read().split()[1:]]
    if closures != REFERENCE_CLOSURES:
        fail(f"phase 13 graph accepted {closures}, phase 8 {REFERENCE_CLOSURES}")
    _, sol = EurocDataset(dm).read_trajectory("/robot0/SLAM/solution_graphslam.csv")
    dpos = float(np.abs(sol[:, :3, 3] - sol8[:, :3, 3]).max())
    err = ate(sol, T_gt)["rmse"]
    if sol.shape != sol8.shape or not np.isfinite(sol).all() or dpos > MESH_SLAM_ATOL:
        fail(f"phase 13 graph: positions {dpos} m from phase 8's solution")
    keys = ("store_load_preprocess_seconds", "solve_loop_seconds", "optimize_seconds",
            "loop_candidate_search_seconds", "loop_icp_seconds", "marginals_seconds",
            "host_other_seconds")
    return (f"graph: solver schur over {MESH_RANKS} ranks, phase 8's "
            f"{len(closures)} closures in order, positions within {dpos:.3g} m of "
            f"phase 8's solution, ATE {err:.7f} m (the reference's "
            f"{REFERENCE_FULL_ATE:.7f}), launches per rank "
            f"{[(r['graph']['profile']['kernel_launches']['nn_sweep'], r['graph']['profile']['kernel_launches']['ball_moments']) for r in reports]} "
            f"(K1, K2), " + ", ".join(f"{k} {prof[k]}" for k in keys)
            + f", solver stats {prof['solver_stats']}, command {wall:.3f} s; "
            f"collectives {_collectives(prof)}")


def _mesh_pairs(d, dev):
    """(a)'s input: phase 4's first MESH_PAIRS consecutive pairs as stage 1
    preprocesses them (S = T = 8192), seeded by the odometry."""
    euroc = EurocDataset(d)
    times = euroc.read_csv("/robot0/scanmatcher/lidar_times.csv")["#timestamp [ns]"]
    cfg = IcpConfig(capacity=CAPACITY)
    scans, _, _ = sm.load_and_preprocess_streamed(
        euroc, times[:MESH_PAIRS + 1], cfg, "icppointplane", VOXEL, device=dev)
    odo = euroc.read_csv("/robot0/odom/data.csv")
    odo = euroc.get_rows_at_times(odo, euroc.get_closest_times(times, odo["#timestamp [ns]"]))
    seeds = sm.relative_odometry(odo)[:MESH_PAIRS].astype(np.float32)
    params = ICPParams(max_correspondence_distance=cfg.distance_threshold,
                       max_iterations=cfg.max_iterations)
    src, tgt = slice(1, MESH_PAIRS + 1), slice(0, MESH_PAIRS)
    batch = tuple(a.contiguous() for a in (
        scans.points[src], scans.mask[src], scans.points[tgt], scans.mask[tgt],
        scans.normals[tgt])) + (torch.from_numpy(seeds).to(dev),)
    return batch, params


def phase_mesh(d, T_gt, smi, dev, tmp, stage2_rec):
    """Two ranks on the one card: sharded ICP, stage 1 both layouts, the
    sharded store, stage 2 by the Schur solve, the Schur step at 512
    poses, a separator overflow."""
    t_phase = time.time()
    logs = os.path.join(tmp, "rank_logs")
    os.makedirs(logs, exist_ok=True)
    batch, params = _mesh_pairs(d, dev)
    pairs = np.concatenate([p for p, _ in stage2_rec["icp_pairs"]])
    seeds = np.concatenate([s for _, s in stage2_rec["icp_pairs"]])
    times = EurocDataset(d).read_csv("/robot0/scanmatcher/lidar_times.csv")["#timestamp [ns]"]
    g, _ = solver_graph(512, dev)
    state = {k: getattr(g, k) for k in FACTOR_FIELDS + (
        "poses", "n_poses", "n_chain", "n_loop", "n_gps", "n_prior",
        "chain_capacity", "T0", "T0_gps")}
    sep_cap = g._sep_capacity(MESH_RANKS)
    t0 = time.time()
    try:
        ranks = _mesh.launch(
            MESH_RANKS, _ranks.sequence,
            (_ranks.sharded_icp, (tuple(t.cpu().numpy() for t in batch), params,
                                  "point_to_plane", MESH_ICP_REPS)),
            (_ranks.store_pairs, (d, times, {"capacity": STAGE2_CAPACITY},
                                  "icppointplane", pairs, seeds)),
            (_ranks.schur_step, (state, 1e-4, sep_cap, STEP_REPS)),
            (_ranks.schur_solve, (state, SEP_TOO_SMALL, 2)),
            (_ranks.counters, ()), device="cuda", timeout_s=MESH_TIMEOUT_S,
            log_dir=logs)
    except _mesh.RankError as exc:
        fail(f"phase 13: a rank failed: {exc}")
    wall = time.time() - t0
    backend = ranks[0][-1]["backend"]
    if backend != "gloo" or any(r[-1]["foreign_modules"] for r in ranks):
        fail(f"phase 13: backend {backend}, foreign modules "
             f"{[r[-1]['foreign_modules'] for r in ranks]}")
    # (a) sharded ICP against one process
    one = icp_mod.icp_batch(*batch, params, "point_to_plane")
    T1 = one.transform.cpu().numpy()
    a_diff = max(float(np.abs(r[0]["transform"] - T1).max()) for r in ranks)
    if a_diff > MESH_ICP_ATOL or any(r[0]["k1_launches"] <= 0 for r in ranks):
        fail(f"phase 13 (a): sharded ICP {a_diff} from one process, K1 launches "
             f"{[r[0]['k1_launches'] for r in ranks]}")
    icp_one_s = sum(_timed(lambda: icp_mod.icp_batch(*batch, params, "point_to_plane"))[0]
                    for _ in range(MESH_ICP_REPS)) / MESH_ICP_REPS
    # (c) the sharded store against one store
    store = KeyframeStore(d, times, cfg=IcpConfig(capacity=STAGE2_CAPACITY), device=dev)
    T_store = store.load_and_preprocess().compute_transformations_batch(pairs, seeds)
    for r in ranks:
        if not np.array_equal(r[1]["T"], T_store) or r[1]["k1_launches"] <= 0:
            fail(f"phase 13 (c): rank {r[-1]['rank']}'s sharded store differs from "
                 f"one store by {float(np.abs(r[1]['T'] - T_store).max())}")
    # (e) the Schur step at 512 poses against the dense step
    f = make_factor_data(512, dev, **{k: getattr(g, k) for k in FACTOR_FIELDS})
    p0 = torch.as_tensor(g.poses, device=dev)
    ref, _ = solver._lm_step(p0, f, 512, 1e-4)
    e_diff = max(float(np.abs(r[2]["poses"] - ref.cpu().numpy()).max()) for r in ranks)
    if e_diff > MESH_STEP_ATOL:
        fail(f"phase 13 (e): Schur step {e_diff} from the dense step at 512 poses")
    dense_ms = _step_ms(lambda p: solver._lm_step(p, f, 512, 1e-4), p0, STEP_REPS)
    pcg_ms = _step_ms(lambda p: pcg.pcg_lm_step(p, f, 512, 1e-4), p0, STEP_REPS)
    # (f) the separator overflow, raised in every rank
    for r in ranks:
        if "separator count" not in r[3].get("error", ""):
            fail(f"phase 13 (f): rank {r[-1]['rank']} gave {r[3]} with "
                 f"sep_capacity {SEP_TOO_SMALL}")
    stage1 = _mesh_stage1(d, T_gt, tmp, logs)
    stage2 = _mesh_stage2(d, T_gt, tmp, logs)
    print(f"phase 13 multi-device ({MESH_RANKS} ranks sharing {smi}, backend "
          f"{backend}, spawned, rendezvous through a FileStore): (a) sharded ICP of "
          f"{MESH_PAIRS} phase-4 pairs (S=T={CAPACITY}) vs one process max |diff| "
          f"{a_diff:.3g} (bit-equal {a_diff == 0.0}), K1 launches per rank "
          f"{[r[0]['k1_launches'] for r in ranks]}, wall per call (mean of "
          f"{MESH_ICP_REPS} warm calls) per rank {[round(r[0]['seconds'], 4) for r in ranks]} "
          f"s (the first, cold: {[round(r[0]['seconds_first'], 3) for r in ranks]}) "
          f"vs one process {icp_one_s:.4f} s; (c) sharded store, {len(pairs)} loop pairs of phase 8: "
          f"bit-equal to one store, {ranks[0][1]['loaded']} scans loaded per rank, "
          f"K1 launches per rank {[r[1]['k1_launches'] for r in ranks]}; (e) 512 poses: "
          f"Schur step vs dense {e_diff:.3g}, {ranks[0][2]['n_sep']} separators "
          f"(capacity {sep_cap}), ms per LM step Schur "
          f"{[round(r[2]['ms_per_step'], 3) for r in ranks]} (per rank), dense "
          f"{dense_ms:.3f}, PCG {pcg_ms:.3f}; (f) sep_capacity {SEP_TOO_SMALL}: "
          f"ValueError in every rank ('{ranks[0][3]['error'][:40]}...'); launch of "
          f"(a, c, e, f) {wall:.3f} s; (b) {stage1}; (d) {stage2}; phase "
          f"{time.time() - t_phase:.1f} s; card {smi}")


# phase 14: the public API on the card.  Card-vs-CPU bounds of the port's
# f32 geometry (tests/test_torch_geom_api.py holds the CPU to the JAX
# package by the same numbers on random rotations): rotation entries,
# quaternions and angles (modulo 2 pi) 1e-6; euler_to_quat 2e-6 (its
# vector part scales a 1-ulp difference in R by s / sqrt(1 - s^2) near the
# identity); so3_log 3e-6 rad times max(1, theta / sin theta) (sin theta
# floored at 1e-3): below pi - 1e-3 the log scales the skew part by
# theta / (2 sin theta), so the ulp by which acos and sin differ between
# the devices grows as 1 / sin theta near pi, where phase 4's loop passes
# (8.6e-6 rad there on an H100), and se3_log's v = V^-1 t
# carries that error times |t|; translations 1e-6 of the array's largest
# coordinate
API_ROT_ATOL = 1e-6
API_QUAT_OF_R_ATOL = 2e-6
API_LOG_ATOL = 3e-6
API_POS_RTOL = 1e-6
API_ANGLES = {"normalize_angle", "rot_to_euler", "rot_to_euler_both", "quat_to_euler"}
# phase 4's 256 relative transforms (scanmatcher_relative.csv) folded in f32
# on the card, against a float64 sequential fold of the same transforms
API_CHAIN_POS_ATOL = 1e-4   # m
API_CHAIN_ROT_ATOL = 2e-5   # rad
# ... and against the written global trajectory (scanmatcher_global.csv).
# Stage 1 folds its ICP transforms as they come out of f32 (orthonormal to
# ~1e-6), the relative CSV stores them as unit quaternions: the two folds
# part by a few 1e-7 rad a step, up to ~1e-4 rad and ~1e-3 m over 256
# steps (1.13e-4 rad and 7.08e-4 m on an H100 at 700 W)
API_CSV_POS_ATOL = 2e-3     # m
API_CSV_ROT_ATOL = 5e-4     # rad
API_U32 = 2.0 ** -24        # f32 unit roundoff: the ball's rounding band
API_MOMENT_RTOL = 1e-5      # S1/S2 where the counts agree (tests/test_torch_api.py)
API_NORMAL_DOT = 0.999      # |n . n'| between the two normal routes on a sheet
API_COMPAT_ATOL = 1e-9      # compat's float64 round trip
API_ICP_YAML = """\
filter_by_radius:
  max_radius: 30.0
  min_radius: 1.5
filter_by_height:
  max_height: 40.0
  min_height: -2.0
down_sample:
  voxel_size: 0.25
icp:
  distance_threshold: 5
"""
API_ICP_FIELDS = {"max_radius": 30.0, "min_radius": 1.5, "max_height": 40.0,
                  "min_height": -2.0, "voxel_size": 0.25, "distance_threshold": 5}


def _api_geom_cases(rng, T, q_csv):
    """{name: [args, ...]} over every name of ``geom.__all__``: phase 4's
    global transforms and quaternions, and the degenerate inputs of the
    JAX package's tests (zero quaternions, gimbal lock, near-pi rotations,
    slerp between q and -q and between nearly equal q)."""
    f32 = np.float32
    T = T.astype(f32)
    R = T[:, :3, :3]
    q = rng.normal(size=(4, 64, 4)).astype(f32)
    q.reshape(-1, 4)[:3] = 0.0
    half = len(q_csv) // 2
    q1 = q_csv[:half].astype(f32)
    q2 = q_csv[half:2 * half].astype(f32)
    t = rng.uniform(size=half).astype(f32)
    abg = rng.uniform(-np.pi, np.pi, (256, 3)).astype(f32)
    abg[:16, 1] = np.pi / 2
    abg[16:32, 1] = -np.pi / 2
    axes = rng.normal(size=(64, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    w_pi = np.cos(0.5 * (np.pi - rng.uniform(0, 1e-3, (64, 1))))
    q_pi = np.concatenate([w_pi, np.sqrt(1 - w_pi ** 2) * axes], axis=1)
    R_pi = hostmath.quat_to_rot_np(q_pi).astype(f32)
    w = rng.normal(size=(2, 128, 3)).astype(f32)
    w[0, :8] *= 1e-7
    xi = rng.normal(size=(256, 6)).astype(f32)
    pts = rng.normal(scale=10.0, size=(min(16, len(T)), 512, 3)).astype(f32)
    rel = (np.linalg.inv(T[:-1].astype(np.float64)) @ T[1:]).astype(f32)
    return {
        "quat_to_rot": [(q,), (q1,)],
        "rot_to_quat": [(R,), (R_pi,), (T,)],
        "quat_multiply": [(q, q[::-1].copy()), (q1, q2)],
        "quat_conjugate": [(q,)],
        "quat_normalize": [(q,)],
        "quat_slerp": [(q1, q2, t), (q1, -q1, t), (q1, (q1 + 1e-6).astype(f32), t),
                       (q1, q2, 0.5)],
        "euler_to_rot": [(abg,)],
        "rot_to_euler": [(R,), (geom.euler_to_rot(torch.from_numpy(abg)).numpy(),)],
        "rot_to_euler_both": [(R,), (geom.euler_to_rot(torch.from_numpy(abg)).numpy(),)],
        "euler_to_quat": [(abg,)],
        "quat_to_euler": [(q,), (q1,)],
        "normalize_angle": [(rng.uniform(-20, 20, 1024).astype(f32),)],
        "so3_exp": [(w,)],
        "so3_log": [(R,), (R_pi,)],
        "so3_hat": [(w,)],
        "so3_vee": [(geom.so3_hat(torch.from_numpy(w)).numpy(),)],
        "make_transform": [(T[:, :3, 3].copy(), R)],
        "transform_from_quat": [(T[:, :3, 3].copy(), q_csv.astype(f32))],
        "transform_from_euler": [(T[:, :3, 3].copy(), abg[:1].repeat(len(T), 0))],
        "compose": [(T[:-1], rel)],
        "inverse": [(T,)],
        "transform_points": [(T[:len(pts)], pts)],
        "positions": [(T,)],
        "rotations": [(T,)],
        "t2v": [(T,)],
        "se3_exp": [(xi,)],
        "se3_log": [(T,), (rel,)],
        "relative_transforms": [(T,)],
        "global_transforms": [(rel,), (rel, T[0], T[1])],
        "multiply_by_transform": [(T, T[-1])],
        "transforms_from_pose_columns": [(T[:, :3, 3].copy(), q_csv.astype(f32))],
        "pose_columns_from_transforms": [(T,)],
    }


def _api_outputs(x):
    return list(x) if isinstance(x, tuple) else [x]


def _api_geom_err(name, got, ref) -> float:
    """The largest error of ``got`` against ``ref`` over the bound that
    applies to it (<= 1 within every bound)."""
    d = np.abs(got.astype(np.float64) - ref)
    if name in API_ANGLES:
        d = np.abs(np.angle(np.exp(1j * (got.astype(np.float64) - ref))))
    pos_atol = API_POS_RTOL * max(float(np.abs(ref).max(initial=0)), 1.0)
    if name in ("so3_log", "se3_log"):
        w = ref[..., :3]
        th = np.linalg.norm(w, axis=-1)
        log_atol = API_LOG_ATOL * np.maximum(1.0, th / np.maximum(np.sin(th), 1e-3))
        rot = (d[..., :3].max(-1) / log_atol).max(initial=0)
        if name == "so3_log":
            return rot
        v = np.linalg.norm(ref[..., 3:], axis=-1)
        return max(rot, (d[..., 3:].max(-1) / (pos_atol + 2 * log_atol * v)).max(initial=0))
    if got.shape[-2:] == (4, 4):
        return max(d[..., :3, :3].max(initial=0) / API_ROT_ATOL,
                   d[..., :3, 3].max(initial=0) / pos_atol,
                   np.inf if (d[..., 3, :] != 0).any() else 0.0)
    if name in ("positions", "transform_points") or (
            name == "pose_columns_from_transforms" and got.shape[-1] == 3):
        return d.max(initial=0) / pos_atol
    if name == "t2v":
        ang = np.abs(np.angle(np.exp(1j * (got[..., 3:].astype(np.float64) - ref[..., 3:]))))
        return max(d[..., :3].max() / pos_atol, ang.max() / API_ROT_ATOL)
    atol = {"euler_to_quat": API_QUAT_OF_R_ATOL}.get(name, API_ROT_ATOL)
    return d.max(initial=0) / atol


def _pose_gap(A, B):
    """(largest position gap in m, largest rotation angle in rad) between
    two (N, 4, 4) float64 trajectories."""
    D = np.linalg.inv(A[:, :3, :3]) @ B[:, :3, :3]
    return (float(np.linalg.norm(A[:, :3, 3] - B[:, :3, 3], axis=-1).max()),
            float(np.linalg.norm(geom.so3_log(torch.from_numpy(D)).numpy(), axis=-1).max()))


def _api_geometry(d, dev):
    """(a): every geom name on the card against the CPU and the float64
    host mirrors; phase 4's relative transforms folded on the card."""
    euroc = EurocDataset(d)
    _, T_rel = euroc.read_trajectory("/robot0/scanmatcher/scanmatcher_relative.csv")
    _, T_glob = euroc.read_trajectory("/robot0/scanmatcher/scanmatcher_global.csv")
    q_csv = hostmath.rot_to_quat_np(T_glob[:, :3, :3])
    cases = _api_geom_cases(np.random.default_rng(14), T_glob, q_csv)
    if sorted(cases) != sorted(geom.__all__):
        fail(f"phase 14 (a): the cases miss {sorted(set(geom.__all__) - set(cases))}")
    worst, calls = {}, 0
    for name, arg_sets in cases.items():
        fn = getattr(geom, name)
        for args in arg_sets:
            card = _api_outputs(fn(*[torch.from_numpy(np.array(a)).to(dev)
                                     if isinstance(a, np.ndarray) else a for a in args]))
            cpu = _api_outputs(fn(*[torch.from_numpy(np.array(a))
                                    if isinstance(a, np.ndarray) else a for a in args]))
            calls += 1
            for g, c in zip(card, cpu):
                if g.device.type != dev.type or g.dtype != c.dtype or g.shape != c.shape:
                    fail(f"phase 14 (a) {name}: {g.device} {g.dtype} {tuple(g.shape)} "
                         f"against the CPU's {c.dtype} {tuple(c.shape)}")
                worst[name] = max(worst.get(name, 0.0),
                                  _api_geom_err(name, g.cpu().numpy(), c.numpy()))
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    if bad:
        fail(f"phase 14 (a): card vs CPU beyond the bounds (error / bound): {bad}")
    # the float64 host mirrors (geom/hostmath.py)
    T32 = torch.from_numpy(T_glob.astype(np.float32)).to(dev)
    q32 = torch.from_numpy(q_csv.astype(np.float32)).to(dev)
    mirror = {}
    R = geom.quat_to_rot(q32).cpu().numpy()
    mirror["quat_to_rot"] = np.abs(R - hostmath.quat_to_rot_np(q_csv.astype(np.float32))).max()
    qh = hostmath.rot_to_quat_np(T_glob.astype(np.float32))
    # the f32 trace's rounding, up to 4 u, moves w = sqrt(trace) / 2 by
    # u / w: near pi (phase 4's loop) w is small
    q_atol = API_ROT_ATOL + 4 * API_U32 / np.maximum(np.abs(qh[:, :1]), 1e-3)

    def q_err(qc):
        sign = np.where(np.sum(qc * qh, axis=-1) < 0, -1.0, 1.0)[:, None]
        return float((np.abs(qc * sign - qh) / q_atol).max()) * API_ROT_ATOL

    mirror["rot_to_quat"] = q_err(geom.rot_to_quat(T32).cpu().numpy())
    Tc = geom.transforms_from_pose_columns(T32[:, :3, 3], q32).cpu().numpy()
    Th = hostmath.transforms_from_pose_columns_np(T_glob[:, :3, 3].astype(np.float32),
                                                  q_csv.astype(np.float32))
    mirror["transforms_from_pose_columns"] = np.abs(Tc - Th)[:, :3, :3].max()
    xyz, qq = geom.pose_columns_from_transforms(T32)
    xyz_h, _ = hostmath.pose_columns_from_transforms_np(T_glob.astype(np.float32))
    mirror["pose_columns_from_transforms"] = max(
        np.abs(xyz.cpu().numpy() - xyz_h).max(), q_err(qq.cpu().numpy()))
    yaw = geom.quat_to_euler(q32)[:, 2].cpu().numpy()
    mirror["quat_to_euler (yaw)"] = np.abs(np.angle(np.exp(
        1j * (yaw - hostmath.quat_to_yaw_np(q_csv.astype(np.float32)))))).max()
    if max(mirror.values()) > API_ROT_ATOL:
        fail(f"phase 14 (a): the card against the float64 host mirrors (quaternions: "
             f"error scaled to the bound 1e-6 + 4 u / w): {mirror}")
    # phase 4's relative transforms folded on the card, against a float64
    # sequential fold of the same transforms and against the written global
    rel = torch.from_numpy(T_rel.astype(np.float32)).to(dev)
    G = geom.global_transforms(rel).cpu().numpy().astype(np.float64)
    F = np.empty_like(T_glob)
    F[0] = np.eye(4)
    for i, Tij in enumerate(T_rel):
        F[i + 1] = F[i] @ Tij
    (dpos, drot), (cpos, crot), (gpos, grot) = (
        _pose_gap(a, b) for a, b in ((G, F), (G, T_glob), (F, T_glob)))
    if G.shape != T_glob.shape or dpos > API_CHAIN_POS_ATOL or drot > API_CHAIN_ROT_ATOL \
            or cpos > API_CSV_POS_ATOL or crot > API_CSV_ROT_ATOL:
        fail(f"phase 14 (a): global_transforms of phase 4's {len(T_rel)} relative "
             f"transforms is {dpos} m / {drot} rad from their float64 fold and "
             f"{cpos} m / {crot} rad from scanmatcher_global.csv (the float64 fold "
             f"is {gpos} m / {grot} rad from it)")
    ms = cuda_ms(lambda: geom.global_transforms(rel), 50)
    counts = []
    real = geom_se3.compose

    def counted(a, b):
        counts.append(a.shape[0])
        return real(a, b)

    geom_se3.compose = counted
    try:
        geom.global_transforms(rel)
    finally:
        geom_se3.compose = real
    profile_later(14, f"global_transforms ({len(T_rel)} relative poses)",
                  lambda: geom.global_transforms(rel), 200)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    return (f"(a) geometry: {len(geom.__all__)} names, {calls} calls card vs CPU "
            f"within the bounds (largest error / bound: "
            + ", ".join(f"{k} {v:.3g}" for k, v in top)
            + f"); float64 host mirrors max |diff| (quaternions scaled to 1e-6 + 4 u / w) "
            + ", ".join(f"{k} {v:.3g}" for k, v in mirror.items())
            + f"; global_transforms of phase 4's {len(T_rel)} relative transforms (f32) "
            f"vs their float64 sequential fold {dpos:.3g} m, {drot:.3g} rad (bounds "
            f"{API_CHAIN_POS_ATOL}, {API_CHAIN_ROT_ATOL}), vs scanmatcher_global.csv "
            f"{cpos:.3g} m, {crot:.3g} rad (bounds {API_CSV_POS_ATOL}, "
            f"{API_CSV_ROT_ATOL}; the float64 fold itself is {gpos:.3g} m, {grot:.3g} "
            f"rad from it); {ms:.4f} ms a call (CUDA events, 50 calls), "
            f"{len(counts)} batched compose steps")


def _api_cloud(d, dev):
    """(b): phase 4's first batch, cropped and voxelised on the card."""
    euroc = EurocDataset(d)
    prm = euroc.read_scanmatcher_parameters()
    cfg = IcpConfig(capacity=CAPACITY)
    scan_times, _, _, _, _ = sm.prepare_experiment_data(euroc, 0, prm["delta_time"])
    raw_pts, raw_mask = sm.load_scans(euroc, scan_times[:cfg.batch_size], cfg.raw_capacity)
    c = Cloud(torch.from_numpy(raw_pts).to(dev), torch.from_numpy(raw_mask).to(dev))
    c = crop_radius_height(c, cfg.min_radius, cfg.max_radius, cfg.min_height,
                           cfg.max_height)
    vd = voxel_downsample(c, VOXEL, out_capacity=CAPACITY)
    vc = voxel_downsample_counted(c, VOXEL, out_capacity=CAPACITY)[0]
    if not (torch.equal(vd.points, vc.points) and torch.equal(vd.mask, vc.mask)):
        fail("phase 14 (b): voxel_downsample differs from voxel_downsample_counted")
    n = num_valid(vd)
    if n.dtype != torch.int32 or not torch.equal(n, vd.mask.sum(-1).to(torch.int32)):
        fail(f"phase 14 (b): num_valid {n} against the mask's sums")
    rows = to_numpy(vd)
    pts, mask = vd.points.cpu().numpy(), vd.mask.cpu().numpy()
    if len(rows) != len(pts) or not all(np.array_equal(r, p[m])
                                        for r, p, m in zip(rows, pts, mask)):
        fail("phase 14 (b): to_numpy differs from the masked rows")
    one = from_numpy(raw_pts[0][raw_mask[0]], CAPACITY)
    if one.points.device.type != "cuda" or one.mask.device.type != "cuda":
        fail(f"phase 14 (b): from_numpy with no device gave {one.points.device}")
    return vd, (f"(b) cloud helpers on phase 4's first batch ({len(rows)} scans "
                f"cropped and voxelised at {VOXEL} m, capacity {CAPACITY}, "
                f"{[int(x) for x in n]} valid): voxel_downsample bit-equal to "
                f"voxel_downsample_counted[0], num_valid int32 = the mask's sums, "
                f"to_numpy = the masked rows, from_numpy with no device on "
                f"{one.points.device}")


def _api_band(q, t, tmask, r):
    """Per query: the valid targets whose exact (float64) d2 lies within the
    f32 rounding band of r^2, 8 u (|q|^2 + |t|^2 + r^2), where the matmul
    form may count them on either side."""
    r2 = float(np.float32(r) * np.float32(r))
    out = []
    for b in range(q.shape[0]):
        q64, t64 = q[b].double(), t[b].double()
        t2 = (t64 * t64).sum(-1)
        rows = []
        for q0 in range(0, q64.shape[0], 1024):
            qc = q64[q0:q0 + 1024]
            d2 = ((qc[:, None, :] - t64[None, :, :]) ** 2).sum(-1)
            scale = (qc * qc).sum(-1)[:, None] + t2[None, :] + r2
            rows.append(((d2 - r2).abs() <= 8 * API_U32 * scale) & tmask[b][None, :])
        out.append(torch.cat(rows).sum(-1))
    return torch.stack(out)


def _api_normals(vd, dev):
    """(c): raw-origin moments and the normals' two routes."""
    r = RADIUS
    args = (vd.points, vd.points, vd.mask, r)
    card = radius_accumulate(*args)
    cpu = radius_accumulate(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    band = _api_band(vd.points, vd.points, vd.mask, r).cpu()
    cnt, cnt_cpu = card[0].cpu(), cpu[0]
    valid = vd.mask.cpu()
    clear = valid & (band == 0)
    if not torch.equal(cnt[clear], cnt_cpu[clear]):
        fail(f"phase 14 (c): radius_accumulate counts differ from the CPU's in "
             f"{int((cnt[clear] != cnt_cpu[clear]).sum())} queries outside the band")
    if bool(((cnt - cnt_cpu).abs() > band)[valid].any()):
        fail("phase 14 (c): a count differs from the CPU's by more than its band targets")
    same = valid & (cnt == cnt_cpu)
    pmax = float(vd.points[vd.mask].abs().max())
    err = []
    for k in (1, 2):
        dk = (card[k].cpu() - cpu[k]).abs()[same]
        tol = API_MOMENT_RTOL * cnt[same][:, None] * pmax ** k + 1e-6
        if bool((dk > tol).any()):
            fail(f"phase 14 (c): S{k} beyond {API_MOMENT_RTOL} of count x max|p|^{k} "
                 f"(max |diff| {float(dk.max())})")
        err.append(float(dk.max()))
    # the gate: the two routes on a smooth sheet
    rng = np.random.default_rng(15)
    sheet = rng.uniform(-10, 10, size=(CAPACITY, 3)).astype(np.float32)
    sheet[:, 2] = 0.3 * np.sin(sheet[:, 0])
    c = from_numpy(sheet, CAPACITY)
    n_xla = estimate_normals(c, 0.8, impl="xla").normals
    n_k2 = estimate_normals(c, 0.8, impl="auto").normals
    dots = (n_xla * n_k2).sum(-1).abs()[c.mask]
    if float(dots.min()) <= API_NORMAL_DOT:
        fail(f"phase 14 (c): impl='xla' vs 'auto' on a smooth sheet: min |n.n'| "
             f"{float(dots.min())}")
    # a record: phase 4's pillar scans, where thin pillars are ill-conditioned
    a = estimate_normals(vd, r, impl="xla").normals
    b = estimate_normals(vd, r, impl="auto").normals
    within = float(((a * b).sum(-1).abs()[vd.mask] > np.cos(np.deg2rad(1.0))).float().mean())
    try:
        estimate_normals(vd, r, impl="pallas_interpret")
        fail("phase 14 (c): impl='pallas_interpret' did not raise")
    except ValueError:
        pass
    ra_ms = cuda_ms(lambda: radius_accumulate(*args), 10)
    k2_ms = cuda_ms(lambda: ball_moments(*args, query_mask=vd.mask), 20)
    B, Q = vd.mask.shape
    tile = B * 1024 * 2048 * 4
    return (f"(c) raw-moment normals, B={B} Q=T={Q} r={r}: radius_accumulate card vs "
            f"CPU counts equal in {int(clear.sum())} valid queries outside the rounding "
            f"band ({int((valid & (band > 0)).sum())} in it, "
            f"{int((valid & (cnt != cnt_cpu)).sum())} of them differing), S1/S2 max "
            f"|diff| {err[0]:.3g} / {err[1]:.3g} (within {API_MOMENT_RTOL} of count x "
            f"max|p|^k); smooth sheet ({CAPACITY} points, r=0.8) impl xla vs auto "
            f"(K2) min |n.n'| {float(dots.min()):.6f} (gate > {API_NORMAL_DOT}); "
            f"phase 4's pillar scans: {within:.4f} of the valid points within 1 deg "
            f"(a record); pallas_interpret raises ValueError; wrapper ms "
            f"radius_accumulate {ra_ms:.4f} vs K2 ball_moments {k2_ms:.4f} at the "
            f"same shape (CUDA events), weight tile {tile} B (B x 1024 x 2048 f32)")


def _api_config_compat(d, tmp, dev):
    """(d): IcpConfig.from_yaml and compat's trajectory round trip."""
    path = os.path.join(tmp, "icp_parameters.yaml")
    with open(path, "w") as f:
        f.write(API_ICP_YAML)
    cfg = IcpConfig.from_yaml(path)
    got = {k: getattr(cfg, k) for k in API_ICP_FIELDS}
    if got != API_ICP_FIELDS or IcpConfig.from_yaml(path, capacity=4).capacity != 4:
        fail(f"phase 14 (d): IcpConfig.from_yaml gave {got}")
    _, T_glob = EurocDataset(d).read_trajectory("/robot0/scanmatcher/scanmatcher_global.csv")
    hms = compat.unstack(T_glob)
    back = compat.stack(compat.compute_global_transformations(
        compat.compute_relative_transformations(hms), hms[0]))
    T64 = torch.from_numpy(T_glob).to(dev)
    card = geom.global_transforms(geom.relative_transforms(T64), T64[0]).cpu().numpy()
    e_in, e_card = np.abs(back - T_glob).max(), np.abs(back - card).max()
    if back.shape != T_glob.shape or e_in > API_COMPAT_ATOL or e_card > API_COMPAT_ATOL:
        fail(f"phase 14 (d): compat's round trip is {e_in} from phase 4's transforms "
             f"and {e_card} from the card's float64 fold")
    gone = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pandas", "yaml"))
    if gone:
        fail(f"phase 14 (d): {gone} imported")
    return (f"(d) IcpConfig.from_yaml: the 6 fields of a nested icp_parameters.yaml and "
            f"an override; compat unstack -> relative -> global -> stack of phase 4's "
            f"{len(T_glob)} transforms: {e_in:.3g} from them, {e_card:.3g} from the "
            f"card's float64 global_transforms (bound {API_COMPAT_ATOL}), with no jax, "
            f"pandas or yaml imported")


def phase_api(d, smi, dev, tmp):
    """Phase 14: the port's public API on the card, on phase 4's dataset."""
    t0 = time.time()
    a = _api_geometry(d, dev)
    vd, b = _api_cloud(d, dev)
    c = _api_normals(vd, dev)
    dd = _api_config_compat(d, tmp, dev)
    print(f"phase 14 public API: {a}")
    print(f"phase 14 public API: {b}")
    print(f"phase 14 public API: {c}")
    print(f"phase 14 public API: {dd}; phase {time.time() - t0:.1f} s; card {smi}")


# phase 15 (b): the loop closer's ICP override (the store's own: 10 m, 30
# iterations, stride 1), the pose it closes at and the drift per step of
# its graph
LOOP_OVERRIDE = ICPParams(max_correspondence_distance=2.0, max_iterations=15,
                          source_stride=4)
LOOP_AT = 250
LOOP_DRIFT = (1e-3, 1e-4)     # m along x, rad of yaw
LOOP_ATOL = 1e-4              # card vs CPU transforms, m and rad
SEED_SCANS = 24               # phase 15 (c): scans of the icp2planes stores


def _loop_api_quickstart(tmp):
    """(a): the quickstart at its card size, its launches counted."""
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        out = quickstart.main([os.path.join(tmp, "quickstart")])
    wall = time.time() - t0
    total = dict(_cuda.launch_counts)
    if not out["stage1_ate"] < VOXEL or not np.isfinite(
            [out["slam_ate"], out["slam_rpe"]]).all():
        fail(f"phase 15 (a): quickstart stage-1 ATE {out['stage1_ate']} m "
             f"(bound {VOXEL}), SLAM ATE {out['slam_ate']}, RPE {out['slam_rpe']}")
    if total["nn_sweep"] <= 0 or total["ball_moments"] <= 0 or \
            out["stage1_launches"]["nn_sweep"] <= 0:
        fail(f"phase 15 (a): quickstart launched {total}")
    s1, s2 = out["stage1_launches"], out["stage2_launches"]
    return (f"(a) quickstart ({out['scans']} scans x {quickstart.SIZES['cuda'][1]} "
            f"points, raw capacity {quickstart.SIZES['cuda'][2]}, capacity "
            f"{quickstart.SIZES['cuda'][3]}): stage-1 ATE {out['stage1_ate']:.5f} m, "
            f"{out['frames_per_second']} frames/s; SLAM ATE {out['slam_ate']:.5f} m, "
            f"RPE {out['slam_rpe']:.5f} m/step, {out['loop_closures']} closures, "
            f"solve+loop {out['solve_loop_seconds']} s; launches stage 1 K1 "
            f"{s1['nn_sweep']} K2 {s1['ball_moments']}, stage 2 K1 {s2['nn_sweep']} "
            f"K2 {s2['ball_moments']}; viewer {out['view_error'] or 'drawn'}; "
            f"wall {wall:.2f} s")


def _drifted_graph(T_gt, device):
    g = PoseGraph(max_poses=512, device=device)
    g.init_graph()
    drift = synthetic._yaw_T(LOOP_DRIFT[0], 0.0, LOOP_DRIFT[1])
    for i in range(LOOP_AT):
        rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1] @ drift
        g.add_initial_estimate(rel, i + 1)
        g.add_edge(rel, i, i + 1, "SM")
    return g


def _loop_edges(g):
    """The transforms of the graph's loop-closure edges, in order."""
    return g.bt_T[g.chain_capacity:g.chain_capacity + g.n_loop]


def _loop_closing(T_gt, d, device, *store):
    """(closer, accepted closures, their transforms, seconds) of a
    LoopCloser over ``store`` (a KeyframeStore, or points, masks and
    normals) with the ICP override, on a drifted graph of the true poses."""
    slam = EurocDataset(d).read_slam_parameters()
    g = _drifted_graph(T_gt, device)
    closer = LoopCloser(g, *store, distance_backwards=slam["distance_backwards"],
                        radius_threshold=slam["radius_threshold"],
                        icp_params=LOOP_OVERRIDE)
    t0 = time.perf_counter()
    added = closer.loop_closing_triangle(LOOP_AT, slam["number_of_triplets_loop_closing"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    return closer, added, _loop_edges(g).astype(np.float64), time.perf_counter() - t0


def _loop_api_closer(d, T_gt, dev, store):
    """(b): the array-form LoopCloser with the override, card vs CPU, and
    the same override through the store."""
    tensors = (store.points, store.mask, store.normals)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    closer, card, T_card, s_card = _loop_closing(T_gt, d, dev, *tensors)
    k1 = _cuda.launch_counts["nn_sweep"]
    if closer.store.points is not tensors[0] or \
            closer.store.icp_params_override is not LOOP_OVERRIDE:
        fail("phase 15 (b): the array form did not wrap the caller's tensors")
    _, cpu, T_cpu, s_cpu = _loop_closing(T_gt, d, torch.device("cpu"),
                                         *(t.cpu() for t in tensors))
    if not card or card != cpu or k1 <= 0:
        fail(f"phase 15 (b): the card accepted {card}, the CPU {cpu}; K1 launches {k1}")
    dpos, drot = _pose_err(T_card, T_cpu)
    if dpos.max() > LOOP_ATOL or drot.max() > LOOP_ATOL:
        fail(f"phase 15 (b): card vs CPU closures differ by {dpos.max()} m / "
             f"{drot.max()} rad")
    via, via_store, T_store, _ = _loop_closing(T_gt, d, dev, store)
    if store.icp_params_override is not None or via.store is store or \
            via.store.points is not store.points or via_store != card or \
            not np.array_equal(T_store, T_card):
        fail(f"phase 15 (b): through the store: closures {via_store}, its own "
             f"override {store.icp_params_override}")
    return (f"(b) array-form LoopCloser over phase 8's store tensors "
            f"({tuple(store.points.shape)}), override {LOOP_OVERRIDE.max_correspondence_distance} m / "
            f"{LOOP_OVERRIDE.max_iterations} iterations / stride "
            f"{LOOP_OVERRIDE.source_stride}, closing at {LOOP_AT} (drift "
            f"{LOOP_DRIFT} per step): {len(card)} closures "
            + " ".join(f"{i}-{j}" for i, j in card)
            + f", the CPU's; card vs CPU {dpos.max():.3g} m / {drot.max():.3g} rad "
            f"(bound {LOOP_ATOL}); {closer.timings['icp_pairs']} ICP pairs, K1 "
            f"launches {k1}; card {s_card:.3f} s, CPU {s_cpu:.3f} s; through the "
            f"store: its own parameters kept, the same closures bit for bit")


def _loop_api_store(d, dev, store):
    """(c): memory_bytes, load_and_preprocess(seed=0), path."""
    times = EurocDataset(d).read_csv("/robot0/scanmatcher/lidar_times.csv")[
        "#timestamp [ns]"][:SEED_SCANS]
    cfg = IcpConfig(capacity=STAGE2_CAPACITY)
    default, seeded = (KeyframeStore(d, times, method="icp2planes", cfg=cfg, device=dev)
                       .load_and_preprocess(**kw) for kw in ({}, {"seed": 0}))
    fields = ("points", "mask", "normals", "ground_mask", "nonground_mask")
    for f in fields:
        if not torch.equal(getattr(default, f), getattr(seeded, f)):
            fail(f"phase 15 (c): load_and_preprocess(seed=0) {f} differs from the default")
    sizes = []
    for s in (store, seeded):
        want = sum(t.numel() * t.element_size() for t in
                   (getattr(s, f) for f in fields) if t is not None)
        if s.memory_bytes() != want:
            fail(f"phase 15 (c): memory_bytes {s.memory_bytes()}, the tensors hold {want}")
        sizes.append(want)
    rel = "/robot0/lidar/data.csv"
    if EurocDataset(d).path(rel) != d + rel or not os.path.exists(d + rel):
        fail(f"phase 15 (c): EurocDataset.path gave {EurocDataset(d).path(rel)}")
    return (f"(c) memory_bytes {sizes[0]} B (icppointplane, {len(store)} scans) and "
            f"{sizes[1]} B (icp2planes, {SEED_SCANS} scans), the tensors' bytes; "
            f"load_and_preprocess(seed=0) bit-equal to the default under icp2planes; "
            f"EurocDataset.path")


def phase_loop_api(d, T_gt, smi, dev, tmp):
    """Phase 15: the method-level API on the card."""
    t0 = time.time()
    a = _loop_api_quickstart(tmp)
    print(f"phase 15 method-level API: {a}")
    times = EurocDataset(d).read_csv("/robot0/scanmatcher/lidar_times.csv")["#timestamp [ns]"]
    store = KeyframeStore(d, times, cfg=IcpConfig(capacity=STAGE2_CAPACITY),
                          device=dev).load_and_preprocess()
    b = _loop_api_closer(d, T_gt, dev, store)
    print(f"phase 15 method-level API: {b}")
    c = _loop_api_store(d, dev, store)
    print(f"phase 15 method-level API: {c}; phase {time.time() - t0:.1f} s; card {smi}")


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
        stage1, d, T_gt, ate1 = phase_stage1(tmp, smi)
        res.update(phase_k3_k4(cases))
        res["nn_pruned"] = phase_k5(rng, dev)
        launches = phase_nn_impls(d, T_gt, dev)
        stage2, stage2_rec = phase_stage2(d, T_gt, ate1, smi, dev)
        phase_planes(tmp, smi, dev)
        phase_fpfh(tmp, smi, dev)
        phase_host(d, T_gt, smi, dev, tmp)
        phase_mesh(d, T_gt, smi, dev, tmp, stage2_rec)
        phase_api(d, smi, dev, tmp)
        phase_loop_api(d, T_gt, smi, dev, tmp)
    phase_solvers(dev)
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
    # K1 and K2 also run on stage 2's path (phase 8), at its own shapes
    for k in kernels[:2]:
        st = stage2[k["name"]]
        k["stage2"] = {"launches": st["launches"], "shape": st["shape"],
                       "max_abs_err": st["max_abs_err"], "ms": st["ms"],
                       "plain_ms": st["plain_ms"], "bound_ms": st["bound"][0],
                       "bound_by": st["bound"][1], "library_ms": None}
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
