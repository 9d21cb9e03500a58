"""Time variants of K2's tuning constants (``csrc/ball_moments.cu``) on a card.

    python -m lidar_slam_arvc_tpu_torch.utils.moments_variants \
        [--qb 64,128,256] [--tile 128,256] [--lanes 1,2,4]

Copies ``csrc/ball_moments.cu`` once per point of the grid with the
constants ``kQb`` (queries per CTA), ``kTile`` (targets per tile box and
staged tile) and ``kLanes`` (threads per query) replaced, builds each with
``nvcc`` (several at once), and times its launch entry: the kernel's own
time in a torch.profiler trace of 20 launches (a launch from Python takes
~10 us of host time, longer than a short kernel, so CUDA events over
back-to-back launches time the host) and, beside it, CUDA events over 50
launches; at the shapes of ``chip_smoke.py`` phase 3
(``utils.workload.k2_cases``): 4 voxelised synthetic scans at capacity
8192 with r = 0.5 (the bench workload's normals), and a ragged B = 2,
Q = T = 1000 cloud with r = 0.3.  Each result is checked against the plain
version (counts equal, S1/S2 within ``summation_tolerance``).  Prints the
card's name and power limit, then one line per variant with the tiles its
query block and tile size score (``ops.moments.scored_pairs``).  Needs nvcc
and a CUDA card; the builds go to a temporary directory under ``_build/``.
The shipped kernel's wrapper and device time per call are
``chip_smoke.py``'s phase-3 lines.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import itertools
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.ops import _cuda
from lidar_slam_arvc_tpu_torch.ops.moments import (
    ball_moments_plain, scored_pairs, summation_tolerance)
from lidar_slam_arvc_tpu_torch.utils.sweep_variants import (
    PARALLEL_BUILDS, _ms, variant_source)
from lidar_slam_arvc_tpu_torch.utils.workload import k2_cases

KNOBS = {"qb": "kQb", "tile": "kTile", "lanes": "kLanes"}
DEFAULTS = {"qb": "64,128,256", "tile": "128,256", "lanes": "1,2,4"}
PROFILE_REPS = 20


def _device_ms(fn) -> float:
    """The mean device ms of the one kernel ``fn`` launches, over
    PROFILE_REPS launches (torch.profiler; nan when the trace holds no
    kernel)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_REPS):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(times) / len(times) / 1e3 if times else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for knob, default in DEFAULTS.items():
        ap.add_argument("--" + knob, default=default)
    args = ap.parse_args(argv)
    grid = {k: [int(v) for v in getattr(args, k).split(",")] for k in KNOBS}
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    source = open(os.path.join(_cuda.CSRC, "ball_moments.cu")).read()
    nvcc = _cuda._nvcc()
    inputs = {tag: (c.points, c.mask, r)
              for tag, c, r in k2_cases(np.random.default_rng(0), dev)}
    ref = {tag: ball_moments_plain(p, p, m, r, query_mask=m)
           for tag, (p, m, r) in inputs.items()}
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as root:
        variants = []
        for combo in itertools.product(*grid.values()):
            values = dict(zip(grid, combo))
            if values["qb"] * values["lanes"] > 1024:
                continue
            d = os.path.join(root, "_".join(map(str, combo)))
            os.makedirs(d)
            with open(os.path.join(d, "ball_moments.cu"), "w") as f:
                f.write(variant_source(source, values, KNOBS, "ball_moments.cu"))
            variants.append((values, os.path.join(d, "lib.so")))

        def build(so):
            return subprocess.run(
                [nvcc, *_cuda.NVCC_FLAGS, "-shared", "-o", so,
                 os.path.join(os.path.dirname(so), "ball_moments.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        with concurrent.futures.ThreadPoolExecutor(PARALLEL_BUILDS) as pool:
            procs = list(pool.map(build, [so for _, so in variants]))
        for (values, so), proc in zip(variants, procs):
            log = proc.stdout
            name = " ".join(f"{k}={v}" for k, v in values.items())
            if proc.returncode:
                print(f"{name}: build failed\n{log}", flush=True)
                continue
            lib = ctypes.CDLL(so)
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.ball_moments_launch.argtypes = [P, P, P, P, I, I, I, F, P, P]
            items = []
            for tag, (p, m, r) in inputs.items():
                B, N = m.shape
                out = torch.empty((B, N, 10), dtype=torch.float32, device=dev)

                def call():
                    _cuda.check(lib.ball_moments_launch(
                        p.data_ptr(), m.data_ptr(), p.data_ptr(), m.data_ptr(), B, N, N,
                        float(r) ** 2, out.data_ptr(), _cuda.stream_of(p)), "variant")
                call()
                torch.cuda.synchronize()
                c, s1, s2 = ref[tag]
                ok = torch.equal(out[..., 0], c) and all(
                    bool(((out[..., lo:hi] - s).abs().amax(-1)
                          <= summation_tolerance(c, r, k)).all())
                    for k, (lo, hi, s) in enumerate(((1, 4, s1), (4, 10, s2)), start=1))
                tiles, _ = scored_pairs(p, p, m, r, m, values["qb"], values["tile"])
                items.append(f"{tag} device {_device_ms(call):.4f} ms, events "
                             f"{_ms(call):.4f} ms ({tiles} tiles)"
                             + ("" if ok else " DIFFERS FROM PLAIN"))
            regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
            print(f"{name} (registers {'/'.join(regs)}): " + "; ".join(items), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
