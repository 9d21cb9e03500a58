"""Time variants of the exhaustive sweep's tuning constants on a card.

    python -m lidar_slam_arvc_tpu_torch.utils.sweep_variants \
        [--max-rows 1,2,4] [--tile 512,1024] [--ctas-per-sm 2,4,8] \
        [--min-split 1,2] [--threads 128] [--shapes S2048,S8192,stage2,kitti,nclt]

Copies ``csrc/nn_sweep.cu`` and ``csrc/nn_sweep.cuh`` once per point of the
grid with the constants ``kMaxRows`` (most sources per thread), ``kTile``
(targets per staged tile), ``kCtasPerSm`` (the grid the geometry aims at),
``kMinSplit`` (the least cluster split) and ``kThreads`` replaced, builds each
with ``nvcc`` (several at once), and times K1's launch entry (sentinel
form) with CUDA events (back-to-back launches after warm-up, so the host's
share is hidden) at these shapes: ``S2048`` B = 4, S = 2048, T = 8192,
``S8192`` B = 4, S = T = 8192 and ``stage2`` B = 12, S = T = 8192, with
~30% of the targets masked at random and no source mask (the small ICP
shapes and stage 2's loop pairs); ``kitti`` B = 4, S = T = 32768 with
prefixes of 19,500-22,500 valid sources and targets (the
``kitti00.stage1`` cell's scans); ``nclt`` B = 4, S = T = 65536 with
prefixes of 50,700-55,700 valid points (``nclt-full.stage1``).  The
source mask goes in as the ICP passes it.  Each result is checked against
the plain version (indices equal, d2 bit-equal).  Prints the card's name
and power limit, then one line per variant: its registers and, per shape,
its ms and the geometry it picked.  Needs nvcc and a CUDA card; the builds
go to a temporary directory under ``_build/``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import itertools
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.ops import _cuda
from lidar_slam_arvc_tpu_torch.ops.nn import nn_search_plain

KNOBS = {"max_rows": "kMaxRows", "tile": "kTile", "ctas_per_sm": "kCtasPerSm",
         "min_split": "kMinSplit", "threads": "kThreads"}
# name -> (B, S, T, valid points per row: a prefix in [lo, hi], or None
# for ~30% of the targets masked at random and every source valid)
SHAPES = {"S2048": (4, 2048, 8192, None), "S8192": (4, 8192, 8192, None),
          "stage2": (12, 8192, 8192, None),
          "kitti": (4, 32768, 32768, (19500, 22500)),
          "nclt": (4, 65536, 65536, (50700, 55700))}
PARALLEL_BUILDS = 8


def variant_source(header: str, values: dict, knobs: dict = KNOBS,
                   name: str = "nn_sweep.cuh") -> str:
    """``header`` (the source ``name``) with each knob's constexpr set to
    ``values[knob]``; ``knobs`` maps a knob to its constant's name."""
    for knob, value in values.items():
        pat = rf"constexpr int {knobs[knob]} = \d+;"
        header, n = re.subn(pat, f"constexpr int {knobs[knob]} = {value};", header)
        if n != 1:
            raise ValueError(f"{knobs[knob]}: {n} definitions in {name}")
    return header


def _inputs(dev, names):
    """{name: (src, src_mask or None, tgt, tgt_mask)} on the card."""
    rng = np.random.default_rng(0)
    out = {}
    for name in names:
        B, S, T, valid = SHAPES[name]
        src = rng.uniform(-25, 25, (B, S, 3)).astype(np.float32)
        tgt = rng.uniform(-25, 25, (B, T, 3)).astype(np.float32)
        src[:, :S // 4] = tgt[:, rng.integers(0, T, S // 4)]
        if valid is None:
            smask, tmask = None, rng.uniform(size=(B, T)) > 0.3
        else:
            n = rng.integers(valid[0], valid[1] + 1, size=(2, B))
            smask = np.arange(S) < n[0][:, None]
            tmask = np.arange(T) < n[1][:, None]
        out[name] = [None if a is None else torch.from_numpy(a).to(dev)
                     for a in (src, smask, tgt, tmask)]
    return out


def _ms(fn, reps: int = 50) -> float:
    for _ in range(3):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    defaults = {"max_rows": "1,2,4", "tile": "512,1024", "ctas_per_sm": "2,4,8",
                "min_split": "1,2", "threads": "128"}
    for knob, default in defaults.items():
        ap.add_argument("--" + knob.replace("_", "-"), default=default)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args(argv)
    grid = {k: [int(v) for v in getattr(args, k).split(",")] for k in KNOBS}
    names = args.shapes.split(",")
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    header = open(os.path.join(_cuda.CSRC, "nn_sweep.cuh")).read()
    nvcc = _cuda._nvcc()
    inputs = _inputs(dev, names)
    ref = {name: nn_search_plain(s, t, tm, src_mask=sm)
           for name, (s, sm, t, tm) in inputs.items()}
    n_sm = _cuda.sm_count(dev)
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as root:
        variants = []
        for combo in itertools.product(*grid.values()):
            values = dict(zip(grid, combo))
            if values["tile"] % values["threads"]:
                continue
            d = os.path.join(root, "_".join(map(str, combo)))
            os.makedirs(d)
            with open(os.path.join(d, "nn_sweep.cuh"), "w") as f:
                f.write(variant_source(header, values))
            shutil.copy(os.path.join(_cuda.CSRC, "nn_sweep.cu"), d)
            variants.append((values, os.path.join(d, "lib.so")))

        def build(so):
            return subprocess.run(
                [nvcc, *_cuda.NVCC_FLAGS, "-shared", "-o", so,
                 os.path.join(os.path.dirname(so), "nn_sweep.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        with concurrent.futures.ThreadPoolExecutor(PARALLEL_BUILDS) as pool:
            procs = list(pool.map(build, [so for _, so in variants]))
        P, I = ctypes.c_void_p, ctypes.c_int
        for (values, so), proc in zip(variants, procs):
            log = proc.stdout
            label = " ".join(f"{k}={v}" for k, v in values.items())
            if proc.returncode:
                print(f"{label}: build failed\n{log}", flush=True)
                continue
            lib = ctypes.CDLL(so)
            lib.nn_sweep_launch.argtypes = [I, P, P, P, P, I, I, I, I, P, P, P]
            lib.nn_sweep_geometry.argtypes = [I, I, I, I, P]
            times = []
            for name, (s, sm, t, tm) in inputs.items():
                B, S = s.shape[:2]
                T = t.shape[1]
                idx = torch.empty((B, S), dtype=torch.int32, device=dev)
                d2 = torch.empty((B, S), dtype=torch.float32, device=dev)
                stream = _cuda.stream_of(s)
                geo = (ctypes.c_int * 7)()
                lib.nn_sweep_geometry(B, S, T, n_sm, geo)

                def call():
                    _cuda.check(lib.nn_sweep_launch(
                        0, s.data_ptr(), None if sm is None else sm.data_ptr(), t.data_ptr(),
                        tm.data_ptr(), B, S, T, n_sm, idx.data_ptr(), d2.data_ptr(), stream),
                        "variant")
                call()
                torch.cuda.synchronize()
                ri, rd = ref[name]
                ok = torch.equal(idx, ri) and torch.equal(d2, rd)
                reps = 20 if S * T >= 2 ** 28 else 50
                times.append(f"{name} {_ms(call, reps):.4f} ms (grid {geo[0]}x{geo[1]}, "
                             f"cluster {geo[2]}, rows {geo[5]})"
                             + ("" if ok else " DIFFERS FROM PLAIN"))
            regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
            print(f"{label} (registers {'/'.join(regs)}): " + "; ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
