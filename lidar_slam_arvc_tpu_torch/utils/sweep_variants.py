"""Time variants of the exhaustive sweep's tuning constants on a card.

    python -m lidar_slam_arvc_tpu_torch.utils.sweep_variants \
        [--rows 1,2,4] [--tile 128,256,512] [--chains 1,2] \
        [--ctas-per-sm 1,2,4] [--threads 128]

Copies ``csrc/nn_sweep.cu`` and ``csrc/nn_sweep.cuh`` once per point of the
grid with the constants ``kRows`` (sources per thread), ``kTile`` (targets
per staged tile), ``kChains`` (running bests per source), ``kCtasPerSm``
(the split's target grid) and ``kThreads`` replaced, builds each with
``nvcc`` (several at once), and times its launch entry with CUDA events
(50 back-to-back launches after warm-up, so the host's share is hidden) at
the bench shapes: B = 4, T = 8192, S = 2048 and 8192, in the sentinel
form (K1) and the matmul form (K3 ``mxu``).  Each result is checked
against the plain version (indices equal, d2 bit-equal).  Prints the
card's name and power limit, then one line per variant.  Needs nvcc and a
CUDA card; the builds go to a temporary directory under ``_build/``.
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

KNOBS = {"rows": "kRows", "tile": "kTile", "chains": "kChains",
         "ctas_per_sm": "kCtasPerSm", "threads": "kThreads"}
SHAPES = (("S2048", 2048, 8192), ("S8192", 8192, 8192))
FORMS = (("K1", 0, "vpu_t"), ("mxu", 2, "mxu"))
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


def _inputs(dev):
    rng = np.random.default_rng(0)
    out = {}
    for tag, S, T in SHAPES:
        src = rng.uniform(-25, 25, (4, S, 3)).astype(np.float32)
        tgt = rng.uniform(-25, 25, (4, T, 3)).astype(np.float32)
        src[:, :S // 4] = tgt[:, rng.integers(0, T, S // 4)]
        mask = rng.uniform(size=(4, T)) > 0.3
        out[tag] = [torch.from_numpy(a).to(dev) for a in (src, tgt, mask)]
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
    defaults = {"rows": "1,2,4", "tile": "128,256,512", "chains": "1,2",
                "ctas_per_sm": "1,2,4", "threads": "128"}
    for knob, default in defaults.items():
        ap.add_argument("--" + knob.replace("_", "-"), default=default)
    args = ap.parse_args(argv)
    grid = {k: [int(v) for v in getattr(args, k).split(",")] for k in KNOBS}
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    header = open(os.path.join(_cuda.CSRC, "nn_sweep.cuh")).read()
    nvcc = _cuda._nvcc()
    inputs = _inputs(dev)
    ref = {(tag, name): nn_search_plain(*inputs[tag], impl=impl)
           for tag, *_ in SHAPES for name, _, impl in FORMS}
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
        for (values, so), proc in zip(variants, procs):
            log = proc.stdout
            name = " ".join(f"{k}={v}" for k, v in values.items())
            if proc.returncode:
                print(f"{name}: build failed\n{log}", flush=True)
                continue
            lib = ctypes.CDLL(so)
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.nn_sweep_launch.argtypes = [I, P, P, P, I, I, I, I, P, P, P]
            times = []
            for tag, S, T in SHAPES:
                s, t, m = inputs[tag]
                idx = torch.empty((4, S), dtype=torch.int32, device=dev)
                d2 = torch.empty((4, S), dtype=torch.float32, device=dev)
                stream = _cuda.stream_of(s)
                for fname, form, _ in FORMS:
                    def call():
                        _cuda.check(lib.nn_sweep_launch(
                            form, s.data_ptr(), t.data_ptr(), m.data_ptr(), 4, S, T,
                            n_sm, idx.data_ptr(), d2.data_ptr(), stream), "variant")
                    call()
                    torch.cuda.synchronize()
                    ri, rd = ref[(tag, fname)]
                    ok = torch.equal(idx, ri) and torch.equal(d2, rd)
                    times.append(f"{fname} {tag} {_ms(call):.4f} ms"
                                 + ("" if ok else " DIFFERS FROM PLAIN"))
            regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
            print(f"{name} (registers {'/'.join(regs)}): " + "; ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
