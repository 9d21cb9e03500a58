"""Build, load and launch the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (Hopper;
the kernels launch thread block clusters) into ONE shared library with a
plain C interface, at first use, into ``_build/`` beside the package
(git-ignored): one ``nvcc -c`` per source, all running at once, then one
link.  The library's name carries
a hash of the sources, so an edited kernel is rebuilt and a stale build is
never loaded.  Nothing here runs at import: the CPU-only test machines have
no ``nvcc`` and no card, and import every module.

Launch contract (shared by all wrappers): pointers and the stream go
through ``ctypes.c_void_p``; the kernel runs on PyTorch's current stream,
allocates nothing, and its C entry point returns ``cudaGetLastError()``,
which ``check`` turns into an exception.  ``launch_counts`` counts the
launches of each kernel, so a run can prove that it went through them.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

from lidar_slam_arvc_tpu_torch.utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches of each kernel since the last reset (wrappers add one per launch)
launch_counts = {"nn_sweep": 0, "ball_moments": 0, "nn_sweep_vpu": 0,
                 "nn_sweep_vpu2": 0, "nn_sweep_mxu": 0, "nn_sweep_vals": 0,
                 "nn_pruned": 0, "icp_step": 0, "normal_solve": 0}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def torch_device(device, caller: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card present is
    an error, never a silent move to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: device 'cuda' requested but no CUDA "
                           "device is available")
    return device


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                           "the CUDA kernels cannot be built")
    return path


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(_build())
        return _lib


def _build() -> str:
    srcs = _sources()
    h = hashlib.sha256()
    for p in srcs:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libslam_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        build_info.update(path=so, seconds=0.0, cached=True, log="")
        profiling.record_build("slam_kernels", 0.0, cached=True)
        return so
    t0 = time.time()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o",
                 os.path.join(tmp, os.path.basename(p) + ".o"), p]
                for p in srcs if p.endswith(".cu")]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]   # waits for every one
        for cmd, proc, out in zip(cmds, procs, logs):
            _raise_if_failed(cmd, proc.returncode, out)
        link = [nvcc, "-shared", "-o", os.path.join(tmp, "lib.so"),
                *[c[-2] for c in cmds]]
        done = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        _raise_if_failed(link, done.returncode, done.stdout)
        os.replace(os.path.join(tmp, "lib.so"), so)
    log = "".join(logs)
    with open(so + ".log", "w") as f:
        f.write(log)
    build_info.update(path=so, seconds=time.time() - t0, cached=False, log=log)
    profiling.record_build("slam_kernels", build_info["seconds"], cached=False)
    return so


def _raise_if_failed(cmd: list[str], rc: int, out: str) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nn_sweep_launch.argtypes = [I, P, P, P, P, I, I, I, I, P, P, P]
    lib.nn_sweep_launch.restype = I
    lib.nn_sweep_geometry.argtypes = [I, I, I, I, P]
    lib.nn_sweep_geometry.restype = None
    lib.ball_moments_launch.argtypes = [P, P, P, P, I, I, I, F, P, P]
    lib.ball_moments_launch.restype = I
    lib.ball_moments_geometry.argtypes = [I, I, I, P]
    lib.ball_moments_geometry.restype = I
    lib.nn_sweep_vals_launch.argtypes = [P, P, P, P, P, I, I, I, I, P, P, P, P]
    lib.nn_sweep_vals_launch.restype = I
    lib.nn_pruned_launch.argtypes = [P, P, P, P, I, I, I, I, I, F, I, P, P, P]
    lib.nn_pruned_launch.restype = I
    lib.nn_pruned_geometry.argtypes = [I, I, I, I, I, I, P]
    lib.nn_pruned_geometry.restype = I
    lib.icp_step_launch.argtypes = [I, I, P, P, P, P, P, P, P, P, P, I, I, I, F, I, F,
                                    P, P, P, P, P, P, P, P]
    lib.icp_step_launch.restype = I
    lib.icp_step_geometry.argtypes = [I, P]
    lib.icp_step_geometry.restype = None
    lib.normal_solve_launch.argtypes = [P, P, ctypes.c_int64, ctypes.c_double, P]
    lib.normal_solve_launch.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device``'s card (the kernels size
    their grids by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ints(fn, *args, n: int) -> tuple[int, ...]:
    out = (ctypes.c_int * n)()
    err = fn(*args, out)
    if err:
        raise ValueError(f"{fn.__name__}{args}: sizes the kernel refuses")
    return tuple(out)


def sweep_geometry(B: int, S: int, T: int, device) -> dict:
    """The launch K1/K3/K4 (``csrc/nn_sweep.cuh``) make for these sizes on
    ``device``'s card, as the kernel library computes it: grid, cluster
    size (the CTAs that share a source block; target tile j goes to rank
    j mod cluster), targets per tile, threads per CTA, sources per thread
    and targets per sub-tile (the unit the sweep notes its minimum's
    place in)."""
    g = _ints(library().nn_sweep_geometry, B, S, T,
              sm_count(torch.device(device)), n=7)
    return {"grid": g[:2], "cluster": g[2], "tile": g[3], "threads": g[4],
            "rows_per_thread": g[5], "sub_tile": g[6]}


def pruned_geometry(B: int, Sp: int, Tp: int, sb: int, tb: int, device) -> dict:
    """The launch K5 (``csrc/nn_pruned.cu``) makes for these sizes on
    ``device``'s card: grid, cluster size, threads per CTA, source rows per
    CTA and threads per source row."""
    g = _ints(library().nn_pruned_geometry, B, Sp, Tp, sb, tb,
              sm_count(torch.device(device)), n=6)
    return {"grid": g[:2], "cluster": g[2], "threads": g[3],
            "rows_per_cta": g[4], "threads_per_row": g[5]}


def moments_geometry(B: int, Q: int, T: int) -> dict:
    """The launch K2 (``csrc/ball_moments.cu``) makes for these sizes: grid,
    cluster size (query blocks sharing one set of tile boxes), threads per
    CTA, queries per CTA, targets per tile, threads per query, whether a
    16-byte aligned cloud takes 16-byte loads, and its dynamic shared
    memory."""
    g = _ints(library().ball_moments_geometry, B, Q, T, n=9)
    return {"grid": g[:2], "cluster": g[2], "threads": g[3],
            "queries_per_cta": g[4], "tile": g[5], "lanes": g[6],
            "vector_loads": bool(g[7]), "smem": g[8]}


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle (read
    without building a ``torch.cuda.Stream`` object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(dev: torch.device):
    """Makes ``dev`` the current device for a launch: a no-op context when
    it already is (the usual case, which skips two device switches)."""
    if torch.cuda.current_device() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def idx_d2_outputs(B: int, S: int, device: torch.device):
    """(idx (B, S) int32, d2 (B, S) f32) for a search kernel to write: two
    contiguous views of one allocation, which costs the host half of two."""
    buf = torch.empty((2, B, S), dtype=torch.int32, device=device)
    return buf[0], buf[1].view(torch.float32)


def require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this dtype/shape/device."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
