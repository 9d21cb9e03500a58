"""Build, load and launch the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (Hopper)
into ONE shared library with a plain C interface, at first use, into
``_build/`` beside the package (git-ignored).  The library's name carries
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

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches of each kernel since the last reset (wrappers add one per launch)
launch_counts = {"nn_sweep": 0, "ball_moments": 0, "nn_sweep_vpu": 0,
                 "nn_sweep_vpu2": 0, "nn_sweep_mxu": 0, "nn_sweep_vals": 0,
                 "nn_pruned": 0}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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
        return so
    t0 = time.time()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[p for p in srcs if p.endswith(".cu")]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    log = proc.stdout + proc.stderr
    with open(so + ".log", "w") as f:
        f.write(log)
    build_info.update(path=so, seconds=time.time() - t0, cached=False, log=log)
    return so


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nn_sweep_launch.argtypes = [I, P, P, P, P, I, I, I, P, P, P]
    lib.nn_sweep_launch.restype = I
    lib.ball_moments_launch.argtypes = [P, P, P, P, P, P, I, I, I, I, F, P, P]
    lib.ball_moments_launch.restype = I
    lib.nn_sweep_vals_launch.argtypes = [P, P, P, P, I, I, I, P, P, P, P]
    lib.nn_sweep_vals_launch.restype = I
    lib.nn_pruned_launch.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P, P, P]
    lib.nn_pruned_launch.restype = I
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
