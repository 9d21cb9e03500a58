"""ctypes bindings of the port's PCD parser (``csrc/pcd_native.cpp``).

Counterpart of ``lidar_slam_arvc_tpu/io/native.py`` with the same C
interface (``lzf_decompress``, ``pcd_read_xyz``, ``pcd_read_batch``).  The
library is built from the port's own source with the host C++ compiler
(``$CXX``, default ``g++``) at first use into ``_build/`` beside the
package, under a name that carries a hash of the source and flags, and
loaded with ctypes, as ``ops/_cuda.py`` does for the kernels.  A build
failure raises: there is no silent switch to the Python parser.  A *file*
the parser rejects (ASCII storage, a parse error) gets a negative count;
the caller parses that file in Python (``pipeline.scanmatcher._load_paths``).

The ctypes calls release the interpreter lock, so a batch decodes while
other Python threads run.
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

import numpy as np

from lidar_slam_arvc_tpu_torch.utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "pcd_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the PCD parser "
                           "cannot be built")
    return found


def _build(build_dir: str = BUILD_DIR) -> str:
    """Path of the built library, compiling it unless a build of this
    source and these flags is already there."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(build_dir, exist_ok=True)
    so = os.path.join(build_dir, f"libpcd_native_{digest}.so")
    if os.path.exists(so):
        profiling.record_build("pcd_native", 0.0, cached=True)
        return so
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        built = os.path.join(tmp, "lib.so")
        cmd = [_compiler(), *CXX_FLAGS, "-o", built, SOURCE]
        done = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"building the PCD parser failed "
                               f"({done.returncode}):\n{' '.join(cmd)}\n"
                               f"{done.stdout}")
        os.replace(built, so)
    profiling.record_build("pcd_native", time.time() - t0, cached=False)
    return so


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.lzf_decompress.restype = ctypes.c_size_t
    lib.lzf_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
    lib.pcd_read_xyz.restype = ctypes.c_long
    lib.pcd_read_xyz.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    lib.pcd_read_batch.restype = None
    lib.pcd_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_long),
        ctypes.c_long, ctypes.c_int]
    return lib


def library() -> ctypes.CDLL:
    """The parser library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(_build())
        return _lib


def available() -> bool:
    """True when the parser builds and loads here.  Unlike the reference,
    which then falls back to Python, a failed build still raises where the
    parser is used."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def lzf_decompress(data: bytes, expected_length: int) -> bytes:
    """libLZF decompression of a PCL ``binary_compressed`` payload."""
    out = np.empty(expected_length, dtype=np.uint8)
    n = library().lzf_decompress(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        expected_length)
    return out[:n].tobytes()


def read_pcd_xyz(path: str, capacity: int) -> np.ndarray | None:
    """(n, 3) float32 xyz of at most ``capacity`` points, or None for a file
    the parser rejects (ASCII, parse error)."""
    buf = np.empty((capacity, 3), dtype=np.float32)
    n = library().pcd_read_xyz(
        os.fsencode(path), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        capacity)
    if n < 0:
        return None
    return buf[:n].copy()


def read_pcd_batch(paths: list[str], capacity: int, n_threads: int | None = None,
                   out: np.ndarray | None = None):
    """Threaded batch read -> (points (B, capacity, 3) f32, counts (B,) int64).

    Each file's first ``capacity`` points, the rest of its row zero.
    ``counts[i] < 0`` flags a file the parser rejected (its row is zero).
    ``out``: a C-contiguous (B, capacity, 3) float32 array to decode into
    (for example a view of pinned host memory)."""
    b = len(paths)
    if out is None:
        out = np.empty((b, capacity, 3), dtype=np.float32)
    elif (out.dtype != np.float32 or out.shape != (b, capacity, 3)
          or not out.flags.c_contiguous):
        raise ValueError(f"out: {out.dtype} {out.shape}, expected a "
                         f"C-contiguous float32 ({b}, {capacity}, 3) array")
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    counts = np.zeros(b, dtype=np.int64)
    arr = (ctypes.c_char_p * b)(*[os.fsencode(p) for p in paths])
    library().pcd_read_batch(
        arr, b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), capacity,
        n_threads)
    return out, counts
