"""Per-stage timing, build accounting and device traces.

Counterpart of ``lidar_slam_arvc_tpu/utils/profiling.py``:

* :class:`StageTimer`: named wall-clock counters with items/s, the same
  report and ``dump`` JSON as the reference's; each stage is a
  :func:`span`, and with ``sync`` (a CUDA device) its seconds include the
  device's work.
* :func:`span`: a named ``torch.profiler`` span while a profiler runs, a
  shared null context otherwise.  Its events are CPU ``user_annotation``
  events of the same trace as the card's kernels and runtime calls.
  The port's names: ``scanmatch.*`` (stage 1's phases), ``pcd.wait``,
  ``preprocess.batch``, ``preprocess.compact`` (full resolution),
  ``icp.*`` (``registration/icp.py``), ``graph.*``, ``loop.round``,
  ``store.load`` (stage 2), and ``sync.<site>`` around each call that
  makes the host wait for the card.
* :data:`counts` and :func:`count`: host counters of the stage-1 path
  (ICP steps, K1 pairs swept and valid, PCD wait and decode seconds, the
  scans' points before the capacity and those kept),
  read as deltas around a stage like ``ops._cuda.launch_counts``.
* :class:`BuildCounter`: in place of the reference's ``CompileCounter``
  (distinct XLA programs compiled), the native libraries a stage built
  (the CUDA kernels, ``ops/_cuda.py``; the PCD parser, ``io/native.py``)
  or loaded from an earlier build in ``_build/``, with the build seconds.
* :func:`trace`: a ``torch.profiler`` trace of the CPU and, when a card is
  present, CUDA activity, written for TensorBoard.

The reference's ``enable_compilation_cache`` (a persistent XLA cache) has
no counterpart: the port's libraries are cached in ``_build/`` by the hash
of their sources.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict

import torch

# what ``span`` returns while no profiler runs: one shared object, so a
# span costs a flag read and allocates nothing
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler runs,
    else a shared null context (a bare ``record_function`` costs ~11 us
    even with no profiler; this ~0.6 us)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


# host counts of the stage-1 path; ``count`` adds to them from any thread
# (the PCD decode thread among them)
counts = {"icp_steps": 0, "k1_pairs_swept": 0, "k1_pairs_valid": 0,
          "pcd_wait_seconds": 0.0, "pcd_decode_seconds": 0.0,
          "scan_points_valid": 0, "scan_points_kept": 0}
_counts_lock = threading.Lock()


def count(name: str, n) -> None:
    with _counts_lock:
        counts[name] += n


def counts_since(before: dict) -> dict:
    """``counts`` minus a copy taken earlier."""
    with _counts_lock:
        return {k: v - before[k] for k, v in counts.items()}


class StageTimer:
    """Accumulates wall time + item counts per named stage."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.items = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0, sync=None):
        """Time the block as stage ``name`` inside a ``span(name)``.
        ``sync``: a device; a CUDA one is synchronised before the clock is
        read at the block's end, so the seconds include its queued work."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
                if sync is not None and torch.device(sync).type == "cuda":
                    with span("sync." + name):
                        torch.cuda.synchronize(sync)
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.items[name] += items

    def rate(self, name: str) -> float | None:
        s = self.seconds.get(name, 0.0)
        n = self.items.get(name, 0)
        return n / s if s > 0 and n else None

    def report(self) -> dict:
        out = {}
        for name in self.seconds:
            out[name] = {"seconds": round(self.seconds[name], 4),
                         "items": self.items[name]}
            r = self.rate(name)
            if r is not None:
                out[name]["items_per_second"] = round(r, 2)
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)

    def __str__(self):
        parts = []
        for name, stats in sorted(self.report().items()):
            rate = stats.get("items_per_second")
            rate_s = f" ({rate}/s)" if rate else ""
            parts.append(f"{name}: {stats['seconds']}s{rate_s}")
        return " | ".join(parts)


# the counters inside a ``BuildCounter.scope()``; the library loaders
# report to them through ``record_build``
_active: list["BuildCounter"] = []
_active_lock = threading.Lock()


def record_build(library: str, seconds: float, cached: bool) -> None:
    """Called by a library loader when it builds ``library`` (``cached``
    False, taking ``seconds``) or finds an earlier build (``cached``)."""
    with _active_lock:
        for counter in _active:
            counter.events.append((library, float(seconds), bool(cached)))


class BuildCounter:
    """The native libraries built or loaded from ``_build/`` in a scope.

    A process builds or loads each library once, at its first use, so a
    later stage of the same process reports none."""

    def __init__(self):
        self.events: list[tuple[str, float, bool]] = []

    @contextlib.contextmanager
    def scope(self):
        with _active_lock:
            _active.append(self)
        try:
            yield self
        finally:
            with _active_lock:
                _active.remove(self)

    def report(self) -> dict:
        built = [(lib, s) for lib, s, cached in self.events if not cached]
        return {"libraries_built": [lib for lib, _ in built],
                "build_seconds": round(sum(s for _, s in built), 3),
                "libraries_loaded_from_cache":
                    [lib for lib, _, cached in self.events if cached]}


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (TensorBoard's profile plugin or chrome://tracing read it)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
