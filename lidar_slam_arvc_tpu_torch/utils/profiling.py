"""Per-stage timing, build accounting and device traces.

Counterpart of ``lidar_slam_arvc_tpu/utils/profiling.py``:

* :class:`StageTimer`: named wall-clock counters with items/s, the same
  report and ``dump`` JSON as the reference's.
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


class StageTimer:
    """Accumulates wall time + item counts per named stage."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.items = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
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
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
