"""Reading a ``torch.profiler`` Chrome trace: device intervals, their union,
kernel time by name, launches in a span, and where the device sat idle.

Times are microseconds as the trace gives them; the functions that return
a duration return seconds.
"""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_PREFIX = "cudaLaunchKernel"      # cudaLaunchKernel and cudaLaunchKernelExC


def load(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def from_profiler(prof) -> list:
    """The events of a finished ``torch.profiler.profile`` in the form
    ``load`` gives (category, name, start and duration in us), read
    straight from the profiler's events: no Chrome trace is written."""
    events = prof.profiler.kineto_results.events()
    if not events:
        return []
    cpu = type(events[0].device_type()).CPU
    return [{"cat": _category(e, cpu), "name": e.name(), "ts": e.start_ns() * 1e-3,
             "dur": e.duration_ns() * 1e-3} for e in events]


def _category(e, cpu) -> str:
    """A profiler event's Chrome-trace category, from what every torch
    version's event carries: whether it ran on the host (``cpu``: the CPU
    device type), its name, and whether it is a ``record_function``
    annotation."""
    name = e.name()
    on_device = e.device_type() != cpu
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if on_device:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "cuda_runtime" if name.startswith("cuda") else "cpu_op"


def span(events: list, name: str):
    """(start, end) of the first event called ``name``, or None."""
    for e in events:
        if e["name"] == name:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def device_intervals(events: list, lo: float, hi: float) -> list:
    """Sorted (start, end) of device activity clipped to [lo, hi]."""
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            a, b = max(a, lo), min(b, hi)
            if b > a:
                out.append((a, b))
    return sorted(out)


def merged(intervals: list) -> list:
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_seconds(events: list, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] in which some operation ran on the device."""
    return sum(b - a for a, b in merged(device_intervals(events, lo, hi))) * 1e-6


def kernel_seconds(events: list, name_part: str, lo: float, hi: float) -> float:
    return sum(float(e["dur"]) for e in events
               if e.get("cat") == "kernel" and name_part in e["name"]
               and lo <= float(e["ts"]) <= hi) * 1e-6


def launches(events: list, lo: float, hi: float) -> int:
    return sum(1 for e in events
               if e.get("cat") == "cuda_runtime" and e["name"].startswith(LAUNCH_PREFIX)
               and lo <= float(e["ts"]) <= hi)


def breakdown(events: list, lo: float, hi: float, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by the host operation running at each gap's midpoint (the innermost
    CPU op or annotation, else ``host``): one sweep over the host ops in
    start order with a stack of the open ones."""
    by_op = defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATS and lo <= e["ts"] <= hi:
            by_op[e["name"]] += e["dur"] * 1e-6
    gaps, t = [], lo
    for a, b in merged(device_intervals(events, lo, hi)):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in ("cpu_op", "user_annotation", "python_function"))
    by_host = defaultdict(float)
    stack, k = [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while k < len(host) and host[k][0] <= mid:
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        # an op that ended under a later, still open one is not on top
        label = next((h[2] for h in reversed(stack) if h[1] >= mid), "host")
        by_host[label] += (b - a) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
