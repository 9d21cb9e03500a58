"""Benchmark of the PyTorch + CUDA port (``lidar_slam_arvc_tpu_torch``).

    python3 slam_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``slam_bench/configs/<name>.json``: sensor, world, motion, the program's
parameters) and a traffic file (``slam_bench/traffic/<name>.json``: which
stage runs, its warm-up, the check's sample).  A run:

1. set-up (``setup_s``, from the start of this process): generates the
   dataset from the seed on the card into a temporary directory under
   ``TMPDIR`` (removed at exit), builds or loads the port's kernels, and
   warms up on the first keyframes of that dataset;
2. the window: whole sequences back to back through the stage's public
   entry point, until the first sequence boundary after ``--seconds``; the
   rate is the work of all of them over the elapsed time;
3. with ``--trace 1``: one more sequence under ``torch.profiler``, from
   which the cell's per-layer metrics (``slam_bench/metrics/<name>.py``)
   are read;
4. the check (``check.py``) of the window's outputs against the plain
   reference, each number beside its limit (``slam_bench/limits/<cell>.json``);
5. one JSON line on standard output.

It exits non-zero, with no result, without the cards, when the port cannot
be imported, or when JAX or the JAX package was loaded in this process.
``--control 1`` (not part of the benchmark's runs) runs one sequence and
judges the reference computed one precision lower (``check.py``) in the
program's place.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "slam_bench")
FORBIDDEN = ("jax", "jaxlib", "flax", "lidar_slam_arvc_tpu")
MANIFEST = os.path.join(REPO, "BENCHMARK.json")
# the build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(REPO, "_bench_cache")

if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def cell(workload: str, manifest: str = MANIFEST) -> dict:
    """The cell's manifest entry, configuration, traffic and limits."""
    bench = _load_json(manifest)
    w = next((x for x in bench["workloads"] if x["name"] == workload), None)
    if w is None:
        raise SystemExit(f"unknown workload {workload!r}")
    c = next(x for x in bench["configs"] if x["name"] == w["config"])
    return {"workload": w, "bench": bench,
            "config": _load_json(os.path.join(REPO, c["file"])),
            "traffic": _load_json(os.path.join(BENCH, "traffic", f"{w['traffic']}.json")),
            "limits": _load_json(os.path.join(BENCH, "limits", f"{workload}.json"))}


def reader(metric: str):
    spec = importlib.util.spec_from_file_location(
        f"slam_bench_metric_{metric}", os.path.join(BENCH, "metrics", f"{metric}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as exc:
        return f"unread ({type(exc).__name__})"


class Stage:
    """The stage a traffic file names: its entry point and what the check
    needs from each sequence."""

    def __init__(self, stage: int, cfg: dict, device):
        import torch
        from lidar_slam_arvc_tpu_torch.pipeline import graphslam, scanmatcher
        from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
        self.stage, self.device = stage, device
        self.icp = IcpConfig(**cfg["icp"])
        self.entry = scanmatcher.run_scanmatcher if stage == 1 else graphslam.run_graphslam
        self.outputs = []
        if stage == 2:
            from slam_bench.spies import Stage2Record
            self.record = Stage2Record()
        self._sync = (lambda: torch.cuda.synchronize(device)) if \
            torch.device(device).type == "cuda" else (lambda: None)

    def run(self, directory: str, keep: bool):
        """One sequence; returns (work units, the program's profile)."""
        if self.stage == 1:
            out = self.entry(directory, self.icp, progress=False, device=self.device)
            self._sync()
            if keep:
                self.outputs.append(out["relative"])
            return out["profile"]["pairs"], out["profile"]
        with self.record.on():
            out = self.entry(directory, self.icp, progress=False, device=self.device)
        self._sync()
        if keep:
            covs, skip = self.record.marginals
            idx = range(0, len(out["solution"]), skip)
            sigma = positional_sigma(covs[list(idx)])
            self.outputs.append({
                "accepted": [tuple(p) for g in out["loop_closures"] if g for p in g],
                "solution": out["solution"], "sigma": sigma, "sample": list(idx),
                "rounds": self.record.rounds, "graph": self.record.graph})
        return out["profile"]["poses"], out["profile"]


def positional_sigma(covs):
    """sqrt(trace Sigma_xyz) of (k, 6, 6) [w, v] covariance blocks."""
    import numpy as np
    return np.sqrt(np.asarray(covs)[:, 3:, 3:].diagonal(axis1=-2, axis2=-1).sum(-1))


def correctness(stage: Stage, cfg, traffic, directory, seed, device, control):
    """({name: value} of the check (``check.py``), diagnostics)."""
    import numpy as np
    import torch
    from slam_bench import check
    torch.cuda.empty_cache() if torch.device(device).type == "cuda" else None
    if stage.stage == 1:
        n_pairs = len(stage.outputs[0])
        rng = np.random.default_rng([seed, 2])
        pairs = np.sort(rng.choice(n_pairs, size=min(traffic["check_pairs"], n_pairs),
                                   replace=False))
        ref = check.stage1_reference(directory, cfg, pairs, device)
        program = ([check.stage1_reference(directory, cfg, pairs, device, control=True)]
                   if control else [rel[pairs] for rel in stage.outputs])
        return check.stage1_numbers(program, ref), {"pairs": pairs.tolist()}
    last = stage.outputs[-1]
    ref = check.stage2_reference(directory, cfg, last["rounds"], last["sample"], device)
    if control:
        c = check.stage2_reference(directory, cfg, last["rounds"], last["sample"], device,
                                   control=True)
        program = [(c["accepted"], c["solution"], c["sigma"])]
    else:
        program = [(o["accepted"], o["solution"], o["sigma"]) for o in stage.outputs]
    diag = check.stage2_diagnostics(last["graph"], last["solution"], ref, device)
    diag["closures"] = len(ref["accepted"])
    diag["marginal_gap"] = check.marginal_gap(program, ref)
    return check.stage2_numbers(program, ref), diag


def trajectory_error(stage: Stage, T_gt) -> float:
    """ATE rmse (m, after rigid alignment) of the last sequence's
    trajectory against the truth: a sanity print beside the check."""
    import numpy as np
    from slam_bench.reference.trajectory import ate
    last = stage.outputs[-1]
    if stage.stage == 2:
        return ate(last["solution"], T_gt)["rmse"]
    T = np.empty((len(last) + 1, 4, 4))
    T[0] = np.eye(4)
    for i, rel in enumerate(last):
        T[i + 1] = T[i] @ rel
    return ate(T, T_gt)["rmse"]


def per_layer(stage: Stage, c: dict, directory: str, profiles: list, device):
    """(metrics, device busy_s, window_s, breakdown) of one profiled sequence."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from slam_bench import trace
    from slam_bench.spies import Work
    work = Work()
    with work.on(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("slam_bench.sequence"):
            stage.run(directory, keep=False)
            torch.cuda.synchronize(device)
    log("traced sequence run")
    events = trace.from_profiler(prof)
    log(f"{len(events)} trace events read")
    spans = {"sequence": trace.span(events, "slam_bench.sequence"),
             "icp": trace.span(events, "slam_bench.icp")}
    ctx = {"profiles": profiles, "events": events, "spans": spans,
           "work": {"k1": work.k1, "k2": work.k2}, "k1_launches": work.k1_launches}
    metrics = {}
    name = c["workload"]["name"]
    for m in c["bench"]["per_layer"]:
        if name in m.get("workloads", [name]):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    lo, hi = spans["sequence"]
    log("per-layer metrics read")
    return (metrics, trace.busy_seconds(events, lo, hi), (hi - lo) * 1e-6,
            trace.breakdown(events, lo, hi))


def log(what: str) -> None:
    print(f"slam_bench: {what} at {time.perf_counter() - T_START:.2f} s", file=sys.stderr,
          flush=True)


def run(workload: str, seed: int, seconds: float, trace_on: bool, device="cuda",
        control: bool = False, overrides: dict | None = None,
        manifest: str = MANIFEST) -> dict:
    import torch
    c = cell(workload, manifest)
    cfg = merge(c["config"], (overrides or {}).get("config", {}))
    traffic = merge(c["traffic"], (overrides or {}).get("traffic", {}))
    limits = c["limits"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from slam_bench.gen import dataset
    stage = Stage(traffic["stage"], cfg, device)

    with tempfile.TemporaryDirectory(prefix="slam_bench_") as tmp:
        data = os.path.join(tmp, "data")
        log("imports done")
        info = dataset.generate(cfg, seed, data, device)
        log("dataset generated")
        warm = os.path.join(tmp, "warmup")
        dataset.subset(data, warm, traffic["warmup_keyframes"])
        stage.run(warm, keep=False)
        setup_s = time.perf_counter() - T_START
        log("warm-up done")

        work, profiles, t0 = 0, [], time.perf_counter()
        while True:
            units, prof = stage.run(data, keep=True)
            work += units
            profiles.append(prof)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds or control:
                break
        on_card = torch.device(device).type == "cuda"
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0

        result_device = {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}
        rate = {traffic["rate_metric"]: {"value": work / elapsed,
                                         "unit": traffic["rate_unit"]},
                "setup_s": {"value": setup_s, "unit": "s"}}
        breakdown = None
        log(f"window closed after {len(profiles)} sequences")
        if trace_on:
            metrics, busy, window, breakdown = per_layer(stage, c, data, profiles, device)
            result_device.update(busy_s=busy, window_s=window)
            log("traced sequence read")
        else:
            metrics = rate
        numbers, diagnostics = correctness(stage, cfg, traffic, data, seed, device, control)
        diagnostics["ate_rmse_m"] = trajectory_error(stage, info["T_gt"])
        log("check done")
    from slam_bench.check import judge
    correct, rows = judge(numbers, limits)
    # the numbers the cell's limits leave out are printed, not judged
    diagnostics.update({k: v for k, v in numbers.items() if k not in limits})
    dropped = (int(p.get("voxels_dropped_total", 0)) for p in profiles)
    out = {"correct": correct, "attempted": len(profiles),
           "failed": 0 if correct else len(profiles),
           "metrics": metrics, "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["info"] = {"seed": seed, "sequences": len(profiles), "window_s": elapsed,
                   "work": work, "rate": rate, "voxels_dropped_max": max(dropped, default=0),
                   "raw_returns_max": int(info["raw_returns"].max()),
                   "power": power_limit() if on_card else "cpu",
                   "diagnostics": diagnostics, "profile": profiles[-1]}
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.makedirs(CACHE, exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    import torch
    chips = cell(args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slam_bench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              control=bool(args.control))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"slam_bench: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
