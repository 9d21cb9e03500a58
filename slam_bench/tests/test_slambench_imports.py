"""What the benchmark loads and opens: the reference imports neither JAX
nor either package; a dry run of the harness on the CPU loads no JAX and no
JAX package (the port, ``lidar_slam_arvc_tpu_torch``, is another top-level
name) and opens nothing under ``benchmarks/`` nor ``bench.py``; without a
card the command exits non-zero and prints no result."""

import json
import os
import subprocess
import sys

import pytest

from slam_bench import run

NEVER = {"jax", "jaxlib", "flax", "lidar_slam_arvc_tpu"}


def _python(code: str, timeout=900):
    env = dict(os.environ, PYTHONPATH=run.REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=run.REPO, env=env, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_neither_package():
    mods = _python(
        "import sys, json; "
        "import slam_bench.reference.cloud, slam_bench.reference.icp, "
        "slam_bench.reference.graph, slam_bench.reference.loop, "
        "slam_bench.reference.geometry, slam_bench.reference.trajectory, "
        "slam_bench.check, slam_bench.gen.dataset; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(mods) & (NEVER | {"lidar_slam_arvc_tpu_torch"})


@pytest.mark.parametrize("workload", ["kitti00.stage1", "nclt.stage2"])
def test_dry_run_loads_no_jax_and_opens_no_old_benchmark(workload):
    kf = 9 if workload.endswith("stage1") else 60
    code = f"""
import json, os, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" and args and isinstance(args[0], (str, bytes, os.PathLike)) else None)
import torch
torch.set_num_threads(2)
from slam_bench import run
from slam_bench.tests import tiny
out = run.run({workload!r}, 2**31 + 77, 0.1, trace_on=False, device="cpu",
              overrides=tiny.overrides({workload!r}, keyframes={kf}), manifest=tiny.MANIFEST)
print(json.dumps({{"modules": sorted({{m.split('.')[0] for m in sys.modules}}),
                  "opened": sorted(set(opened)), "keys": list(out)}}))
"""
    got = _python(code)
    assert not set(got["modules"]) & NEVER
    assert "lidar_slam_arvc_tpu_torch" in got["modules"]
    old = (os.path.join(run.REPO, "benchmarks"), os.path.join(run.REPO, "bench.py"))
    assert not [p for p in got["opened"] if os.path.abspath(p).startswith(old)]
    assert got["keys"][:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert got["keys"][-1] == "checks"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, os.path.join(run.BENCH, "run.py"),
                          "--workload", "kitti00.stage1", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=run.REPO, timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_card_run_prints_a_result():
    """On a card, a short run of the stage-1 cell prints its result line
    with the manifest's metrics (decided here whether a card is present)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, os.path.join(run.BENCH, "run.py"),
                          "--workload", "kitti00.stage1", "--seed", "5",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=run.REPO, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res["metrics"]) == {"stage1_fps", "setup_s"} and res["correct"]
