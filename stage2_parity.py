"""Stage 2 of the JAX package and of the PyTorch port on the CPU, on the
dataset of ``chip_smoke.py``'s phases 4 and 8 (257 scans x 12,000 points),
and the JAX package's runs under the icp2planes and fpfh methods on the
datasets of its phases 10 and 11.

    python3 stage2_parity.py model
    python3 stage2_parity.py full [--capacity 2048]
    python3 stage2_parity.py icp2planes
    python3 stage2_parity.py fpfh
    python3 stage2_parity.py boxworld

``model``: the scan matcher's CSVs are replaced by the ground truth and
loop closing is off, so the SLAM trajectory shows only what stage 2's
noise model makes of the odometry and GPS; prints the JAX package's ATE
(the reference value ``chip_smoke.py`` holds its phase-8 model run to) and
the port's on the CPU.

``full``: the JAX package's stage 1 (voxel 0.2, capacity 8192), then
stage 2 of both packages with loop closing on copies of its output, the
keyframe store at ``--capacity`` (the card runs 8192: ~15 minutes on 8
CPU cores); prints both packages' closures and ATE, the reference's
accepted (i, j) pairs and whether ``loop_closures.csv`` is
byte-identical.  The JAX side runs its NN sweep and ball moments in their
XLA CPU forms.

``icp2planes`` (phase 10's numbers; ~13-22 minutes a key, ~59 in all, on 8
CPU cores): the JAX
package's stage 1 (voxel 0.2, capacity 8192) and stage 2 (store at voxel
None, capacity 8192) under ``method: icp2planes`` on phase 4's scans.
``fpfh`` (phase 11's; ~4.6 minutes a key, ~14 in all): its stage 1 under ``method: fpfh`` on
the box-world dataset (``utils.workload.method_dataset``).  Both methods
draw from ``jax.random``, so each runs under KEYS keys: key k offsets every
``jax.random.PRNGKey`` seed the package makes (preprocessing, the fpfh
matcher's per-batch keys, the store's) by k * KEY_STRIDE; key 0 is the
package's own run.  Per key: stage 1's ATE, the pairs fallen back to their
odometry seed, the share of pairs whose relative translation is within
0.5 m of the ground truth, and for icp2planes stage 2's ATE and accepted
(i, j) closures; then each number's spread (max - min) over the keys.

``boxworld`` (~6 minutes on 8 CPU cores): stage 1 under icp2planes on the
six box-world scans of ``tests/test_torch_cuda.py::
test_icp2planes_card_matches_cpu_on_a_box_world`` (voxel 0.2, up to 3,330
voxels a scan), at capacity 2048 (each scan cut to the voxels lowest in
key order) and 4096 (nothing dropped): each pair's translation error to
the truth in the JAX package under KEYS keys and in the port on the CPU
under plane seeds 0 to KEYS - 1 (``run_scanmatcher(seed=)``).

Each mode prints one JSON line.  Needs the JAX package (jax, pandas,
PyYAML) besides the port; runs in a scratch directory it removes.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_SCANS = 257
KEYS = 3
KEY_STRIDE = 1000003


def _dataset(d: str) -> dict:
    from lidar_slam_arvc_tpu_torch.utils import synthetic
    from lidar_slam_arvc_tpu_torch.utils.workload import SCAN_POINTS, VOXEL, WORLD
    return synthetic.make_dataset(
        d, n_scans=N_SCANS, seed=0, scan_points=SCAN_POINTS, world_kwargs=WORLD,
        scanmatcher_params={"voxel_size": VOXEL, "method": "icppointplane"})


def _jax_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")


def run_model(tmp: str) -> dict:
    _jax_cpu()
    from lidar_slam_arvc_tpu.pipeline.graphslam import run_graphslam as run_ref
    from lidar_slam_arvc_tpu_torch.pipeline.graphslam import run_graphslam
    from lidar_slam_arvc_tpu_torch.utils.metrics import ate
    from lidar_slam_arvc_tpu_torch.utils.synthetic import write_model_inputs
    d = os.path.join(tmp, "model")
    info = _dataset(d)
    write_model_inputs(d, info["T_gt"])
    d_port = d + "_port"
    shutil.copytree(d, d_port)
    t0 = time.time()
    ref = run_ref(d, progress=False)
    t_ref = time.time() - t0
    t0 = time.time()
    got = run_graphslam(d_port, progress=False, device="cpu")
    t_port = time.time() - t0
    return {"mode": "model", "poses": N_SCANS,
            "ate_reference": ate(np.asarray(ref["solution"]), info["T_gt"])["rmse"],
            "ate_port_cpu": ate(got["solution"], info["T_gt"])["rmse"],
            "seconds_reference_cpu": round(t_ref, 3),
            "seconds_port_cpu": round(t_port, 3)}


def run_full(tmp: str, capacity: int) -> dict:
    _jax_cpu()
    from lidar_slam_arvc_tpu.pipeline.graphslam import run_graphslam as run_ref
    from lidar_slam_arvc_tpu.pipeline.scanmatcher import run_scanmatcher as run_sm_ref
    from lidar_slam_arvc_tpu.utils.config import IcpConfig as IcpConfigRef
    from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
    from lidar_slam_arvc_tpu_torch.pipeline.graphslam import run_graphslam
    from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
    from lidar_slam_arvc_tpu_torch.utils.metrics import ate
    from lidar_slam_arvc_tpu_torch.utils.workload import CAPACITY
    d = os.path.join(tmp, "full")
    info = _dataset(d)
    run_sm_ref(d, cfg=IcpConfigRef(capacity=CAPACITY), progress=False)
    d_port = d + "_port"
    shutil.copytree(d, d_port)
    t0 = time.time()
    ref = run_ref(d, cfg=IcpConfigRef(capacity=capacity), progress=False)
    t_ref = time.time() - t0
    t0 = time.time()
    got = run_graphslam(d_port, cfg=IcpConfig(capacity=capacity), progress=False,
                        device="cpu")
    t_port = time.time() - t0
    lc = "/robot0/SLAM/loop_closures.csv"
    with open(d + lc, "rb") as f, open(d_port + lc, "rb") as g:
        same = f.read() == g.read()
    with open(d + lc) as f:
        pairs = [[int(v) for v in row.split(",")[1:]]
                 for row in f.read().splitlines()[1:]]
    _, sm = EurocDataset(d).read_trajectory("/robot0/scanmatcher/scanmatcher_global.csv")
    return {"mode": "full", "poses": N_SCANS, "store_capacity": capacity,
            "ate_stage1": ate(sm, info["T_gt"])["rmse"],
            "ate_reference": ate(np.asarray(ref["solution"]), info["T_gt"])["rmse"],
            "ate_port_cpu": ate(got["solution"], info["T_gt"])["rmse"],
            "closures_reference": int(ref["n_loop_closures"]),
            "closures_port_cpu": int(got["n_loop_closures"]),
            "loop_closures_csv_identical": same,
            "loop_closures_reference": pairs,
            "seconds_reference_cpu": round(t_ref, 3),
            "seconds_port_cpu": round(t_port, 3)}


def _keyed(k: int):
    """Context in which every ``jax.random.PRNGKey(s)`` is PRNGKey(s + k *
    KEY_STRIDE): the JAX package's draws under its k-th key."""
    import contextlib

    import jax

    @contextlib.contextmanager
    def ctx():
        orig = jax.random.PRNGKey
        jax.random.PRNGKey = lambda s, *a, **kw: orig(s + k * KEY_STRIDE, *a, **kw)
        try:
            yield
        finally:
            jax.random.PRNGKey = orig
    return ctx()


def run_method(tmp: str, method: str) -> dict:
    _jax_cpu()
    from lidar_slam_arvc_tpu.io import EurocDataset as EurocRef
    from lidar_slam_arvc_tpu.pipeline.graphslam import run_graphslam as run_ref
    from lidar_slam_arvc_tpu.pipeline.scanmatcher import (
        prepare_experiment_data, relative_odometry)
    from lidar_slam_arvc_tpu.pipeline.scanmatcher import run_scanmatcher as run_sm_ref
    from lidar_slam_arvc_tpu.utils.config import IcpConfig as IcpConfigRef
    from lidar_slam_arvc_tpu_torch.utils.metrics import ate
    from lidar_slam_arvc_tpu_torch.utils.workload import CAPACITY, method_dataset
    d0 = os.path.join(tmp, method)
    info = method_dataset(d0, method)
    T_gt = info["T_gt"]
    rel_gt = np.einsum("nij,njk->nik", np.linalg.inv(T_gt[:-1]), T_gt[1:])
    _, _, _, df_odo, _ = prepare_experiment_data(EurocRef(d0), 0, 1.0)
    seeds = relative_odometry(df_odo).astype(np.float32).astype(np.float64)
    cfg = IcpConfigRef(capacity=CAPACITY)
    keys = []
    for k in range(KEYS):
        d = f"{d0}_key{k}"
        shutil.copytree(d0, d)
        row = {"key": k}
        with _keyed(k):
            t0 = time.time()
            sm = run_sm_ref(d, cfg=cfg, progress=False)
            row["seconds_stage1"] = round(time.time() - t0, 3)
            rel = sm["relative"]
            row["ate_stage1"] = ate(sm["global"], T_gt)["rmse"]
            row["fallbacks"] = int(sum(np.array_equal(a, b)
                                       for a, b in zip(rel, seeds)))
            err = np.linalg.norm(rel[:, :3, 3] - rel_gt[:, :3, 3], axis=1)
            row["share_within_0.5m"] = float((err < 0.5).mean())
            if method == "icp2planes":
                t0 = time.time()
                ref = run_ref(d, cfg=cfg, progress=False)
                row["seconds_stage2"] = round(time.time() - t0, 3)
                row["ate_stage2"] = ate(np.asarray(ref["solution"]), T_gt)["rmse"]
                with open(d + "/robot0/SLAM/loop_closures.csv") as f:
                    row["closures"] = [[int(v) for v in r.split(",")[1:]]
                                       for r in f.read().splitlines()[1:]]
        shutil.rmtree(d)
        keys.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    spread = {name: max(r[name] for r in keys) - min(r[name] for r in keys)
              for name in ("ate_stage1", "fallbacks", "share_within_0.5m",
                           "ate_stage2") if name in keys[0]}
    return {"mode": method, "scans": len(T_gt), "capacity": CAPACITY,
            "keys": keys, "spread": spread}


def run_boxworld(tmp: str) -> dict:
    _jax_cpu()
    from lidar_slam_arvc_tpu.pipeline.scanmatcher import run_scanmatcher as run_sm_ref
    from lidar_slam_arvc_tpu.utils.config import IcpConfig as IcpConfigRef
    from lidar_slam_arvc_tpu_torch.pipeline.scanmatcher import run_scanmatcher
    from lidar_slam_arvc_tpu_torch.utils import synthetic
    from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
    from lidar_slam_arvc_tpu_torch.utils.workload import BOX_WORLD
    d = os.path.join(tmp, "boxworld")
    info = synthetic.make_dataset(
        d, n_scans=6, seed=2, radius=5.0, scan_points=4000, max_range=10.0,
        world_kwargs=BOX_WORLD,
        scanmatcher_params={"voxel_size": 0.2, "method": "icp2planes"})
    T = info["T_gt"]
    rel_gt = np.einsum("nij,njk->nik", np.linalg.inv(T[:-1]), T[1:])

    def err(out):
        return np.linalg.norm(out["relative"][:, :3, 3] - rel_gt[:, :3, 3],
                              axis=1).tolist()

    out = {"mode": "boxworld", "scans": len(T)}
    for cap in (2048, 4096):
        ref = []
        for k in range(KEYS):
            with _keyed(k):
                ref.append(err(run_sm_ref(d, cfg=IcpConfigRef(raw_capacity=8192, capacity=cap),
                                          progress=False)))
        port = [err(run_scanmatcher(d, cfg=IcpConfig(raw_capacity=8192, capacity=cap),
                                    progress=False, device="cpu", seed=k))
                for k in range(KEYS)]
        out[str(cap)] = {"reference_keys": ref, "port_cpu_seeds": port}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("model", "full", "icp2planes", "fpfh",
                                         "boxworld"))
    parser.add_argument("--capacity", type=int, default=2048,
                        help="full: the keyframe store's point capacity")
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        if args.mode == "model":
            out = run_model(tmp)
        elif args.mode == "full":
            out = run_full(tmp, args.capacity)
        elif args.mode == "boxworld":
            out = run_boxworld(tmp)
        else:
            out = run_method(tmp, args.mode)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
