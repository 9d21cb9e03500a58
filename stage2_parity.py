"""Stage 2 of the JAX package and of the PyTorch port on the CPU, on the
dataset of ``chip_smoke.py``'s phases 4 and 8 (257 scans x 12,000 points).

    python3 stage2_parity.py model
    python3 stage2_parity.py full [--capacity 2048]

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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("model", "full"))
    parser.add_argument("--capacity", type=int, default=2048,
                        help="full: the keyframe store's point capacity")
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        out = (run_model(tmp) if args.mode == "model"
               else run_full(tmp, args.capacity))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
