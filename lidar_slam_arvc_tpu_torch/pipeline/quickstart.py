"""Quickstart: generate a synthetic EUROC dataset and run the full pipeline.

    python -m lidar_slam_arvc_tpu_torch.pipeline.quickstart [dir] [--device cpu]

Counterpart of ``examples/quickstart.py``: writes the same synthetic
dataset, runs stage 1 (``run_scanmatcher``) and stage 2 (``run_graphslam``)
on the device, prints the ATE and RPE against the generator's ground truth,
and exports the trajectory plots and the map (``view_dataset``).  On the
card the sizes are those the JAX script gives an accelerator (40 scans of
8000 points, raw capacity 16384, capacity 8192), on the CPU its small ones
(24 scans of 4000 points, 8192, 4096).
Where matplotlib is missing the viewer's ImportError is reported and the
stages' CSVs stay written.
"""

from __future__ import annotations

import argparse
import tempfile

from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.ops._cuda import torch_device
from lidar_slam_arvc_tpu_torch.pipeline.graphslam import run_graphslam
from lidar_slam_arvc_tpu_torch.pipeline.scanmatcher import run_scanmatcher
from lidar_slam_arvc_tpu_torch.utils import synthetic
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
from lidar_slam_arvc_tpu_torch.utils.metrics import ate, rpe
from lidar_slam_arvc_tpu_torch.viz.viewer import view_dataset

# device type -> (scans, points per scan, raw capacity, capacity)
SIZES = {"cuda": (40, 8000, 16384, 8192), "cpu": (24, 4000, 8192, 4096)}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("directory", nargs="?", default=None,
                   help="where to write the dataset (default: a new temp dir)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    """Run the quickstart; returns its metrics (metres, seconds) and the
    two stages' kernel launches."""
    args = _parser().parse_args(argv)
    device = torch_device(args.device, "quickstart")
    directory = args.directory or tempfile.mkdtemp(prefix="slam_quickstart_")
    print(f"dataset directory: {directory}")
    n_scans, pts, cap_raw, cap = SIZES[device.type]
    info = synthetic.make_dataset(
        directory, n_scans=n_scans, seed=0, radius=10.0, scan_points=pts,
        scanmatcher_params={"voxel_size": 0.2, "method": "icppointplane",
                            "delta_time": 1.0, "start_index": 0},
        slam_params={"skip_loop_closing": 10, "skip_optimization": 10,
                     "radius_threshold": 3.0, "distance_backwards": 8.0,
                     "number_of_triplets_loop_closing": 10})

    cfg = IcpConfig(raw_capacity=cap_raw, capacity=cap, batch_size=8)
    sm = run_scanmatcher(directory, cfg=cfg, device=device)
    sm_ate = ate(sm["global"], info["T_gt"])["rmse"]
    print(f"scanmatcher: {sm['frames_per_second']:.1f} frames/s, "
          f"ATE {sm_ate * 100:.1f} cm")

    slam = run_graphslam(directory, cfg=cfg, device=device)
    _, T_sol = EurocDataset(directory).read_trajectory(
        "/robot0/SLAM/solution_graphslam.csv")
    slam_ate = ate(T_sol, info["T_gt"])["rmse"]
    slam_rpe = rpe(T_sol, info["T_gt"])["trans_rmse"]
    print(f"graphSLAM: {slam['n_loop_closures']} loop closures, "
          f"ATE {slam_ate * 100:.1f} cm, RPE {slam_rpe * 100:.1f} cm/step")

    out = {"directory": directory, "scans": n_scans,
           "stage1_ate": float(sm_ate), "slam_ate": float(slam_ate),
           "slam_rpe": float(slam_rpe),
           "frames_per_second": float(sm["frames_per_second"]),
           "solve_loop_seconds": float(slam["profile"]["solve_loop_seconds"]),
           "loop_closures": int(slam["n_loop_closures"]),
           "stage1_launches": sm["profile"]["kernel_launches"],
           "stage2_launches": slam["profile"]["kernel_launches"],
           "view_error": None}
    try:
        view = view_dataset(directory, keyframe_sampling=4)
    except ImportError as exc:      # no matplotlib: the plots cannot be drawn
        out["view_error"] = f"{type(exc).__name__}: {exc}"
        print(f"viewer skipped ({out['view_error']})")
    else:
        print(f"artifacts in {view['out_dir']}")
    return out


if __name__ == "__main__":
    main()
