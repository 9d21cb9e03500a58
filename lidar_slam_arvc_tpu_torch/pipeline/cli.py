"""Command-line interface of the port.

    python -m lidar_slam_arvc_tpu_torch.pipeline.cli scanmatch -i <dataset>
    python -m lidar_slam_arvc_tpu_torch.pipeline.cli graph     -i <dataset>
    python -m lidar_slam_arvc_tpu_torch.pipeline.cli run       -i <dataset>
        [--capacity N] [--batch-size N] [--source-stride N] [--device cuda]
    python -m lidar_slam_arvc_tpu_torch.pipeline.cli view      -i <dataset>
    python -m lidar_slam_arvc_tpu_torch.pipeline.cli convert   -i <dataset>
        [--mesh] [--alpha A]
    python -m lidar_slam_arvc_tpu_torch.pipeline.cli diag      -i <dataset>
    python -m lidar_slam_arvc_tpu_torch.pipeline.cli ingest    -i <dataset>
        --bag <file.bag> [--odom-topic T] [--lidar-topic T] [--gps-topic T]

``-i/--ifile`` keeps the reference's flag (run_scanmatcher.py:19-34).
``run`` is both stages in one process: stage 2's loop-closure store reuses
stage 1's preprocessed tensors when stage 1 ran at full resolution (voxel
None) with the same configuration.  ``scanmatch``, ``graph`` and ``run``
default to the device ``cuda``; with no card that is an error, not a
silent move to the CPU (``--device cpu`` asks for the kernels' plain
versions).  ``view``, ``convert``, ``diag`` and ``ingest`` run on the host
(numpy; matplotlib for the PNGs, scipy for the meshes).
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_stage_options(p):
    p.add_argument("--capacity", type=int, default=None,
                   help="padded per-scan point capacity after "
                        "downsampling (stage 2: after cropping)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="scans per preprocess batch and pairs per ICP "
                        "group")
    p.add_argument("--source-stride", type=int, default=None,
                   help="subsample ICP source clouds by this stride "
                        "(1 = all points)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="lidar_slam_arvc_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, text in (
            ("scanmatch", "stage 1: odometry-seeded consecutive scan matching"),
            ("graph", "stage 2: pose graph, loop closing, GPS"),
            ("run", "stage 1 then stage 2"),
            ("view", "trajectory PNGs and the global map (PLY, PCD)"),
            ("convert", "every scan as a PLY file (points or mesh)"),
            ("diag", "timestamp, raw-data and solution diagnostics (JSON "
                     "report, PNGs)")):
        p = sub.add_parser(name, help=text)
        p.add_argument("-i", "--ifile", required=True, dest="directory",
                       help="EUROC-format dataset directory")
        if name in ("scanmatch", "graph", "run"):
            _add_stage_options(p)
        if name == "convert":
            p.add_argument("--mesh", action="store_true",
                           help="export alpha-shape meshes instead of point "
                                "PLYs (reference save_pointcloud_as_mesh)")
            p.add_argument("--alpha", type=float, default=0.01,
                           help="alpha-shape radius (reference "
                                "keyframe.py:57 uses 0.01)")
    p = sub.add_parser("ingest", help="extract a ROS1 bag into the EUROC "
                       "layout")
    p.add_argument("-i", "--ifile", required=True, dest="directory",
                   help="output EUROC dataset directory")
    p.add_argument("--bag", required=True, help="input .bag (v2.0)")
    p.add_argument("--odom-topic", default=None)
    p.add_argument("--lidar-topic", default=None)
    p.add_argument("--gps-topic", default=None)
    return parser


def _stages(args) -> None:
    from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
    overrides = {}
    if args.capacity:
        overrides["capacity"] = args.capacity
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.source_stride:
        overrides["source_stride"] = args.source_stride
    cfg = IcpConfig(**overrides)

    preprocessed = None
    if args.command in ("scanmatch", "run"):
        from lidar_slam_arvc_tpu_torch.pipeline.scanmatcher import run_scanmatcher
        out = run_scanmatcher(args.directory, cfg=cfg, device=args.device,
                              return_preprocessed=args.command == "run")
        preprocessed = out.get("preprocessed")
        if preprocessed is not None and preprocessed["voxel_size"] is not None:
            # stage 2 wants full resolution: a voxelised stack can never be
            # reused, so it is not kept alive through stage 2
            preprocessed = None
        print(f"scanmatcher: {len(out['relative'])} pairs, "
              f"{out['frames_per_second']:.2f} frames/s (ICP)")
    if args.command in ("graph", "run"):
        from lidar_slam_arvc_tpu_torch.pipeline.graphslam import run_graphslam
        out = run_graphslam(args.directory, cfg=cfg, device=args.device,
                            preprocessed=preprocessed)
        print(f"graphSLAM: {len(out['solution'])} poses, "
              f"{out['n_loop_closures']} loop closures, "
              f"{out['seconds']:.1f}s")


def _diagnostics_report(directory: str) -> dict:
    """The ``diag`` report (reference cli.py:122-137)."""
    from lidar_slam_arvc_tpu_torch.viz import diagnostics
    report = {"timestamps": diagnostics.check_timestamps(directory),
              "raw_data": diagnostics.view_raw_data(directory)}
    for csv, tag in (("/robot0/SLAM/solution_graphslam.csv", "slam"),
                     ("/robot0/scanmatcher/scanmatcher_global.csv",
                      "scanmatcher")):
        try:
            report[f"solution_{tag}"] = diagnostics.view_solutions(directory, csv)
            report[f"delta_{tag}"] = diagnostics.compare_solutions(directory, csv)
        except FileNotFoundError:
            pass
    return report


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.command in ("scanmatch", "graph", "run"):
        _stages(args)
    elif args.command == "view":
        from lidar_slam_arvc_tpu_torch.viz.viewer import view_dataset
        view_dataset(args.directory)
    elif args.command == "convert":
        from lidar_slam_arvc_tpu_torch.viz.converter import convert_dataset
        convert_dataset(args.directory, mesh=args.mesh, alpha=args.alpha)
    elif args.command == "diag":
        print(json.dumps(_diagnostics_report(args.directory), indent=2))
    else:
        from lidar_slam_arvc_tpu_torch.io.rosbag import ingest_bag
        ingest_bag(args.bag, args.directory, odom_topic=args.odom_topic,
                   lidar_topic=args.lidar_topic, gps_topic=args.gps_topic)
    return 0


if __name__ == "__main__":
    sys.exit(main())
