"""Command-line interface of the port: stage 1, stage 2, or both.

    python -m lidar_slam_arvc_tpu_torch.pipeline.cli scanmatch -i <dataset>
    python -m lidar_slam_arvc_tpu_torch.pipeline.cli graph     -i <dataset>
    python -m lidar_slam_arvc_tpu_torch.pipeline.cli run       -i <dataset>
        [--capacity N] [--batch-size N] [--source-stride N] [--device cuda]

``-i/--ifile`` keeps the reference's flag (run_scanmatcher.py:19-34).
``run`` is both stages in one process: stage 2's loop-closure store reuses
stage 1's preprocessed tensors when stage 1 ran at full resolution (voxel
None) with the same configuration.  The default device is ``cuda``; with
no card that is an error, not a silent move to the CPU (``--device cpu``
asks for the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="lidar_slam_arvc_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, text in (("scanmatch", "stage 1: odometry-seeded consecutive "
                        "scan matching"),
                       ("graph", "stage 2: pose graph, loop closing, GPS"),
                       ("run", "stage 1 then stage 2")):
        p = sub.add_parser(name, help=text)
        p.add_argument("-i", "--ifile", required=True, dest="directory",
                       help="EUROC-format dataset directory")
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
    args = parser.parse_args(argv)

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
