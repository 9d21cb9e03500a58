"""Command-line interface of the port.

    python -m lidar_slam_arvc_tpu_torch.pipeline.cli scanmatch -i <dataset>
    python -m lidar_slam_arvc_tpu_torch.pipeline.cli graph     -i <dataset>
    python -m lidar_slam_arvc_tpu_torch.pipeline.cli run       -i <dataset>
        [--capacity N] [--batch-size N] [--source-stride N] [--device cuda]
        [--devices N] [--shard-scans]
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

``--devices N`` runs the stages on N ranks, one process per device
(``parallel/mesh.py``): stage 1's pairs split over them (``--shard-scans``:
each rank loads and preprocesses only its block of scans), stage 2 solves
by the distributed Schur complement over a sharded keyframe store.  Inside
a process group (``torchrun``'s environment, one or several hosts) the
command joins it; otherwise it spawns the N ranks itself, rank r on
``cuda:{r % cards}`` (or the CPU under ``--device cpu``), and fails when
any rank fails.  ``--devices 0`` means every rank of the group, or every
visible card.
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
    p.add_argument("--devices", type=int, default=None, metavar="N",
                   help="ranks (one process per device) for the pipeline: "
                        "stage-1 pairs split over them, stage-2 "
                        "distributed Schur solve; 0 = every rank of the "
                        "group or every visible card, default 1")
    p.add_argument("--shard-scans", action="store_true",
                   help="with --devices N: each rank loads and preprocesses "
                        "only its block of the scans (halo for the pairs "
                        "across blocks) instead of every scan")


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


def _stages(args, progress: bool = True) -> dict:
    """The stage commands in this process (a rank of the group, if one is
    initialised); returns each stage's profile, the paths this process
    wrote and the scans it loaded."""
    from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig
    overrides = {}
    if args.capacity:
        overrides["capacity"] = args.capacity
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.source_stride:
        overrides["source_stride"] = args.source_stride
    if args.devices is not None:
        overrides["mesh_devices"] = args.devices
    if args.shard_scans:
        overrides["shard_scans"] = True
    cfg = IcpConfig(**overrides)

    report = {}
    preprocessed = None
    if args.command in ("scanmatch", "run"):
        from lidar_slam_arvc_tpu_torch.pipeline.scanmatcher import run_scanmatcher
        out = run_scanmatcher(args.directory, cfg=cfg, device=args.device,
                              progress=progress,
                              return_preprocessed=args.command == "run")
        preprocessed = out.get("preprocessed")
        if preprocessed is not None and preprocessed["voxel_size"] is not None:
            # stage 2 wants full resolution: a voxelised stack can never be
            # reused, so it is not kept alive through stage 2
            preprocessed = None
        report["scanmatch"] = {k: out[k] for k in
                               ("profile", "written", "scans_loaded_locally")}
        if progress:
            print(f"scanmatcher: {len(out['relative'])} pairs, "
                  f"{out['frames_per_second']:.2f} frames/s (ICP)")
    if args.command in ("graph", "run"):
        from lidar_slam_arvc_tpu_torch.pipeline.graphslam import run_graphslam
        out = run_graphslam(args.directory, cfg=cfg, device=args.device,
                            progress=progress, preprocessed=preprocessed)
        report["graph"] = {k: out[k] for k in
                           ("profile", "written", "store_scans_loaded_locally")}
        if progress:
            print(f"graphSLAM: {len(out['solution'])} poses, "
                  f"{out['n_loop_closures']} loop closures, "
                  f"{out['seconds']:.1f}s")
    return report


def rank_stages(argv) -> dict:
    """The stage command ``argv`` in one rank of a launched group (the
    target of ``launch_stages``): rank 0 prints the progress.  Returns
    ``_stages``'s report with the rank's index and kernel counters."""
    from lidar_slam_arvc_tpu_torch.parallel import _ranks
    args = _parser().parse_args(argv)
    ident = _ranks.counters()
    report = _stages(args, progress=ident["rank"] == 0)
    report.update(_ranks.counters())
    return report


def launch_stages(argv, n: int, device, log_dir: str | None = None) -> list:
    """Spawn n ranks that run the stage command ``argv`` together; returns
    each rank's report (``rank_stages``), raises when a rank fails.
    ``log_dir``: the ranks' output goes to files there."""
    from lidar_slam_arvc_tpu_torch.parallel.mesh import launch
    return launch(n, rank_stages, list(argv), device=device, log_dir=log_dir)


def _ranks_requested(args) -> int:
    """The ranks ``--devices`` asks this process to spawn (1: run here)."""
    import torch
    from lidar_slam_arvc_tpu_torch.parallel import mesh, multihost
    if args.devices in (None, 1) or mesh.world_size() > 1 \
            or multihost.in_torchrun_group():
        return 1
    if args.devices == 0:
        return (torch.cuda.device_count() or 1) if args.device.startswith("cuda") else 1
    return args.devices


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
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.command in ("scanmatch", "graph", "run"):
        from lidar_slam_arvc_tpu_torch.parallel import mesh, multihost
        n = _ranks_requested(args)
        if n > 1:
            reports = launch_stages(argv, n, args.device)
            print(f"{n} ranks done ({reports[0]['backend']} on "
                  + ", ".join(r["device"] for r in reports) + ")")
        elif args.devices not in (None, 1) and multihost.in_torchrun_group() \
                and mesh.world_size() == 1:
            multihost.initialize(device=args.device)
            try:
                _stages(args, progress=mesh.world_rank() == 0)
            finally:
                mesh.close_rank()
        else:
            _stages(args, progress=mesh.world_rank() == 0)
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
