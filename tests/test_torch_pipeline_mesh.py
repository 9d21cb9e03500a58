"""The port's CLI on several ranks vs one rank and vs the JAX package.

The counterpart of tests/test_pipeline_mesh.py, at half its size (8 scans
where it has 16, ``make_dataset(seed=7, radius=8.0, scan_points=2000)``,
capacity 2048, batch 2, 15 iterations; 4 ranks still take 2 scans each
and 3 halo rows): ``cli run --devices 2``, ``cli scanmatch
--devices 4 --shard-scans`` and ``dryrun_multichip(2, "cpu")``, each
spawning its ranks (gloo on the CPU, the kernels' plain versions).
Tolerances:

* stage 1: 1e-5 of the port's one-rank run (each rank registers whole
  groups of the same pairs; measured bit-equal), and the relative
  transforms within 1e-3 of the JAX package's one-device run with its TPU
  kernels in Pallas interpret mode, entry by entry as
  tests/test_pipeline_mesh.py compares its own (the port's one-rank run
  is 2.5e-4 from it, a pose 2.5e-4 m; at 16 scans 7.7e-4 and 1.09e-3 m:
  on this pillar world f32 rounding turns the normals, ROADMAP Queue 3);
  ATE < 0.2 m;
* stage 2 (the slam parameters of tests/test_torch_stage2.py, loop closing
  on): the Schur solve's positions within 5e-3 m of the one-rank dense
  solve (tests/test_pipeline_mesh.py's bound) and ``loop_closures.csv``
  byte-equal.  This circle's 6.1 m scan spacing leaves no triplet window,
  so no closure is drawn here; the sharded
  store's registration is held bit-equal to one rank's in
  tests/test_torch_parallel.py.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from lidar_slam_arvc_tpu.cloud import normals as normals_ref
from lidar_slam_arvc_tpu.pipeline import preprocess as prep_ref
from lidar_slam_arvc_tpu.pipeline import scanmatcher as sm_ref
from lidar_slam_arvc_tpu.registration import ICPParams as ICPParamsRef
from lidar_slam_arvc_tpu.utils.config import IcpConfig as IcpConfigRef
from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.parallel.dryrun import dryrun_multichip
from lidar_slam_arvc_tpu_torch.pipeline import cli
from lidar_slam_arvc_tpu_torch.utils import synthetic
from lidar_slam_arvc_tpu_torch.utils.metrics import ate

torch.set_num_threads(1)

N_SCANS = 8
CFG_KW = dict(raw_capacity=4096, capacity=2048, batch_size=2, max_iterations=15)
ARGS = ["--capacity", "2048", "--batch-size", "2", "--device", "cpu"]
SLAM = {"skip_loop_closing": 12, "skip_optimization": 12,
        "radius_threshold": 3.0, "distance_backwards": 8.0,
        "number_of_triplets_loop_closing": 10}
SM = "/robot0/scanmatcher/"
SLAM_DIR = "/robot0/SLAM/"


def relative(d):
    return EurocDataset(d).read_trajectory(SM + "scanmatcher_relative.csv")[1]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh") / "euroc")
    info = synthetic.make_dataset(
        d, n_scans=N_SCANS, seed=7, radius=8.0, scan_points=2000,
        scanmatcher_params={"voxel_size": 0.2, "method": "icppointplane",
                            "delta_time": 1.0, "start_index": 0},
        slam_params=SLAM)
    return d, info


@pytest.fixture(scope="module")
def one_rank(dataset, tmp_path_factory):
    """Both stages on one rank, through the CLI."""
    d = str(tmp_path_factory.mktemp("one") / "euroc")
    shutil.copytree(dataset[0], d)
    assert cli.main(["run", "-i", d, *ARGS]) == 0
    return d


@pytest.fixture(scope="module")
def reference_relative(dataset, tmp_path_factory):
    """The JAX package's one-device stage 1, its K1 and K2 originals in
    Pallas interpret mode (tests/test_torch_stage1.py's setting)."""
    d = str(tmp_path_factory.mktemp("ref") / "euroc")
    shutil.copytree(dataset[0], d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sm_ref, "ICPParams", lambda **kw: ICPParamsRef(nn_impl="vpu_t", **kw))
        mp.setattr(prep_ref.cl, "estimate_normals",
                   lambda c, r: normals_ref.estimate_normals(c, r, impl="pallas_interpret"))
        sm_ref.run_scanmatcher(d, cfg=IcpConfigRef(**CFG_KW), progress=False)
    return relative(d)


@pytest.fixture
def reports(monkeypatch):
    """The rank reports of the CLI's next launch."""
    got = []
    launch = cli.launch_stages

    def spy(argv, n, device):
        got.extend(launch(argv, n, device))
        return got

    monkeypatch.setattr(cli, "launch_stages", spy)
    return got


def _check_stage1(d, one_rank, reference_relative, info):
    np.testing.assert_allclose(relative(d), relative(one_rank), atol=1e-5)
    np.testing.assert_allclose(relative(d), reference_relative, atol=1e-3)
    _, T = EurocDataset(d).read_trajectory(SM + "scanmatcher_global.csv")
    assert ate(T, info["T_gt"])["rmse"] < 0.2


def _check_ranks(reports, n, stage):
    assert [r["rank"] for r in reports] == list(range(n))
    for r in reports:
        assert r["backend"] == "gloo" and r["foreign_modules"] == []
        # only rank 0 writes
        assert bool(r[stage]["written"]) == (r["rank"] == 0)
        assert r[stage]["profile"]["process_count"] == n


def test_cli_run_two_ranks(dataset, one_rank, reference_relative, reports, tmp_path):
    """``cli run --devices 2``: stage 1's pairs split over 2 ranks, stage 2
    by the distributed Schur solve over a sharded store."""
    d = str(tmp_path / "euroc")
    shutil.copytree(dataset[0], d)
    assert cli.main(["run", "-i", d, "--devices", "2", *ARGS]) == 0
    _check_stage1(d, one_rank, reference_relative, dataset[1])
    _check_ranks(reports, 2, "scanmatch")
    _check_ranks(reports, 2, "graph")
    prof = reports[0]["graph"]["profile"]
    with open(d + "/robot0/viz/graphslam_profile.json") as f:
        assert json.load(f)["solver"] == prof["solver"] == "schur"
    assert prof["mesh_devices"] == 2 and prof["collectives"]["reduce"]["calls"] > 0
    assert reports[0]["scanmatch"]["profile"]["mesh_devices"] == 2
    with open(d + SLAM_DIR + "loop_closures.csv", "rb") as f, \
            open(one_rank + SLAM_DIR + "loop_closures.csv", "rb") as g:
        assert f.read() == g.read()
    sol = EurocDataset(d).read_trajectory(SLAM_DIR + "solution_graphslam.csv")[1]
    sol1 = EurocDataset(one_rank).read_trajectory(SLAM_DIR + "solution_graphslam.csv")[1]
    assert sol.shape == (N_SCANS, 4, 4)
    np.testing.assert_allclose(sol[:, :3, 3], sol1[:, :3, 3], atol=5e-3)


def test_cli_scanmatch_sharded_four_ranks(dataset, one_rank, reference_relative,
                                          reports, tmp_path):
    """``--devices 4 --shard-scans``: each rank loads only its block of
    N_SCANS / 4 scans; the pairs across blocks take the next rank's first
    scan."""
    d = str(tmp_path / "euroc")
    shutil.copytree(dataset[0], d)
    assert cli.main(["scanmatch", "-i", d, "--devices", "4", "--shard-scans",
                     *ARGS]) == 0
    _check_stage1(d, one_rank, reference_relative, dataset[1])
    _check_ranks(reports, 4, "scanmatch")
    for r in reports:
        prof = r["scanmatch"]["profile"]
        assert r["scanmatch"]["scans_loaded_locally"] == N_SCANS // 4
        assert prof["shard_scans"] and prof["mesh_devices"] == 4
        assert prof["collectives"]["halo"]["calls"] == 3


def test_dryrun_multichip_two_ranks():
    out = dryrun_multichip(2, "cpu")
    assert len(out) == 2 and out[0]["schur"] < 0.5 * out[0]["cost0"]
