"""Stage 1's host paths in the port on the CPU: the streamed load against the
two-phase load, checkpoint/resume (with checkpoints of the JAX package's
format), and ``sample_odometry`` against the JAX package's.

Streamed and two-phase preprocessing run the same batches with the same
draws, so they must agree bit for bit; a resumed stage must give the
uninterrupted transforms bit for bit, since the groups it runs are the
uninterrupted run's groups.
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from lidar_slam_arvc_tpu.io import sampling as sampling_ref
from lidar_slam_arvc_tpu.pipeline import scanmatcher as sm_ref
from lidar_slam_arvc_tpu.utils.config import IcpConfig as IcpConfigRef
from lidar_slam_arvc_tpu_torch.io import sampling
from lidar_slam_arvc_tpu_torch.io.euroc import EurocDataset
from lidar_slam_arvc_tpu_torch.pipeline import scanmatcher as sm
from lidar_slam_arvc_tpu_torch.utils import synthetic
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig

torch.set_num_threads(1)

N_SCANS = 15
CFG = IcpConfig(raw_capacity=1024, capacity=512, batch_size=4,
                max_iterations=10)
WORLD = {"extent": 15.0, "n_ground": 2000, "n_pillars": 5, "pillar_pts": 100,
         "n_boxes": 2}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("stage1_host"))
    info = synthetic.make_dataset(d, n_scans=N_SCANS, seed=1, scan_points=800,
                                  world_kwargs=WORLD,
                                  scanmatcher_params={"voxel_size": 0.2})
    return d, info


def _times(d):
    return EurocDataset(d).read_csv("/robot0/lidar/data.csv")["#timestamp [ns]"]


@pytest.mark.parametrize("method", ["icppointplane", "icp2planes"])
def test_streamed_matches_two_phase(dataset, method):
    """15 scans in chunks of 8 (a full chunk, a partial one, a partial last
    batch) and of 4: points, mask, normals, both ground masks and the
    overflow equal the two-phase path's.  Under icp2planes the ground
    planes' draws follow the scan's index in the whole sequence, so the
    chunking cannot change them."""
    d, _ = dataset
    euroc = EurocDataset(d)
    times = _times(d)
    ref, ovf_ref = sm.preprocess_all(*sm.load_scans(euroc, times, CFG.raw_capacity),
                                     CFG, method, 0.2, device="cpu")
    for chunk in (8, 4):
        got, ovf, n_python = sm.load_and_preprocess_streamed(
            euroc, times, CFG, method, 0.2, device="cpu", chunk_scans=chunk)
        assert n_python == 0
        for name, a, b in zip(ref._fields, got, ref):
            if b is None:
                assert a is None, name
            else:
                assert torch.equal(a, b), (name, chunk)
        np.testing.assert_array_equal(ovf, ovf_ref)
    assert (ref.ground_mask is not None) == (method == "icp2planes")


def test_default_chunk_rounds_up_to_whole_batches(dataset, monkeypatch):
    """chunk_scans defaults to max(8 B, 32), rounded up to a multiple of B."""
    d, _ = dataset
    euroc = EurocDataset(d)
    seen = []
    real = sm._load_paths
    monkeypatch.setattr(sm, "_load_paths",
                        lambda paths, *a, **k: seen.append(len(paths)) or real(paths, *a, **k))
    cfg = IcpConfig(raw_capacity=256, capacity=128, batch_size=3)
    sm.load_and_preprocess_streamed(euroc, _times(d), cfg, "icppointpoint",
                                    0.2, device="cpu", chunk_scans=5)
    assert seen == [6, 6, 3]
    seen.clear()
    sm.load_and_preprocess_streamed(euroc, _times(d), cfg, "icppointpoint",
                                    0.2, device="cpu")
    assert seen == [N_SCANS]          # 33 >= 15 scans: one chunk


@pytest.fixture(scope="module")
def matcher_inputs(dataset):
    d, _ = dataset
    euroc = EurocDataset(d)
    scan_times, _, _, odo, _ = sm.prepare_experiment_data(euroc, 0, 1.0)
    rel_odo = sm.relative_odometry(odo)
    scans, _, _ = sm.load_and_preprocess_streamed(
        euroc, scan_times, CFG, "icppointplane", 0.2, device="cpu")
    fused, stats = sm.match_consecutive(scans.points, scans.mask, scans.normals,
                                        rel_odo, CFG, "icppointplane",
                                        progress=False)
    return scans, rel_odo, fused, stats


def _run(inputs, ck, key=7):
    scans, rel_odo = inputs[:2]
    return sm.match_consecutive(scans.points, scans.mask, scans.normals,
                                rel_odo, CFG, "icppointplane", progress=False,
                                checkpoint_path=ck, checkpoint_key=key)


@pytest.fixture(scope="module")
def checkpointed(matcher_inputs, tmp_path_factory):
    """A checkpointed run of every group: its transforms, its stats and
    the checkpoint it leaves behind."""
    ck = str(tmp_path_factory.mktemp("checkpointed") / "ck.npz")
    full, st = _run(matcher_inputs, ck)
    return full, st, dict(np.load(ck))


def test_resume_mid_stage(matcher_inputs, checkpointed, tmp_path):
    """tests/test_pipeline.py::TestCheckpointResume, bit for bit: a
    checkpointed run gives the fused run's transforms and stats; cut back
    to 2 groups with the later transforms zeroed, it resumes to the same
    transforms, running only the missing groups."""
    fused, stats = matcher_inputs[2:]
    ck = str(tmp_path / "ck.npz")
    full, st = checkpointed[:2]
    np.testing.assert_array_equal(full, fused)
    for k in stats:
        np.testing.assert_array_equal(st[k], stats[k], k)
    saved = {k: v.copy() for k, v in checkpointed[2].items()}
    assert int(saved["batches_done"]) == 4 and int(saved["n_pairs"]) == N_SCANS - 1
    saved["batches_done"] = 2
    saved["transforms"][8:] = 0.0
    np.savez(ck, **saved)
    resumed, st = _run(matcher_inputs, ck)
    np.testing.assert_array_equal(resumed, fused)
    assert (st["iterations"][:8] == -1).all()
    np.testing.assert_array_equal(st["iterations"][8:], stats["iterations"][8:])
    assert int(np.load(ck)["batches_done"]) == 4


@pytest.mark.parametrize("bad", ["key", "n_pairs", "batch_size", "garbage"])
def test_mismatched_or_unreadable_checkpoint_recomputes(matcher_inputs, tmp_path, bad):
    fused = matcher_inputs[2]
    ck = str(tmp_path / "ck.npz")
    fields = dict(key=7, n_pairs=N_SCANS - 1, batch_size=CFG.batch_size,
                  batches_done=3, transforms=np.zeros((N_SCANS - 1, 4, 4)))
    if bad == "garbage":
        with open(ck, "wb") as f:
            f.write(b"not an npz")
    else:
        fields[bad] += 1
        np.savez(ck, **fields)
    out, _ = _run(matcher_inputs, ck)
    np.testing.assert_array_equal(out, fused)


def test_checkpoints_cross_between_the_packages(matcher_inputs, checkpointed, tmp_path):
    """The port's checkpoint, cut back by one group, resumes in the JAX
    package, which writes the last group's transforms in its own format;
    the port then reads that checkpoint as complete and returns it whole:
    the port's groups, then the JAX package's last group."""
    scans, rel_odo, fused = matcher_inputs[:3]
    ck = str(tmp_path / "ck.npz")
    saved = dict(checkpointed[2])
    saved["batches_done"] = 3
    np.savez(ck, **saved)
    cfg_ref = IcpConfigRef(**{k: getattr(CFG, k) for k in
                              ("raw_capacity", "capacity", "batch_size",
                               "max_iterations")})
    j = lambda t: jnp.asarray(t.numpy())
    ref = sm_ref.match_consecutive(j(scans.points), j(scans.mask),
                                   j(scans.normals), rel_odo, cfg_ref,
                                   "icppointplane", progress=False,
                                   checkpoint_path=ck, checkpoint_key=7)
    np.testing.assert_array_equal(ref[:12], fused[:12])
    written = np.load(ck)
    assert sorted(written.files) == ["batch_size", "batches_done", "key",
                                     "n_pairs", "transforms"]
    assert int(written["batches_done"]) == 4
    got, st = _run(matcher_inputs, ck)
    np.testing.assert_array_equal(got, ref)
    assert (st["iterations"] == -1).all() and not st["fell_back"].any()
    # the last group agrees with the port's own within ICP parity
    np.testing.assert_allclose(ref[12:], fused[12:], atol=1e-3)


def test_run_scanmatcher_checkpoint_file(dataset, tmp_path):
    """run_scanmatcher with checkpoint_batches: the reference's path and key
    (a prepared complete checkpoint is taken as is), and no checkpoint
    left once the stage completes."""
    d = str(tmp_path / "ds")
    shutil.copytree(dataset[0], d)
    cfg = IcpConfig(**{**CFG.__dict__, "checkpoint_batches": 1})
    ck = f"{d}/robot0/scanmatcher/checkpoint.npz"
    out = sm.run_scanmatcher(d, cfg=cfg, device="cpu", progress=False)
    assert not os.path.exists(ck)
    plain = sm.run_scanmatcher(d, cfg=CFG, device="cpu", progress=False)
    np.testing.assert_array_equal(out["relative"], plain["relative"])
    scan_times = out["scan_times"]
    key = int(np.int64(np.sum(scan_times)) & 0x7FFFFFFF)
    marked = np.tile(np.eye(4), (len(scan_times) - 1, 1, 1))
    marked[:, 0, 3] = 0.25
    os.makedirs(os.path.dirname(ck), exist_ok=True)
    np.savez(ck, key=key, n_pairs=len(marked), batch_size=CFG.batch_size,
             batches_done=4, transforms=marked)
    resumed = sm.run_scanmatcher(d, cfg=cfg, device="cpu", progress=False)
    np.testing.assert_array_equal(resumed["relative"], marked)
    assert resumed["profile"]["pairs_resumed_from_checkpoint"] == len(marked)
    assert not os.path.exists(ck)


def test_sample_odometry_matches_reference(dataset):
    d, _ = dataset
    odo = EurocDataset(d).read_csv("/robot0/odom/data.csv")
    for dxy, dth in ((0.5, 0.2), (2.0, 0.05), (0.0, 10.0)):
        times, rows = sampling.sample_odometry(odo, dxy, dth)
        times_ref, df = sampling_ref.sample_odometry(pd.DataFrame(odo), dxy, dth)
        np.testing.assert_array_equal(times, times_ref)
        assert list(rows) == list(df.columns)
        for k in df.columns:
            np.testing.assert_array_equal(rows[k], df[k].to_numpy(), k)
    assert 1 < len(sampling.sample_odometry(odo, 2.0, 0.05)[0]) < len(odo["x"])


def test_resume_keeps_the_fpfh_group_draws(dataset, tmp_path):
    """Under fpfh, group g draws its RANSAC from ``manual_seed(g)``, so a
    group run after a resume draws what it drew uninterrupted."""
    d, _ = dataset
    euroc = EurocDataset(d)
    scan_times, _, _, odo, _ = sm.prepare_experiment_data(euroc, 0, 1.0)
    rel_odo = sm.relative_odometry(odo)[:8]
    scans, _, _ = sm.load_and_preprocess_streamed(
        euroc, scan_times[:9], CFG, "fpfh", 0.2, device="cpu")
    args = (scans.points, scans.mask, scans.normals, rel_odo, CFG, "fpfh")
    masks = dict(ground_mask=scans.ground_mask,
                 nonground_mask=scans.nonground_mask, progress=False)
    fused, _ = sm.match_consecutive(*args, **masks)
    ck = str(tmp_path / "ck.npz")
    saved = dict(key=3, n_pairs=8, batch_size=CFG.batch_size, batches_done=1,
                 transforms=fused.copy())
    saved["transforms"][4:] = 0.0
    np.savez(ck, **saved)
    resumed, st = sm.match_consecutive(*args, **masks, checkpoint_path=ck,
                                       checkpoint_key=3)
    np.testing.assert_array_equal(resumed, fused)
    assert (st["iterations"][:4] == -1).all() and (st["iterations"][4:] >= 0).all()
