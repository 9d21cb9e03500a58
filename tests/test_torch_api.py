"""The rest of the port's public API vs the JAX package: the cloud helpers,
raw-moment normals, the YAML subset and ``IcpConfig.from_yaml``, the empty
factor buffers, ``io.native.available``, and the rule that every entry
point defaults to the card.

Tolerances:

* ``to_numpy`` and ``num_valid``: exact.  ``voxel_downsample``: bit-equal
  to the port's ``voxel_downsample_counted(...)[0]``; against the JAX
  package, mask exact and centroids within 1e-5 m, as
  ``test_torch_geom_cloud.py`` holds ``voxel_downsample_counted`` (the
  reference sums each voxel in f32, the port in float64).
* ``radius_accumulate``: the matmul form d2 = (|q|^2 + |t|^2) - 2 q.t
  rounds differently in the two packages (another BLAS), so a target whose
  exact d2 lies within the rounding band of r^2, 8 u (|q|^2 + |t|^2 + r^2)
  with u = 2^-24, may count on either side.  Counts are exact for every
  query with no valid target in that band; a query with one may differ by
  at most its band targets.  Where the counts agree, S1 and S2 agree
  within 1e-5 of count x max|p| (S1) and count x max|p|^2 (S2): sums of
  up to count f32 terms of that size in another order.
* Normals: |n . n'| > 0.999 on a smooth sheet (tests/test_cloud_ops.py's
  check of its two routes).
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from lidar_slam_arvc_tpu import cloud as cl_ref
from lidar_slam_arvc_tpu.graph import factors as factors_ref
from lidar_slam_arvc_tpu.ops.nn import radius_accumulate as radius_accumulate_ref
from lidar_slam_arvc_tpu.utils.config import IcpConfig as IcpConfigRef
import lidar_slam_arvc_tpu_torch
from lidar_slam_arvc_tpu_torch import cloud as cl
from lidar_slam_arvc_tpu_torch.cloud.cloud import pad_numpy
from lidar_slam_arvc_tpu_torch import io as io_port
from lidar_slam_arvc_tpu_torch import pipeline
from lidar_slam_arvc_tpu_torch.graph import graph_cost, make_factor_buffers, make_factor_data
from lidar_slam_arvc_tpu_torch.graph.factors import FACTOR_FIELDS
from lidar_slam_arvc_tpu_torch.io import formats, native
from lidar_slam_arvc_tpu_torch.ops.nn import radius_accumulate
from lidar_slam_arvc_tpu_torch.utils import synthetic
from lidar_slam_arvc_tpu_torch.utils.config import IcpConfig

torch.set_num_threads(1)

U32 = 2.0 ** -24
MOMENT_RTOL = 1e-5


def _scans(rng, b=2, n_points=1500, cap=2048):
    world = synthetic.make_world(rng, extent=20.0, n_ground=4000,
                                 n_pillars=10, pillar_pts=200)
    return [pad_numpy(synthetic.render_scan(
        world, synthetic._yaw_T(0.5 * i, 0.1 * i, 0.0), rng,
        max_points=n_points - 100 * i), cap) for i in range(b)]


# ----------------------------------------------------------- cloud helpers

def test_to_numpy_and_num_valid_match_reference():
    rng = np.random.default_rng(0)
    scans = _scans(rng)
    for pts, mask in scans:
        ref = cl_ref.Cloud(jnp.asarray(pts), jnp.asarray(mask))
        got = cl.from_arrays(pts, mask, device="cpu")
        np.testing.assert_array_equal(cl.to_numpy(got), cl_ref.to_numpy(ref))
        assert cl.num_valid(got).dtype == torch.int32
        assert int(cl.num_valid(got)) == int(cl_ref.num_valid(ref))
    batch = cl.Cloud(torch.from_numpy(np.stack([p for p, _ in scans])),
                     torch.from_numpy(np.stack([m for _, m in scans])))
    rows = cl.to_numpy(batch)
    assert len(rows) == len(scans)
    for (pts, mask), r in zip(scans, rows):
        np.testing.assert_array_equal(r, pts[mask])
    np.testing.assert_array_equal(cl.num_valid(batch).numpy(),
                                  [m.sum() for _, m in scans])
    with pytest.raises(ValueError, match="mask shape"):
        cl.to_numpy(cl.Cloud(batch.points[None], batch.mask[None]))


@pytest.mark.parametrize("out_capacity", [None, 600])
def test_voxel_downsample(out_capacity):
    rng = np.random.default_rng(1)
    (pts, mask), = _scans(rng, b=1)
    c = cl.from_arrays(pts, mask, device="cpu")
    got = cl.voxel_downsample(c, 0.2, out_capacity)
    want = cl.voxel_downsample_counted(c, 0.2, out_capacity)[0]
    assert torch.equal(got.points, want.points) and torch.equal(got.mask, want.mask)
    ref = cl_ref.voxel_downsample(cl_ref.Cloud(jnp.asarray(pts), jnp.asarray(mask)),
                                  0.2, out_capacity)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points),
                               rtol=0, atol=1e-5)


def test_from_numpy_defaults_to_the_card():
    """With no card the default device raises instead of moving the cloud
    to the CPU (the port's rule: entry points default to cuda)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    with pytest.raises((RuntimeError, AssertionError)):
        cl.from_numpy(np.zeros((5, 3), np.float32), 8)


# ------------------------------------------------------ raw-moment normals

def _band_rows(q, t, tmask, r):
    """Per query: the number of valid targets whose exact d2 lies within
    the f32 rounding band of r^2."""
    q64, t64 = q.astype(np.float64), t.astype(np.float64)
    d2 = ((q64[:, None, :] - t64[None, :, :]) ** 2).sum(-1)
    r2 = float(np.float32(r) * np.float32(r))
    scale = (q64 ** 2).sum(-1)[:, None] + (t64 ** 2).sum(-1)[None, :] + r2
    return ((np.abs(d2 - r2) <= 8 * U32 * scale) & tmask[None, :]).sum(1)


def _cloud_pair(kind, rng):
    """(queries (Q, 3), targets (T, 3), target mask (T,), radius): Q and T
    not multiples of the blocks used below."""
    if kind == "near":
        q = rng.normal(size=(300, 3)).astype(np.float32)
        t = rng.normal(size=(500, 3)).astype(np.float32)
        return q, t, rng.uniform(size=500) > 0.3, 0.9
    # 10-30 m from the origin, where |t|^2 - 2 q.t cancels
    off = np.float32([18.0, -9.0, 3.0])
    q = (rng.uniform(-1, 1, size=(300, 3)) + off).astype(np.float32)
    t = (rng.uniform(-1, 1, size=(500, 3)) + off).astype(np.float32)
    return q, t, rng.uniform(size=500) > 0.2, 0.5


@pytest.mark.parametrize("kind", ["near", "far"])
def test_radius_accumulate_matches_reference(kind):
    rng = np.random.default_rng(2)
    pairs = [_cloud_pair(kind, rng) for _ in range(2)]
    r = pairs[0][3]
    got = radius_accumulate(*(torch.from_numpy(np.stack([p[i] for p in pairs]))
                              for i in range(3)), r, query_block=128,
                            tgt_block=256)
    n_band = 0
    for b, (q, t, m, _) in enumerate(pairs):
        ref = [np.asarray(x) for x in radius_accumulate_ref(
            jnp.asarray(q), jnp.asarray(t), jnp.asarray(m), r,
            query_block=128, tgt_block=256)]
        count, s1, s2 = (x[b].numpy() for x in got)
        assert count.shape == (300,) and s1.shape == (300, 3) and s2.shape == (300, 6)
        band = _band_rows(q, t, m, r)
        clear = band == 0
        n_band += int((~clear).sum())
        np.testing.assert_array_equal(count[clear], ref[0][clear])
        assert np.all(np.abs(count - ref[0]) <= band)
        same = count == ref[0]
        pmax = float(np.abs(t[m]).max())
        for k, (g, w) in enumerate(((s1, ref[1]), (s2, ref[2]))):
            tol = MOMENT_RTOL * count[same][:, None] * pmax ** (k + 1) + 1e-6
            assert np.all(np.abs(g[same] - w[same]) <= tol), (k, np.abs(g - w).max())
    # the exclusion leaves most rows in (far: a 4e-4 m shell at r = 0.5 m)
    assert n_band < 0.2 * 2 * 300


def test_radius_accumulate_counts_brute_force():
    """Masked targets never count; every clear query's count is the
    brute-force count."""
    rng = np.random.default_rng(3)
    q, t, m, r = _cloud_pair("near", rng)
    count, s1, _ = radius_accumulate(torch.from_numpy(q), torch.from_numpy(t),
                                     torch.from_numpy(m), r, query_block=64,
                                     tgt_block=100)
    d2 = ((q[:, None].astype(np.float64) - t[None]) ** 2).sum(-1)
    w = (d2 <= np.float32(r) ** 2) & m[None]
    clear = _band_rows(q, t, m, r) == 0
    np.testing.assert_array_equal(count.numpy()[clear], w.sum(1)[clear])
    np.testing.assert_allclose(s1.numpy()[clear], (w @ t)[clear], rtol=0, atol=1e-4)


def _sheet():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-3, 3, size=(300, 3)).astype(np.float32)
    pts[:, 2] = 0.3 * np.sin(pts[:, 0])        # smooth sheet
    return pts


def _dots(a, b, mask):
    return np.abs(np.sum(a.normals.numpy()[mask] * np.asarray(b.normals)[mask], axis=1))


def test_normals_xla_matches_reference_and_k2_route():
    pts = _sheet()
    c = cl.from_numpy(pts, 512, device="cpu")
    m = c.mask.numpy()
    xla = cl.estimate_normals(c, radius=0.8, impl="xla")
    ref = cl_ref.estimate_normals(cl_ref.from_numpy(pts, 512), radius=0.8, impl="xla")
    assert _dots(xla, ref, m).min() > 0.999
    for impl in ("auto", "pallas"):
        k2 = cl.estimate_normals(c, radius=0.8, impl=impl)
        assert _dots(xla, k2, m).min() > 0.999
    assert torch.equal(cl.estimate_normals(c, radius=0.8).normals,
                       cl.estimate_normals(c, radius=0.8, impl="auto").normals)


@pytest.mark.parametrize("impl", ["pallas_interpret", "vpu", ""])
def test_normals_unknown_impl_raises(impl):
    c = cl.from_numpy(_sheet(), 512, device="cpu")
    with pytest.raises(ValueError, match="auto|pallas|xla"):
        cl.estimate_normals(c, radius=0.8, impl=impl)


# ------------------------------------------------------ YAML and IcpConfig

ICP_YAML = """\
# the reference's config/icp_parameters.yaml layout
filter_by_radius:
  max_radius: 30.0
  min_radius: 1.5
filter_by_height:
  max_height: 40.0   # m
  min_height: -2.0
down_sample:
  voxel_size: 0.25
icp:
  distance_threshold: 5
"""

NESTED = {
    "icp_parameters": ICP_YAML,
    "deep": "a:\n  b:\n    c: 1\n    d: [x]\n  e: ~\nf: yes\n".replace(" [x]", "\n      - x\n      - 2.5"),
    "list_at_key_indent": "a:\n  b:\n  - 1\n  - two\n  c: .inf\n",
    "empty_values": "a:\nb:\n    c: null\n    d:\n",
    "quotes_comments": "a:\n  b: 'x: y'  # c\n  c: \"#z\"\n",
}


@pytest.mark.parametrize("case", list(NESTED))
def test_load_yaml_nested_matches_safe_load(case):
    text = NESTED[case]
    assert formats.load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a:\n  - 1\n    - 2\n", "- 1\n", "a: 1\n  b: 2\n",
                                  "a:\n  b:\n    - 1\n    c: 2\n"])
def test_load_yaml_rejects_outside_the_subset(text):
    with pytest.raises(ValueError, match="YAML subset"):
        formats.load_yaml(text)


@pytest.mark.parametrize("overrides", [{}, {"voxel_size": None, "capacity": 4096,
                                            "max_radius": 12.0}])
def test_icp_config_from_yaml_matches_reference(tmp_path, overrides):
    path = tmp_path / "icp_parameters.yaml"
    path.write_text(ICP_YAML)
    got = IcpConfig.from_yaml(str(path), **overrides)
    ref = IcpConfigRef.from_yaml(str(path), **overrides)
    import dataclasses
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.min_radius == 1.5 and got.distance_threshold == 5


# ------------------------------------------------------------ the remainder

def test_make_factor_buffers_empty_graph():
    bufs = make_factor_buffers(5, 3, 2)
    ref = factors_ref.make_factor_buffers(5, 3, 2)
    assert tuple(bufs) == FACTOR_FIELDS
    for k in FACTOR_FIELDS:
        a, b = bufs[k], np.asarray(getattr(ref, k))
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    f = make_factor_data(16, "cpu", **bufs)
    assert f.bt_i.numel() == f.gps_i.numel() == f.pr_i.numel() == 0
    poses = torch.eye(4).expand(16, 4, 4).contiguous()
    assert float(graph_cost(poses, f)) == 0.0


def test_native_parser_available():
    assert native.available() is True


def test_exports_of_the_reference():
    assert io_port.ingest_bag is importlib.import_module(
        "lidar_slam_arvc_tpu_torch.io.rosbag").ingest_bag
    assert callable(io_port.read_bag)
    assert pipeline.run_scanmatcher is importlib.import_module(
        "lidar_slam_arvc_tpu_torch.pipeline.scanmatcher").run_scanmatcher
    assert pipeline.run_graphslam is importlib.import_module(
        "lidar_slam_arvc_tpu_torch.pipeline.graphslam").run_graphslam


# --------------------------------------------------------- device defaults

# helpers whose device the caller always passes, with the reason
INTERNAL_DEVICE_DEFAULTS = {
    "lidar_slam_arvc_tpu_torch.ops.draws.uniform_draws":
        "the uniforms come from CPU generators; both callers (cloud/plane.py, "
        "registration/global_reg.py) pass the clouds' device",
}


def _device_defaults():
    """{qualified name: default} of every function and method of the port
    whose ``device`` parameter has a default."""
    out = {}
    for m in pkgutil.walk_packages(lidar_slam_arvc_tpu_torch.__path__,
                                   "lidar_slam_arvc_tpu_torch."):
        mod = importlib.import_module(m.name)
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != m.name:
                continue
            members = ([(f"{name}.{k}", v) for k, v in vars(obj).items()]
                       if inspect.isclass(obj) else [(name, obj)])
            for qual, f in members:
                f = getattr(f, "__func__", f)
                if not callable(f):
                    continue
                try:
                    p = inspect.signature(f).parameters.get("device")
                except (TypeError, ValueError):
                    continue
                if p is not None and p.default is not inspect.Parameter.empty:
                    out[f"{m.name}.{qual}"] = p.default
    return out


def test_every_device_default_is_the_card():
    """No function of the port defaults to the CPU: the subpackages'
    exports (``cloud.from_numpy``/``from_arrays``, ``parallel.launch``,
    ``PoseGraph``, ``KeyframeStore``) and every other module's, apart from
    the listed internal helpers."""
    found = _device_defaults()
    for name in ("lidar_slam_arvc_tpu_torch.cloud.cloud.from_numpy",
                 "lidar_slam_arvc_tpu_torch.cloud.cloud.from_arrays",
                 "lidar_slam_arvc_tpu_torch.parallel.mesh.launch",
                 "lidar_slam_arvc_tpu_torch.parallel.dryrun.tiny_pair_batch"):
        assert name in found
    wrong = {k: v for k, v in found.items()
             if str(v) != "cuda" and k not in INTERNAL_DEVICE_DEFAULTS}
    assert not wrong
    for k in INTERNAL_DEVICE_DEFAULTS:
        assert k in found
