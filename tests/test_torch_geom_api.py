"""The port's public geometry API (``geom.__all__``) vs the JAX package's.

Every one of the 32 names runs on the same float32 numpy inputs, made from
a seed, through ``lidar_slam_arvc_tpu.geom`` (JAX on the CPU, jitted) and
``lidar_slam_arvc_tpu_torch.geom``, batched over leading dimensions and on
the degenerate inputs of ``tests/test_geom.py``: zero quaternions,
rotations near pi, gimbal lock, slerp between q and -q and between nearly
equal q.  Tolerances (absolute, f32; measured on this CPU in brackets):
1e-6 on rotation entries, quaternions and angles [<= 7.2e-7; angles
compared modulo 2 pi]; 2e-6 on ``euler_to_quat`` [1.07e-6, see
QUAT_OF_R_ATOL]; 3e-6 rad on ``so3_log`` [1.4e-6 at angles up to pi];
translations 1e-6 of the array's largest coordinate [3.8e-6 at ~40 m].
Trajectories: 257 poses (chip_smoke's phase-4 length) through
``global_transforms``, whose log-depth scan combines in another order than
the reference's ``associative_scan``: bound 1e-4 m and 2e-5 on rotation
entries [1.34e-5 m and 1.0e-6 from the JAX package, 9.2e-6 m and 8.0e-7
from a float64 sequential fold, at positions of up to 19 m].
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as SR

import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu import geom as G
from lidar_slam_arvc_tpu_torch import geom as P

torch.set_num_threads(1)
f32 = np.float32

ROT_ATOL = 1e-6
LOG_ATOL = 3e-6
# euler_to_quat = rot_to_quat(euler_to_rot): the packages' sin/cos differ
# by 1 ulp in R, and the vector part sqrt(1 - s^2) scales that by
# s / sqrt(1 - s^2) near the identity (measured 1.07e-6)
QUAT_OF_R_ATOL = 2e-6
# translations: relative to the largest coordinate of the array (sums of
# 3-4 f32 products of that size round to a few ulp of it)
POS_RTOL = 1e-6
ANGLE_OUTPUTS = {"normalize_angle", "rot_to_euler", "rot_to_euler_both",
                 "quat_to_euler"}
CHAIN = 257
CHAIN_ROT_ATOL = 2e-5
CHAIN_POS_ATOL = 1e-4


def _rots(n, seed=1):
    return SR.random(n, random_state=seed).as_matrix().astype(f32)


def _near_pi():
    """tests/test_geom.py::test_near_pi_rotations' rotations, and 64 more
    random axes at pi - [0, 1e-3)."""
    rng = np.random.default_rng(5)
    axes = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 1, 1]]
    axes = np.concatenate([np.array(axes, float), rng.normal(size=(64, 3))])
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angle = np.concatenate([np.full(5, np.pi - 1e-5),
                            np.pi - rng.uniform(0, 1e-3, 64)])
    return SR.from_rotvec(axes * angle[:, None]).as_matrix().astype(f32)


def _quats(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(f32)
    q.reshape(-1, 4)[:3] = 0.0            # zero quaternions -> identity
    return q


def _euler(rng, n):
    abg = rng.uniform(-np.pi, np.pi, (n, 3)).astype(f32)
    abg[:8, 1] = np.pi / 2                 # gimbal lock, both signs
    abg[8:16, 1] = -np.pi / 2
    return abg


def _transforms(rng, n, scale=10.0):
    T = np.tile(np.eye(4, dtype=f32), (n, 1, 1))
    T[:, :3, :3] = _rots(n, seed=int(rng.integers(1 << 30)))
    T[:, :3, 3] = rng.normal(scale=scale, size=(n, 3))
    return T


def _chain(rng, n=CHAIN):
    """A smooth f32 trajectory of n poses from the identity, positions up
    to ~40 m."""
    rv = np.cumsum(rng.normal(scale=0.05, size=(n, 3)), axis=0)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = SR.from_rotvec(rv).as_matrix()
    T[:, :3, 3] = np.cumsum(rng.normal(size=(n, 3)), axis=0)
    return (np.linalg.inv(T[0]) @ T).astype(f32)


@jax.jit
def _derived(R, abg, w, xi):
    """The inputs made by the JAX package, as one compiled program (this
    runs at collection, in every worker)."""
    return (G.rot_to_quat(R[:16]), G.rot_to_quat(R[16:32]), G.euler_to_rot(abg),
            G.so3_exp(w), G.so3_hat(w), G.se3_exp(xi))


def _cases():
    rng = np.random.default_rng(0)
    R = _rots(48)
    q = _quats(rng, (3, 16))
    t = rng.uniform(size=16).astype(f32)
    abg = _euler(rng, 48)
    noisy = (R + rng.normal(scale=1e-3, size=R.shape)).astype(f32)
    w = rng.normal(size=(2, 24, 3)).astype(f32)
    w[0, :4] *= 1e-7                        # the Taylor branches
    xi = rng.normal(size=(32, 6)).astype(f32)
    q1, q2, R_lock, R_w, W_w, T_xi = map(np.asarray, _derived(R, abg, w, xi))
    Ta, Tb = _transforms(rng, 32), _transforms(rng, 32)
    pos = rng.normal(scale=10.0, size=(32, 3)).astype(f32)
    pts = rng.normal(scale=10.0, size=(32, 50, 3)).astype(f32)
    return {
        "quat_to_rot": [("quat_to_rot", (q,))],
        "rot_to_quat": [("rot_to_quat", (R,)), ("rot_to_quat", (noisy,)),
                        ("rot_to_quat", (Ta,))],
        "quat_multiply": [("quat_multiply", (q, q[::-1].copy()))],
        "quat_conjugate": [("quat_conjugate", (q,))],
        "quat_normalize": [("quat_normalize", (q,))],
        "quat_slerp": [("quat_slerp", (q1, q2, t)),
                       ("quat_slerp", (q1, -q1, t)),
                       ("quat_slerp", (q1, (q1 + 1e-6).astype(f32), t)),
                       ("quat_slerp", (q1, q2, 0.3)),
                       ("quat_slerp", (q1, q2, 0.0)),
                       ("quat_slerp", (q1, q2, 1.0))],
        "euler_to_rot": [("euler_to_rot", (abg,))],
        "rot_to_euler": [("rot_to_euler", (R,)), ("rot_to_euler", (R_lock,))],
        "rot_to_euler_both": [("rot_to_euler_both", (R,)),
                              ("rot_to_euler_both", (R_lock,))],
        "euler_to_quat": [("euler_to_quat", (abg,))],
        "quat_to_euler": [("quat_to_euler", (q,))],
        "normalize_angle": [("normalize_angle", (
            np.concatenate([rng.uniform(-20, 20, 64), [np.pi, -np.pi, 0.0]]
                           ).astype(f32),))],
        "so3_exp": [("so3_exp", (w,))],
        "so3_log": [("so3_log", (R,)), ("so3_log", (_near_pi(),)),
                    ("so3_log", (R_w,))],
        "so3_hat": [("so3_hat", (w,))],
        "so3_vee": [("so3_vee", (W_w,))],
        "make_transform": [("make_transform", (pos, R[:32])),
                           ("make_transform", (pos, R[0]))],
        "transform_from_quat": [("transform_from_quat", (pos, q.reshape(-1, 4)[:32]))],
        "transform_from_euler": [("transform_from_euler", (pos, abg[:32]))],
        "compose": [("compose", (Ta, Tb))],
        "inverse": [("inverse", (Ta,))],
        "transform_points": [("transform_points", (Ta, pts))],
        "positions": [("positions", (Ta,))],
        "rotations": [("rotations", (Ta,))],
        "t2v": [("t2v", (Ta,))],
        "se3_exp": [("se3_exp", (xi,))],
        "se3_log": [("se3_log", (T_xi,))],
        "relative_transforms": [("relative_transforms", (Ta,))],
        "global_transforms": [("global_transforms", (Ta[:9],)),
                              ("global_transforms", (Ta[:9], Tb[0], Tb[1]))],
        "multiply_by_transform": [("multiply_by_transform", (Ta, Tb[0]))],
        "transforms_from_pose_columns": [("transforms_from_pose_columns",
                                          (pos, q.reshape(-1, 4)[:32]))],
        "pose_columns_from_transforms": [("pose_columns_from_transforms", (Ta,))],
    }


CASES = _cases()
PARAMS = [pytest.param(name, k, id=f"{name}-{k}")
          for name, calls in CASES.items() for k in range(len(calls))]


def _pos_atol(ref):
    return POS_RTOL * max(float(np.abs(ref).max(initial=0)), 1.0)


def _outputs(x):
    return list(x) if isinstance(x, tuple) else [x]


def _diff(name, got, ref):
    d = got.astype(np.float64) - ref
    if name in ANGLE_OUTPUTS:
        d = np.angle(np.exp(1j * d))
    return np.abs(d)


def test_all_names_covered():
    """The port's geom exports exactly the JAX package's 32 names, and
    each is exercised below."""
    assert sorted(P.__all__) == sorted(G.__all__)
    assert len(P.__all__) == 32
    assert sorted(CASES) == sorted(G.__all__)


@pytest.mark.parametrize("name,k", PARAMS)
def test_geom_name_matches_reference(name, k):
    fn, args = CASES[name][k]
    # one compiled program per call: faster on the CPU than op-by-op
    ref = _outputs(jax.jit(getattr(G, fn))(*[jnp.asarray(a) for a in args]))
    got = _outputs(getattr(P, fn)(*[torch.from_numpy(np.array(a))
                                    if isinstance(a, np.ndarray) else a
                                    for a in args]))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype
        d = _diff(fn, g, r)
        if g.shape[-2:] == (4, 4):
            assert d[..., :3, :3].max(initial=0) <= ROT_ATOL, fn
            assert d[..., :3, 3].max(initial=0) <= _pos_atol(r[..., :3, 3]), fn
            assert np.array_equal(g[..., 3, :], r[..., 3, :]), fn
        elif fn in ("positions", "transform_points") or \
                (fn == "pose_columns_from_transforms" and g.shape[-1] == 3):
            assert d.max(initial=0) <= _pos_atol(r), fn
        elif fn in ("t2v", "se3_log"):
            # [translation (3), rotation (3)], the order each returns
            pos, rot = (d[..., :3], d[..., 3:]) if fn == "t2v" else (d[..., 3:], d[..., :3])
            assert pos.max() <= _pos_atol(r), fn
            assert rot.max() <= LOG_ATOL, fn
        else:
            atol = {"so3_log": LOG_ATOL, "euler_to_quat": QUAT_OF_R_ATOL}.get(fn, ROT_ATOL)
            assert d.max(initial=0) <= atol, (fn, d.max())


def test_rot_to_quat_near_pi_sign_fixed():
    """tests/test_geom.py's near-pi probe: q and -q are one rotation, so
    the comparison fixes the sign; the JAX form gives w >= 0."""
    R = _near_pi()
    ref = np.asarray(jax.jit(G.rot_to_quat)(jnp.asarray(R)))
    got = P.rot_to_quat(torch.from_numpy(R)).numpy()
    assert (got[:, 0] >= 0).all()
    sign = np.where(np.sum(got * ref, axis=-1) < 0, -1.0, 1.0)[:, None]
    np.testing.assert_allclose(got * sign, ref, rtol=0, atol=ROT_ATOL)
    # test_geom.py's round trip, on its own five rotations (at pi - 1e-3
    # the f32 trace alone moves w by ~5%, in either package)
    back = P.quat_to_rot(torch.from_numpy(got[:5])).numpy()
    np.testing.assert_allclose(back, R[:5], rtol=0, atol=1e-5)


def test_quat_edge_cases():
    """Zero quaternions normalise to the identity; slerp takes the short
    path between q and -q (q1 flips to -q: the same rotation at every t)
    and returns the endpoints at t = 0 and 1."""
    z = torch.zeros(2, 4)
    assert torch.equal(P.quat_normalize(z), torch.tensor([[1.0, 0, 0, 0]] * 2))
    assert torch.equal(P.quat_to_rot(z), torch.eye(3).expand(2, 3, 3))
    q = P.quat_normalize(torch.tensor([0.3, -0.2, 0.5, 0.1]))
    for t in (0.0, 0.5, 1.0):
        torch.testing.assert_close(P.quat_slerp(q, -q, t), -q, rtol=0, atol=1e-7)
    r = P.quat_normalize(torch.tensor([0.4, 0.1, 0.6, -0.2]))   # q . r > 0
    torch.testing.assert_close(P.quat_slerp(q, r, 0.0), q, rtol=0, atol=1e-7)
    torch.testing.assert_close(P.quat_slerp(q, r, 1.0), r, rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_frames", [False, True])
def test_trajectory_roundtrip_257_poses(with_frames):
    """relative_transforms -> global_transforms at 257 poses, with and
    without T0 and Trobot_gps: against the JAX package, a float64
    sequential fold of the same relative transforms, and the input."""
    rng = np.random.default_rng(11)
    T = _chain(rng)
    T0 = T[0] if with_frames else None
    Tg = _transforms(rng, 1, scale=0.5)[0] if with_frames else None
    rel_ref = np.asarray(jax.jit(G.relative_transforms)(jnp.asarray(T)))
    rel = P.relative_transforms(torch.from_numpy(T))
    np.testing.assert_allclose(rel.numpy(), rel_ref, rtol=0, atol=1e-5)
    opt = [None if a is None else torch.from_numpy(a) for a in (T0, Tg)]
    got = P.global_transforms(rel, *opt).numpy()
    ref = np.asarray(jax.jit(G.global_transforms)(
        jnp.asarray(rel.numpy()), *[None if a is None else jnp.asarray(a)
                                    for a in (T0, Tg)]))
    fold = [np.eye(4) if T0 is None else T0.astype(np.float64)]
    for r in rel.numpy().astype(np.float64):
        fold.append(fold[-1] @ r)
    fold = np.stack(fold)
    if Tg is not None:
        fold = fold @ Tg.astype(np.float64)
    assert got.shape == (CHAIN, 4, 4)
    for other in (ref, fold):
        d = np.abs(got - other)
        assert d[:, :3, :3].max() <= CHAIN_ROT_ATOL
        assert d[:, :3, 3].max() <= CHAIN_POS_ATOL
    if not with_frames:
        d = np.abs(got - T)
        assert d[:, :3, :3].max() <= CHAIN_ROT_ATOL
        assert d[:, :3, 3].max() <= CHAIN_POS_ATOL


def test_global_transforms_log_depth():
    """global_transforms composes ceil(log2 N) batched steps, not N - 1:
    counted through the port's compose."""
    from lidar_slam_arvc_tpu_torch.geom import se3
    calls = []
    real = se3.compose

    def counting(a, b):
        calls.append(a.shape[0])
        return real(a, b)

    se3.compose = counting
    try:
        P.global_transforms(torch.eye(4).expand(CHAIN - 1, 4, 4).contiguous())
    finally:
        se3.compose = real
    assert len(calls) == int(np.ceil(np.log2(CHAIN)))


def test_rot_to_quat_within_its_f32_rounding_of_the_float64_mirror():
    """``rot_to_quat`` in f32 (the JAX package's form) against its float64
    host mirror on the same f32 matrices: near pi, near the identity and
    anywhere between.  The trace's rounding, up to 4 u, moves
    w = sqrt(trace + 1) / 2 by u / w and the vector part sqrt(1 - w^2) by
    u / |v|, so the bound is 1e-6 + 4 u / max(min(w, |v|), 1e-3), as
    ``chip_smoke.py`` phase 14 (a) holds the card to it.  The w term alone
    does not hold near the identity: there the vector part carries the
    whole error (all of it below ~3e-4 rad, where trace + 1 rounds to 4)."""
    from lidar_slam_arvc_tpu_torch.geom import hostmath

    rng = np.random.default_rng(12)
    n = 3000
    yaw = np.concatenate([rng.uniform(-0.1, 0.1, n), rng.uniform(-np.pi, np.pi, n),
                          np.pi - rng.uniform(0, 1e-2, n)])
    rot = SR.from_euler("xyz", np.stack([rng.normal(scale=2e-4, size=3 * n),
                                         rng.normal(scale=2e-4, size=3 * n), yaw], 1))
    R = rot.as_matrix().astype(f32)
    qh = hostmath.rot_to_quat_np(R)
    got = P.rot_to_quat(torch.from_numpy(R)).numpy().astype(np.float64)
    sign = np.where(np.sum(got * qh, axis=-1) < 0, -1.0, 1.0)[:, None]
    err = np.abs(got * sign - qh)
    u = 2.0 ** -24
    w = np.abs(qh[:, :1])
    v = np.linalg.norm(qh[:, 1:], axis=-1, keepdims=True)
    assert (err <= ROT_ATOL + 4 * u / np.maximum(np.minimum(w, v), 1e-3)).all()
    assert not (err <= ROT_ATOL + 4 * u / np.maximum(w, 1e-3)).all()
