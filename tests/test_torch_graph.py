"""The port's SE(3) log maps and pose-graph solvers vs the JAX package, on
the CPU.

Both packages get the same numpy inputs: one graph is built by the JAX
package's ``PoseGraph`` and carried into the port's through
``PoseGraph.from_reference_state``.  Tolerances:

* log/exp maps: 1e-5 (f32 rounding of both sides near 0, pi);
* H and b: 1e-6 of their largest entry (f32 sums in another order), the
  reference's own bound against its float64 oracle
  (tests/test_graph.py::TestAssembleOracle);
* solves: poses within 1e-4 m / rad and cost within 1e-4 relative on a
  graph whose gauge a tight prior pins.  Under the default sigma table the
  weak prior (10 m) and GPS (2.5 m) leave directions along which f32 LM
  iterates drift by millimetres at an unchanged cost (the reference's own
  dense and PCG solutions differ by 2-3 mm there), so that graph is held
  to the cost (1e-4 relative) and to 1e-2 m / rad;
* marginals: against a float64 inverse of the reference's H, 5e-2 in
  correlation form, the f32 floor of cond(H) ~ 5e8 that
  tests/test_graph.py::TestMarginals states.
"""

import copy
import importlib

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as SR

import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu.graph import DEFAULT_SIGMAS as SIGMAS_REF
from lidar_slam_arvc_tpu.graph import PoseGraph as PoseGraphRef
from lidar_slam_arvc_tpu.graph import bcr as bcr_ref
from lidar_slam_arvc_tpu.graph import pcg as pcg_ref
from lidar_slam_arvc_tpu.graph import solver as solver_ref
from lidar_slam_arvc_tpu_torch.geom import se3
from lidar_slam_arvc_tpu_torch.graph import DEFAULT_SIGMAS, PoseGraph, make_factor_data
from lidar_slam_arvc_tpu_torch.graph import bcr, pcg, solver
from lidar_slam_arvc_tpu_torch.graph.factors import FACTOR_FIELDS
from lidar_slam_arvc_tpu_torch.utils import synthetic

torch.set_num_threads(1)
# both packages' geom/__init__ export functions named like their modules
rotations = importlib.import_module("lidar_slam_arvc_tpu_torch.geom.rotations")
rot_ref = importlib.import_module("lidar_slam_arvc_tpu.geom.rotations")
se3_ref = importlib.import_module("lidar_slam_arvc_tpu.geom.se3")
# the reference's functions that run eagerly, each compiled as one program
# (eager, every primitive compiles for its shapes on first use)
ref_jit = {name: jax.jit(fn) for name, fn in (
    ("so3_log", rot_ref.so3_log), ("rot_to_euler_both", rot_ref.rot_to_euler_both),
    ("se3_exp", se3_ref.se3_exp), ("se3_log", se3_ref.se3_log), ("t2v", se3_ref.t2v),
    ("between", solver_ref._between_residuals), ("gps", solver_ref._gps_residuals),
    ("prior", solver_ref._prior_residuals), ("bcr_factor", bcr_ref.bcr_factor),
    ("bcr_solve", bcr_ref.bcr_solve))}

STATE = FACTOR_FIELDS + ("poses", "n_poses", "n_chain", "n_loop", "n_gps",
                         "n_prior", "chain_capacity", "T0", "T0_gps")


def reference_state(g) -> dict:
    return {k: copy.deepcopy(getattr(g, k)) for k in STATE}


def _noisy(T, rng, rot=0.002, trans=0.01):
    out = T.copy()
    out[:3, :3] = T[:3, :3] @ SR.from_rotvec(rng.normal(scale=rot, size=3)).as_matrix()
    out[:3, 3] += rng.normal(scale=trans, size=3)
    return out


def loopy_graph(n=60, cap=64, prior_sigma=None, seed=5):
    """A JAX-package graph: a noisy circle with SM and ODO chain edges,
    four loop edges (one pair duplicated, one a chain pair) and GPS."""
    rng = np.random.default_rng(seed)
    sig = SIGMAS_REF if prior_sigma is None else SIGMAS_REF._replace(
        prior=np.full(6, prior_sigma))
    T_gt = synthetic.make_trajectory(n, radius=8.0)
    g = PoseGraphRef(max_poses=cap, max_between=4 * cap, max_gps=cap, sigmas=sig)
    g.init_graph()
    for i in range(n - 1):
        rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1]
        odo = _noisy(rel, rng, 0.02, 0.02)
        g.add_initial_estimate(odo, i + 1)
        g.add_edge(_noisy(rel, rng), i, i + 1, "SM")
        g.add_edge(odo, i, i + 1, "ODO")
    for i, j in [(0, n - 2), (1, n - 1), (2, n - 2), (2, n - 2)]:
        g.add_edge(_noisy(np.linalg.inv(T_gt[i]) @ T_gt[j], rng), i, j, "SM")
    for i in range(0, n, 6):
        z = T_gt[i][:3, 3] + rng.normal(scale=0.3, size=3)
        g.add_gps_factor(z[0], z[1], z[2], i)
    return g, T_gt


def _pose_err(Ta, Tb):
    D = np.linalg.inv(np.asarray(Ta, np.float64)) @ np.asarray(Tb, np.float64)
    R = D[..., :3, :3]
    skew = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    return (np.linalg.norm(D[..., :3, 3], axis=-1).max(),
            np.arcsin(np.clip(np.linalg.norm(skew, axis=-1) / 2, 0, 1)).max())


# --------------------------------------------------------------- geometry

def _rotations(rng, n):
    R = SR.random(n, random_state=rng).as_matrix()
    R[0] = np.eye(3)
    R[1] = SR.from_rotvec([1e-6, -2e-6, 5e-7]).as_matrix()
    R[2] = SR.from_rotvec([np.pi - 1e-4, 0.0, 0.0]).as_matrix()
    R[3] = SR.from_rotvec(np.array([0.3, -0.5, 0.8]) / np.linalg.norm(
        [0.3, -0.5, 0.8]) * (np.pi - 5e-4)).as_matrix()
    R[4] = SR.from_euler("xyz", [0.3, np.pi / 2, -0.2]).as_matrix()  # gimbal
    return R.astype(np.float32)


def test_so3_log_and_euler_match_reference(rng):
    R = _rotations(rng, 64)
    got = rotations.so3_log(torch.from_numpy(R)).numpy()
    ref = np.asarray(ref_jit["so3_log"](R))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # near pi the f32 axis recovery holds to ~1e-4 (the reference's own
    # near-pi test, tests/test_geom.py, allows 1e-3)
    back = se3.so3_exp(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, R, atol=2e-4)
    for a, b in zip(rotations.rot_to_euler_both(torch.from_numpy(R)),
                    ref_jit["rot_to_euler_both"](R)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_array_equal(
        rotations.so3_vee(se3.so3_hat(torch.from_numpy(got))).numpy(), got)


def test_se3_log_exp_t2v_match_reference(rng):
    xi = rng.normal(scale=[0.8, 0.8, 0.8, 5.0, 5.0, 5.0], size=(64, 6))
    xi[0] = 0.0
    xi[1, :3] = 1e-7
    xi = xi.astype(np.float32)
    T = se3.se3_exp(torch.from_numpy(xi))
    np.testing.assert_allclose(T.numpy(), np.asarray(ref_jit["se3_exp"](xi)),
                               atol=1e-5)
    got = se3.se3_log(T).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_jit["se3_log"](T.numpy())),
                               atol=1e-5)
    np.testing.assert_allclose(got, xi, atol=1e-4)
    np.testing.assert_allclose(se3.t2v(T).numpy(),
                               np.asarray(ref_jit["t2v"](T.numpy())),
                               atol=1e-5)
    w = torch.from_numpy(xi[:, :3])
    np.testing.assert_allclose(
        (se3._V_inv_matrix(w) @ se3._V_matrix(w)).numpy(),
        np.tile(np.eye(3), (64, 1, 1)), atol=1e-5)


# -------------------------------------------------------------- assembly

def test_assemble_matches_reference_and_float64_oracle():
    """H and b against the reference's _assemble and against a float64
    numpy sum of J^T W^2 J over the reference's own residuals."""
    g, _ = loopy_graph(n=20, cap=32)
    p = PoseGraph.from_reference_state(reference_state(g), device="cpu")
    poses = jnp.asarray(g.poses)
    f = g._factor_data()
    H_ref, b_ref = map(np.asarray, solver_ref._assemble(poses, f, jnp.int32(g.n_poses)))
    H, b = solver._assemble(torch.from_numpy(p.poses), p._factor_data(), p.n_poses)
    scale, bs = np.abs(H_ref).max(), np.abs(b_ref).max()
    np.testing.assert_allclose(H.numpy() / scale, H_ref / scale, atol=1e-6)
    np.testing.assert_allclose(b.numpy() / bs, b_ref / bs, atol=1e-6)

    M = 6 * g.max_poses
    H64, b64 = np.zeros((M, M)), np.zeros(M)

    def add(rows, J, r, w):
        W2 = np.diag(w.astype(np.float64) ** 2)
        Jf = np.zeros((J.shape[0], M))
        for k, pose in enumerate(rows):
            Jf[:, 6 * pose: 6 * pose + 6] += J[:, 6 * k: 6 * k + 6]
        H64[:] += Jf.T @ W2 @ Jf
        b64[:] += Jf.T @ W2 @ r

    r, A, B = map(np.asarray, ref_jit["between"](poses, f))
    rg, Jg = map(np.asarray, ref_jit["gps"](poses, f))
    rp, Jp = map(np.asarray, ref_jit["prior"](poses, f))
    f = type(f)(*map(np.asarray, f))
    for e in np.nonzero(f.bt_winv.any(1))[0]:
        add([int(f.bt_i[e]), int(f.bt_j[e])], np.concatenate([A[e], B[e]], 1),
            r[e], f.bt_winv[e])
    for e in np.nonzero(f.gps_winv.any(1))[0]:
        add([int(f.gps_i[e])], Jg[e], rg[e], f.gps_winv[e])
    add([0], Jp[0], rp[0], f.pr_winv[0])
    for k in range(g.n_poses, g.max_poses):
        H64[6 * k: 6 * k + 6, 6 * k: 6 * k + 6] = np.eye(6)
    s64 = max(np.abs(H64).max(), 1.0)
    np.testing.assert_allclose(H.numpy() / s64, H64 / s64, atol=1e-6)
    bs64 = max(np.abs(b64).max(), 1.0)
    np.testing.assert_allclose(b.numpy() / bs64, b64 / bs64, atol=1e-6)


def test_factor_layout_and_state_carried_across():
    """from_reference_state loads every buffer and counter; the layout
    drops inactive slots and lists each nonzero block once."""
    g, _ = loopy_graph(n=20, cap=32)
    p = PoseGraph.from_reference_state(reference_state(g), device="cpu")
    for k in FACTOR_FIELDS + ("poses",):
        np.testing.assert_array_equal(getattr(p, k), np.asarray(getattr(g, k)), k)
    assert (p.n_poses, p.n_chain, p.n_loop, p.n_gps) == (20, 38, 4, 4)
    f = p._factor_data()
    assert f.bt_i.shape[0] == 42 and f.gps_i.shape[0] == 4
    key = f.blk_rows * 32 + f.blk_cols
    assert bool((key[1:] > key[:-1]).all())
    assert bool((f.blk_rows[f.diag_pos] == torch.arange(32)).all())
    # a chain edge and its duplicate ODO edge sum into one block
    assert int((f.blk_ix[f.band_pos[0]] < f.bt_i.shape[0] * 4).sum()) == 2
    with pytest.raises(ValueError, match="outside"):
        make_factor_data(8, "cpu", **{k: getattr(g, k) for k in FACTOR_FIELDS})
    assert np.array_equal(DEFAULT_SIGMAS.odo, SIGMAS_REF.odo)


# ----------------------------------------------------------------- solves

@pytest.mark.parametrize("solver_name,cap", [("dense", 64), ("pcg", 64),
                                             ("pcg", 72)],
                         ids=["dense", "pcg_bcr", "pcg_tridiag"])
def test_solve_matches_reference(solver_name, cap):
    """The dense LM and the PCG solves (BCR at a power-of-two capacity,
    the tridiagonal scan at 72) against the reference's, on one graph."""
    g, _ = loopy_graph(cap=cap, prior_sigma=1e-3)
    p = PoseGraph.from_reference_state(reference_state(g), device="cpu")
    c_ref = g.optimize(max_iterations=25, solver=solver_name)
    c = p.optimize(max_iterations=25, solver=solver_name)
    assert abs(c - c_ref) <= 1e-4 * abs(c_ref)
    dpos, drot = _pose_err(p.current_estimate, g.current_estimate)
    assert dpos < 1e-4 and drot < 1e-4, (dpos, drot)
    np.testing.assert_array_equal(p.poses[g.n_poses:], g.poses[g.n_poses:])
    assert p.stats["optimizations"] == 1 and p.stats["lm_steps"] > 1
    assert (p.stats["cg_iterations"] > 0) == (solver_name == "pcg")


def test_default_sigma_solve_matches_reference_cost():
    g, T_gt = loopy_graph()
    p = PoseGraph.from_reference_state(reference_state(g), device="cpu")
    c_ref = g.optimize(max_iterations=25)
    c = p.optimize(max_iterations=25)
    assert abs(c - c_ref) <= 1e-4 * abs(c_ref)
    dpos, drot = _pose_err(p.current_estimate, g.current_estimate)
    assert dpos < 1e-2 and drot < 1e-2, (dpos, drot)


def test_lm_schedule_takes_the_reference_decisions():
    """Fed the same candidate costs, the host-driven schedule accepts,
    rejects, damps and stops as the reference's lm_drive: lam falls 5x on
    an accepted step, rises 10x on a worse, infinite or NaN cost, and the
    solve stops on a gain below tol * max(cost, 1)."""
    script = [5.0, 7.0, np.inf, np.nan, 4.0, 3.0, 3.0 - 2.4e-7, 1.0]

    def drive(run, wrap):
        lams, costs = [], iter(script)

        def step(q, lam):
            lams.append(float(lam))
            return q, wrap(next(costs))
        _, cost = run(step, wrap(10.0))
        return lams, float(cost)

    ref = drive(lambda step, c0: solver_ref.lm_drive(step, None, c0, 15),
                lambda c: c)
    got = drive(lambda step, c0: solver.lm_schedule(step, None, c0, 15, 1e-6, 1e-7),
                lambda c: torch.tensor(c, dtype=torch.float32))
    assert len(got[0]) == len(ref[0]) == 7
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
    assert got[1] == pytest.approx(ref[1], rel=1e-7)


def test_bcr_and_tridiag_match_dense(rng):
    """Both chain preconditioners solve random SPD block-tridiagonal
    systems, batched over right-hand sides (float64 oracle, as
    tests/test_graph.py::TestBCR), and BCR agrees with the reference's."""
    for n in (2, 8, 64):
        E = rng.normal(scale=0.3, size=(n, 6, 6)).astype(np.float32)
        E[-1] = 0
        R = rng.normal(size=(n, 6, 6)).astype(np.float32)
        D = np.einsum("kab,kcb->kac", R, R) + 8 * np.eye(6, dtype=np.float32)
        M = np.zeros((6 * n, 6 * n))
        for i in range(n):
            M[6 * i: 6 * i + 6, 6 * i: 6 * i + 6] = D[i]
            if i + 1 < n:
                M[6 * i: 6 * i + 6, 6 * i + 6: 6 * i + 12] = E[i]
                M[6 * i + 6: 6 * i + 12, 6 * i: 6 * i + 6] = E[i].T
        b = rng.normal(size=(3, n, 6)).astype(np.float32)
        x_ref = np.linalg.solve(M, b.reshape(3, -1).T).T.reshape(3, n, 6)
        levels, root = bcr.bcr_factor(torch.from_numpy(D), torch.from_numpy(E))
        x = bcr.bcr_solve(levels, root, torch.from_numpy(b)).numpy()
        Uinv, W = pcg._build_tridiag_precond(torch.from_numpy(D), torch.from_numpy(E))
        x_tri = pcg._apply_tridiag_precond(Uinv, W, torch.from_numpy(E),
                                           torch.from_numpy(b)).numpy()
        for got in (x, x_tri):
            assert np.abs(got - x_ref).max() / max(np.abs(x_ref).max(), 1) < 1e-4
        if n == 8:
            lv, Dr = ref_jit["bcr_factor"](D, E)
            np.testing.assert_allclose(
                x[0], np.asarray(ref_jit["bcr_solve"](lv, Dr, b[0])),
                atol=1e-4 * max(np.abs(x_ref).max(), 1))
    with pytest.raises(ValueError, match="power-of-two"):
        bcr.bcr_factor(torch.eye(6).repeat(12, 1, 1), torch.zeros(12, 6, 6))


@pytest.mark.parametrize("precond", ["bcr", "tridiag", "jacobi"])
def test_pcg_lm_step_matches_reference(precond):
    """One damped PCG step per preconditioner against the reference's."""
    g, _ = loopy_graph(n=28, cap=32, prior_sigma=1e-3)
    p = PoseGraph.from_reference_state(reference_state(g), device="cpu")
    q_ref, c_ref = pcg_ref.pcg_lm_step(jnp.asarray(g.poses), g._factor_data(),
                                       g.n_poses, jnp.float32(1e-4),
                                       precond=precond)
    stats = {}
    q, c = pcg.pcg_lm_step(torch.from_numpy(p.poses), p._factor_data(),
                           p.n_poses, 1e-4, precond=precond, stats=stats)
    assert abs(float(c) - float(c_ref)) <= 1e-4 * abs(float(c_ref))
    dpos, drot = _pose_err(q.numpy()[:28], np.asarray(q_ref)[:28])
    assert dpos < 1e-4 and drot < 1e-4, (dpos, drot)
    assert stats["cg_iterations"] > 0
    assert stats["host_syncs"] == stats["cg_iterations"] + 2 or \
        stats["host_syncs"] == stats["cg_iterations"] + 1
    with pytest.raises(ValueError, match="unknown precond"):
        pcg.pcg_lm_step(torch.from_numpy(p.poses), p._factor_data(), p.n_poses,
                        1e-4, precond="ilu")


# -------------------------------------------------------------- marginals

def test_marginals_match_reference_and_float64_inverse():
    """Dense chunked marginals and the matrix-free PCG blocks of both
    packages against a float64 inverse of the reference's H."""
    g, _ = loopy_graph(n=20, cap=32)
    # linearised at the port's solution (its solves are held to the
    # reference's above), carried into the reference's graph
    p = PoseGraph.from_reference_state(reference_state(g), device="cpu")
    p.optimize(max_iterations=10)
    g.poses = p.poses.copy()
    H, _ = solver_ref._assemble(jnp.asarray(g.poses), g._factor_data(),
                                jnp.int32(g.n_poses))
    cov64 = np.linalg.inv(np.asarray(H, np.float64) + 1e-9 * np.eye(H.shape[0]))
    idx = np.array([0, 3, 10, 19])
    dense, dense_ref = p.marginal_covariances(), g.marginal_covariances()
    blocks, blocks_ref = (p.marginal_covariances(indices=idx),
                          g.marginal_covariances(indices=idx))
    assert dense.shape == (20, 6, 6) and blocks.shape == (4, 6, 6)
    for k, i in enumerate(idx):
        truth = cov64[6 * i: 6 * i + 6, 6 * i: 6 * i + 6]
        d = np.sqrt(np.outer(np.diag(truth), np.diag(truth)))
        for got in (dense[i], dense_ref[i], blocks[k], blocks_ref[k]):
            np.testing.assert_allclose(got / d, truth / d, rtol=5e-2, atol=5e-2)
    assert p.stats["cg_iterations"] > 0


def test_marginals_nan_where_the_cholesky_fails():
    """A graph with no prior (no ``init_graph()``) leaves its gauge free:
    H is singular, the reference's ``cho_factor`` gives NaN marginals, and
    the port's dense path must too instead of finite, meaningless blocks
    (both packages' PCG blocks are NaN as well)."""
    rng = np.random.default_rng(3)
    T_gt = synthetic.make_trajectory(8, radius=4.0)
    g = PoseGraphRef(max_poses=32)      # the capacity of the marginals test above
    for i in range(7):
        rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1]
        g.add_initial_estimate(_noisy(rel, rng), i + 1)
        g.add_edge(_noisy(rel, rng), i, i + 1, "SM")
    p = PoseGraph.from_reference_state(reference_state(g), device="cpu")
    ref = np.asarray(g.marginal_covariances())
    got = p.marginal_covariances()
    assert ref.shape == got.shape == (8, 6, 6)
    assert np.isnan(ref).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(p.marginal_covariances(indices=[0, 3])).all()


def test_singular_preconditioner_block_is_nonfinite():
    """A singular 6x6 block in each PCG preconditioner's set-up gives NaN
    where the reference's ``jnp.linalg.inv`` gives non-finite blocks (the
    card's counterpart is tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(4)
    M = rng.normal(size=(8, 6, 6))
    D = (M @ M.transpose(0, 2, 1) + 6.0 * np.eye(6)).astype(np.float32)
    E = (0.1 * rng.normal(size=(8, 6, 6))).astype(np.float32)
    E[-1] = 0.0
    D[[0, 3]] = 0.0      # inverted directly: 3 by BCR, 0 by the tridiagonal
    b = np.ones((8, 6), np.float32)
    ref = ref_jit["bcr_solve"](*ref_jit["bcr_factor"](D, E), b)
    assert not np.isfinite(np.asarray(ref)).all()
    Dt, Et, bt = torch.from_numpy(D), torch.from_numpy(E), torch.from_numpy(b)
    assert not torch.isfinite(bcr.bcr_solve(*bcr.bcr_factor(Dt, Et), bt)).all()
    Uinv, W = pcg._build_tridiag_precond(Dt, Et)
    assert not torch.isfinite(pcg._apply_tridiag_precond(Uinv, W, Et, bt)).all()
    Minv = solver.inv_or_nan(Dt)
    assert torch.isnan(Minv[[0, 3]]).all() and torch.isfinite(Minv[1:3]).all()


def test_batched_cg_freezes_converged_columns():
    """A batch of right-hand sides gives each column the result it gets
    alone: a column that converged early stays frozen while the others
    iterate (the reference's vmapped while_loop)."""
    g, _ = loopy_graph(n=20, cap=32)
    p = PoseGraph.from_reference_state(reference_state(g), device="cpu")
    lin = solver.linearize(torch.from_numpy(p.poses), p._factor_data(), p.n_poses)
    f = p._factor_data()
    hx = pcg._hx_operator(lin, f, 0.0)
    M = pcg._preconditioner(lin, f, 0.0, "jacobi")
    b = torch.zeros(3, 32, 6)
    b[0, 5, 1] = 1.0
    b[1, 19, 4] = 1.0
    b[2] = lin.grad
    batch = pcg.conjugate_gradient(hx, M, b, 60, 1e-5)
    for c in range(3):
        alone = pcg.conjugate_gradient(hx, M, b[c:c + 1], 60, 1e-5)
        np.testing.assert_array_equal(batch[c].numpy(), alone[0].numpy())


def test_unported_and_invalid_solvers_raise():
    g, _ = loopy_graph(n=10, cap=16)
    p = PoseGraph.from_reference_state(reference_state(g), device="cpu")
    # the Schur solve without a process group: one rank, one chunk, the
    # dense step's algebra on another f32 rounding path (inactive poses
    # left out); under the default sigmas the iterates drift by ~1 mm at
    # an unchanged cost (module docstring), so the cost to 1e-5 relative
    # and the poses to the end-to-end 5e-3 (tests/test_torch_parallel.py
    # holds the step on ranks)
    q = PoseGraph.from_reference_state(reference_state(g), device="cpu")
    c_schur, c_dense = p.optimize(solver="schur"), q.optimize(solver="dense")
    assert abs(c_schur - c_dense) <= 1e-5 * c_dense
    np.testing.assert_allclose(p.poses, q.poses, atol=5e-3)
    with pytest.raises(ValueError, match="unknown solver"):
        p.optimize(solver="qr")
    assert PoseGraph(max_poses=256, device="cpu").auto_solver() == "dense"
    assert PoseGraph(max_poses=512, device="cpu").auto_solver() == "pcg"
    assert PoseGraphRef(max_poses=512).auto_solver() == "pcg"
    with pytest.raises(RuntimeError, match="capacity exceeded"):
        q = PoseGraph(max_poses=8, max_between=8, max_gps=4, device="cpu")
        for _ in range(9):
            q.add_edge(np.eye(4), 0, 5, "SM")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            PoseGraph(max_poses=8)
