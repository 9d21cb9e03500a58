"""The comparison that decides ``correct``: the program's outputs of the
window against the plain reference (``slam_bench/reference``), computed
once the window has closed, from the generated inputs.

Stage 1: a sample of the consecutive pairs, drawn from the seed; for each,
the reference crops, voxelises and estimates normals of the two raw scans
(read from the PCD files both sides read), runs ICP from the odometry
seed, and keeps the seed where the program's fallback rule says so.  The
numbers are the widest translation and rotation gap between the
reference's transform and every window sequence's ``relative`` at those
pairs.

Stage 2: the reference replays every loop-closing round from the pose
estimate the program held at that round (recorded as the round started),
with its own preprocessing of the full-resolution scans, its own ICP and
its own triangle gate, then solves its own graph (the stage-1 and odometry
chains read from the input files, a prior at pose 0, its own accepted
closures) in float64 to convergence and takes its marginals.  The numbers
are the count of closures accepted by one side only, and the widest
position and rotation gap of the solution, each pose taken relative to
pose 0 (the prior on pose 0 is weak: a rigid shift of the whole solution
by centimetres changes the cost by a part in 1e7, so where a float32 solve
stops along it says nothing of the trajectory's shape).  The widest
relative gap of the positional standard deviation sqrt(trace Sigma_xyz)
over the poses whose marginals the program computed is printed beside
them.

``control=True`` computes the reference a second time one precision
below the configuration's float32 and judges that in the program's place:
stage 1 in bfloat16 (every per-point operand rounded to bfloat16, sums in
float32: stage 1's path has no matmul, so TF32 cannot enter it, and the
step a later change would be tempted by is a 16-bit path), stage 2 with
TF32 matmuls (the pose-graph solves are matmuls and refuse TF32).

Every number is non-negative; a NaN or infinity reads as infinity.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from slam_bench.gen import files
from slam_bench.reference import cloud, geometry, graph as rgraph, icp as ricp, loop as rloop


@contextlib.contextmanager
def tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _log(what: str, t0: float) -> None:
    print(f"slam_bench check: {what} after {time.perf_counter() - t0:.2f} s",
          file=sys.stderr, flush=True)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _finite(v) -> float:
    v = float(v)
    return v if np.isfinite(v) else float("inf")


class Scans:
    """Reference-preprocessed scans of a dataset, each made once
    (``lowp``: the rounding of the control, applied to what is kept)."""

    def __init__(self, directory, times, icp, voxel_size, device, lowp=None):
        self.directory, self.times, self.icp = directory, times, icp
        self.voxel_size, self.device, self.cache = voxel_size, device, {}
        self.lowp = lowp or (lambda x: x)

    def __getitem__(self, i):
        if i not in self.cache:
            raw = files.read_pcd(f"{self.directory}/robot0/lidar/data/{self.times[i]}.pcd")
            pts, nrm, _ = cloud.preprocess(torch.from_numpy(raw.copy()).to(self.device),
                                           self.icp, self.voxel_size)
            self.cache[i] = (self.lowp(pts), self.lowp(nrm))
        return self.cache[i]


def _register(scans, icp, pairs, seeds):
    """T_i_j of (i target, j source) pairs from seeds, float64 numpy."""
    out = []
    for (i, j), seed in zip(pairs, seeds):
        src, _ = scans[int(j)]
        tgt, nrm = scans[int(i)]
        T, fit, _, delta = ricp.icp(src, tgt, nrm, seed.astype(np.float32),
                                    icp["distance_threshold"], icp["max_iterations"],
                                    lowp=scans.lowp)
        out.append((T.cpu().numpy(), fit, delta))
    return out


# ---------------------------------------------------------------- stage 1

def stage1_reference(directory, cfg, pairs, device, control=False):
    icp = cfg["icp"]
    times = files.read_csv(f"{directory}/robot0/lidar/data.csv")[files.TIME]
    T_odo = files.transforms(files.read_csv(f"{directory}/robot0/odom/data.csv"))
    seeds = [(np.linalg.inv(T_odo[k]) @ T_odo[k + 1]).astype(np.float32) for k in pairs]
    scans = Scans(directory, times, icp, cfg["scanmatcher"]["voxel_size"], device,
                  lowp=bf16 if control else None)
    res = _register(scans, icp, [(k, k + 1) for k in pairs], seeds)
    out = []
    for (T, fit, delta), seed in zip(res, seeds):
        fell_back = fit < icp["min_fitness"] or delta > 100 * ricp.TOL
        out.append(seed.astype(np.float64) if fell_back else T)
    return np.stack(out)


def stage1_numbers(program_relatives, reference):
    """{name: value}: the widest gaps over every sequence at the pairs."""
    t_gap, r_gap = 0.0, 0.0
    for rel in program_relatives:
        dt, dr = geometry.gaps(rel, reference)
        t_gap = max(t_gap, _finite(dt.max()))
        r_gap = max(r_gap, _finite(dr.max()))
    return {"trans_gap_m": t_gap, "rot_gap_rad": r_gap}


# ---------------------------------------------------------------- stage 2

def stage2_reference(directory, cfg, rounds, sample_idx, device, control=False):
    """(accepted pairs, solution (n, 4, 4), positional sigma at sample_idx)."""
    icp, slam = cfg["icp"], cfg["slam"]
    times = files.read_csv(f"{directory}/robot0/scanmatcher/lidar_times.csv")[files.TIME]
    T_sm = files.transforms(files.read_csv(
        f"{directory}/robot0/scanmatcher/scanmatcher_global.csv"))
    T_odo = files.transforms(files.read_csv(f"{directory}/robot0/odom/data.csv"))
    scans = Scans(directory, times, icp, None, device)
    dtype = torch.float32 if control else torch.float64

    def register(pairs, seeds):
        return np.stack([T for T, _, _ in _register(scans, icp, pairs, seeds)])

    t0 = time.perf_counter()
    with tf32(control):
        accepted, loop_T = rloop.replay(rounds, register, slam["radius_threshold"],
                                        slam["distance_backwards"])
        _log(f"replay of {len(rounds)} rounds", t0)
        n = len(T_sm)
        rel = lambda T: np.einsum("nij,njk->nik", np.linalg.inv(T[:-1]), T[1:])
        k = np.arange(n - 1)
        sm_w = 1.0 / np.asarray(rgraph.SIGMAS["SM"])
        odo_w = 1.0 / np.asarray(rgraph.SIGMAS["ODO"])
        bi = np.concatenate([k, k, [a for a, _ in accepted]]).astype(np.int64)
        bj = np.concatenate([k + 1, k + 1, [b for _, b in accepted]]).astype(np.int64)
        bT = np.concatenate([rel(T_sm), rel(T_odo)] + ([np.stack(loop_T)] if loop_T else []))
        bw = np.concatenate([np.tile(sm_w, (n - 1, 1)), np.tile(odo_w, (n - 1, 1)),
                             np.tile(sm_w, (len(accepted), 1))])
        g = rgraph.Graph(n, bi, bj, bT, bw, np.eye(4), device=device, dtype=dtype)
        X0 = np.empty((n, 4, 4))
        X0[0] = np.eye(4)
        for i, R in enumerate(rel(T_sm)):
            X0[i + 1] = X0[i] @ R
        X = g.solve(X0)
        _log("graph solve", t0)
        cov = g.marginals(X)[torch.as_tensor(sample_idx, device=device)]
        sigma = torch.sqrt(cov[:, 3:, 3:].diagonal(dim1=-2, dim2=-1).sum(-1))
        _log("marginals", t0)
    return {"accepted": accepted, "loop_T": loop_T, "solution": X.double().cpu().numpy(),
            "sigma": sigma.double().cpu().numpy(), "chain": (bi, bj, bT, bw)}


def stage2_numbers(program, reference):
    """``program``: per sequence (accepted pairs, solution, sigma)."""
    acc_r, X_r, s_r = reference["accepted"], reference["solution"], reference["sigma"]
    out = {"closures_mismatch": 0.0, "solution_gap_m": 0.0, "solution_gap_rad": 0.0}
    for acc_p, X_p, s_p in program:
        out["closures_mismatch"] = max(out["closures_mismatch"], float(
            len(set(map(tuple, acc_p)) ^ set(map(tuple, acc_r)))))
        dt, dr = geometry.gaps(_from_first(X_p), _from_first(X_r))
        out["solution_gap_m"] = max(out["solution_gap_m"], _finite(dt.max()))
        out["solution_gap_rad"] = max(out["solution_gap_rad"], _finite(dr.max()))
    return out


def _from_first(X: np.ndarray) -> np.ndarray:
    """Every pose relative to the first, X_0^-1 X_k: the trajectory's shape,
    free of the rigid motion that the weak prior on pose 0 (10 m, 10 deg)
    leaves all but unpinned."""
    return np.einsum("ij,njk->nik", np.linalg.inv(X[0]), X)


def marginal_gap(program, reference) -> float:
    """The widest relative gap of the positional standard deviation over
    the poses whose marginals the program computed (printed, not judged:
    the TF32 control gives no number, so no limit can be set from it)."""
    s_r = reference["sigma"]
    return max(_finite(np.max(np.abs(s_p - s_r) / s_r)) for _, _, s_p in program)


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number the cell's limits
    name at or under its limit."""
    rows = [(k, float(numbers[k]), float(limits[k])) for k in limits]
    return all(v <= lim for _, v, lim in rows), rows


def stage2_diagnostics(graph, X_prog, reference, device) -> dict:
    """Where a solution gap comes from (printed, not judged): the float64
    optimum of the program's own final factors against the program's
    solution, and the program's loop-closure measurements against the
    reference's for the same pairs."""
    act = graph.bt_winv.any(axis=1)
    bi, bj = graph.bt_i[act].astype(np.int64), graph.bt_j[act].astype(np.int64)
    g = rgraph.Graph(graph.n_poses, bi, bj, graph.bt_T[act].astype(np.float64),
                     graph.bt_winv[act].astype(np.float64), np.eye(4), device=device)
    X = g.solve(X_prog)
    costs = (g.cost(torch.as_tensor(X_prog, dtype=torch.float64, device=device)), g.cost(X))
    X = X.cpu().numpy()
    dt, dr = geometry.gaps(X_prog, X)
    loops = {(int(i), int(j)): graph.bt_T[k].astype(np.float64)
             for k, (i, j) in enumerate(zip(graph.bt_i, graph.bt_j))
             if act[k] and j != i + 1}
    lt, lr = [], []
    for (i, j), T in zip(reference["accepted"], reference["loop_T"]):
        if (i, j) in loops:
            a, b = geometry.gaps(loops[(i, j)], T)
            lt.append(float(a))
            lr.append(float(b))
    return {"own_factors_gap_m": float(dt.max()), "own_factors_gap_rad": float(dr.max()),
            "own_factors_cost_program": costs[0], "own_factors_cost_optimum": costs[1],
            "loop_T_gap_m": max(lt, default=0.0), "loop_T_gap_rad": max(lr, default=0.0),
            "loop_T_compared": len(lt)}
