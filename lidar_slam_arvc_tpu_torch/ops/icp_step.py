"""K6: an ICP step's update after the correspondence search, in one launch
(``csrc/icp_step.cu``).

Replaces no TPU kernel: the JAX package's ICP loop body is XLA that jit
fuses, and the port ran it as ~186 small PyTorch launches and a host read a
step.  For each pair of a group, K6 gates the correspondences, computes the
fitness and inlier RMSE, the Welsch IRLS weights, the Gauss-Newton system
(point-to-plane, or point-to-point in its closed form), the damped 6x6 LU
solve and the se(3) update, advances the pair's state in place as
``registration/icp.py``'s loop does, and writes the sources under the new
transform for the next search.

Its plain version, ``icp_step_plain``, is the eager step in plain PyTorch
(``_update``, then ``_advance`` applies it with ``torch.where``), spans
``icp.assemble`` and ``icp.solve``: the ICP's CPU path, and the reference
the card's tests hold K6 to.  ``icp_step`` runs K6 for CUDA tensors and
the plain version for CPU tensors; a wrong dtype, shape, contiguity or
device raises ``ValueError`` before any launch.

Residuals/Jacobians:
  point-to-plane: r = n . (p' - q),      J = [p' x n, n]
  point-to-point: r = p' - q (3-vec),    J = [-[p']_x, I3]
The plain 6x6 normal equations are elementwise products and sums (no
matmul, so TF32 cannot enter).
"""

from __future__ import annotations

import ctypes

import torch

from lidar_slam_arvc_tpu_torch.geom.se3 import (
    _hat_sq, compose, se3_exp, so3_hat, transform_points,
)
from lidar_slam_arvc_tpu_torch.ops import _cuda
from lidar_slam_arvc_tpu_torch.utils.profiling import span

F32 = torch.float32


def geometry(S: int) -> dict:
    """The launch K6 makes for S sources a pair: CTAs per pair (one thread
    block cluster each), sources per CTA, register rounds per pass (1: the
    sources' d2, mask and gate stay in registers) and threads per CTA."""
    out = (ctypes.c_int * 4)()
    _cuda.library().icp_step_geometry(S, out)
    return {"cluster": out[0], "slice": out[1], "rounds": out[2], "threads": out[3]}


def _gn_point_to_plane(p, n_corr, q, w):
    """(H, b) for point-to-plane residuals; w gates correspondences."""
    r = torch.sum(n_corr * (p - q), dim=-1)
    J = torch.cat([torch.linalg.cross(p, n_corr), n_corr], dim=-1)  # (B,N,6)
    Jw = J * w[..., None]
    H = torch.sum(Jw[..., :, None] * J[..., None, :], dim=-3)
    b = -torch.sum(Jw * r[..., None], dim=-2)
    return H, b


def _gn_point_to_point(p, q, w):
    """(H, b) for 3-vector point-to-point residuals, in closed form."""
    r = p - q
    w1 = w[..., None]
    # J^T r: rotation part [p]_x r = p x r, translation part r
    bw = -torch.sum(torch.linalg.cross(p, r) * w1, dim=-2)
    bv = -torch.sum(r * w1, dim=-2)
    # Hww = -sum w [p]_x [p]_x, Hwv = sum w [p]_x, Hvv = sum(w) I
    ww = w[..., None, None]
    Hww = -torch.sum(_hat_sq(p) * ww, dim=-3)
    Hwv = torch.sum(so3_hat(p) * ww, dim=-3)
    Hvv = torch.sum(w, dim=-1)[..., None, None] * torch.eye(
        3, dtype=p.dtype, device=p.device)
    H = torch.cat([torch.cat([Hww, Hwv], dim=-1),
                   torch.cat([Hwv.transpose(-1, -2), Hvv], dim=-1)], dim=-2)
    return H, torch.cat([bw, bv], dim=-1)


def _gathered(idx, tgt_points, tgt_normals):
    """The target points and normals at a search's indices idx (B, S)."""
    g = idx.to(torch.int64)[..., None].expand(idx.shape + (3,))
    return torch.gather(tgt_points, 1, g), torch.gather(tgt_normals, 1, g)


def _metrics(d2, mask_f, thr2):
    """(gate, fitness, inlier rmse) of correspondences at squared distances
    d2 under the gate thr2."""
    gate = mask_f * (d2 <= thr2).to(mask_f.dtype)
    n_src = torch.clamp(torch.sum(mask_f, dim=-1), min=1.0)
    n_in = torch.sum(gate, dim=-1)
    rmse = torch.sqrt(torch.sum(d2 * gate, dim=-1)
                      / torch.clamp(n_in, min=1.0))
    return gate, n_in / n_src, rmse


def _update(T, p, d2, q, n_corr, mask_f, thr2, robust: bool, point_to_plane: bool):
    """The step after the search: (exp(xi) T, |xi|, fitness, rmse) of every
    pair, from the sources p under T and their correspondences (d2, q,
    n_corr)."""
    with span("icp.assemble"):
        gate, fit, rmse = _metrics(d2, mask_f, thr2)
        w = gate
        if robust:
            # Welsch IRLS: scale from the gated mean-square distance,
            # sharpened once by reweighting (no new NN sweep)
            sigma2 = (torch.sum(w * d2, dim=-1)
                      / torch.clamp(torch.sum(w, dim=-1), min=1.0))
            w1 = w * torch.exp(-d2 / torch.clamp(2.0 * sigma2, min=1e-8)[..., None])
            sigma2 = (torch.sum(w1 * d2, dim=-1)
                      / torch.clamp(torch.sum(w1, dim=-1), min=1e-6))
            w = w * torch.exp(-d2 / torch.clamp(2.0 * sigma2, min=1e-8)[..., None])
        if point_to_plane:
            H, b = _gn_point_to_plane(p, n_corr, q, w)
        else:
            H, b = _gn_point_to_point(p, q, w)
        # Tikhonov floor: degenerate geometry must not blow up the solve
        trace = H.diagonal(dim1=-2, dim2=-1).sum(-1)
        damp = 1e-6 * (trace / 6.0 + 1.0)
        eye = torch.eye(6, dtype=H.dtype, device=H.device)
    with span("icp.solve"):
        xi = torch.linalg.solve_ex(H + damp[..., None, None] * eye,
                                   b[..., None])[0][..., 0]
        # a non-finite solve keeps T unchanged
        ok = torch.isfinite(xi).all(dim=-1, keepdim=True)
        xi = torch.where(ok, xi, torch.zeros_like(xi))
        return (compose(se3_exp(xi), T), torch.linalg.vector_norm(xi, dim=-1),
                fit, rmse)


def _advance(state, new, max_iters, tol):
    """The loop's state (T, delta, fit, rmse, it, active) after a step whose
    results are ``new`` = (T', delta', fit', rmse'): each taken where the
    pair is active, ``it`` counting the active pairs' steps, and a pair
    active while under ``max_iters`` steps with its last update above
    ``tol``."""
    T, delta, fit, rmse, it, active = state
    T_new, d, f, r = new
    T = torch.where(active[:, None, None], T_new, T)
    delta = torch.where(active, d, delta)
    fit = torch.where(active, f, fit)
    rmse = torch.where(active, r, rmse)
    it = it + active.to(torch.int32)
    active = (it < max_iters) & (delta > tol)
    return T, delta, fit, rmse, it, active


def icp_step_plain(src, p, mask, d2, idx, q, n, tgt_points, tgt_normals, state, *,
                   thr2: float, robust: bool, point_to_plane: bool, max_iters: int,
                   tol: float) -> torch.Tensor:
    """Plain PyTorch K6, ``icp_step``'s contract: the eager step on the
    same inputs, its state written back in place."""
    if idx is not None:
        q, n = _gathered(idx, tgt_points, tgt_normals)
    new = _update(state[0], p, d2, q, n, mask, thr2, robust, point_to_plane)
    for old, value in zip(state, _advance(state, new, max_iters, tol)):
        old.copy_(value)
    return transform_points(state[0], src)


def icp_step(src, p, mask, d2, idx, q, n, tgt_points, tgt_normals, state, *,
             thr2: float, robust: bool, point_to_plane: bool, max_iters: int,
             tol: float) -> torch.Tensor:
    """One ICP step's update of B pairs; returns the sources under the new
    transforms (a new (B, S, 3) tensor).

    Args: src (B, S, 3) the phase's sources; p (B, S, 3) the sources under
    the current transforms (the search's input); mask (B, S) f32, 1 for a
    valid source; d2 (B, S) the squared distance to each correspondence.
    The correspondence either by index, idx (B, S) int32 into tgt_points
    and tgt_normals (B, T, 3), q = n = None; or by value (K4), q and n
    (B, S, 3), idx = None (the targets are then not read).  ``state`` =
    (T (B, 4, 4) f32, delta, fit, rmse (B,) f32, it (B,) int32, active (B,)
    bool), updated in place: where active, T = exp(xi) T, delta = |xi|, fit
    and rmse those of this step's correspondences; it += active; active =
    (it < max_iters) & (delta > tol).  thr2 is the gate's squared distance.
    Everything contiguous on one device.
    """
    dev = src.device
    if dev.type == "cpu":
        return icp_step_plain(src, p, mask, d2, idx, q, n, tgt_points, tgt_normals, state,
                              thr2=thr2, robust=robust, point_to_plane=point_to_plane,
                              max_iters=max_iters, tol=tol)
    if dev.type != "cuda":
        raise ValueError(f"icp_step: unsupported device {dev}")
    if src.dim() != 3:
        raise ValueError(f"icp_step: src of shape {tuple(src.shape)}, expected (B, S, 3)")
    B, S = src.shape[:2]
    if B == 0 or S == 0:
        raise ValueError("icp_step: no pair or no source")
    for name, t, dtype, shape in (("src", src, F32, (B, S, 3)), ("p", p, F32, (B, S, 3)),
                                  ("mask", mask, F32, (B, S)), ("d2", d2, F32, (B, S))):
        _cuda.require(t, name, dtype, shape, dev)
    if (idx is None) == (q is None) or (q is None) != (n is None):
        raise ValueError("icp_step: give idx, or q and n")
    if idx is not None:
        if tgt_points is None or tgt_normals is None or tgt_points.dim() != 3:
            raise ValueError("icp_step: idx needs tgt_points and tgt_normals (B, T, 3)")
        T = tgt_points.shape[1]
        if T == 0:
            raise ValueError("icp_step: empty target cloud")
        _cuda.require(idx, "idx", torch.int32, (B, S), dev)
        _cuda.require(tgt_points, "tgt_points", F32, (B, T, 3), dev)
        _cuda.require(tgt_normals, "tgt_normals", F32, (B, T, 3), dev)
        ptrs = (idx.data_ptr(), tgt_points.data_ptr(), tgt_normals.data_ptr(), None, None)
    else:
        T = 0
        _cuda.require(q, "q", F32, (B, S, 3), dev)
        _cuda.require(n, "n", F32, (B, S, 3), dev)
        ptrs = (None, None, None, q.data_ptr(), n.data_ptr())
    Tm, delta, fit, rmse, it, active = state
    for name, t, dtype, shape in (("T", Tm, F32, (B, 4, 4)), ("delta", delta, F32, (B,)),
                                  ("fit", fit, F32, (B,)), ("rmse", rmse, F32, (B,)),
                                  ("it", it, torch.int32, (B,)),
                                  ("active", active, torch.bool, (B,))):
        _cuda.require(t, name, dtype, shape, dev)
    p_next = torch.empty_like(p)
    lib = _cuda.library()
    with _cuda.on_device(dev):
        err = lib.icp_step_launch(
            int(point_to_plane), int(robust), src.data_ptr(), p.data_ptr(),
            mask.data_ptr(), d2.data_ptr(), *ptrs, B, S, T, thr2, max_iters, tol,
            p_next.data_ptr(), Tm.data_ptr(), delta.data_ptr(), fit.data_ptr(),
            rmse.data_ptr(), it.data_ptr(), active.data_ptr(), _cuda.stream_of(src))
    _cuda.check(err, "icp_step")
    _cuda.launch_counts["icp_step"] += 1
    return p_next
