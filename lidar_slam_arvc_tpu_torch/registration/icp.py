"""Batched ICP on SE(3): point-to-plane and point-to-point.

Counterpart of ``lidar_slam_arvc_tpu/registration/icp.py``.  Direction
convention as there: ``icp(src=cloud_j, tgt=cloud_i, T_init=T_ij)``
returns the refined T_ij mapping scan j's points into scan i's frame.

Per iteration, for a whole group of scan pairs at once: correspondences
from the search that ``ICPParams.nn_impl`` selects (one kernel launch for
the group), gated by ``max_correspondence_distance``; Welsch IRLS weights;
one Gauss-Newton step on the se(3) left perturbation (xi = [w, v],
T' = exp(xi) T) with a Tikhonov floor; a non-finite guard.

``nn_impl`` as in the reference (its ``icp`` dispatch):

* ``auto``, ``pallas``, ``vpu_t``: K1 (``ops.nn.nn_search``);
* ``vpu``, ``vpu2``, ``mxu``: K3, the same search in those d2 forms;
* ``vpu_tq``: K4 (``ops.nn.nn_search_vals``), which returns the winner's
  point and normal, so no gathers;
* ``pruned``: K5 (``ops.nn_pruned``), exact within the gate; both clouds
  are Morton-sorted once per call (the source by its raw coordinates), and
  it refuses the coarse-to-fine schedule as the reference does;
* ``xla``: ``ops.nn.nn_search_xla``, the JAX package's matmul-form sweep.

Any other value raises ``ValueError`` (the reference silently takes its
XLA sweep there).

The reference vmaps a ``lax.while_loop``: every pair freezes once its own
update norm falls to ``convergence_tol`` and the group runs until all have.
Here that is a per-pair ``active`` mask applied with ``torch.where``; each
pair's ``iterations`` and ``final_delta`` are its own.  The loop reads one
boolean per iteration from the device (``active.any()``).

Residuals/Jacobians:
  point-to-plane: r = n . (p' - q),      J = [p' x n, n]
  point-to-point: r = p' - q (3-vec),    J = [-[p']_x, I3]
The 6x6 normal equations are elementwise products and sums (no matmul, so
TF32 cannot enter).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_slam_arvc_tpu_torch.cloud.cloud import Cloud
from lidar_slam_arvc_tpu_torch.geom.se3 import (
    _hat_sq, compose, se3_exp, so3_hat, t2v, transform_from_euler, transform_points,
)
from lidar_slam_arvc_tpu_torch.ops.nn import nn_search, nn_search_vals, nn_search_xla
from lidar_slam_arvc_tpu_torch.ops.nn_pruned import (
    morton_sort, nn_search_pruned_presorted, pad_rows,
)

NN_IMPLS = ("auto", "pallas", "vpu_t", "vpu", "vpu2", "mxu", "vpu_tq",
            "pruned", "xla")


class ICPParams(NamedTuple):
    """The reference's ICP parameters, same names and defaults, so
    ``ICPParams(**jax_params._asdict())`` converts them.  ``src_block`` and
    ``tgt_block`` were TPU tile sizes; only ``nn_impl="pruned"`` reads
    them, as the reference does: K5's blocks have ``min(512, src_block)``
    source and ``min(512, tgt_block)`` target rows.  The other searches
    ignore them."""
    max_correspondence_distance: float = 10.0
    max_iterations: int = 30
    src_block: int = 1024
    tgt_block: int = 2048
    # Welsch IRLS with a scale adapted to the residual distribution;
    # False weights every gated correspondence equally
    robust: bool = True
    # per-pair early exit on the se(3) update norm; 0 disables it
    convergence_tol: float = 1e-4
    # correspondence search, one of NN_IMPLS (see the module docstring)
    nn_impl: str = "auto"
    coarse_factor: int = 1
    coarse_iterations: int = 0
    # True recomputes fitness/rmse at the final transform (one more sweep);
    # False reports those of the last iteration's correspondences
    exact_metrics: bool = False
    # persistent source subsampling for the whole solve
    source_stride: int = 1


class ICPResult(NamedTuple):
    transform: torch.Tensor     # (..., 4, 4) refined T mapping src into tgt
    fitness: torch.Tensor       # inlier fraction of valid source points
    inlier_rmse: torch.Tensor   # RMSE over inlier correspondences
    iterations: torch.Tensor | int = 0      # (...,) int32 iterations each pair ran
    final_delta: torch.Tensor | float = 0.0  # se(3) norm of each pair's last step


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


def _check_nn_impl(params: ICPParams) -> None:
    if params.nn_impl not in NN_IMPLS:
        raise ValueError(f"unknown nn_impl {params.nn_impl!r} "
                         f"({' | '.join(NN_IMPLS)})")
    if (params.nn_impl == "pruned" and params.coarse_factor > 1
            and params.coarse_iterations > 0):
        raise ValueError("nn_impl='pruned' does not compose with the "
                         "coarse-to-fine schedule (strided sources "
                         "break the presorted block layout)")


def _correspondence(params: ICPParams, src_mask, tgt_points, tgt_masks,
                    tgt_normals):
    """correspond(p) -> (d2, q, n) for transformed sources p, by the
    search that ``params.nn_impl`` selects.  ``src_mask`` is read by the
    pruned search only."""
    impl = params.nn_impl

    def gathered(idx, d2):
        g = idx.to(torch.int64)[..., None].expand(idx.shape + (3,))
        return d2, torch.gather(tgt_points, 1, g), torch.gather(tgt_normals, 1, g)

    if impl == "vpu_tq":
        return lambda p: nn_search_vals(p.contiguous(), tgt_points, tgt_masks,
                                        tgt_normals)
    if impl == "xla":
        return lambda p: gathered(*nn_search_xla(p, tgt_points, tgt_masks))
    if impl == "pruned":
        sb = min(512, params.src_block)
        tb = min(512, params.tgt_block)
        gate = params.max_correspondence_distance
        return lambda p: gathered(*nn_search_pruned_presorted(
            p.contiguous(), src_mask, tgt_points, tgt_masks, gate, sb, tb))
    form = "vpu_t" if impl in ("auto", "pallas") else impl
    return lambda p: gathered(*nn_search(p.contiguous(), tgt_points, tgt_masks,
                                         form))


def icp_batch(src_points, src_masks, tgt_points, tgt_masks, tgt_normals,
              T_inits, params: ICPParams = ICPParams(),
              method: str = "point_to_plane") -> ICPResult:
    """ICP over a leading batch of B scan pairs.

    Shapes: src (B, S, 3) + (B, S); tgt (B, T, 3) + (B, T); tgt_normals
    (B, T, 3) or None; T_inits (B, 4, 4).  All on one device.
    """
    if method not in ("point_to_plane", "point_to_point"):
        raise ValueError(f"unknown ICP method {method!r}")
    if method == "point_to_plane" and tgt_normals is None:
        raise ValueError("point_to_plane ICP needs target normals")
    _check_nn_impl(params)
    if tgt_normals is None:
        tgt_normals = torch.zeros_like(tgt_points)
    src_pts, src_mask = src_points, src_masks
    if params.source_stride > 1:
        src_pts = src_pts[:, ::params.source_stride]
        src_mask = src_mask[:, ::params.source_stride]
    if params.nn_impl == "pruned":
        # both clouds Morton-sorted once: the target is fixed and a rigid
        # motion keeps the source's blocks compact; every reduction below
        # is over rows, so the order does not change the result's meaning
        src_pts, src_mask, _ = morton_sort(src_pts, src_mask,
                                           min(512, params.src_block))
        tgt_points, tgt_masks, t_order = morton_sort(
            tgt_points, tgt_masks, min(512, params.tgt_block))
        tgt_normals = torch.take_along_dim(
            pad_rows(tgt_normals, t_order.shape[1]), t_order[..., None], dim=1)
    src_pts = src_pts.contiguous()
    src_mask = src_mask.contiguous()
    src_mask_f = src_mask.to(src_pts.dtype)
    thr2 = params.max_correspondence_distance ** 2
    correspond = _correspondence(params, src_mask, tgt_points.contiguous(),
                                 tgt_masks.contiguous(), tgt_normals.contiguous())

    def metrics(d2, mask_f):
        gate = mask_f * (d2 <= thr2).to(mask_f.dtype)
        n_src = torch.clamp(torch.sum(mask_f, dim=-1), min=1.0)
        n_in = torch.sum(gate, dim=-1)
        rmse = torch.sqrt(torch.sum(d2 * gate, dim=-1)
                          / torch.clamp(n_in, min=1.0))
        return gate, n_in / n_src, rmse

    def make_step(pts, mask_f):
        def step(T):
            p = transform_points(T, pts)
            d2, q, n_corr = correspond(p)
            gate, fit, rmse = metrics(d2, mask_f)
            w = gate
            if params.robust:
                # Welsch IRLS: scale from the gated mean-square distance,
                # sharpened once by reweighting (no new NN sweep)
                sigma2 = (torch.sum(w * d2, dim=-1)
                          / torch.clamp(torch.sum(w, dim=-1), min=1.0))
                w1 = w * torch.exp(-d2 / torch.clamp(2.0 * sigma2, min=1e-8)[..., None])
                sigma2 = (torch.sum(w1 * d2, dim=-1)
                          / torch.clamp(torch.sum(w1, dim=-1), min=1e-6))
                w = w * torch.exp(-d2 / torch.clamp(2.0 * sigma2, min=1e-8)[..., None])
            if method == "point_to_plane":
                H, b = _gn_point_to_plane(p, n_corr, q, w)
            else:
                H, b = _gn_point_to_point(p, q, w)
            # Tikhonov floor: degenerate geometry must not blow up the solve
            trace = H.diagonal(dim1=-2, dim2=-1).sum(-1)
            damp = 1e-6 * (trace / 6.0 + 1.0)
            eye = torch.eye(6, dtype=H.dtype, device=H.device)
            xi = torch.linalg.solve_ex(H + damp[..., None, None] * eye,
                                       b[..., None])[0][..., 0]
            # a non-finite solve keeps T unchanged
            ok = torch.isfinite(xi).all(dim=-1, keepdim=True)
            xi = torch.where(ok, xi, torch.zeros_like(xi))
            return (compose(se3_exp(xi), T), torch.linalg.vector_norm(xi, dim=-1),
                    fit, rmse)
        return step

    def run_phase(T, step, max_iters, tol):
        B = T.shape[0]
        dev = T.device
        fit = torch.zeros(B, dtype=torch.float32, device=dev)
        rmse = torch.full((B,), torch.inf, dtype=torch.float32, device=dev)
        if params.convergence_tol > 0:
            it = torch.zeros(B, dtype=torch.int32, device=dev)
            delta = torch.full((B,), torch.inf, dtype=torch.float32, device=dev)
            active = (it < max_iters) & (delta > tol)
            while bool(active.any()):
                T_new, d, f, r = step(T)
                T = torch.where(active[:, None, None], T_new, T)
                delta = torch.where(active, d, delta)
                fit = torch.where(active, f, fit)
                rmse = torch.where(active, r, rmse)
                it = it + active.to(torch.int32)
                active = (it < max_iters) & (delta > tol)
            return T, it, delta, fit, rmse
        delta = torch.zeros(B, dtype=torch.float32, device=dev)
        for _ in range(max_iters):
            T, delta, fit, rmse = step(T)
        return (T, torch.full((B,), max_iters, dtype=torch.int32, device=dev),
                delta, fit, rmse)

    T = T_inits.to(torch.float32)
    iters = torch.zeros(T.shape[0], dtype=torch.int32, device=T.device)
    if params.coarse_factor > 1 and params.coarse_iterations > 0:
        f = params.coarse_factor
        T, it_c, _, _, _ = run_phase(
            T, make_step(src_pts[:, ::f], src_mask_f[:, ::f]),
            params.coarse_iterations, 10.0 * params.convergence_tol)
        iters = iters + it_c
    T, it_f, final_delta, fitness, rmse = run_phase(
        T, make_step(src_pts, src_mask_f), params.max_iterations,
        params.convergence_tol)
    iters = iters + it_f
    # zero iterations read as converged, not as the +inf initialiser
    final_delta = torch.where(it_f > 0, final_delta, 0.0)

    if params.exact_metrics or params.max_iterations == 0:
        d2, _, _ = correspond(transform_points(T, src_pts))
        _, fitness, rmse = metrics(d2, src_mask_f)
    return ICPResult(transform=T, fitness=fitness, inlier_rmse=rmse,
                     iterations=iters, final_delta=final_delta)


def icp(src: Cloud, tgt: Cloud, T_init: torch.Tensor,
        params: ICPParams = ICPParams(),
        method: str = "point_to_plane") -> ICPResult:
    """Refine T_init so that T @ src aligns with tgt (unbatched clouds).

    For 'point_to_plane' the target must carry ``normals``."""
    res = icp_batch(src.points[None], src.mask[None], tgt.points[None],
                    tgt.mask[None],
                    None if tgt.normals is None else tgt.normals[None],
                    T_init[None], params, method)
    return ICPResult(*(x[0] for x in res))


def icp_two_planes(src_ground: Cloud, tgt_ground: Cloud,
                   src_nonground: Cloud, tgt_nonground: Cloud,
                   T_init: torch.Tensor,
                   params: ICPParams = ICPParams()) -> ICPResult:
    """Point-to-plane ICP on the ground clouds (solution t1) and on the
    non-ground clouds (t2), fused per component: [tx, ty, gamma] from t2,
    [tz, alpha, beta] from t1 (reference keyframe.py:262-295): the ground
    fixes height and tilt, the structure the planar motion and heading.

    Batched clouds (B, CAP), the targets with normals, and T_init
    (B, 4, 4).  The two ICPs run as ONE ``icp_batch`` of 2B pairs, ground rows first: each
    pair's ICP is its own (it freezes on its own convergence), so the
    numbers are those of two calls, and the search launches once per
    iteration.  Returns the fused transform, the non-ground solve's
    fitness and inlier RMSE, the summed iterations and the larger
    final_delta."""
    B = T_init.shape[0]
    res = icp_batch(torch.cat([src_ground.points, src_nonground.points]),
                    torch.cat([src_ground.mask, src_nonground.mask]),
                    torch.cat([tgt_ground.points, tgt_nonground.points]),
                    torch.cat([tgt_ground.mask, tgt_nonground.mask]),
                    torch.cat([tgt_ground.normals, tgt_nonground.normals]),
                    torch.cat([T_init, T_init]), params, "point_to_plane")
    t1, t2 = t2v(res.transform[:B]), t2v(res.transform[B:])
    T = transform_from_euler(torch.stack([t2[:, 0], t2[:, 1], t1[:, 2]], dim=-1),
                             torch.stack([t1[:, 3], t1[:, 4], t2[:, 5]], dim=-1))
    return ICPResult(transform=T, fitness=res.fitness[B:],
                     inlier_rmse=res.inlier_rmse[B:],
                     iterations=res.iterations[:B] + res.iterations[B:],
                     final_delta=torch.maximum(res.final_delta[:B],
                                               res.final_delta[B:]))


def two_planes_pairs(points, normals, ground_mask, nonground_mask, si, ti,
                     seeds, params: ICPParams):
    """``icp_two_planes`` of the pairs (source scan si[k] onto target scan
    ti[k]) of a stack of split scans."""
    return icp_two_planes(
        Cloud(points[si], ground_mask[si]),
        Cloud(points[ti], ground_mask[ti], normals[ti]),
        Cloud(points[si], nonground_mask[si]),
        Cloud(points[ti], nonground_mask[ti], normals[ti]), seeds, params)
