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
Here that is a per-pair ``active`` mask; each pair's ``iterations`` and
``final_delta`` are its own.  The loop reads one boolean per iteration from
the device (``active.any()``).

A trip of the loop is the search, then ``ops.icp_step``, which does
everything else the step does and writes the next trip's transformed
sources: on a card, K6, so a trip is two hand-written kernels (K1 for the
default ``nn_impl``) and the one host read; on the CPU its plain version,
the eager step in plain PyTorch.  The numbers are the eager step's up to
the order of f32 sums.

Spans (``utils.profiling.span``, recorded only under a profiler): the call
is ``icp.group``, each trip of the loop ``icp.step`` (counted in
``utils.profiling.counts["icp_steps"]``), inside it ``icp.correspond`` and
``icp.update`` (inside that, on the CPU, the eager step's ``icp.assemble``
and ``icp.solve``), and each host read a ``sync.*`` span.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lidar_slam_arvc_tpu_torch.cloud.cloud import Cloud
from lidar_slam_arvc_tpu_torch.geom.se3 import t2v, transform_from_euler, transform_points
from lidar_slam_arvc_tpu_torch.ops.icp_step import _metrics, icp_step
from lidar_slam_arvc_tpu_torch.ops.nn import _nn_search, _nn_search_vals, nn_search_xla
from lidar_slam_arvc_tpu_torch.ops.nn_pruned import (
    morton_sort, nn_search_pruned_presorted, pad_rows,
)
from lidar_slam_arvc_tpu_torch.utils import profiling
from lidar_slam_arvc_tpu_torch.utils.profiling import span

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


def _check_nn_impl(params: ICPParams) -> None:
    if params.nn_impl not in NN_IMPLS:
        raise ValueError(f"unknown nn_impl {params.nn_impl!r} "
                         f"({' | '.join(NN_IMPLS)})")
    if (params.nn_impl == "pruned" and params.coarse_factor > 1
            and params.coarse_iterations > 0):
        raise ValueError("nn_impl='pruned' does not compose with the "
                         "coarse-to-fine schedule (strided sources "
                         "break the presorted block layout)")


def _search(params: ICPParams, tgt_points, tgt_masks, tgt_normals):
    """search(p, mask) -> (d2, idx, q, n) for transformed sources p and
    their mask, by the search that ``params.nn_impl`` selects: the nearest
    valid target's index, or (K4, ``vpu_tq``) its point and normal, the
    other pair None.  K1, K3 and K4 take the mask: a masked source reports
    index 0 (K4: target 0's point and normal) and d2 0.0, which the step's
    gate drops, and a block of masked sources is not swept.  The pruned
    search reads it too; the XLA sweep does not."""
    impl = params.nn_impl

    def by_index(idx, d2):
        return d2, idx, None, None

    if impl == "vpu_tq":
        def by_value(p, mask):
            d2, q, n = _nn_search_vals(p.contiguous(), tgt_points, tgt_masks, tgt_normals,
                                       mask)
            return d2, None, q, n
        return by_value
    if impl == "xla":
        return lambda p, mask: by_index(*nn_search_xla(p, tgt_points, tgt_masks))
    if impl == "pruned":
        sb = min(512, params.src_block)
        tb = min(512, params.tgt_block)
        gate = params.max_correspondence_distance
        return lambda p, mask: by_index(*nn_search_pruned_presorted(
            p.contiguous(), mask, tgt_points, tgt_masks, gate, sb, tb))
    form = "vpu_t" if impl in ("auto", "pallas") else impl
    return lambda p, mask: by_index(*_nn_search(p.contiguous(), tgt_points, tgt_masks, form,
                                                mask))


def icp_batch(src_points, src_masks, tgt_points, tgt_masks, tgt_normals,
              T_inits, params: ICPParams = ICPParams(),
              method: str = "point_to_plane") -> ICPResult:
    """ICP over a leading batch of B scan pairs.

    Shapes: src (B, S, 3) + (B, S); tgt (B, T, 3) + (B, T); tgt_normals
    (B, T, 3) or None; T_inits (B, 4, 4).  All on one device.
    """
    with span("icp.group"):
        return _icp_batch(src_points, src_masks, tgt_points, tgt_masks,
                          tgt_normals, T_inits, params, method)


def _icp_batch(src_points, src_masks, tgt_points, tgt_masks, tgt_normals,
               T_inits, params: ICPParams, method: str) -> ICPResult:
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
    thr2 = params.max_correspondence_distance ** 2
    tgt_points = tgt_points.contiguous()
    tgt_normals = tgt_normals.contiguous()
    search = _search(params, tgt_points, tgt_masks.contiguous(), tgt_normals)
    converge = params.convergence_tol > 0

    def run_phase(T, pts, mask, max_iters, tol):
        """Each trip is the search and ``icp_step``, which updates the state
        (T, delta, fit, rmse, it, active) in place and returns the sources
        under the new T.  With ``convergence_tol`` 0 every pair steps
        ``max_iters`` times and nothing is read back (``tol`` -inf keeps
        every pair active to its last step).  Returns (T, it, delta, fit,
        rmse)."""
        B = T.shape[0]
        dev = T.device
        if not converge:
            tol = -math.inf
        T = T.clone(memory_format=torch.contiguous_format)
        fit = torch.zeros(B, dtype=torch.float32, device=dev)
        rmse = torch.full((B,), torch.inf, dtype=torch.float32, device=dev)
        it = torch.zeros(B, dtype=torch.int32, device=dev)
        delta = torch.full((B,), torch.inf if converge else 0.0, dtype=torch.float32,
                           device=dev)
        active = (it < max_iters) & (delta > tol)
        state = (T, delta, fit, rmse, it, active)
        pts = pts.contiguous()
        mask = mask.contiguous()
        mask_f = mask.to(pts.dtype)
        p = transform_points(T, pts)
        if converge:
            with span("sync.icp_converged"):
                go = bool(active.any())
        else:
            go = max_iters > 0
        trips = 0
        while go:
            with span("icp.step"):
                with span("icp.correspond"):
                    d2, idx, q, n = search(p, mask)
                with span("icp.update"):
                    p = icp_step(pts, p, mask_f, d2, idx, q, n, tgt_points, tgt_normals,
                                 state, thr2=thr2, robust=params.robust,
                                 point_to_plane=method == "point_to_plane",
                                 max_iters=max_iters, tol=tol)
                trips += 1
                if converge:
                    with span("sync.icp_converged"):
                        go = bool(active.any())
                else:
                    go = trips < max_iters
            profiling.count("icp_steps", 1)
        return T, it, delta, fit, rmse

    T = T_inits.to(torch.float32)
    iters = torch.zeros(T.shape[0], dtype=torch.int32, device=T.device)
    if params.coarse_factor > 1 and params.coarse_iterations > 0:
        f = params.coarse_factor
        T, it_c, _, _, _ = run_phase(
            T, src_pts[:, ::f], src_mask[:, ::f],
            params.coarse_iterations, 10.0 * params.convergence_tol)
        iters = iters + it_c
    T, it_f, final_delta, fitness, rmse = run_phase(
        T, src_pts, src_mask, params.max_iterations, params.convergence_tol)
    iters = iters + it_f
    # zero iterations read as converged, not as the +inf initialiser
    final_delta = torch.where(it_f > 0, final_delta, 0.0)

    if params.exact_metrics or params.max_iterations == 0:
        d2 = search(transform_points(T, src_pts), src_mask)[0]
        _, fitness, rmse = _metrics(d2, src_mask.to(src_pts.dtype), thr2)
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
