"""Query-centred ball moments: K2, the CUDA kernel, and its plain version.

Replaces ``lidar_slam_arvc_tpu/ops/moments_pallas.py::ball_moments_pallas``
(TPU kernel ``_ball_kernel``), the neighbour half of normal estimation.
Contract: for each valid query q, over the valid targets t with
``(dx*dx + dy*dy) + dz*dz <= r*r`` (inclusive, self included):
count, S1 = sum (t - q), S2 = upper triangle (xx, xy, xz, yy, yz, zz) of
sum (t - q)(t - q)^T.  Rows whose query is masked are zeros.

``ball_moments`` launches ``csrc/ball_moments.cu`` for CUDA tensors, one
kernel per call that also builds the target tile boxes (see the source for
what bounds it on an H100 and how tile skipping works), and runs
``ball_moments_plain`` for CPU tensors.  A CUDA tensor never reaches the
plain version: a build or launch failure raises.  ``tile_boxes`` and
``scored_pairs`` reckon the kernel's work at its shipped query block and
tile; they are not on its path.
"""

from __future__ import annotations

import torch

from lidar_slam_arvc_tpu_torch.ops import _cuda

SENTINEL = -4e7
# the kernel's shipped kQb and kTile (csrc/ball_moments.cu): queries per
# CTA, targets per tile box
QUERY_BLOCK = 64
TILE = 128


def _batched(query, tgt, tgt_mask, query_mask):
    if query_mask is None:
        query_mask = torch.ones(query.shape[:-1], dtype=torch.bool,
                                device=query.device)
    if query.dim() == 2:
        return query[None], tgt[None], tgt_mask[None], query_mask[None], False
    return query, tgt, tgt_mask, query_mask, True


def _split(out: torch.Tensor, batched: bool):
    if not batched:
        out = out[0]
    return out[..., 0], out[..., 1:4], out[..., 4:10]


def ball_moments_plain(query, tgt, tgt_mask, radius: float,
                       query_mask=None, max_elems: int | None = None):
    """Plain PyTorch K2: the same contract, in query chunks so that no
    (Q, T) tensor larger than ``max_elems`` is built (default: 2^23 on a
    card; on the CPU 2^16, at least 16 queries, which keeps the
    temporaries in cache and runs ~4.5x faster at B=2, Q=T=2048).  Each
    query's sums are over its own row, so the chunking does not change
    them."""
    query, tgt, tgt_mask, query_mask, batched = _batched(
        query, tgt, tgt_mask, query_mask)
    B, Q, _ = query.shape
    T = tgt.shape[1]
    r2 = torch.tensor(float(radius) ** 2, dtype=torch.float32,
                      device=query.device)
    tgt_s = torch.where(tgt_mask[..., None], tgt, SENTINEL)[:, None]  # (B,1,T,3)
    if max_elems is None:
        cpu = query.device.type == "cpu"
        max_elems = max(1 << 16, 16 * B * T) if cpu else 1 << 23
    chunk = max(1, min(Q, max_elems // max(B * T, 1)))
    outs = []
    for q0 in range(0, Q, chunk):
        q = query[:, q0:q0 + chunk, None, :]                           # (B,C,1,3)
        dx = tgt_s[..., 0] - q[..., 0]
        dy = tgt_s[..., 1] - q[..., 1]
        dz = tgt_s[..., 2] - q[..., 2]
        d2 = dx * dx + dy * dy
        d2 = d2 + dz * dz
        w = (d2 <= r2).to(torch.float32)
        wx, wy, wz = w * dx, w * dy, w * dz
        outs.append(torch.stack([
            w.sum(-1), wx.sum(-1), wy.sum(-1), wz.sum(-1),
            (wx * dx).sum(-1), (wx * dy).sum(-1), (wx * dz).sum(-1),
            (wy * dy).sum(-1), (wy * dz).sum(-1), (wz * dz).sum(-1),
        ], dim=-1))
    out = torch.cat(outs, dim=1) * query_mask[..., None]
    return _split(out, batched)


def summation_tolerance(count, radius: float, power: int):
    """Bound on |kernel - plain| for a moment that sums ``count`` f32
    terms of magnitude <= radius**power in two different orders.

    Each order is within (count-1)*u*sum|x| of the exact sum (u = 2**-24)
    and the kernel's fused multiply-adds round each product once less; a
    factor 4 covers both orders and the product rounding."""
    return 4.0 * count * count * 2.0 ** -24 * radius ** power + 1e-12


def tile_boxes(points: torch.Tensor, mask: torch.Tensor, tile: int = TILE):
    """(B, ceil(N/tile), 3) lo / hi of the valid points of each run of
    ``tile`` consecutive points (+inf / -inf for a run with none)."""
    B, N, _ = points.shape
    pad = (-N) % tile
    if pad:
        points = torch.cat([points, points.new_zeros((B, pad, 3))], dim=1)
        mask = torch.cat([mask, mask.new_zeros((B, pad))], dim=1)
    p = points.view(B, -1, tile, 3)
    v = mask.view(B, -1, tile, 1)
    lo = torch.where(v, p, torch.inf).amin(dim=2)
    hi = torch.where(v, p, -torch.inf).amax(dim=2)
    return lo.contiguous(), hi.contiguous()


def scored_pairs(query, tgt, tgt_mask, radius: float, query_mask=None,
                 query_block: int = QUERY_BLOCK, tile: int = TILE
                 ) -> tuple[int, int]:
    """(tiles, pairs) the kernel scores: the (query block, target tile)
    pairs whose box gap does not exceed the radius, and the sum over them
    of valid queries x tile targets.  The skip test as in
    ``ball_moments.cu`` (by default its shipped blocks of QUERY_BLOCK
    queries and tiles of TILE targets); for reckoning the kernel's work,
    not for its results."""
    query, tgt, tgt_mask, query_mask, _ = _batched(query, tgt, tgt_mask,
                                                   query_mask)
    lo, hi = tile_boxes(tgt, tgt_mask, tile)                        # (B, nt, 3)
    qlo, qhi = tile_boxes(query, query_mask, query_block)           # (B, nq, 3)
    gap = torch.maximum(lo[:, None] - qhi[:, :, None], qlo[:, :, None] - hi[:, None])
    gap = torch.where(torch.isfinite(gap), gap.clamp(min=0.0), 1e12)
    visit = (gap * gap).sum(-1) <= float(radius) ** 2               # (B, nq, nt)
    T = tgt.shape[1]
    n_tgt = torch.clamp(T - tile * torch.arange(lo.shape[1], device=tgt.device),
                        max=tile)
    pad = (-query_mask.shape[1]) % query_block
    n_q = torch.cat([query_mask, query_mask.new_zeros((query_mask.shape[0], pad))],
                    dim=1).view(query_mask.shape[0], -1, query_block).sum(-1)
    pairs = (visit * n_q[..., None] * n_tgt).sum()
    return int(visit.sum()), int(pairs)


def ball_moments(query: torch.Tensor, tgt: torch.Tensor,
                 tgt_mask: torch.Tensor, radius: float,
                 query_mask: torch.Tensor | None = None):
    """Ball moments of every query.

    Args: query (B, Q, 3) or (Q, 3) f32; tgt (B, T, 3) or (T, 3) f32;
    tgt_mask (B, T) or (T,) bool; radius a Python float (fixed for the
    launch); query_mask like ``query`` without its last axis (default: all
    valid).  Returns (count (.., Q), S1 (.., Q, 3), S2 (.., Q, 6)) f32.
    On the card T is at most 4096 tiles of TILE targets (524,288 points;
    the kernel keeps its list of tiles in shared memory); a larger cloud
    raises.
    """
    if query.device.type == "cpu":
        return ball_moments_plain(query, tgt, tgt_mask, radius, query_mask)
    if query.device.type != "cuda":
        raise ValueError(f"ball_moments: unsupported device {query.device}")
    batched = query.dim() == 3
    if not batched:   # views: no launch
        query, tgt, tgt_mask = query[None], tgt[None], tgt_mask[None]
        if query_mask is not None:
            query_mask = query_mask[None]
    B, Q = query.shape[:2]
    T = tgt.shape[1]
    dev = query.device
    _cuda.require(query, "query", torch.float32, (B, Q, 3), dev)
    _cuda.require(tgt, "tgt", torch.float32, (B, T, 3), dev)
    _cuda.require(tgt_mask, "tgt_mask", torch.bool, (B, T), dev)
    if query_mask is not None:
        _cuda.require(query_mask, "query_mask", torch.bool, (B, Q), dev)
    if Q == 0 or T == 0:
        raise ValueError("ball_moments: empty query or target cloud")
    out = torch.empty((B, Q, 10), dtype=torch.float32, device=dev)
    lib = _cuda.library()
    with _cuda.on_device(dev):
        err = lib.ball_moments_launch(
            query.data_ptr(), None if query_mask is None else query_mask.data_ptr(),
            tgt.data_ptr(), tgt_mask.data_ptr(), B, Q, T, float(radius) ** 2,
            out.data_ptr(), _cuda.stream_of(query))
    _cuda.check(err, "ball_moments")
    _cuda.launch_counts["ball_moments"] += 1
    return _split(out, batched)
