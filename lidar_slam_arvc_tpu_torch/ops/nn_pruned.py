"""Distance-adaptive pruned NN sweep: K5, the CUDA kernel, and its plain
version.

Replaces ``lidar_slam_arvc_tpu/ops/nn_pruned.py`` (TPU kernel
``_pruned_kernel``), ICP's ``nn_impl="pruned"``: the correspondence search
that skips target blocks which cannot hold a neighbour inside the gate.
Contract: EXACT nearest neighbour for every source row whose true nearest
neighbour lies within ``gate``; rows with no target inside the gate report
d2 > gate^2 (gated ICP discards them either way).  d2 is the matmul form
``max(|t|^2 + pen - 2 s.t + |s|^2, 0)``; a masked winner reports ~1e12.

Both clouds are sorted by a 2-D Morton key so that fixed blocks of points
are spatially compact (``morton_sort``, hoisted out of the ICP loop).  Per
call come the block boxes, the lower bounds on the squared distance of
every (source block, target block) pair, pushed to 1e12 beyond the gate,
and each source block's nearest-first visiting order (a stable argsort:
among equal bounds the lower block comes first, and across blocks the
earlier-visited block wins a distance tie).  Everything takes a leading
batch (pair) axis.

``nn_search_pruned_presorted`` launches ``csrc/nn_pruned.cu`` for CUDA
tensors: one kernel per call, which does that preparation itself (rank
counting in place of the argsort).  For CPU tensors it runs
``nn_search_pruned_presorted_plain`` (``prepare`` in torch, then
``pruned_sweep_plain``).  A CUDA tensor never reaches the plain version:
a build or launch failure raises.
"""

from __future__ import annotations

import torch

from lidar_slam_arvc_tpu_torch.ops import _cuda
from lidar_slam_arvc_tpu_torch.ops.nn import BIG, _batched, _sq_norm, _unbatched

NEG = -1e12
MAX_SRC_BLOCK = 1024    # kMaxRows in nn_pruned.cu
MAX_TGT_BLOCK = 2048    # kMaxTile in nn_pruned.cu
MAX_TGT_BLOCKS = 1024   # kMaxTgtBlocks in nn_pruned.cu


def _morton_xy(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., N) 8-bit-per-axis interleaved xy key of (..., N, 3) points;
    invalid points get the largest int32, so they sort to the end."""
    v = valid[..., None]
    lo = torch.where(v, points, torch.inf).amin(dim=-2, keepdim=True)
    hi = torch.where(v, points, -torch.inf).amax(dim=-2, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((points - lo) / span * 255.0, 0.0, 255.0).to(torch.int32)

    def spread(x):  # 8 bits -> even bit positions of 16
        x = (x | (x << 4)) & 0x0F0F
        x = (x | (x << 2)) & 0x3333
        return (x | (x << 1)) & 0x5555

    key = (spread(q[..., 1]) << 1) | spread(q[..., 0])
    return torch.where(valid, key, 0x7FFFFFFF)


def pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad axis 1 of (B, N, ...) to n rows."""
    pad = n - x.shape[1]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], dim=1)


def morton_sort(points: torch.Tensor, mask: torch.Tensor, block: int = 512):
    """(points_sorted, mask_sorted, order) of (B, N, 3) points and (B, N)
    mask: padded to a block multiple, then stably sorted by Morton xy."""
    n = points.shape[1]
    n_pad = n + (-n) % block
    p = pad_rows(points, n_pad)
    m = pad_rows(mask, n_pad)
    order = torch.argsort(_morton_xy(p, m), dim=-1, stable=True)
    return (torch.take_along_dim(p, order[..., None], dim=1),
            torch.take_along_dim(m, order, dim=1), order)


def _block_boxes(points: torch.Tensor, valid: torch.Tensor, block: int):
    """(B, n, 3) lo / hi of the valid points of each block of ``block``
    consecutive points (+inf / -inf for a block with none)."""
    B, N, _ = points.shape
    p = points.reshape(B, N // block, block, 3)
    v = valid.reshape(B, N // block, block, 1)
    return (torch.where(v, p, torch.inf).amin(dim=2),
            torch.where(v, p, -torch.inf).amax(dim=2))


def _box_dist2(lo_a, hi_a, lo_b, hi_b):
    """(B, A, C) min squared distance between every box pair of (B, A, 3)
    and (B, C, 3) boxes; an empty box has gap +inf, counted as 1e12."""
    gap = torch.clamp(torch.maximum(lo_b[:, None] - hi_a[:, :, None],
                                    lo_a[:, :, None] - hi_b[:, None]), min=0.0)
    g = torch.where(torch.isfinite(gap), gap, BIG)
    g2 = g * g
    return (g2[..., 0] + g2[..., 1]) + g2[..., 2]


def prepare(ss, sv, ts, tv, gate: float, src_block: int, tgt_block: int):
    """The per-call preparation of the plain version, as the reference
    runs it outside its kernel (the CUDA kernel does the same inside):
    (perm, tile_d2, t2).  perm (B, n_i, n_j) int32 visits each source
    block's target blocks nearest-first; tile_d2 (B, n_i, n_j) f32 are
    their box bounds in that order; t2 (B, Tp) = |t|^2 + (0 or 1e12)."""
    d2 = _box_dist2(*_block_boxes(ss, sv, src_block),
                    *_block_boxes(ts, tv, tgt_block))
    # gate pre-prune: an f32 tensor against a Python float compares in
    # f32, against gate * gate rounded to f32 (the kernel's gate2)
    d2 = torch.where(d2 > gate * gate, BIG, d2)
    perm = torch.argsort(d2, dim=-1, stable=True)
    tile_d2 = torch.take_along_dim(d2, perm, dim=-1)
    t2 = _sq_norm(ts) + torch.where(tv, 0.0, BIG)
    return perm.to(torch.int32), tile_d2.contiguous(), t2


def pruned_sweep_plain(ss, sv, ts, t2, perm, tile_d2, src_block: int,
                       tgt_block: int, count_visits: bool = False):
    """Plain PyTorch K5 sweep over prepared inputs: the kernel's visiting
    and skipping rules, vectorised over (pair, source block), one step per
    visiting rank j.  With ``count_visits`` also returns the number of
    (pair, source block, target block) tiles scored and the sum over them
    of the valid source rows (the work the data needs)."""
    B, Sp, _ = ss.shape
    Tp = ts.shape[1]
    sb, tb = src_block, tgt_block
    n_i, n_j = Sp // sb, Tp // tb
    s = ss.reshape(B, n_i, sb, 1, 3)
    s2 = _sq_norm(ss).reshape(B, n_i, sb)
    valid = sv.reshape(B, n_i, sb)
    best = torch.where(valid, torch.inf, NEG).to(torch.float32)
    best_i = torch.zeros((B, n_i, sb), dtype=torch.int64, device=ss.device)
    t_blocks = ts.reshape(B, n_j, tb, 3)
    t2_blocks = t2.reshape(B, n_j, tb)
    perm = perm.to(torch.int64)
    tiles = rows = 0
    for j in range(n_j):
        bound = (best + s2).amax(dim=-1)                    # (B, n_i)
        visit = tile_d2[..., j] <= bound
        if not bool(visit.any()):
            continue
        k = perm[..., j]                                    # (B, n_i)
        t = torch.take_along_dim(t_blocks, k[..., None, None], dim=1)  # (B,n_i,tb,3)
        tt = torch.take_along_dim(t2_blocks, k[..., None], dim=1)      # (B,n_i,tb)
        t = t[:, :, None]                                   # (B, n_i, 1, tb, 3)
        cross = s[..., 0] * t[..., 0] + s[..., 1] * t[..., 1]
        cross = cross + s[..., 2] * t[..., 2]               # (B, n_i, sb, tb)
        score = tt[:, :, None] - 2.0 * cross
        m, a = torch.min(score, dim=-1)
        better = visit[..., None] & (m < best)
        best = torch.where(better, m, best)
        best_i = torch.where(better, a + k[..., None] * tb, best_i)
        if count_visits:
            tiles += int(visit.sum())
            rows += int((valid.sum(-1) * visit).sum())
    d2 = torch.clamp(best + s2, min=0.0).reshape(B, Sp)
    idx = torch.clamp(best_i, 0, Tp - 1).to(torch.int32).reshape(B, Sp)
    if count_visits:
        return idx, d2, tiles, rows
    return idx, d2


def _check_blocks(Sp, Tp, src_block, tgt_block):
    if Sp % src_block or Tp % tgt_block:
        raise ValueError(f"clouds of {Sp}/{Tp} rows are not whole blocks of "
                         f"{src_block}/{tgt_block}: morton_sort them first")


def nn_search_pruned_presorted_plain(ss, sv, ts, tv, gate: float,
                                     src_block: int = 512,
                                     tgt_block: int = 512):
    """Plain PyTorch K5: ``prepare`` + ``pruned_sweep_plain``."""
    ss, sv, ts, tv, batched = _batched(ss, sv, ts, tv)
    _check_blocks(ss.shape[1], ts.shape[1], src_block, tgt_block)
    perm, tile_d2, t2 = prepare(ss, sv, ts, tv, gate, src_block, tgt_block)
    idx, d2 = pruned_sweep_plain(ss, sv, ts, t2, perm, tile_d2, src_block,
                                 tgt_block)
    return _unbatched((idx, d2), batched)


def nn_search_pruned_presorted(ss: torch.Tensor, sv: torch.Tensor,
                               ts: torch.Tensor, tv: torch.Tensor,
                               gate: float, src_block: int = 512,
                               tgt_block: int = 512):
    """Pruned sweep over clouds already ``morton_sort``-ed (whole blocks).

    Args: ss (B, Sp, 3) f32 + sv (B, Sp) bool; ts (B, Tp, 3) f32 + tv
    (B, Tp) bool (or the same without B).  Returns (idx into ts, int32;
    d2, f32), in ss row order; invalid source rows get (0, 0)."""
    if ss.device.type == "cpu":
        return nn_search_pruned_presorted_plain(ss, sv, ts, tv, gate,
                                                src_block, tgt_block)
    if ss.device.type != "cuda":
        raise ValueError(f"nn_search_pruned: unsupported device {ss.device}")
    ss, sv, ts, tv, batched = _batched(ss, sv, ts, tv)
    B, Sp = ss.shape[:2]
    Tp = ts.shape[1]
    dev = ss.device
    _cuda.require(ss, "ss", torch.float32, (B, Sp, 3), dev)
    _cuda.require(sv, "sv", torch.bool, (B, Sp), dev)
    _cuda.require(ts, "ts", torch.float32, (B, Tp, 3), dev)
    _cuda.require(tv, "tv", torch.bool, (B, Tp), dev)
    if not (0 < src_block <= MAX_SRC_BLOCK and 0 < tgt_block <= MAX_TGT_BLOCK):
        raise ValueError(f"nn_search_pruned: blocks {src_block}/{tgt_block} "
                         f"outside 1..{MAX_SRC_BLOCK}/1..{MAX_TGT_BLOCK}")
    if Sp == 0 or Tp == 0:
        raise ValueError("nn_search_pruned: empty source or target cloud")
    _check_blocks(Sp, Tp, src_block, tgt_block)
    if Tp // tgt_block > MAX_TGT_BLOCKS:
        raise ValueError(f"nn_search_pruned: {Tp // tgt_block} target blocks, "
                         f"at most {MAX_TGT_BLOCKS}: use larger blocks")
    idx, d2 = _cuda.idx_d2_outputs(B, Sp, dev)
    lib = _cuda.library()
    with _cuda.on_device(dev):
        err = lib.nn_pruned_launch(
            ss.data_ptr(), sv.data_ptr(), ts.data_ptr(), tv.data_ptr(), B,
            Sp, Tp, src_block, tgt_block, gate * gate, _cuda.sm_count(dev),
            idx.data_ptr(), d2.data_ptr(), _cuda.stream_of(ss))
    _cuda.check(err, "nn_pruned")
    _cuda.launch_counts["nn_pruned"] += 1
    return _unbatched((idx, d2), batched)


def nn_search_pruned(src: torch.Tensor, src_mask: torch.Tensor,
                     tgt: torch.Tensor, tgt_mask: torch.Tensor, gate: float,
                     src_block: int = 512, tgt_block: int = 512):
    """(idx, d2) in the callers' point order: exact NN for rows whose NN
    is within ``gate``.  Invalid source rows return arbitrary values: mask
    them.  Repeated calls on the same clouds (ICP iterations) should
    ``morton_sort`` once and call ``nn_search_pruned_presorted``."""
    src, src_mask, tgt, tgt_mask, batched = _batched(src, src_mask, tgt,
                                                     tgt_mask)
    S = src.shape[1]
    ss, sv, s_order = morton_sort(src, src_mask, src_block)
    ts, tv, t_order = morton_sort(tgt, tgt_mask, tgt_block)
    idx_s, d2_s = nn_search_pruned_presorted(ss, sv, ts, tv, gate,
                                             src_block, tgt_block)
    # undo both sorts: indices point into sorted targets; rows are in
    # sorted source order
    idx_orig = torch.take_along_dim(t_order, idx_s.to(torch.int64), dim=1)
    inv = torch.argsort(s_order, dim=1)
    idx = torch.take_along_dim(idx_orig, inv, dim=1)[:, :S].to(torch.int32)
    d2 = torch.take_along_dim(d2_s, inv, dim=1)[:, :S]
    return _unbatched((idx, d2), batched)
