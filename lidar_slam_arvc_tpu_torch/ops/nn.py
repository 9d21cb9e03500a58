"""Exact nearest-neighbour sweeps: K1, K3 and K4, and their plain versions.

Replaces ``lidar_slam_arvc_tpu/ops/nn_pallas.py``, the correspondence
search of every ICP iteration.  Contract of every form: for each source
point the index (or the values) and the squared distance of the nearest
valid target, ties to the lowest target index.  The forms differ in how
d2 is formed and so in what a masked winner (only when every target is
masked) reports:

==========  ================================  =================  ==========
impl        TPU kernel                        d2                 masked d2
==========  ================================  =================  ==========
``vpu_t``   ``_nn_kernel_vpu_t`` (K1)         (dx²+dy²)+dz²,     >= ~4e14
                                              sentinel -4e7
``vpu2``    ``_nn_kernel_vpu2`` (K3)          as ``vpu_t``       >= ~4e14
``vpu``     ``_nn_kernel_vpu`` (K3)           ((dx²+dy²)+dz²)    ~1e12 + d2
                                              + pen (1e12)
``mxu``     ``_nn_kernel_mxu`` (K3)           max(t2 - 2 s.t     ~1e12
                                              + s2, 0)
==========  ================================  =================  ==========

``nn_search_vals`` (K4, ``_nn_kernel_vpu_tq``) is ``vpu_t`` returning the
winner's point and normal instead of its index.  ``nn_search_xla`` and
``nn2_search`` are the counterparts of ``lidar_slam_arvc_tpu/ops/nn.py``'s
``nn_search`` and ``nn2_search``, the JAX package's matmul-form sweeps for
points and for any feature width (the 33-D FPFH features), and
``radius_accumulate`` (raw-origin ball moments) is its namesake: plain
PyTorch there and here, no kernel.

``nn_search`` and ``nn_search_vals`` launch ``csrc/nn_sweep.cu`` and
``csrc/nn_sweep_vals.cu`` for CUDA tensors, one kernel per call (see
``csrc/nn_sweep.cuh`` for what bounds them on an H100 and how the launch
splits the target axis across a cluster), and run the plain versions for
CPU tensors.  A CUDA tensor never reaches a plain version: a build or
launch failure raises.
"""

from __future__ import annotations

import contextlib

import torch

from lidar_slam_arvc_tpu_torch.ops import _cuda

SENTINEL = -4e7
BIG = 1e12

# impl -> (d2 form of csrc/nn_sweep.cuh, launch-count key)
FORMS = {"vpu_t": (0, "nn_sweep"), "vpu2": (0, "nn_sweep_vpu2"),
         "vpu": (1, "nn_sweep_vpu"), "mxu": (2, "nn_sweep_mxu")}


def _batched(src, *rest):
    if src.dim() == 2:
        return (src[None], *(x[None] for x in rest), False)
    return (src, *rest, True)


def _unbatched(outs, batched):
    return outs if batched else tuple(x[0] for x in outs)


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    """(x*x + y*y) + z*z, each operation rounded on its own (the kernels'
    order)."""
    x, y, z = p.unbind(-1)
    return (x * x + y * y) + z * z


def _target_aux(tgt, tgt_mask, impl):
    """The per-target row the JAX wrapper builds outside its kernel: the
    penalty (``vpu``) or t2 = |t|^2 + penalty (``mxu``); None otherwise.
    The kernels form it while staging each target tile."""
    if impl not in ("vpu", "mxu"):
        return None
    pen = torch.where(tgt_mask, 0.0, BIG).to(torch.float32)
    return pen if impl == "vpu" else _sq_norm(tgt) + pen


def nn_search_plain(src: torch.Tensor, tgt: torch.Tensor,
                    tgt_mask: torch.Tensor, impl: str = "vpu_t",
                    max_elems: int | None = None):
    """Plain PyTorch K1/K3: the same contract and arithmetic, sweeping
    target chunks.

    Chunks of targets keep the (B, S, chunk) score tensor under
    ``max_elems`` (default: 2^24 on a card; on the CPU 2^16, at least 64
    targets, which keeps the temporaries in cache and runs ~2.4x faster
    at B=2, S=T=2048); across chunks the running best is replaced only
    on a strict <, and within a chunk ``min`` returns the first minimum,
    so ties go to the lowest index whatever the chunking, as in the
    kernels (which merge the target ranges of a cluster by the same
    rule)."""
    if impl not in FORMS:
        raise ValueError(f"unknown impl {impl!r} ({'|'.join(FORMS)})")
    src, tgt, tgt_mask, batched = _batched(src, tgt, tgt_mask)
    B, S, _ = src.shape
    T = tgt.shape[1]
    aux = _target_aux(tgt, tgt_mask, impl)
    if FORMS[impl][0] == 0:
        tgt = torch.where(tgt_mask[..., None], tgt, SENTINEL)
    best = torch.full((B, S), torch.inf, dtype=torch.float32, device=src.device)
    best_i = torch.zeros((B, S), dtype=torch.int64, device=src.device)
    if max_elems is None:
        cpu = src.device.type == "cpu"
        max_elems = max(1 << 16, 64 * B * S) if cpu else 1 << 24
    chunk = max(1, min(T, max_elems // max(B * S, 1)))
    sx, sy, sz = (src[..., a, None] for a in range(3))       # (B, S, 1)
    for c0 in range(0, T, chunk):
        t = tgt[:, None, c0:c0 + chunk]                         # (B, 1, C, 3)
        if impl == "mxu":
            cross = t[..., 0] * sx + t[..., 1] * sy
            cross = cross + t[..., 2] * sz
            d2 = aux[:, None, c0:c0 + chunk] - 2.0 * cross
        else:
            dx = t[..., 0] - sx
            dy = t[..., 1] - sy
            dz = t[..., 2] - sz
            d2 = dx * dx + dy * dy
            d2 = d2 + dz * dz
            if impl == "vpu":
                d2 = d2 + aux[:, None, c0:c0 + chunk]
        m, a = torch.min(d2, dim=-1)
        better = m < best
        best = torch.where(better, m, best)
        best_i = torch.where(better, a + c0, best_i)
    if impl == "mxu":
        best = torch.clamp(best + _sq_norm(src), min=0.0)
    return _unbatched((best_i.to(torch.int32), best), batched)


def _require_cloud(fn, src, tgt, tgt_mask, extra=()):
    B, S = src.shape[:2]
    T = tgt.shape[1]
    dev = src.device
    _cuda.require(src, "src", torch.float32, (B, S, 3), dev)
    _cuda.require(tgt, "tgt", torch.float32, (B, T, 3), dev)
    _cuda.require(tgt_mask, "tgt_mask", torch.bool, (B, T), dev)
    for name, x in extra:
        _cuda.require(x, name, torch.float32, (B, T, 3), dev)
    if S == 0 or T == 0:
        raise ValueError(f"{fn}: empty source or target cloud")
    return B, S, T, dev


def nn_search(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor,
              impl: str = "vpu_t"):
    """Nearest valid target per source point, in the d2 form ``impl``
    (``vpu_t`` = K1; ``vpu``, ``vpu2``, ``mxu`` = K3; see the module
    docstring).

    Args: src (B, S, 3) or (S, 3) f32; tgt (B, T, 3) or (T, 3) f32;
    tgt_mask (B, T) or (T,) bool.  Returns (idx int32, d2 f32), each
    shaped like ``src`` without its last axis.
    """
    if impl not in FORMS:
        raise ValueError(f"unknown impl {impl!r} ({'|'.join(FORMS)})")
    if src.device.type == "cpu":
        return nn_search_plain(src, tgt, tgt_mask, impl)
    if src.device.type != "cuda":
        raise ValueError(f"nn_search: unsupported device {src.device}")
    src, tgt, tgt_mask, batched = _batched(src, tgt, tgt_mask)
    B, S, T, dev = _require_cloud("nn_search", src, tgt, tgt_mask)
    form, key = FORMS[impl]
    idx, d2 = _cuda.idx_d2_outputs(B, S, dev)
    lib = _cuda.library()
    with _cuda.on_device(dev):
        err = lib.nn_sweep_launch(
            form, src.data_ptr(), tgt.data_ptr(), tgt_mask.data_ptr(), B, S,
            T, _cuda.sm_count(dev), idx.data_ptr(), d2.data_ptr(),
            _cuda.stream_of(src))
    _cuda.check(err, key)
    _cuda.launch_counts[key] += 1
    return _unbatched((idx, d2), batched)


def nn_search_vals_plain(src, tgt, tgt_mask, tgt_normals,
                         max_elems: int = 1 << 24):
    """Plain PyTorch K4: K1's plain sweep, then the winner's point and
    normal gathered by index."""
    src, tgt, tgt_mask, tgt_normals, batched = _batched(
        src, tgt, tgt_mask, tgt_normals)
    idx, d2 = nn_search_plain(src, tgt, tgt_mask, max_elems=max_elems)
    g = idx.to(torch.int64)[..., None].expand(idx.shape + (3,))
    return _unbatched((d2, torch.gather(tgt, 1, g),
                       torch.gather(tgt_normals, 1, g)), batched)


def nn_search_vals(src: torch.Tensor, tgt: torch.Tensor,
                   tgt_mask: torch.Tensor, tgt_normals: torch.Tensor):
    """K4: (d2, q, n) of the nearest valid target per source point, with
    d2 as ``nn_search(impl="vpu_t")`` and q, n the winner's point and
    normal (its real coordinates even when it is masked).

    Shapes as ``nn_search``; tgt_normals like ``tgt``.  Returns d2 shaped
    like ``src`` without its last axis, q and n like ``src``.
    """
    if src.device.type == "cpu":
        return nn_search_vals_plain(src, tgt, tgt_mask, tgt_normals)
    if src.device.type != "cuda":
        raise ValueError(f"nn_search_vals: unsupported device {src.device}")
    src, tgt, tgt_mask, tgt_normals, batched = _batched(
        src, tgt, tgt_mask, tgt_normals)
    B, S, T, dev = _require_cloud("nn_search_vals", src, tgt, tgt_mask,
                                  (("tgt_normals", tgt_normals),))
    # one allocation for the three outputs (the wrapper's host time is
    # the call's time at S = 2048); each is a contiguous view of it
    buf = torch.empty(7 * B * S, dtype=torch.float32, device=dev)
    d2 = buf[:B * S].view(B, S)
    q = buf[B * S:4 * B * S].view(B, S, 3)
    n = buf[4 * B * S:].view(B, S, 3)
    lib = _cuda.library()
    with _cuda.on_device(dev):
        err = lib.nn_sweep_vals_launch(
            src.data_ptr(), tgt.data_ptr(), tgt_mask.data_ptr(),
            tgt_normals.data_ptr(), B, S, T, _cuda.sm_count(dev),
            d2.data_ptr(), q.data_ptr(), n.data_ptr(), _cuda.stream_of(src))
    _cuda.check(err, "nn_sweep_vals")
    _cuda.launch_counts["nn_sweep_vals"] += 1
    return _unbatched((d2, q, n), batched)


def require_f32_matmul(t: torch.Tensor, who: str) -> None:
    """Raise if matmuls on ``t``'s device may round their inputs to TF32:
    ``torch.backends.cuda.matmul.allow_tf32``, which
    ``torch.set_float32_matmul_precision("high")`` or ``("medium")`` also
    switches on.  ``who`` names the caller in the message."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{who} need f32 matmuls; set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def radius_accumulate(query: torch.Tensor, tgt: torch.Tensor,
                      tgt_mask: torch.Tensor, radius: float,
                      query_block: int = 1024, tgt_block: int = 2048):
    """Raw-origin ball moments of every query point: (count (..., Q),
    S1 (..., Q, 3), S2 (..., Q, 6)), the sums of p and of the upper
    triangle of p p^T (xx, xy, xz, yy, yz, zz) over the valid targets p
    within ``radius`` of the query.

    Counterpart of the JAX package's ``ops/nn.py::radius_accumulate``, the
    moments of ``estimate_normals(impl="xla")``: d2 = (|q|^2 + |t|^2) -
    2 q.t with 1e12 added to |t|^2 of a masked target, and the weights w =
    [d2 <= r^2] summed and multiplied into the targets' features, in
    ``query_block`` x ``tgt_block`` tiles (1024 x 2048 f32 weights: 8 MB a
    cloud).  Plain PyTorch on every device: the reference computes this
    with XLA matmuls, outside any Pallas kernel.  The matmuls must stay
    f32: the covariance S2/n - m m^T of raw moments cancels
    catastrophically, so a CUDA call with TF32 matmuls on raises
    (``require_f32_matmul``).  Shapes: query (..., Q, 3), tgt (..., T, 3),
    tgt_mask (..., T), with the same leading dimensions."""
    require_f32_matmul(query, "radius_accumulate")
    lead = query.shape[:-2]
    q = query.reshape((-1,) + query.shape[-2:])
    t = tgt.reshape((-1,) + tgt.shape[-2:])
    m = tgt_mask.reshape((-1, tgt_mask.shape[-1]))
    r = torch.tensor(radius, dtype=q.dtype, device=q.device)
    r2 = r * r
    t2 = torch.sum(t * t, dim=-1) + torch.where(m, 0.0, BIG).to(q.dtype)
    x, y, z = t.unbind(-1)
    feats = torch.stack([x, y, z, x * x, x * y, x * z, y * y, y * z, z * z],
                        dim=-1)                                  # (B, T, 9)
    counts, moments = [], []
    for q0 in range(0, q.shape[1], query_block):
        qc = q[:, q0:q0 + query_block]
        s2 = torch.sum(qc * qc, dim=-1)[..., None]
        count = torch.zeros(qc.shape[:2], dtype=q.dtype, device=q.device)
        mom = torch.zeros(qc.shape[:2] + (9,), dtype=q.dtype, device=q.device)
        for t0 in range(0, t.shape[1], tgt_block):
            cross = torch.matmul(qc, t[:, t0:t0 + tgt_block].transpose(1, 2))
            d2 = (s2 + t2[:, None, t0:t0 + tgt_block]) - 2.0 * cross
            w = (d2 <= r2).to(q.dtype)
            count = count + torch.sum(w, dim=-1)
            mom = mom + torch.matmul(w, feats[:, t0:t0 + tgt_block])
        counts.append(count)
        moments.append(mom)
    count = torch.cat(counts, dim=1).reshape(lead + (q.shape[1],))
    mom = torch.cat(moments, dim=1).reshape(lead + (q.shape[1], 9))
    return count, mom[..., :3], mom[..., 3:]


@contextlib.contextmanager
def _full_f32_matmul():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def nn_search_xla(src: torch.Tensor, tgt: torch.Tensor,
                  tgt_mask: torch.Tensor, tgt_block: int = 2048):
    """Counterpart of the JAX package's ``ops/nn.py::nn_search``: the
    matmul form d2 = (s2 + t2) - 2 s.t, masked targets at t2 + 1e12, swept
    over target blocks (ties to the lowest index), clamped at 0.

    Plain PyTorch on every device (the JAX side is XLA, no Pallas kernel);
    s.t is a full-f32 ``torch.matmul`` (TF32 off for the call).  Shapes as
    ``nn_search``, with any width D in place of 3."""
    src, tgt, tgt_mask, batched = _batched(src, tgt, tgt_mask)
    B, S, _ = src.shape
    T = tgt.shape[1]
    s2 = torch.sum(src * src, dim=-1)[..., None]                 # (B, S, 1)
    t2 = torch.sum(tgt * tgt, dim=-1) + torch.where(tgt_mask, 0.0, BIG)
    best = torch.full((B, S), torch.inf, dtype=torch.float32, device=src.device)
    best_i = torch.zeros((B, S), dtype=torch.int64, device=src.device)
    with _full_f32_matmul():
        for c0 in range(0, T, tgt_block):
            cross = torch.matmul(src, tgt[:, c0:c0 + tgt_block].transpose(1, 2))
            d2 = (s2 + t2[:, None, c0:c0 + tgt_block]) - 2.0 * cross
            m, a = torch.min(d2, dim=-1)
            better = m < best
            best = torch.where(better, m, best)
            best_i = torch.where(better, a + c0, best_i)
    return _unbatched((best_i.to(torch.int32), torch.clamp(best, min=0.0)),
                      batched)


def nn2_search(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor,
               src_block: int = 1024):
    """The two nearest valid targets per source row, for ratio tests on
    feature matches: (idx1 int32, d2_1, d2_2), d2 clamped at 0.

    Counterpart of the JAX package's ``ops/nn.py::nn2_search``: the matmul
    form d2 = (s2 + t2) - 2 s.t (full f32, TF32 off), masked targets at
    t2 + 1e12, any width D.  ``idx1`` is the first index of the minimum,
    and ``d2_2`` the second-smallest value of the row's multiset, so a tie
    gives d2_2 == d2_1, as the reference's tile merge does.  Source rows
    are swept in blocks of ``src_block``.  Shapes (B, S, D), (B, T, D),
    (B, T) or unbatched."""
    src, tgt, tgt_mask, batched = _batched(src, tgt, tgt_mask)
    s2 = torch.sum(src * src, dim=-1)[..., None]
    t2 = (torch.sum(tgt * tgt, dim=-1) + torch.where(tgt_mask, 0.0, BIG))[:, None]
    outs = []
    with _full_f32_matmul():
        for s0 in range(0, src.shape[1], src_block):
            cross = torch.matmul(src[:, s0:s0 + src_block], tgt.transpose(1, 2))
            d2 = (s2[:, s0:s0 + src_block] + t2) - 2.0 * cross
            m1, i1 = torch.min(d2, dim=-1)
            m2 = torch.min(d2.scatter(-1, i1[..., None], torch.inf), dim=-1).values
            outs.append((i1, m1, m2))
    i1, m1, m2 = (torch.cat(x, dim=1) for x in zip(*outs))
    return _unbatched((i1.to(torch.int32), torch.clamp(m1, min=0.0),
                       torch.clamp(m2, min=0.0)), batched)
