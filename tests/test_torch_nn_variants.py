"""The port's K3, K4, K5 and XLA-form searches: plain versions vs the JAX
package.

On the CPU each wrapper runs its kernel's plain PyTorch version; those are
held against the JAX package's functions on the same numpy inputs, its
Pallas kernels in interpret mode as its own tests run them
(``tests/test_cloud_ops.py``, ``tests/test_nn_pruned.py``).  The CUDA
kernels themselves are compared with their plain versions in
``tests/test_torch_cuda.py``.  Tolerances:

* per-coordinate forms (``vpu``, ``vpu2``, K4): indices equal, d2 within 2
  f32 ulp: XLA on the CPU contracts both multiply-adds of
  (dx*dx + dy*dy) + dz*dz into FMAs, the port rounds every operation (as
  its kernels do, bit-equal to the plain versions on the card);
* matmul forms (``mxu``, ``pruned``, ``xla``): indices equal wherever the
  nearest neighbour is unique by more than the tolerance, d2 within
  atol 1e-3: |t|^2 - 2 s.t cancels terms of ~10^3 at 10-30 m coordinates,
  and the two packages sum s.t in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lidar_slam_arvc_tpu.ops import nn_pruned as pruned_ref
from lidar_slam_arvc_tpu.ops.nn import nn_search as xla_ref
from lidar_slam_arvc_tpu.ops.nn_pallas import nn_search_pallas, nn_search_pallas_vals
from lidar_slam_arvc_tpu_torch.ops import _cuda, nn_pruned
from lidar_slam_arvc_tpu_torch.ops.nn import (
    FORMS, _nn_search, _nn_search_vals, nn_search, nn_search_plain, nn_search_vals,
    nn_search_vals_plain, nn_search_xla, swept_pairs)
from lidar_slam_arvc_tpu_torch.utils import moments_variants, sass, sweep_variants

torch.set_num_threads(1)

MATMUL_ATOL = 1e-3


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _clouds(rng, S, T, scale=10.0, masked=0.3):
    """Sources, targets (10% duplicated: exact ties) and a target mask."""
    src = (rng.normal(size=(S, 3)) * scale).astype(np.float32)
    tgt = (rng.normal(size=(T, 3)) * scale).astype(np.float32)
    tgt[rng.integers(0, T, T // 10)] = tgt[rng.integers(0, T, T // 10)]
    src[: S // 4] = tgt[rng.integers(0, T, S // 4)]
    return src, tgt, rng.uniform(size=T) > masked


def _unique_rows(src, tgt, mask, margin=2 * MATMUL_ATOL):
    """Rows whose valid targets within ``margin`` (in d2) of the nearest all
    sit at the nearest one's coordinates (exact duplicates tie by index in
    both packages)."""
    d = ((src[:, None].astype(np.float64) - tgt[None]) ** 2).sum(-1)
    d[:, ~mask] = np.inf
    near = d <= d.min(1, keepdims=True) + margin
    first = tgt[d.argmin(1)]
    same = (tgt[None] == first[:, None]).all(-1)
    return (~near | same).all(1)


@pytest.mark.parametrize("impl", ["vpu", "vpu2", "mxu"])
@pytest.mark.parametrize("S,T,sb,tb", [(300, 500, 128, 128),
                                       (77, 131, 64, 128)])
def test_k3_plain_matches_pallas(rng, impl, S, T, sb, tb):
    src, tgt, mask = _clouds(rng, S, T)
    i_ref, d_ref = (np.asarray(x) for x in nn_search_pallas(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), src_block=sb,
        tgt_block=tb, interpret=True, impl=impl))
    i, d = nn_search_plain(t(src), t(tgt), t(mask), impl=impl)
    assert i.dtype == torch.int32 and d.dtype == torch.float32
    if impl == "mxu":
        u = _unique_rows(src, tgt, mask)
        assert u.mean() > 0.9
        np.testing.assert_array_equal(i.numpy()[u], i_ref[u])
        np.testing.assert_allclose(d.numpy(), d_ref, atol=MATMUL_ATOL)
    else:
        np.testing.assert_array_equal(i.numpy(), i_ref)
        np.testing.assert_array_max_ulp(d.numpy(), d_ref, maxulp=2)


@pytest.mark.parametrize("impl,lo,hi", [("vpu", 1e12, 1.1e12),
                                        ("vpu2", 4e14, np.inf),
                                        ("mxu", 0.99e12, 1.01e12)])
def test_k3_all_masked_winner(rng, impl, lo, hi):
    """Every target masked: index 0 in both packages, and d2 in the form's
    own range (``vpu`` ~1e12 plus the real distance, ``vpu2`` >= ~4e14,
    ``mxu`` ~1e12 after the + |s|^2 and the clamp)."""
    src, tgt, _ = _clouds(rng, 40, 70)
    none = np.zeros(70, dtype=bool)
    i_ref, d_ref = (np.asarray(x) for x in nn_search_pallas(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(none), src_block=64,
        tgt_block=128, interpret=True, impl=impl))
    i, d = nn_search_plain(t(src), t(tgt), t(none), impl=impl)
    assert (i.numpy() == 0).all() and (i_ref == 0).all()
    assert ((d.numpy() >= lo) & (d.numpy() <= hi)).all()
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=1e-6)


@pytest.mark.parametrize("S,T", [(300, 500), (77, 131)])
def test_k4_plain_matches_pallas(rng, S, T):
    """d2 as K1's (to 2 ulp of the JAX side); q and n are exactly the
    winner's point and normal, the masked ones included."""
    src, tgt, mask = _clouds(rng, S, T)
    nrm = rng.normal(size=(T, 3)).astype(np.float32)
    d_ref, q_ref, n_ref = (np.asarray(x) for x in nn_search_pallas_vals(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
        jnp.asarray(nrm), src_block=128, tgt_block=128, interpret=True))
    d, q, n = nn_search_vals(t(src), t(tgt), t(mask), t(nrm))
    np.testing.assert_array_max_ulp(d.numpy(), d_ref, maxulp=2)
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_equal(n.numpy(), n_ref)
    i, d1 = nn_search(t(src), t(tgt), t(mask))
    assert torch.equal(d, d1)
    np.testing.assert_array_equal(q.numpy(), tgt[i.numpy()])
    none = np.zeros(T, dtype=bool)
    d, q, _ = nn_search_vals(t(src), t(tgt), t(none), t(nrm))
    assert (d.numpy() > 4e14).all()
    np.testing.assert_array_equal(q.numpy(), np.broadcast_to(tgt[0], q.shape))


@pytest.mark.parametrize("S,T", [(300, 500), (77, 131)])
def test_xla_form_matches_jax_nn_search(rng, S, T):
    src, tgt, mask = _clouds(rng, S, T)
    i_ref, d_ref = (np.asarray(x) for x in xla_ref(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), src_block=64,
        tgt_block=128))
    i, d = nn_search_xla(t(src), t(tgt), t(mask), tgt_block=128)
    u = _unique_rows(src, tgt, mask)
    assert u.mean() > 0.9
    np.testing.assert_array_equal(i.numpy()[u], i_ref[u])
    np.testing.assert_allclose(d.numpy(), d_ref, atol=MATMUL_ATOL)
    assert (d.numpy() >= 0).all()


def test_morton_sort_and_boxes_equal_reference(rng):
    """Morton keys, the stable sort order, block boxes and box distances
    are bit-equal to the reference's (the visiting order and so the tie
    rule depend on them)."""
    pts = rng.uniform(-20, 20, (600, 3)).astype(np.float32)
    m = rng.uniform(size=600) > 0.1
    tgt = rng.uniform(-20, 20, (640, 3)).astype(np.float32)
    tm = rng.uniform(size=640) > 0.1
    tm[256:384] = False                 # whole masked runs: empty boxes
    key_ref = np.asarray(pruned_ref._morton_xy(jnp.asarray(pts), jnp.asarray(m)))
    np.testing.assert_array_equal(nn_pruned._morton_xy(t(pts), t(m)).numpy(),
                                  key_ref)
    boxes = []
    for p, v in ((pts, m), (tgt, tm)):
        ps_r, ms_r, o_r = pruned_ref.morton_sort(jnp.asarray(p), jnp.asarray(v), 128)
        ps, ms, o = nn_pruned.morton_sort(t(p)[None], t(v)[None], 128)
        np.testing.assert_array_equal(o[0].numpy(), np.asarray(o_r))
        np.testing.assert_array_equal(ps[0].numpy(), np.asarray(ps_r))
        lo_r, hi_r = pruned_ref._block_boxes(ps_r, ms_r, 128)
        lo, hi = nn_pruned._block_boxes(ps, ms, 128)
        np.testing.assert_array_equal(lo[0].numpy(), np.asarray(lo_r))
        np.testing.assert_array_equal(hi[0].numpy(), np.asarray(hi_r))
        boxes.append(((lo, hi), (lo_r, hi_r)))
    (a, a_r), (b, b_r) = boxes
    d2 = nn_pruned._box_dist2(*a, *b)[0].numpy()
    np.testing.assert_array_equal(d2, np.asarray(pruned_ref._box_dist2(*a_r, *b_r)))
    assert (d2 == 3e24).any() and (d2 == 0).any()


@pytest.mark.parametrize("case", ["uniform", "icp_like", "far"])
def test_k5_plain_matches_pruned_reference(rng, case):
    """nn_search_pruned of both packages (128-row blocks): within the gate
    indices equal where unique and d2 within MATMUL_ATOL; beyond it both
    report d2 > gate^2."""
    if case == "uniform":
        src, tgt, tmask = _clouds(rng, 600, 700, scale=12.0, masked=0.1)
        smask, gate = rng.uniform(size=600) > 0.1, 5.0
    elif case == "icp_like":
        tgt = rng.uniform(-30, 30, (512, 3)).astype(np.float32)
        src = tgt + rng.normal(scale=0.01, size=tgt.shape).astype(np.float32)
        smask = tmask = np.ones(512, bool)
        gate = 10.0
    else:
        src = rng.uniform(0, 1, (128, 3)).astype(np.float32)
        tgt = src + np.array([100.0, 0, 0], np.float32)
        smask = tmask = np.ones(128, bool)
        gate = 2.0
    i_ref, d_ref = (np.asarray(x) for x in pruned_ref.nn_search_pruned(
        jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt),
        jnp.asarray(tmask), gate, src_block=128, tgt_block=128,
        interpret=True))
    i, d = (x.numpy() for x in nn_pruned.nn_search_pruned(
        t(src), t(smask), t(tgt), t(tmask), gate, src_block=128, tgt_block=128))
    best = ((src[:, None].astype(np.float64) - tgt[None]) ** 2).sum(-1)
    best[:, ~tmask] = np.inf
    inside = smask & (best.min(1) <= gate * gate)
    outside = smask & ~inside
    u = inside & _unique_rows(src, tgt, tmask)
    np.testing.assert_array_equal(i[u], i_ref[u])
    np.testing.assert_allclose(d[inside], d_ref[inside], atol=MATMUL_ATOL)
    assert (d[outside] > gate * gate * 0.999).all()
    assert (d_ref[outside] > gate * gate * 0.999).all()
    assert inside.any() if case != "far" else outside.all()


def test_k5_presorted_invalid_rows_and_visits(rng):
    """Presorted form, batched: invalid source rows come out (0, 0) and
    never block skipping; the visit count shows far tiles skipped."""
    a = rng.normal(scale=0.5, size=(2, 384, 3)).astype(np.float32)
    a[:, 128:256] += 20.0               # two clusters, one 128-row block each
    sv = np.ones((2, 384), bool)
    sv[:, 256:] = False                 # invalid rows sort into a third block
    ss, svv, _ = nn_pruned.morton_sort(t(a), t(sv), 128)
    ts, tv, _ = nn_pruned.morton_sort(t(a[:, :256]),
                                      torch.ones((2, 256), dtype=torch.bool), 128)
    idx, d2 = nn_pruned.nn_search_pruned_presorted(ss, svv, ts, tv, 10.0, 128, 128)
    inv = ~svv
    assert (idx[inv] == 0).all() and (d2[inv] == 0).all()
    np.testing.assert_allclose(d2[svv].numpy(), 0.0, atol=MATMUL_ATOL)
    perm, tile_d2, t2 = nn_pruned.prepare(ss, svv, ts, tv, 10.0, 128, 128)
    *_, tiles, rows = nn_pruned.pruned_sweep_plain(ss, svv, ts, t2, perm,
                                                  tile_d2, 128, 128,
                                                  count_visits=True)
    assert tiles == 4 and rows == int(svv.sum())    # the far cluster skipped
    i1, d1 = nn_pruned.nn_search_pruned_presorted(ss[1], svv[1], ts[1], tv[1],
                                                  10.0, 128, 128)
    assert torch.equal(i1, idx[1]) and torch.equal(d1, d2[1])
    with pytest.raises(ValueError, match="whole blocks"):
        nn_pruned.nn_search_pruned_presorted(ss[:, :200], svv[:, :200], ts, tv,
                                             10.0, 128, 128)


@pytest.mark.parametrize("impl", sorted(FORMS))
def test_plain_sweep_equal_for_every_chunking(rng, impl):
    """The merge rule the split sweep relies on: target ranges swept with a
    strict <, then merged in ascending order by a strict <, give the
    unsplit (idx, d2) exactly.  Every chunking of nn_search_plain is such
    a split; duplicated targets straddle each chunk boundary, with a
    source on them, and one batch row has every target masked."""
    B, S, T = 2, 40, 97
    src, tgt, mask = _clouds(rng, S, T)
    src, tgt = np.stack([src, src[::-1]]), np.stack([tgt, tgt])
    mask = np.stack([mask, np.zeros(T, bool)])
    chunks = (1, 5, 7, 16, 50, T)
    for n, edge in enumerate(sorted({e for c in chunks for e in range(c, T, c)})):
        tgt[:, edge] = tgt[:, edge - 1]
        src[:, n % S] = tgt[:, edge]
    mask[0, 1:] |= mask[0, :-1]           # both sides of a tie valid somewhere
    ref = nn_search_plain(t(src), t(tgt), t(mask), impl, max_elems=1 << 24)
    for c in chunks:
        got = nn_search_plain(t(src), t(tgt), t(mask), impl, max_elems=c * B * S)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), c
    assert (ref[0][1] == 0).all()


@pytest.mark.parametrize("impl", sorted(FORMS))
def test_chunk_edges_inside_tied_runs_keep_the_lowest_index(rng, impl):
    """Runs of one repeated target (exact ties) with every chunk edge of
    the plain sweep inside some run, and sources on the runs: every
    chunking returns the run's first valid index, and equidistant targets
    (the same d2 from other points) the lowest of them."""
    B, S, T = 2, 24, 120
    src, tgt, mask = _clouds(rng, S, T, masked=0.2)
    src, tgt, mask = np.stack([src, src]), np.stack([tgt, tgt]), np.stack([mask, mask])
    runs = [(3, 12), (14, 41), (45, 47), (60, 99)]       # [start, end) of each run
    for k, (a, e) in enumerate(runs):
        tgt[:, a:e] = tgt[:, a:a + 1]
        mask[:, a] = mask[:, a + 1] = True
        src[:, k] = tgt[:, a]
    mask[1, 14:30] = False                # row 1: run 2 starts valid at 30
    mask[1, 30] = True
    # two targets at the same distance from source 5 in other chunks
    src[:, 5] = 0.0
    tgt[:, 101], tgt[:, 110] = (0.5, 0.0, 0.0), (0.0, -0.5, 0.0)
    mask[:, [101, 110]] = True
    got = [nn_search_plain(t(src), t(tgt), t(mask), impl, max_elems=c * B * S)
           for c in (1, 2, 4, 5, 8, 13, 16, T)]
    idx = got[0][0]
    for i, d in got[1:]:
        assert torch.equal(i, idx) and torch.equal(d, got[0][1])
    assert idx[0, :4].tolist() == [3, 14, 45, 60]
    assert idx[1, :4].tolist() == [3, 30, 45, 60]
    if impl != "mxu":                     # the matmul form's d2 is |t|^2 - 2 s.t
        assert idx[:, 5].tolist() == [101, 101]


@pytest.mark.parametrize("impl", sorted(FORMS) + ["vals"])
def test_masked_sources_report_index_0_and_d2_0(rng, impl):
    """The plain versions' source-mask contract, as K1, K3 and K4 keep it:
    a masked source reports index 0 (K4: target 0's point and normal) and
    d2 0.0; the others what the search without a mask gives, which the
    private entries give unchanged for a mask of None; batched and
    unbatched alike."""
    B, S, T = 3, 50, 90
    src, tgt, mask = _clouds(rng, S, T)
    src, tgt = np.stack([src] * B), np.stack([tgt] * B)
    mask = np.stack([mask, mask, np.zeros(T, bool)])
    nrm = rng.normal(size=(B, T, 3)).astype(np.float32)
    smask = rng.uniform(size=(B, S)) > 0.5
    smask[1] = False
    if impl == "vals":
        plain = nn_search_vals_plain(t(src), t(tgt), t(mask), t(nrm))
        got = nn_search_vals_plain(t(src), t(tgt), t(mask), t(nrm), src_mask=t(smask))
        priv = _nn_search_vals(t(src), t(tgt), t(mask), t(nrm), t(smask))
        assert all(torch.equal(a, b) for a, b in
                   zip(_nn_search_vals(t(src), t(tgt), t(mask), t(nrm), None), plain))
        one = _nn_search_vals(t(src[0]), t(tgt[0]), t(mask[0]), t(nrm[0]), t(smask[0]))
        want = (torch.where(t(smask), plain[0], 0.0),
                torch.where(t(smask)[..., None], plain[1], t(tgt[:, :1])),
                torch.where(t(smask)[..., None], plain[2], t(nrm[:, :1])))
    else:
        plain = nn_search_plain(t(src), t(tgt), t(mask), impl)
        got = nn_search_plain(t(src), t(tgt), t(mask), impl, src_mask=t(smask))
        priv = _nn_search(t(src), t(tgt), t(mask), impl, t(smask))
        assert all(torch.equal(a, b) for a, b in
                   zip(_nn_search(t(src), t(tgt), t(mask), impl, None), plain))
        one = _nn_search(t(src[0]), t(tgt[0]), t(mask[0]), impl, t(smask[0]))
        want = (torch.where(t(smask), plain[0], 0), torch.where(t(smask), plain[1], 0.0))
    for a, b, c, w in zip(got, priv, one, want):
        assert torch.equal(a, w) and torch.equal(b, w) and torch.equal(c, w[0])
    d2 = got[0] if impl == "vals" else got[1]
    assert (d2[~t(smask)].view(torch.int32) == 0).all()      # +0.0, bit for bit


def _kernel_swept(smask, tmask, block, tile):
    """Pairs the sweep scores, decided as the kernel decides: a block of
    ``block`` sources is swept when one holds a valid source, a tile of
    ``tile`` targets when one holds a valid target."""
    total = 0
    for sm, tm in zip(smask, tmask):
        blocks = sum(sm[i:i + block].any() for i in range(0, len(sm), block))
        tiles = sum(tm[i:i + tile].any() for i in range(0, len(tm), tile))
        total += blocks * block * tiles * tile
    return total


@pytest.mark.parametrize("rows", [1, 2, 4])
def test_swept_pairs_counts_the_occupied_blocks_and_tiles(rows):
    """``ops.nn.swept_pairs`` (``k1_pairs_swept`` on a card) from the valid
    counts: on prefix masks, the pairs of the occupied source blocks and
    target tiles, as the kernel's votes find them; on scattered masks of
    the same counts the kernel scores more (more blocks and tiles hold a
    valid point), which counts of a prefix cannot see."""
    geo = {"threads": 128, "rows_per_thread": rows, "tile": 512}
    rng = np.random.default_rng(rows)
    S = T = 4096
    vs = np.array([0, 1, 640, 2049, 4096])
    vt = np.array([4096, 511, 513, 0, 3000])
    prefix_s = np.arange(S) < vs[:, None]
    prefix_t = np.arange(T) < vt[:, None]
    block = 128 * rows
    assert swept_pairs(vs, vt, geo) == _kernel_swept(prefix_s, prefix_t, block, 512)
    scattered_s = np.stack([rng.permutation(m) for m in prefix_s])
    scattered_t = np.stack([rng.permutation(m) for m in prefix_t])
    assert _kernel_swept(scattered_s, scattered_t, block, 512) > swept_pairs(vs, vt, geo)
    assert swept_pairs([S], [T], geo) == S * T
    assert swept_pairs([], [], geo) == 0


def _rank_order(d: np.ndarray) -> np.ndarray:
    """perm of the K5 kernel's rank counting: rank_k = #{m : d_m < d_k or
    (d_m == d_k and m < k)}, perm[rank_k] = k."""
    perm = np.empty(d.shape, np.int64)
    for k in range(d.shape[-1]):
        rank = ((d < d[..., k:k + 1]).sum(-1)
                + (d[..., :k] == d[..., k:k + 1]).sum(-1))
        np.put_along_axis(perm, rank[..., None], k, axis=-1)
    return perm


@pytest.mark.parametrize("gate", [0.3, 10.0])
def test_k5_rank_order_and_f32_gate(gate):
    """What the K5 kernel computes for itself: the stable nearest-first
    order by rank counting equals prepare's stable argsort, with ties
    among equal box bounds (overlapping blocks at 0, pruned ones at 1e12);
    the gate pre-prune compares in f32 against gate * gate rounded to f32
    (the kernel's gate2), as the plain version and the reference's
    nn_search_pruned_presorted (on its own _block_boxes / _box_dist2) do.
    At a 0.3 m gate a box gap of exactly f32(0.3) gives a bound equal to
    f32(0.09), which stays unpruned in all three."""
    sb = tb = 4
    # source blocks: x in [-1, 0]; target blocks k: x in [lo_k, lo_k + 1]
    src = np.zeros((2 * sb, 3), np.float32)
    src[:, 0] = np.tile(np.float32([-1.0, -0.5, -0.25, 0.0]), 2)
    src[sb:, 1] = 5.0                               # block 1 sits 5 m off in y
    lo = np.float32([0.3, 0.0, -0.5, 0.3, 2.0, np.nextafter(np.float32(0.3), 1),
                     0.0, 30.0])
    tgt = np.zeros((len(lo) * tb, 3), np.float32)
    tgt[:, 0] = (lo[:, None] + np.float32([0.0, 0.3, 0.6, 1.0])).ravel()
    tgt[:tb, 0] = np.float32([0.3, 0.3, 0.5, 0.9])  # lo exactly f32(0.3)
    sv = np.ones(len(src), bool)
    tv = np.ones(len(tgt), bool)
    tv[6 * tb:7 * tb] = False                       # an empty block: 1e12
    perm, tile_d2, _ = nn_pruned.prepare(t(src)[None], t(sv)[None], t(tgt)[None],
                                         t(tv)[None], gate, sb, tb)
    perm, tile_d2 = perm[0].numpy(), tile_d2[0].numpy()
    d_ref = np.asarray(pruned_ref._box_dist2(
        *pruned_ref._block_boxes(jnp.asarray(src), jnp.asarray(sv), sb),
        *pruned_ref._block_boxes(jnp.asarray(tgt), jnp.asarray(tv), tb)))
    d_ref = np.asarray(jnp.where(d_ref > gate * gate, pruned_ref._BIG, d_ref))
    d_f32 = np.where(d_ref > np.float32(gate * gate), np.float32(1e12), d_ref)
    np.testing.assert_array_equal(d_f32, d_ref)
    np.testing.assert_array_equal(perm, _rank_order(d_ref))
    np.testing.assert_array_equal(tile_d2, np.take_along_axis(d_ref, perm, -1))
    assert (np.diff(tile_d2, axis=-1) >= 0).all()
    row = d_ref[0]
    assert (row == 0).sum() >= 2 and (row == np.float32(1e12)).sum() >= 2  # ties
    if gate == 0.3:
        assert row[0] == np.float32(0.09) and row[3] == row[0]   # kept, tied
        assert row[5] == np.float32(1e12)                        # just past: pruned


def test_batched_equals_unbatched_and_cpu_launches_nothing(rng):
    src = (rng.normal(size=(3, 90, 3)) * 4).astype(np.float32)
    tgt = (rng.normal(size=(3, 70, 3)) * 4).astype(np.float32)
    nrm = rng.normal(size=(3, 70, 3)).astype(np.float32)
    mask = rng.uniform(size=(3, 70)) > 0.2
    before = dict(_cuda.launch_counts)
    for impl in ("vpu", "vpu2", "mxu"):
        ib, db = nn_search(t(src), t(tgt), t(mask), impl)
        for b in range(3):
            i, d = nn_search_plain(t(src[b]), t(tgt[b]), t(mask[b]), impl,
                                   max_elems=1000)
            assert torch.equal(i, ib[b]) and torch.equal(d, db[b])
    vb = nn_search_vals(t(src), t(tgt), t(mask), t(nrm))
    xb = nn_search_xla(t(src), t(tgt), t(mask), tgt_block=32)
    for b in range(3):
        v = nn_search_vals(t(src[b]), t(tgt[b]), t(mask[b]), t(nrm[b]))
        assert all(torch.equal(x, y[b]) for x, y in zip(v, vb))
        x = nn_search_xla(t(src[b]), t(tgt[b]), t(mask[b]))
        assert torch.equal(x[0], xb[0][b])
    assert _cuda.launch_counts == before
    with pytest.raises(ValueError, match="unknown impl"):
        nn_search(t(src), t(tgt), t(mask), "vpu3")


def test_sweep_variant_source_sets_each_knob():
    """utils/sweep_variants.py edits exactly the tuned constants of
    nn_sweep.cuh, and refuses a header where one is missing."""
    header = open(f"{_cuda.CSRC}/nn_sweep.cuh").read()
    values = {"max_rows": 4, "tile": 256, "ctas_per_sm": 8, "min_split": 1, "threads": 64}
    out = sweep_variants.variant_source(header, values)
    for knob, v in values.items():
        assert f"constexpr int {sweep_variants.KNOBS[knob]} = {v};" in out
    assert out.count("constexpr int") == header.count("constexpr int")
    with pytest.raises(ValueError, match="kTile"):
        sweep_variants.variant_source(header.replace("kTile = ", "kTileX = "), values)


def test_sass_hot_loop_issue_slots():
    """utils/sass.py: the hot loop is the loop densest in FP32 arithmetic
    (not the largest), and its issue slots per pair are its instructions
    over its best-value selects (FSEL)."""
    text = """
        Function : k
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   LDS.128 R4, [R2] ;
.L_x_2:
        /*0020*/                   FADD R8, R4, -R9 ;
        /*0030*/                   FMUL R8, R8, R8 ;
        /*0040*/                   FSETP.GEU.AND P0, PT, R8, R10, PT ;
        /*0050*/                   FSEL R10, R8, R10, !P0 ;
        /*0060*/               @P1 BRA `(.L_x_2) ;
        /*0070*/                   STS [R3], R10 ;
        /*0080*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0090*/                   BRA `(.L_x_1) ;
"""
    func = sass.parse(text)["k"]
    assert len(sass.largest_loop(func)) == 9
    hot = sass.hot_loop(func)
    assert len(hot) == 5 and sum(sass._opcode(t) == "FSEL" for t in hot) == 1


def test_sass_running_minimum_counts_one_pair_per_fmnmx():
    """utils/sass.py: in a sweep that keeps a running minimum (K1, K3, K4)
    a scored pair is one FMNMX, ahead of the selects and compares of its
    per-sub-tile bookkeeping."""
    text = """
        Function : k1
.L_x_1:
        /*0000*/                   LDS.128 R4, [R2] ;
        /*0010*/                   FADD R8, R4, -R9 ;
        /*0020*/                   FMUL R8, R8, R8 ;
        /*0030*/                   FMNMX R10, R8, R10, PT ;
        /*0040*/                   FADD R8, R5, -R9 ;
        /*0050*/                   FMUL R8, R8, R8 ;
        /*0060*/                   FMNMX R10, R8, R10, PT ;
        /*0070*/                   FSETP.GEU.AND P0, PT, R10, R11, PT ;
        /*0080*/                   SEL R12, R13, R12, !P0 ;
        /*0090*/               @P1 BRA `(.L_x_1) ;
"""
    func = sass.parse(text)["k1"]
    assert sass.pairs_in(sass.hot_loop(func)) == (2, "FMNMX")
    assert sass.issue_slots_per_pair(func) == (5.0, 0.0, 10, 2, "FMNMX")


def test_moments_variant_source_sets_each_knob():
    """utils/moments_variants.py edits exactly K2's tuned constants in
    ball_moments.cu, and refuses a source where one is missing."""
    source = open(f"{_cuda.CSRC}/ball_moments.cu").read()
    values = {"qb": 128, "tile": 256, "lanes": 2}
    out = sweep_variants.variant_source(source, values, moments_variants.KNOBS,
                                        "ball_moments.cu")
    for knob, v in values.items():
        assert f"constexpr int {moments_variants.KNOBS[knob]} = {v};" in out
    assert out.count("constexpr int") == source.count("constexpr int")
    with pytest.raises(ValueError, match="kLanes: 0 definitions in ball_moments.cu"):
        sweep_variants.variant_source(source.replace("kLanes = ", "kLane = "), values,
                                      moments_variants.KNOBS, "ball_moments.cu")


def test_sass_ball_compares_and_ptxas_usage():
    """utils/sass.py: a hot loop without a select (K2's) counts one scored
    pair per ball compare (FSETP), and the instructions a predicated
    forward branch skips (the accumulations of a neighbour) apart from the
    rest; registers, static shared memory, stack and spills are read per
    kernel from ``ptxas -v``."""
    text = """
        Function : k2
.L_x_1:
        /*0000*/                   LDS.128 R4, [R2] ;
        /*0010*/                   FADD R8, R4, -R9 ;
        /*0020*/                   FMUL R8, R8, R8 ;
        /*0030*/                   FSETP.GTU.AND P0, PT, R8, R10, PT ;
        /*0040*/                   BSSY B0, `(.L_x_2) ;
        /*0050*/               @P0 BRA `(.L_x_2) ;
        /*0060*/                   FADD R11, R11, 1 ;
.L_x_2:
        /*0070*/                   BSYNC B0 ;
        /*0080*/               @P1 BRA `(.L_x_1) ;
"""
    func = sass.parse(text)["k2"]
    assert sass.pairs_in(sass.hot_loop(func)) == (1, "FSETP")
    assert sass.branch_bodies(func) == ["FADD R11, R11, 1"]
    assert sass.issue_slots_per_pair(func) == (8.0, 1.0, 9, 1, "FSETP")
    log = """ptxas info    : Compiling entry function '_Z2k2Pf' for 'sm_90a'
ptxas info    : Function properties for _Z2k2Pf
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 4352 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z2k1v' for 'sm_90a'
ptxas info    : Function properties for _Z2k1v
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 400 bytes cmem[0]
"""
    assert sass.ptxas_usage(log) == {
        "_Z2k2Pf": "40 registers, 4352 bytes static smem, 8 bytes stack, 8 bytes spilled",
        "_Z2k1v": "64 registers, 0 bytes static smem, 0 bytes stack, 0 bytes spilled"}
