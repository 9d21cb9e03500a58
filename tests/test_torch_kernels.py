"""The port's two kernels: plain versions vs the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; those are
held against the TPU kernels run as the JAX package's own tests run them
(Pallas interpret mode, ``tests/test_cloud_ops.py``).  The CUDA kernels
themselves are compared with their plain versions in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax.numpy as jnp

from lidar_slam_arvc_tpu.ops.moments_pallas import ball_moments_pallas
from lidar_slam_arvc_tpu.ops.nn_pallas import nn_search_pallas
from lidar_slam_arvc_tpu_torch.ops import _cuda
from lidar_slam_arvc_tpu_torch.ops.moments import (
    QUERY_BLOCK, TILE, ball_moments, ball_moments_plain, scored_pairs, tile_boxes)
from lidar_slam_arvc_tpu_torch.ops.nn import nn_search, nn_search_plain

torch.set_num_threads(1)

# S1/S2 are sums of <= ~100 terms of magnitude <= r^k (r ~ 1) taken in a
# different order by the Pallas kernel (sublane tiles) and the plain
# version: f32 summation error, well under 1e-5 at these sizes
MOMENT_ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nn_ref(src, tgt, mask, sb=128, tb=128):
    i, d = nn_search_pallas(jnp.asarray(src), jnp.asarray(tgt),
                            jnp.asarray(mask), src_block=sb, tgt_block=tb,
                            interpret=True, impl="vpu_t")
    return np.asarray(i), np.asarray(d)


@pytest.mark.parametrize("S,T,sb,tb", [(300, 500, 128, 128),
                                       (77, 131, 64, 128)])
def test_nn_plain_matches_pallas_vpu_t(rng, S, T, sb, tb):
    """Indices equal; d2 to 1 f32 ulp (the same products and sums; XLA
    may fuse the last add on the CPU)."""
    src = (rng.normal(size=(S, 3)) * 10).astype(np.float32)
    tgt = (rng.normal(size=(T, 3)) * 10).astype(np.float32)
    mask = rng.uniform(size=T) > 0.3
    i_ref, d_ref = _nn_ref(src, tgt, mask, sb, tb)
    i, d = nn_search_plain(t(src), t(tgt), t(mask))
    assert i.dtype == torch.int32 and d.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), i_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=2e-7)
    # against an independent oracle over the valid targets
    dist, j = cKDTree(tgt[mask]).query(src)
    np.testing.assert_array_equal(i.numpy(), np.flatnonzero(mask)[j])


def test_nn_plain_ties_and_all_masked(rng):
    """Duplicated targets: the lowest index wins, as in the TPU kernel;
    every target masked: index 0 at the sentinel distance."""
    tgt = (rng.normal(size=(200, 3)) * 5).astype(np.float32)
    tgt[150:] = tgt[:50]                     # exact duplicates
    src = tgt[[3, 160, 40, 199]] + np.float32(1e-3)
    mask = np.ones(200, dtype=bool)
    i_ref, _ = _nn_ref(src, tgt, mask, 128, 64)
    i, _ = nn_search_plain(t(src), t(tgt), t(mask), max_elems=64)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    assert (i.numpy() < 150).all()
    none = np.zeros(200, dtype=bool)
    i_ref, d_ref = _nn_ref(src, tgt, none, 128, 64)
    i, d = nn_search_plain(t(src), t(tgt), t(none))
    np.testing.assert_array_equal(i.numpy(), i_ref)
    assert (i.numpy() == 0).all() and (d.numpy() > 4e15).all()


def test_nn_batched_equals_unbatched(rng):
    src = (rng.normal(size=(3, 90, 3)) * 4).astype(np.float32)
    tgt = (rng.normal(size=(3, 70, 3)) * 4).astype(np.float32)
    mask = rng.uniform(size=(3, 70)) > 0.2
    ib, db = nn_search_plain(t(src), t(tgt), t(mask), max_elems=1000)
    for b in range(3):
        i, d = nn_search(t(src[b]), t(tgt[b]), t(mask[b]))
        assert torch.equal(i, ib[b]) and torch.equal(d, db[b])


def _moments_ref(q, tgt, mask, r, qb, tb, query_mask=None):
    out = ball_moments_pallas(jnp.asarray(q), jnp.asarray(tgt),
                              jnp.asarray(mask), r, query_block=qb,
                              tgt_block=tb, interpret=True,
                              query_mask=None if query_mask is None
                              else jnp.asarray(query_mask))
    return [np.asarray(x) for x in out]


def _check_moments(got, ref, rows):
    c, s1, s2 = (x.numpy() for x in got)
    np.testing.assert_array_equal(c[rows], ref[0][rows])
    np.testing.assert_allclose(s1[rows], ref[1][rows], atol=MOMENT_ATOL)
    np.testing.assert_allclose(s2[rows], ref[2][rows], atol=MOMENT_ATOL)


def test_moments_plain_matches_pallas(rng):
    """Counts exact (same d2 and the inclusive <= test), moments within
    MOMENT_ATOL; masked targets excluded."""
    q = rng.normal(size=(70, 3)).astype(np.float32)
    tgt = rng.normal(size=(90, 3)).astype(np.float32)
    mask = rng.uniform(size=90) > 0.3
    ref = _moments_ref(q, tgt, mask, 0.9, 32, 16)
    _check_moments(ball_moments_plain(t(q), t(tgt), t(mask), 0.9), ref,
                   slice(None))


def test_moments_plain_tile_skipping_case(rng):
    """Spatially sorted clusters 100 m apart (tests/test_cloud_ops.py:134):
    the Pallas kernel skips every cross-cluster tile; the plain version
    scores every pair and must agree."""
    a = rng.normal(scale=0.4, size=(32, 3)).astype(np.float32)
    b = rng.normal(scale=0.4, size=(32, 3)).astype(np.float32) + 100.0
    pts = np.concatenate([a, b])
    mask = np.ones(64, dtype=bool)
    ref = _moments_ref(pts, pts, mask, 0.8, 16, 16)
    got = ball_moments_plain(t(pts), t(pts), t(mask), 0.8, max_elems=500)
    _check_moments(got, ref, slice(None))
    assert (got[0].numpy() >= 1).all()        # self is always included


def test_moments_query_mask(rng):
    """Valid query rows match the Pallas kernel run with the same
    query_mask; masked query rows are zeros (the TPU kernel leaves them as
    garbage for the caller to gate)."""
    pts = rng.normal(scale=0.6, size=(2, 100, 3)).astype(np.float32)
    qm = rng.uniform(size=(2, 100)) > 0.4
    got = ball_moments(t(pts), t(pts), t(qm), 0.5, query_mask=t(qm))
    for b in range(2):
        ref = _moments_ref(pts[b], pts[b], qm[b], 0.5, 32, 16, qm[b])
        _check_moments([x[b] for x in got], ref, qm[b])
        assert not got[0][b][~t(qm[b])].any()
        assert not got[1][b][~t(qm[b])].any()


def test_tile_boxes():
    pts = torch.arange(30, dtype=torch.float32).reshape(1, 10, 3)
    mask = torch.tensor([[True] * 3 + [False] * 5 + [True] * 2])
    lo, hi = tile_boxes(pts, mask, tile=4)
    assert lo.shape == (1, 3, 3)
    assert lo[0, 0].tolist() == [0, 1, 2] and hi[0, 0].tolist() == [6, 7, 8]
    assert torch.isinf(lo[0, 1]).all() and (lo[0, 1] > 0).all()
    assert lo[0, 2].tolist() == [24, 25, 26] and hi[0, 2].tolist() == [27, 28, 29]


def test_cpu_tensors_take_the_plain_version(rng):
    """A CPU tensor runs the plain version and launches nothing."""
    before = dict(_cuda.launch_counts)
    pts = t(rng.normal(size=(40, 3)).astype(np.float32))
    m = torch.ones(40, dtype=torch.bool)
    nn_search(pts, pts, m)
    ball_moments(pts, pts, m, 0.5)
    assert _cuda.launch_counts == before


def test_scored_pairs_matches_brute_force_box_gaps(rng):
    """``scored_pairs`` reckons K2's work at the kernel's shipped query
    block and tile (the constants of ``csrc/ball_moments.cu``): the same
    (query block, target tile) pairs and pair count as a numpy loop over
    every block and tile of a small sorted cloud."""
    src = open(f"{_cuda.CSRC}/ball_moments.cu").read()
    assert f"constexpr int kQb = {QUERY_BLOCK};" in src
    assert f"constexpr int kTile = {TILE};" in src
    B, Q, T, r = 2, 300, 700, 0.5
    tgt = np.sort(rng.uniform(0, 8, (B, T, 3)).astype(np.float32), axis=1)
    q = np.sort(rng.uniform(0, 8, (B, Q, 3)).astype(np.float32), axis=1)
    tm = rng.uniform(size=(B, T)) > 0.2
    qm = rng.uniform(size=(B, Q)) > 0.2
    tm[0, TILE:2 * TILE] = False                  # one tile with no valid target
    tiles = pairs = 0
    for b in range(B):
        for i0 in range(0, Q, QUERY_BLOCK):
            qv = q[b, i0:i0 + QUERY_BLOCK][qm[b, i0:i0 + QUERY_BLOCK]]
            for j0 in range(0, T, TILE):
                tv = tgt[b, j0:j0 + TILE][tm[b, j0:j0 + TILE]]
                if not len(qv) or not len(tv):
                    continue
                gap = np.maximum(np.maximum(tv.min(0) - qv.max(0),
                                            qv.min(0) - tv.max(0)), 0)
                if (gap * gap).sum(dtype=np.float32) <= np.float32(r * r):
                    tiles += 1
                    pairs += len(qv) * min(TILE, T - j0)
    assert 0 < tiles < B * -(-Q // QUERY_BLOCK) * -(-T // TILE)
    assert scored_pairs(t(q), t(tgt), t(tm), r, t(qm)) == (tiles, pairs)
