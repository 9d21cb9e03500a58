// The exhaustive nearest-neighbour sweep shared by K1 and K3 (nn_sweep.cu)
// and K4 (nn_sweep_vals.cu), for NVIDIA Hopper (sm_90a).
//
// What bounds it on this card: FP32 instruction issue.  A scored (source,
// target) pair costs 8 rounded f32 operations for its d2 (3 differences,
// 3 products, 2 sums; the matmul form 3 products, 2 sums, a doubling and
// a difference), and nothing is read from device memory but the clouds.
// No product may contract into an FMA: the plain PyTorch versions round
// each operation alone, and d2 has to be bit-equal to theirs, or near
// ties pick other indices.  A roofline that counts 8 operations a pair
// against the card's 67 TFLOP/s, which counts an FMA as two, is therefore
// out of reach by half: an exhaustive sweep issues at least 8 slots a
// pair, so it reaches at most ~50% of that roofline.  Tensor cores do not
// apply (contraction depth 3, and no TF32).  The time is pairs scored x
// issue slots a pair, and the design cuts both factors:
//
//   * Score only occupied tiles.  Given a source mask, a CTA whose
//     sources are all masked writes their rows (index 0, d2 0.0) and
//     leaves; a cluster shares one source block, so its CTAs vote alike
//     and leave together.  In the sentinel form (K1, K3 vpu2, K4) a
//     staged target tile that holds no valid target is not swept: a
//     block-wide vote over the staging's mask loads (__syncthreads_or, at
//     the barrier the double buffer needs anyway) decides it, so the test
//     is uniform and costs no pass and no host read.  Every masked target
//     of that form sits at the one sentinel point, so the skipped tiles
//     are stood for by one candidate, their first target at the source's
//     d2 to the sentinel: exactly what sweeping them would give, also
//     when every target is masked.  The penalty and matmul forms give
//     each masked target its own score and sweep every tile.  Masked
//     sources of a swept block are scored and then written as index 0,
//     d2 0.0.
//   * One running minimum a pair.  The inner loop keeps only the minimum
//     of d2 (one FMNMX a pair in place of a compare and two selects); at
//     the end of each sub-tile of 32 targets it notes the sub-tile if the
//     minimum fell strictly in it.  After a tile, for each source whose
//     minimum fell in it, the warp scores the noted sub-tile again from
//     shared memory with the same rounded operations, one target a lane,
//     and the first lane whose d2 equals the minimum gives the index: the
//     first minimum over all targets, ties to the lowest index, at ~20
//     warp instructions a fall (a source's minimum falls in few of its
//     tiles).  fminf ignores NaN, so a position past the cloud (NaN in
//     the tile) never wins.
//   * Several sources a thread.  Each target read from shared memory (an
//     LDS.128 broadcast) serves `rows` sources, each its own minimum in
//     registers: 9 + 1/rows issue slots a pair.  geometry() picks rows
//     (1 or 2) and the cluster split at launch from B, S and T: the most
//     rows that still give kCtasPerSm CTAs an SM, so that the grid fills
//     the card.  Where even one row a thread leaves the grid short, rows
//     stays 1 and the split grows.  (4 rows, 9.4 slots a pair, left too
//     few CTAs at the cells' shapes to spread the busy ones over the SMs.)
//   * Busy blocks spread over the card.  Cluster c of a batch row sweeps
//     source block (c * stride) mod blocks, stride an odd step near 0.618
//     blocks and coprime to it, so that the blocks a prefix of valid
//     sources leaves busy are not consecutive CTAs, which the hardware may
//     deal to the same SMs.
//   * The target axis split across a thread block cluster of `split`
//     CTAs (1..8) that share one source block: target tile j goes to rank
//     j mod split, so each rank gets its share of a valid prefix.  Each
//     rank keeps, per source, the first minimum over its tiles; the ranks
//     then merge (d2, index) through distributed shared memory, the lower
//     d2 and on equal d2 the lower index.  A rank with no tile
//     contributes (+inf, 0), which never wins.
//   * Target tiles are double-buffered: the next tile's loads are issued
//     into registers before the current tile is swept and written to the
//     other shared-memory buffer after it, one barrier per tile.  Staging
//     also forms the per-target row of each form (the sentinel
//     substitution, the penalty, or t2 = |t|^2 + penalty) with the
//     rounded operations of ops/nn.py, so the wrapper launches nothing
//     else.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn/
// __fsub_rn): nvcc would otherwise contract a*b + c into an FMA.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <numeric>
#include <type_traits>

namespace nn_sweep {

namespace cg = cooperative_groups;

// kTile, kMaxRows, kCtasPerSm and kMinSplit: the fastest of a grid of
// variants at the benchmark cells' shapes and at the small ICP shapes on
// an H100 (utils/sweep_variants.py).
constexpr int kThreads = 128;                 // threads per CTA
constexpr int kMaxRows = 2;                   // most sources per thread
constexpr int kTile = 1024;                   // targets per staged tile
constexpr int kFetch = kTile / kThreads;      // targets each thread stages
constexpr int kSub = 32;                      // targets per sub-tile: a warp's lanes
constexpr unsigned kWarp = 0xffffffffu;       // every lane of a warp
constexpr int kMaxSplit = 8;                  // portable cluster size
constexpr int kCtasPerSm = 2;                 // the grid geometry() aims at, per SM
constexpr int kMinSplit = 2;                  // CTAs a source block's tiles go to, at least
constexpr float kSentinel = -4e7f;
constexpr float kBig = 1e12f;
static_assert(kTile % kThreads == 0 && kTile % kSub == 0 && kSub == 32, "tile shape");

// The d2 form, after the TPU kernel whose numbers it reproduces.
enum Form : int {
  // _nn_kernel_vpu_t, _vpu2, _vpu_tq: masked targets moved to the
  // sentinel, d2 = (dx*dx + dy*dy) + dz*dz
  kSentinelForm = 0,
  // _nn_kernel_vpu: d2 = ((dx*dx + dy*dy) + dz*dz) + pen, pen = 0 for a
  // valid target and 1e12 for a masked one
  kPenaltyForm = 1,
  // _nn_kernel_mxu: score = t2 - 2 ((sx*tx + sy*ty) + sz*tz) with
  // t2 = ((tx*tx + ty*ty) + tz*tz) + pen; d2 = max(best + |s|^2, 0)
  kMatmulForm = 2,
};

// Where the merged (best, index) of a source goes: K1/K3 write the index
// and d2; K4 (vals) writes d2 and the winner's point and normal.
struct Outputs {
  int32_t* idx;
  float* d2;
  const float* normals;
  float* q;
  float* n;
};

// The launch geometry: `rows` sources per thread, CTAs along the sources,
// and the cluster split of the target axis.
struct Geometry {
  int rows;    // sources per thread (1 or 2)
  int blocks;  // source CTAs per batch row, kThreads * rows sources each
  int split;   // cluster size: CTAs of one source block, tiles dealt round robin
  int stride;  // cluster c of a batch row sweeps source block (c * stride) mod blocks
};

// An odd step near 0.618 n that is coprime to n: consecutive clusters
// then take source blocks spread over the whole row, so that the blocks
// a prefix of valid sources leaves busy spread over the SMs however the
// hardware deals consecutive CTAs to them.
inline int spread_stride(int n) {
  if (n <= 2) return 1;
  int k = static_cast<int>(0.618 * n) | 1;
  while (std::gcd(k, n) != 1) k += 2;
  return k;
}

// The most rows (kMaxRows, halved down to 1) that give at least
// kCtasPerSm * n_sm CTAs at the least split (kMinSplit, at most the target
// tiles); where none does, 1 row and the split doubled (at most kMaxSplit
// and the tiles) until the grid has that many.  A split of 2 or more
// halves each CTA's share of a block's tiles, which the cells' shapes run
// faster with; small clouds take 1 row before a larger split.
inline Geometry geometry(int B, int S, int T, int n_sm) {
  const long long want = static_cast<long long>(kCtasPerSm) * n_sm;
  const int tiles = (T + kTile - 1) / kTile;
  Geometry g{1, 0, 1, 1};
  auto ctas = [&] { return static_cast<long long>(g.blocks) * B * g.split; };
  for (int rows = kMaxRows; rows >= 1; rows /= 2) {
    g.rows = rows;
    g.blocks = (S + kThreads * rows - 1) / (kThreads * rows);
    g.split = 1;
    while (g.split < kMinSplit && 2 * g.split <= tiles) g.split *= 2;
    if (ctas() >= want) break;
  }
  while (g.split < kMaxSplit && 2 * g.split <= tiles && ctas() < want) g.split *= 2;
  g.stride = spread_stride(g.blocks);
  return g;
}

// fn(std::integral_constant<int, R>) for the R == rows among kMaxRows,
// kMaxRows / 2, ..., 1: only the row counts geometry() can pick are
// instantiated.
template <int R = kMaxRows, typename Fn>
cudaError_t by_rows(int rows, Fn&& fn) {
  if constexpr (R == 1) {
    return fn(std::integral_constant<int, 1>{});
  } else {
    return rows == R ? fn(std::integral_constant<int, R>{}) : by_rows<R / 2>(rows, fn);
  }
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// A target as the sweep scores it in form F: x, y, z and the form's value
// (the sentinel in place of a masked target's point, or its penalty, or
// t2 = |t|^2 + penalty).
template <int F>
__device__ __forceinline__ float4 scored_target(float x, float y, float z, bool valid) {
  if constexpr (F == kSentinelForm) {
    return valid ? make_float4(x, y, z, 0.f)
                 : make_float4(kSentinel, kSentinel, kSentinel, 0.f);
  } else {
    const float pen = valid ? 0.f : kBig;
    return make_float4(x, y, z, F == kPenaltyForm ? pen : __fadd_rn(sq_norm(x, y, z), pen));
  }
}

// d2 (or the matmul score) of source (sx, sy, sz) against target
// (tx, ty, tz) with per-target value ta, in form F.
template <int F>
__device__ __forceinline__ float pair_d2(float sx, float sy, float sz, float tx, float ty,
                                         float tz, float ta) {
  if constexpr (F == kMatmulForm) {
    const float c = __fadd_rn(__fadd_rn(__fmul_rn(sx, tx), __fmul_rn(sy, ty)),
                              __fmul_rn(sz, tz));
    return __fsub_rn(ta, __fmul_rn(2.f, c));
  } else {
    const float dx = __fsub_rn(tx, sx);
    const float dy = __fsub_rn(ty, sy);
    const float dz = __fsub_rn(tz, sz);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    if constexpr (F == kPenaltyForm) return __fadd_rn(d2, ta);
    return d2;
  }
}

// Writes the merged (best, bi) of source s of batch row b; a masked source
// (valid false) writes index 0 and d2 0.0.  src/tgt are already offset to
// row b.
template <int F, bool kVals>
__device__ __forceinline__ void epilogue(const float* __restrict__ src,
                                         const float* __restrict__ tgt, const Outputs& out,
                                         int b, int S, int T, int s, float best, int bi,
                                         bool valid) {
  const size_t o = static_cast<size_t>(b) * S + s;
  if (!valid) {
    best = 0.f;
    bi = 0;
  } else if constexpr (F == kMatmulForm) {
    const float s2 = sq_norm(src[3 * s], src[3 * s + 1], src[3 * s + 2]);
    best = fmaxf(__fadd_rn(best, s2), 0.f);
  }
  out.d2[o] = best;
  if constexpr (kVals) {
    const float* nrm = out.normals + static_cast<size_t>(b) * T * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      out.q[3 * o + a] = tgt[3 * bi + a];
      out.n[3 * o + a] = nrm[3 * bi + a];
    }
  } else {
    out.idx[o] = bi;
  }
}

// The whole kernel body: grid (blocks * split, B), cluster (split, 1, 1),
// kThreads threads, kRows sources a thread.  CTA x of a batch row holds
// sources k * kThreads * kRows + r * kThreads + threadIdx.x, r < kRows,
// of source block k = ((x / split) * stride) mod blocks.  smask (B, S) may
// be null: every source valid.
template <int F, bool kVals, int kRows>
__device__ __forceinline__ void sweep(const float* __restrict__ src,
                                      const uint8_t* __restrict__ smask,
                                      const float* __restrict__ tgt,
                                      const uint8_t* __restrict__ tmask, int S, int T,
                                      int stride, const Outputs& out) {
  constexpr int kBlockRows = kThreads * kRows;
  constexpr bool kSkip = F == kSentinelForm;  // the form whose masked targets are one point
  const float kInf = __int_as_float(0x7f800000);
  __shared__ float4 tile[2][kTile];  // per target: x, y, z and the form's value
  __shared__ float m_best[kBlockRows];
  __shared__ int m_idx[kBlockRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int blocks = static_cast<int>(gridDim.x) / split;
  const int s0 = static_cast<int>(static_cast<long long>(blockIdx.x / split) * stride % blocks) *
                 kBlockRows;
  const int tid = threadIdx.x;
  src += static_cast<size_t>(b) * S * 3;
  tgt += static_cast<size_t>(b) * T * 3;
  tmask += static_cast<size_t>(b) * T;
  if (smask != nullptr) smask += static_cast<size_t>(b) * S;
  auto source_valid = [&](int s) { return s < S && (smask == nullptr || smask[s] != 0); };

  float sx[kRows], sy[kRows], sz[kRows];
  bool live[kRows];
  bool any_live = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = s0 + r * kThreads + tid;
    const bool in = s < S;
    sx[r] = in ? src[3 * s] : 0.f;
    sy[r] = in ? src[3 * s + 1] : 0.f;
    sz[r] = in ? src[3 * s + 2] : 0.f;
    live[r] = source_valid(s);
    any_live |= live[r];
  }
  if (!__syncthreads_or(any_live)) {
    // every source of the block masked: each CTA of the cluster writes its
    // share of the rows, as the merge below would
    for (int e = rank * kThreads + tid; e < kBlockRows; e += split * kThreads)
      if (s0 + e < S) epilogue<F, kVals>(src, tgt, out, b, S, T, s0 + e, 0.f, 0, false);
    return;
  }

  const int lane = tid % kSub;
  float best[kRows], prev[kRows];
  int bi[kRows];   // the first target at best
  int win[kRows];  // offset in the tile of the sub-tile where best last fell, or -1
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    best[r] = prev[r] = kInf;
    bi[r] = 0;
    win[r] = -1;
  }

  // the next tile, in registers while the current one is swept
  float px[kFetch], py[kFetch], pz[kFetch];
  bool pin[kFetch], pm[kFetch];
  auto fetch = [&](int base) {
#pragma unroll
    for (int u = 0; u < kFetch; ++u) {
      const int t = base + u * kThreads + tid;
      pin[u] = t < T;
      px[u] = pin[u] ? tgt[3 * t] : 0.f;
      py[u] = pin[u] ? tgt[3 * t + 1] : 0.f;
      pz[u] = pin[u] ? tgt[3 * t + 2] : 0.f;
      pm[u] = pin[u] && tmask[t] != 0;
    }
  };
  // A position past the cloud is NaN: fminf ignores it, so every tile is
  // swept whole (a constant trip count).  Returns whether this thread
  // staged a valid target.
  auto stage = [&](int buf) {
    const float nan = __int_as_float(0x7fc00000);
    bool valid = false;
#pragma unroll
    for (int u = 0; u < kFetch; ++u) {
      tile[buf][u * kThreads + tid] = pin[u] ? scored_target<F>(px[u], py[u], pz[u], pm[u])
                                             : make_float4(nan, nan, nan, nan);
      valid |= pm[u];
    }
    return valid;
  };

  const int tiles = (T + kTile - 1) / kTile;
  int first_skip = -1;  // first target of the first skipped tile (all masked)
  int buf = 0;
  bool occupied = false;
  if (rank < tiles) {
    fetch(rank * kTile);
    occupied = stage(0);
  }
  occupied = __syncthreads_or(occupied);
  for (int j = rank; j < tiles; j += split) {
    const int base = j * kTile;
    const bool more = j + split < tiles;
    if (more) fetch(base + split * kTile);
    if (!kSkip || occupied) {
      const float4* cur = tile[buf];
#pragma unroll 1
      for (int u = 0; u < kTile; u += kSub) {
#pragma unroll
        for (int k = 0; k < kSub; ++k) {
          const float4 p = cur[u + k];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            best[r] = fminf(best[r], pair_d2<F>(sx[r], sy[r], sz[r], p.x, p.y, p.z, p.w));
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (best[r] < prev[r]) win[r] = u;
          prev[r] = best[r];
        }
      }
      // The index of each row whose minimum fell in this tile, while the
      // tile is in shared memory: the warp scores the row's noted
      // sub-tile, one target a lane, and takes the first lane at the
      // minimum.
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        for (unsigned todo = __ballot_sync(kWarp, win[r] >= 0); todo != 0;
             todo &= todo - 1) {
          const int l = __ffs(todo) - 1;
          const int w = __shfl_sync(kWarp, win[r], l);
          const float4 p = cur[w + lane];
          const float d2 = pair_d2<F>(__shfl_sync(kWarp, sx[r], l),
                                      __shfl_sync(kWarp, sy[r], l),
                                      __shfl_sync(kWarp, sz[r], l), p.x, p.y, p.z, p.w);
          const unsigned at = __ballot_sync(kWarp, d2 == __shfl_sync(kWarp, best[r], l));
          if (lane == l) bi[r] = base + w + __ffs(at) - 1;
        }
        win[r] = -1;
      }
    } else if (first_skip < 0) {
      first_skip = base;
    }
    bool next = false;
    if (more) next = stage(buf ^ 1);
    occupied = __syncthreads_or(next);
    buf ^= 1;
  }

  // (best, bi) is each source's first minimum over this rank's swept
  // tiles; in the sentinel form the skipped tiles add one candidate
  if (kSkip && first_skip >= 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float d2 = pair_d2<F>(sx[r], sy[r], sz[r], kSentinel, kSentinel, kSentinel, 0.f);
      if (d2 < best[r] || (d2 == best[r] && first_skip < bi[r])) {
        best[r] = d2;
        bi[r] = first_skip;
      }
    }
  }
  if (split == 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int s = s0 + r * kThreads + tid;
      if (s < S) epilogue<F, kVals>(src, tgt, out, b, S, T, s, best[r], bi[r], live[r]);
    }
    return;
  }
  // merge the cluster's ranks: the lower d2, on equal d2 the lower index;
  // each CTA merges and writes its share of the sources
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_best[r * kThreads + tid] = best[r];
    m_idx[r * kThreads + tid] = bi[r];
  }
  cluster.sync();
  for (int e = rank * kThreads + tid; e < kBlockRows; e += split * kThreads) {
    const int s = s0 + e;
    if (s >= S) continue;
    float w[kMaxSplit];
    int wi[kMaxSplit];
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c) {  // all loads in flight at once
      w[c] = c < split ? cluster.map_shared_rank(m_best, c)[e] : kInf;
      wi[c] = c < split ? cluster.map_shared_rank(m_idx, c)[e] : 0;
    }
    float v = kInf;
    int vi = 0;
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c) {
      if (w[c] < v || (w[c] == v && wi[c] < vi)) {
        v = w[c];
        vi = wi[c];
      }
    }
    epilogue<F, kVals>(src, tgt, out, b, S, T, s, v, vi, source_valid(s));
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// Launches kernel on grid (blocks * split, B) with a cluster of `split`
// CTAs; returns the launch's error.
template <typename... KArgs, typename... Args>
cudaError_t launch_clustered(void (*kernel)(KArgs...), const Geometry& g, int B,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.blocks * g.split, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace nn_sweep
