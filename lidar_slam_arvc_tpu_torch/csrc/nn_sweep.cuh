// The exhaustive nearest-neighbour sweep shared by K1 and K3 (nn_sweep.cu)
// and K4 (nn_sweep_vals.cu), for NVIDIA Hopper (sm_90a).
//
// Bound on this card: FP32 instruction issue.  Each (source, target) pair
// costs 7-9 rounded f32 operations plus a compare and a select, and S*T
// pairs are scored; nothing is read from device memory but the clouds.
// Tensor cores do not apply (the contraction depth is 3).  The design:
//
//   * kRows sources per thread, each with kChains running bests (value,
//     index) over interleaved targets (k mod kChains), all in registers:
//     each target read from shared memory serves kRows pairs, and the
//     kRows * kChains compare/select chains are independent, so the
//     scheduler has work while one chain waits on its last select.  A
//     source's chains merge by the lower d2 and, on a tie, the lower
//     index: the first minimum over all its targets.  (kRows = 1 today:
//     more sources per thread cost CTAs where the split is capped.)
//   * The target axis is split across a thread block cluster of `split`
//     CTAs (1..8, chosen at launch by geometry() so that the grid fills
//     the SMs when the sources alone cannot).  CTA rank c sweeps the
//     contiguous, ascending range [c*chunk, min((c+1)*chunk, T)) with a
//     strict <, so within its range the first minimum wins.  The CTAs
//     then merge their
//     (best, index) through distributed shared memory in rank order,
//     again with a strict <: the result is the minimum over the same set
//     of bit-identical values with the lowest index on a tie, which is
//     what the unsplit sweep returns.  An empty range contributes
//     (+inf, 0) and never wins.
//   * Target tiles are double-buffered: the next tile's loads are issued
//     into registers before the current tile is swept, and written to the
//     other shared-memory buffer after it, one barrier per tile.  Staging
//     also forms the per-target row of each form (the sentinel
//     substitution, the penalty, or t2 = |t|^2 + penalty) with the
//     rounded operations of ops/nn.py, so the wrapper launches nothing
//     else.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn/
// __fsub_rn): nvcc would otherwise contract a*b + c into an FMA, and the
// plain PyTorch versions, which round each operation, would differ in the
// last bit of d2 and so on near-tie indices.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nn_sweep {

namespace cg = cooperative_groups;

// kRows, kTile, kChains and kCtasPerSm are the fastest of a grid of
// variants at the bench shapes on an H100 (utils/sweep_variants.py): with
// kRows = 2 or 4 the split, capped at kMaxSplit, leaves the S = 2048 grid
// at 256 or 128 CTAs.
constexpr int kThreads = 128;                 // threads per CTA
constexpr int kRows = 1;                      // sources per thread
constexpr int kBlockRows = kThreads * kRows;  // sources per CTA
constexpr int kTile = 512;                    // targets per staged tile
constexpr int kFetch = kTile / kThreads;      // targets each thread stages
constexpr int kChains = 2;                    // running bests per source
constexpr int kMaxSplit = 8;                  // portable cluster size
constexpr int kCtasPerSm = 2;                 // the split's target grid, per SM
constexpr float kSentinel = -4e7f;
constexpr float kBig = 1e12f;

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

// The launch geometry: CTAs along the sources, and the cluster split of
// the target axis.  The split is the smallest power of two (at most
// kMaxSplit) that gives at least kCtasPerSm * n_sm CTAs; each CTA of a
// cluster sweeps chunk = ceil(T / split) targets.
struct Geometry {
  int blocks;  // source CTAs per batch row
  int split;   // cluster size along the target axis
  int chunk;   // targets per CTA
};

inline Geometry geometry(int B, int S, int T, int n_sm) {
  Geometry g;
  g.blocks = (S + kBlockRows - 1) / kBlockRows;
  g.split = 1;
  while (g.split < kMaxSplit &&
         static_cast<long long>(g.blocks) * B * g.split < static_cast<long long>(kCtasPerSm) * n_sm)
    g.split *= 2;
  g.chunk = (T + g.split - 1) / g.split;
  return g;
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
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

// Writes the merged (best, bi) of source s of batch row b.  src/tgt are
// already offset to row b.
template <int F, bool kVals>
__device__ __forceinline__ void epilogue(const float* __restrict__ src,
                                         const float* __restrict__ tgt, const Outputs& out,
                                         int b, int S, int T, int s, float best, int bi) {
  const size_t o = static_cast<size_t>(b) * S + s;
  if constexpr (F == kMatmulForm) {
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
// kThreads threads.  CTA x of a batch row holds sources
// (x / split) * kBlockRows + r * kThreads + threadIdx.x, r < kRows.
template <int F, bool kVals>
__device__ __forceinline__ void sweep(const float* __restrict__ src,
                                      const float* __restrict__ tgt,
                                      const uint8_t* __restrict__ tmask, int S, int T,
                                      int chunk, const Outputs& out) {
  __shared__ float4 tile[2][kTile];  // per target: x, y, z and the form's value
  __shared__ float m_best[kBlockRows];
  __shared__ int m_idx[kBlockRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int s0 = (blockIdx.x / split) * kBlockRows;
  const int tid = threadIdx.x;
  src += static_cast<size_t>(b) * S * 3;
  tgt += static_cast<size_t>(b) * T * 3;
  tmask += static_cast<size_t>(b) * T;
  const int t_begin = min(T, rank * chunk);
  const int t_end = min(T, t_begin + chunk);

  float sx[kRows], sy[kRows], sz[kRows], best[kRows][kChains];
  int bi[kRows][kChains];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = s0 + r * kThreads + tid;
    const bool ok = s < S;
    sx[r] = ok ? src[3 * s] : 0.f;
    sy[r] = ok ? src[3 * s + 1] : 0.f;
    sz[r] = ok ? src[3 * s + 2] : 0.f;
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      best[r][c] = __int_as_float(0x7f800000);  // +inf
      bi[r][c] = 0;
    }
  }

  // the next tile, in registers while the current one is swept
  float px[kFetch], py[kFetch], pz[kFetch];
  bool pin[kFetch], pm[kFetch];
  auto fetch = [&](int base) {
#pragma unroll
    for (int u = 0; u < kFetch; ++u) {
      const int t = base + u * kThreads + tid;
      pin[u] = t < t_end;
      px[u] = pin[u] ? tgt[3 * t] : 0.f;
      py[u] = pin[u] ? tgt[3 * t + 1] : 0.f;
      pz[u] = pin[u] ? tgt[3 * t + 2] : 0.f;
      pm[u] = pin[u] && tmask[t] != 0;
    }
  };
  // A position past the range is NaN: its d2 is NaN, which no < ever
  // picks, so every tile is swept whole (a constant trip count).
  auto stage = [&](int buf) {
    const float nan = __int_as_float(0x7fc00000);
#pragma unroll
    for (int u = 0; u < kFetch; ++u) {
      float4 v;
      if constexpr (F == kSentinelForm) {
        v = pm[u] ? make_float4(px[u], py[u], pz[u], 0.f)
                  : make_float4(kSentinel, kSentinel, kSentinel, 0.f);
      } else {
        const float pen = pm[u] ? 0.f : kBig;
        v = make_float4(px[u], py[u], pz[u],
                        F == kPenaltyForm ? pen : __fadd_rn(sq_norm(px[u], py[u], pz[u]), pen));
      }
      tile[buf][u * kThreads + tid] = pin[u] ? v : make_float4(nan, nan, nan, nan);
    }
  };

  int buf = 0;
  if (t_begin < t_end) {
    fetch(t_begin);
    stage(0);
  }
  __syncthreads();
  for (int base = t_begin; base < t_end; base += kTile) {
    const bool more = base + kTile < t_end;
    if (more) fetch(base + kTile);
    const float4* cur = tile[buf];
#pragma unroll 4
    for (int k = 0; k < kTile; k += kChains) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        const float4 p = cur[k + c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float d2 = pair_d2<F>(sx[r], sy[r], sz[r], p.x, p.y, p.z, p.w);
          if (d2 < best[r][c]) {
            best[r][c] = d2;
            bi[r][c] = base + k + c;
          }
        }
      }
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  // a source's chains: the lower d2, on a tie the lower index (each
  // chain holds the first minimum of its own targets)
  float fb[kRows];
  int fi[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    fb[r] = best[r][0];
    fi[r] = bi[r][0];
#pragma unroll
    for (int c = 1; c < kChains; ++c) {
      if (best[r][c] < fb[r] || (best[r][c] == fb[r] && bi[r][c] < fi[r])) {
        fb[r] = best[r][c];
        fi[r] = bi[r][c];
      }
    }
  }
  if (split == 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int s = s0 + r * kThreads + tid;
      if (s < S) epilogue<F, kVals>(src, tgt, out, b, S, T, s, fb[r], fi[r]);
    }
    return;
  }
  // merge the cluster's ranges in rank (= target) order; each CTA merges
  // and writes its share of the sources
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_best[r * kThreads + tid] = fb[r];
    m_idx[r * kThreads + tid] = fi[r];
  }
  cluster.sync();
  for (int e = rank * kThreads + tid; e < kBlockRows; e += split * kThreads) {
    const int s = s0 + e;
    if (s >= S) continue;
    float w[kMaxSplit];
    int wi[kMaxSplit];
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c) {  // all loads in flight at once
      w[c] = c < split ? cluster.map_shared_rank(m_best, c)[e] : 0.f;
      wi[c] = c < split ? cluster.map_shared_rank(m_idx, c)[e] : 0;
    }
    float v = __int_as_float(0x7f800000);
    int vi = 0;
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c) {
      if (c < split && w[c] < v) {
        v = w[c];
        vi = wi[c];
      }
    }
    epilogue<F, kVals>(src, tgt, out, b, S, T, s, v, vi);
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
