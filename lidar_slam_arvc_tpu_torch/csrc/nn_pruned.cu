// Distance-adaptive pruned nearest-neighbour sweep (K5) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel _pruned_kernel in
// lidar_slam_arvc_tpu/ops/nn_pruned.py (reached from
// nn_search_pruned_presorted; ICP's nn_impl="pruned").  Both clouds arrive
// Morton-sorted and padded to whole blocks (sb source rows, tb target rows
// per block).  The whole call is this one launch: the preparation the
// reference runs in XLA (and the plain version in torch, ops/nn_pruned.py
// prepare) happens inside it.
//
// One thread block cluster of C CTAs (4 or 8) per (pair, source block i);
// CTA c holds rows [c*ceil(sb/C), (c+1)*ceil(sb/C)) of the block, each on
// H adjacent threads (H = 4, or 2 where that would pass 256 threads):
// lane h of a row scores targets h, h + H, ... of each staged
// block (neighbouring lanes read neighbouring words, no bank conflict).
// Per cluster:
//   1. preparation.  The source block's box is reduced over its valid rows
//      in each CTA and then across the cluster through distributed shared
//      memory (min/max are exact, so every CTA holds the box torch's amin/
//      amax give; +inf/-inf for a block without valid rows).  The boxes of
//      the target blocks are shared out: CTA c reduces blocks c, c + C, ...
//      and each CTA copies the others' from their shared memory.  Every CTA
//      then forms, for every target block k, the bound of
//      ops/nn_pruned.py _box_dist2 with the same rounded operations
//      (gap = max(max(lo_k - hi_i, lo_i - hi_k), 0), a non-finite gap
//      counted as 1e12, (g_x^2 + g_y^2) + g_z^2), pushes it to 1e12 beyond
//      gate^2 (the f32 value the plain version compares with), and ranks it:
//      rank_k = #{m : d_m < d_k or (d_m == d_k and m < k)}, the position a
//      stable argsort gives, so perm and tile_d2 are the plain version's.
//   2. the sweep, nearest block first.  At each step every CTA reduces
//      max(best + |s|^2) over its rows into its shared memory; after
//      cluster.sync() every CTA reads the C values through distributed
//      shared memory, so each holds the bound of the whole sb-row block,
//      the reference's skip rule.  Block perm[j] is skipped when
//      tile_d2[j] > bound; since tile_d2 ascends and the bound only falls
//      after a scored block, the first skip ends the walk (the plain
//      version skips every later block too).  The candidate block's
//      targets are loaded into registers before the bound is reduced, so
//      their latency hides behind the reduction.  A visited block's targets
//      and t2 = ((x*x + y*y) + z*z) + pen are staged in shared memory and
//      each row scores t2 - 2 ((sx*tx + sy*ty) + sz*tz), every operation
//      rounded on its own (__fmul_rn/__fadd_rn) as in the plain version,
//      replacing its best only on a strict <.  Each lane keeps the step
//      at which it found its best; a row's lanes merge by (d2, step,
//      index), the first occurrence in visiting order, so across blocks
//      the earlier-visited block wins a tie and within one the lower
//      index, as in the sequential walk.  The bound takes a row's best as
//      the minimum over its lanes.
//   3. invalid source rows start at -1e12, so they never hold the bound
//      up, and come out with d2 = 0 and index 0; every row writes
//      d2 = max(best + |s|^2, 0) and its index clipped to [0, Tp - 1].
// The result is exact for every row whose nearest neighbour lies inside the
// gate, and equal bit for bit to the plain version (ops/nn_pruned.py
// nn_search_pruned_presorted_plain).
//
// Bound on this card: FP32 instruction issue on the blocks that are not
// skipped (7 rounded operations, a compare and a select per scored pair).
// The skip granularity (the sb-row block) fixes which tiles are scored, so
// a block cannot simply be cut into CTAs of its own: the cluster keeps one
// bound per sb rows and still spreads each block over C SMs (at the bench
// shape, 4 pairs of 4 blocks, 128 CTAs instead of 16).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxRows = 1024;       // source rows per block
constexpr int kMaxTile = 2048;       // target rows per block
constexpr int kMaxTgtBlocks = 1024;  // target blocks per cloud
constexpr int kMaxThreads = 512;     // 2 * kMaxRows / the smallest cluster
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSplit = 8;         // the largest cluster
constexpr int kPre = 4;              // targets per thread loaded ahead of a step
constexpr float kNeg = -1e12f;
constexpr float kBig = 1e12f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// Block-wide box of the points each thread passes (lo = +inf, hi = -inf
// for none): threads 0..5 write lo x, y, z, hi x, y, z to dst[0..5].
// Every thread must call it.
__device__ void block_box(float lo[3], float hi[3], float (*red)[6], float* dst) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = warp_min(lo[a]);
    hi[a] = warp_max(hi[a]);
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      red[warp][a] = lo[a];
      red[warp][a + 3] = hi[a];
    }
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int a = threadIdx.x;
    float m = red[0][a];
    for (int w = 1; w < (blockDim.x + 31) / 32; ++w)
      m = a < 3 ? fminf(m, red[w][a]) : fmaxf(m, red[w][a]);
    dst[a] = m;
  }
  __syncthreads();
}

// grid (n_i * C, B), cluster (C, 1, 1), ceil(ceil(sb / C) * H / 32)
// warps; dynamic shared memory: see smem_bytes.
template <int H>
__global__ void __launch_bounds__(kMaxThreads)
nn_pruned_kernel(const float* __restrict__ ss, const uint8_t* __restrict__ sv,
                 const float* __restrict__ ts, const uint8_t* __restrict__ tv, int Sp,
                 int Tp, int sb, int tb, float gate2, int32_t* __restrict__ out_idx,
                 float* __restrict__ out_d2) {
  extern __shared__ float smem[];
  const int n_j = Tp / tb;
  float* tx = smem;                  // the staged target block: x, y, z, t2
  float* ty = tx + tb;
  float* tz = ty + tb;
  float* tt = tz + tb;
  float* tbox = tt + tb;             // [6][n_j]: lo x, y, z, hi x, y, z
  float* dist = tbox + 6 * n_j;      // bounds in block order
  float* tile_d2 = dist + n_j;       // bounds in visiting order
  int* perm = reinterpret_cast<int*>(tile_d2 + n_j);
  __shared__ float red[kMaxWarps][6];
  __shared__ float sbox_part[6];     // this CTA's share of the source box
  __shared__ float sbox[6];
  __shared__ float wmax[kMaxWarps];
  __shared__ float slot[2];          // this CTA's bound share, per step parity

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int i = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_warps = (blockDim.x + 31) / 32;
  const int rows_per = (sb + C - 1) / C;
  const int h = tid % H;  // this thread's lane of its row
  const int row = rank * rows_per + tid / H;
  const bool has_row = tid / H < rows_per && row < sb;
  const int s = i * sb + row;
  ss += static_cast<size_t>(b) * Sp * 3;
  sv += static_cast<size_t>(b) * Sp;
  ts += static_cast<size_t>(b) * Tp * 3;
  tv += static_cast<size_t>(b) * Tp;

  const float inf = __int_as_float(0x7f800000);
  float sx = 0.f, sy = 0.f, sz = 0.f, s2 = 0.f, best = -inf;
  int best_i = 0, best_j = 0;
  bool valid = false;
  if (has_row) {
    sx = ss[3 * s];
    sy = ss[3 * s + 1];
    sz = ss[3 * s + 2];
    s2 = sq_norm(sx, sy, sz);
    valid = sv[s] != 0;
    best = valid ? inf : kNeg;
  }

  // 1. preparation: the source box (this CTA's share), the target boxes
  // (blocks rank, rank + C, ...)
  {
    float lo[3] = {valid ? sx : inf, valid ? sy : inf, valid ? sz : inf};
    float hi[3] = {valid ? sx : -inf, valid ? sy : -inf, valid ? sz : -inf};
    block_box(lo, hi, red, sbox_part);
  }
  for (int k = rank; k < n_j; k += C) {
    float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
#pragma unroll 4
    for (int q = tid; q < tb; q += blockDim.x) {
      const int t = k * tb + q;
      if (tv[t] != 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float p = ts[3 * t + a];
          lo[a] = fminf(lo[a], p);
          hi[a] = fmaxf(hi[a], p);
        }
      }
    }
    float box[6];
    block_box(lo, hi, red, box);  // only threads 0..5 hold box[tid]
    if (tid < 6) tbox[tid * n_j + k] = box[tid];
  }
  cluster.sync();
  if (tid < 6) {
    float v[kMaxSplit];
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c)  // all loads in flight at once
      v[c] = c < C ? cluster.map_shared_rank(sbox_part, c)[tid] : sbox_part[tid];
    float m = v[0];
#pragma unroll
    for (int c = 1; c < kMaxSplit; ++c) m = tid < 3 ? fminf(m, v[c]) : fmaxf(m, v[c]);
    sbox[tid] = m;
  }
  for (int k = tid; k < n_j; k += blockDim.x) {
    const int owner = k % C;
    if (owner == rank) continue;
    const float* remote = cluster.map_shared_rank(tbox, owner);
#pragma unroll
    for (int a = 0; a < 6; ++a) tbox[a * n_j + k] = remote[a * n_j + k];
  }
  __syncthreads();
  for (int k = tid; k < n_j; k += blockDim.x) {
    float d = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float lo_k = tbox[a * n_j + k], hi_k = tbox[(a + 3) * n_j + k];
      const float gap = fmaxf(fmaxf(__fsub_rn(lo_k, sbox[a + 3]), __fsub_rn(sbox[a], hi_k)),
                              0.f);
      const float g = isfinite(gap) ? gap : kBig;
      const float g2 = __fmul_rn(g, g);
      d = a == 0 ? g2 : __fadd_rn(d, g2);
    }
    dist[k] = d > gate2 ? kBig : d;  // gate pre-prune
  }
  __syncthreads();
  for (int k = tid; k < n_j; k += blockDim.x) {
    const float d = dist[k];
    int pos = 0;
    for (int m = 0; m < n_j; ++m) {
      const float e = dist[m];
      pos += (e < d || (e == d && m < k)) ? 1 : 0;
    }
    perm[pos] = k;
    tile_d2[pos] = d;
  }
  __syncthreads();

  // 2. the sweep, nearest block first
  for (int j = 0; j < n_j; ++j) {
    // the candidate block's first kPre * blockDim targets, loaded while
    // the bound is reduced (harmless when the block turns out skipped)
    const int k = perm[j];
    float px[kPre], py[kPre], pz[kPre];
    bool pv[kPre];
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int q = tid + u * blockDim.x;
      const int t = k * tb + min(q, tb - 1);
      px[u] = ts[3 * t];
      py[u] = ts[3 * t + 1];
      pz[u] = ts[3 * t + 2];
      pv[u] = tv[t] != 0;
    }
    float rb = best;  // the row's best: the minimum over its lanes
#pragma unroll
    for (int o = 1; o < H; o <<= 1) rb = fminf(rb, __shfl_xor_sync(0xffffffffu, rb, o));
    const float v = warp_max(has_row ? __fadd_rn(rb, s2) : -inf);
    if (lane == 0) wmax[warp] = v;
    __syncthreads();
    if (tid == 0) {
      float m = wmax[0];
      for (int w = 1; w < n_warps; ++w) m = fmaxf(m, wmax[w]);
      slot[j & 1] = m;
    }
    cluster.sync();  // also: every thread is done with the previous block
    // lane c of every warp reads CTA c's share; one shuffle max spreads it
    const float bound =
        warp_max(lane < C ? cluster.map_shared_rank(slot, lane)[j & 1] : -inf);
    if (!(tile_d2[j] <= bound)) break;  // and every later block: tile_d2 ascends

    auto put = [&](int q, float x, float y, float z, bool ok) {
      tx[q] = x;
      ty[q] = y;
      tz[q] = z;
      tt[q] = __fadd_rn(sq_norm(x, y, z), ok ? 0.f : kBig);
    };
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int q = tid + u * blockDim.x;
      if (q < tb) put(q, px[u], py[u], pz[u], pv[u]);
    }
    for (int q = tid + kPre * blockDim.x; q < tb; q += blockDim.x) {
      const int t = k * tb + q;
      put(q, ts[3 * t], ts[3 * t + 1], ts[3 * t + 2], tv[t] != 0);
    }
    __syncthreads();
    if (has_row) {
#pragma unroll 4
      for (int q = h; q < tb; q += H) {
        const float c = __fadd_rn(__fadd_rn(__fmul_rn(sx, tx[q]), __fmul_rn(sy, ty[q])),
                                  __fmul_rn(sz, tz[q]));
        const float score = __fsub_rn(tt[q], __fmul_rn(2.f, c));
        if (score < best) {
          best = score;
          best_i = k * tb + q;
          best_j = j;
        }
      }
    }
  }
  // merge a row's lanes: the first occurrence in visiting order
#pragma unroll
  for (int o = 1; o < H; o <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    const int oj = __shfl_xor_sync(0xffffffffu, best_j, o);
    if (ob < best || (ob == best && (oj < best_j || (oj == best_j && oi < best_i)))) {
      best = ob;
      best_i = oi;
      best_j = oj;
    }
  }
  if (has_row && h == 0) {
    const size_t o = static_cast<size_t>(b) * Sp + s;
    out_d2[o] = fmaxf(__fadd_rn(best, s2), 0.f);
    out_idx[o] = min(max(best_i, 0), Tp - 1);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

size_t smem_bytes(int tb, int n_j) {
  return (4 * static_cast<size_t>(tb) + 8 * static_cast<size_t>(n_j)) * sizeof(float) +
         static_cast<size_t>(n_j) * sizeof(int);
}

struct Geometry {
  int C;         // cluster size: CTAs per source block
  int rows_per;  // source rows per CTA
  int H;         // threads per row
  int threads;   // per CTA
};

// C = 8 when clusters of 4 would leave SMs idle, else 4; H = 4 up to 256
// threads per CTA, else 2 (at most kMaxThreads).
Geometry geometry(int B, int Sp, int sb, int n_sm) {
  const long long blocks = static_cast<long long>(Sp / sb) * B;
  Geometry g;
  g.C = blocks * 4 < n_sm ? 8 : 4;
  g.rows_per = (sb + g.C - 1) / g.C;
  g.H = g.rows_per <= 64 ? 4 : 2;
  g.threads = (g.rows_per * g.H + 31) / 32 * 32;
  return g;
}

bool bad_sizes(int B, int Sp, int Tp, int sb, int tb, int n_sm) {
  return B <= 0 || B > 65535 || sb <= 0 || tb <= 0 || sb > kMaxRows || tb > kMaxTile ||
         Sp <= 0 || Tp <= 0 || Sp % sb != 0 || Tp % tb != 0 || Tp / tb > kMaxTgtBlocks ||
         n_sm <= 0;
}

template <int H>
cudaError_t launch(const Geometry& g, int B, size_t smem, cudaStream_t stream,
                   const float* ss, const uint8_t* sv, const float* ts, const uint8_t* tv,
                   int Sp, int Tp, int sb, int tb, float gate2, int32_t* idx, float* d2) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nn_pruned_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Sp / sb * g.C, B, 1);
  cfg.blockDim = dim3(g.threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, nn_pruned_kernel<H>, ss, sv, ts, tv, Sp,
                                             Tp, sb, tb, gate2, idx, d2);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The launch geometry of nn_pruned_launch for these sizes on a card of
// n_sm SMs: out[0..5] = grid x, grid y, cluster size C, threads per CTA,
// source rows per CTA, threads per source row.  Returns
// cudaErrorInvalidValue for sizes the kernel refuses.
extern "C" int nn_pruned_geometry(int B, int Sp, int Tp, int sb, int tb, int n_sm,
                                  int* out) {
  if (bad_sizes(B, Sp, Tp, sb, tb, n_sm)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(B, Sp, sb, n_sm);
  out[0] = Sp / sb * g.C;
  out[1] = B;
  out[2] = g.C;
  out[3] = g.threads;
  out[4] = g.rows_per;
  out[5] = g.H;
  return 0;
}

// ss (B,Sp,3) f32 + sv (B,Sp) bool: the sorted, padded source; ts (B,Tp,3)
// f32 + tv (B,Tp) bool: the sorted, padded target; all contiguous on one
// device.  gate2: the squared gate as f32.  idx (B,Sp) int32 and d2 (B,Sp)
// f32 are written.  Returns the launch's CUDA error.
extern "C" int nn_pruned_launch(const float* ss, const uint8_t* sv, const float* ts,
                                const uint8_t* tv, int B, int Sp, int Tp, int sb, int tb,
                                float gate2, int n_sm, int32_t* idx, float* d2,
                                cudaStream_t stream) {
  if (bad_sizes(B, Sp, Tp, sb, tb, n_sm)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(B, Sp, sb, n_sm);
  const size_t smem = smem_bytes(tb, Tp / tb);
  const cudaError_t err =
      g.H == 4 ? launch<4>(g, B, smem, stream, ss, sv, ts, tv, Sp, Tp, sb, tb, gate2, idx, d2)
               : launch<2>(g, B, smem, stream, ss, sv, ts, tv, Sp, Tp, sb, tb, gate2, idx, d2);
  return static_cast<int>(err);
}
