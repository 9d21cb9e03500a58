// Query-centred ball moments (K2) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel _ball_kernel in
// lidar_slam_arvc_tpu/ops/moments_pallas.py (reached from
// ball_moments_pallas): for every valid query q, over the valid targets t
// with |t - q|^2 <= r^2 (inclusive, the query itself included):
//   count, S1 = sum (t - q), S2 = upper triangle (xx, xy, xz, yy, yz, zz)
//   of sum (t - q)(t - q)^T,
// emitted query-centred as the TPU kernel does, so the covariance
// S2/n - m m^T is formed from values of magnitude ~r, not ~|scene|.
//   * d2 = (dx*dx + dy*dy) + dz*dz with every operation rounded on its own
//     (__fmul_rn/__fadd_rn), as in the plain PyTorch version, so ball
//     membership and hence the counts are identical to the plain
//     version's; S1 and S2 may use FMAs and sum in another order;
//   * masked targets are moved to the sentinel -4e7, far outside any ball;
//   * rows whose query is masked are written as zeros (the TPU kernel
//     leaves them as garbage that callers gate with their mask).
//
// Bound on this card: FP32 instruction issue on the (query block, target
// tile) pairs that are not skipped: 8 rounded operations and a compare per
// scored pair, 10 accumulations per neighbour.  At the bench shape only
// ~6% of the pairs are scored, so a call is short and latency (set-up,
// barriers, the first loads) weighs as much as the arithmetic.  The
// whole call is this one launch:
//   1. tile boxes.  A thread block cluster of C CTAs (up to 8) holds C
//      consecutive query blocks of one batch row; CTA rank c reduces the
//      boxes of the valid targets of tiles c, c + C, ... (one warp per
//      tile; +inf/-inf for a tile without valid targets) into its shared
//      memory.  Every CTA needs every box of its row: sharing them across
//      the cluster reads the target cloud 1/C as often as each CTA
//      reducing all of them itself would (at the bench shape 8 tiles of
//      1.6 KB per CTA instead of 64, 6.8 MB of L2 reads per call instead
//      of 54 MB), for one cluster barrier and one read of distributed
//      shared memory per tile.
//   2. skip test, every tile at once.  After cluster.sync(), thread k
//      reads tile k's box through distributed shared memory and tests its
//      gap to the box of the block's valid queries (gap = max(lo_t - hi_q,
//      lo_q - hi_t, 0), a non-finite gap counted as 1e12, rounded as d2
//      is, so a skipped tile cannot hold a pair whose rounded d2 <= r^2).
//      A ballot and a prefix over the warps compact the scored tiles, in
//      ascending order, into a list in shared memory.  Each CTA then
//      arrives at a second cluster barrier and waits on it only before it
//      leaves, so no CTA waits for the others' skip tests and none leaves
//      while another may still read its boxes.
//   3. the sweep walks only the list.  Each query has kLanes threads; lane
//      h scores targets h, h + kLanes, ... of each staged tile (more warps
//      in flight for the same work), and the lanes' ten moments merge at
//      the end by a fixed butterfly of shuffles.  A pair outside the ball
//      skips the ten accumulations by a branch: ~1% of the scored pairs
//      are neighbours, so the warp takes it at a fraction of the steps,
//      and selects that add zeros cost more (measured).  Tiles are double-
//      buffered: the next listed tile is loaded into registers (16-byte
//      loads of the AoS points where every row starts 16-byte aligned,
//      i.e. T % 4 == 0, else scalar loads) while the current one is
//      scored, then written to the other buffer as one float4 per target
//      with the sentinel applied; one barrier per tile.  Positions past
//      the cloud's end are NaN, which no <= admits, so every tile has a
//      constant trip count.
// The order of every sum is fixed (the list ascends, the lanes' share is
// fixed, no atomics): two runs are bit-equal.
//
// kQb, kTile and kLanes are the fastest of a grid of variants (query
// block 64/128/256 x tile 128/256 x 1/2/4 threads per query) at the bench
// shape on an H100 (utils/moments_variants.py rewrites them; PERF.md has
// the table).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kQb = 64;          // queries per CTA
constexpr int kTile = 128;       // targets per tile box and per staged tile
constexpr int kLanes = 4;        // threads per query
constexpr int kMaxCluster = 8;   // portable cluster size
constexpr int kMaxTiles = 4096;  // target tiles per cloud (shared memory)
constexpr float kSentinel = -4e7f;
constexpr float kBig = 1e12f;    // gap of an empty box, as in _box_dist2

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The squared gap between box (lo[0..2], hi[0..2]) and box (lo[3..5],
// hi[3..5]) rounded as d2 is: gap = max(lo_a - hi_b, lo_b - hi_a, 0) per
// axis, 1e12 where that is not finite (an empty box).
__device__ __forceinline__ float gap2(const float a[6], const float b[6]) {
  float d = 0.f;
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    const float gap = fmaxf(fmaxf(__fsub_rn(a[x], b[x + 3]), __fsub_rn(b[x], a[x + 3])), 0.f);
    const float g = isfinite(gap) ? gap : kBig;
    const float g2 = __fmul_rn(g, g);
    d = x == 0 ? g2 : __fadd_rn(d, g2);
  }
  return d;
}

// The two halves of a cluster barrier (cluster.sync() is both at once):
// arrive releases this thread's earlier memory operations, wait returns
// once every thread of the cluster has arrived.  Every thread runs each
// once.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Warp-wide lo/hi of lo[3]/hi[3]; every lane ends with the result.
__device__ __forceinline__ void warp_box(float lo[3], float hi[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = warp_min(lo[a]);
    hi[a] = warp_max(hi[a]);
  }
}

// grid (ceil(n_qb / C) * C, B), cluster (C, 1, 1), QB * L threads;
// dynamic shared memory: 6 * ceil(n_tiles / C) floats (this CTA's tile
// boxes, [axis][slot]) and n_tiles ints (the scored list).  VEC: every
// target row starts 16-byte aligned.
template <int QB, int TL, int L, bool VEC>
__global__ void __launch_bounds__(QB * L)
ball_moments_kernel(const float* __restrict__ query, const uint8_t* __restrict__ qmask,
                    const float* __restrict__ tgt, const uint8_t* __restrict__ tmask, int Q,
                    int T, float r2, float* __restrict__ out) {
  constexpr int kThreads = QB * L;
  constexpr int kWarps = kThreads / 32;
  constexpr int kUnit = VEC ? 4 : 1;                  // floats per load
  constexpr int kUnits = TL * 3 / kUnit;              // loads per full tile
  constexpr int kFetch = (kUnits + kThreads - 1) / kThreads;
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "threads per CTA");
  static_assert(TL % 4 == 0 && 32 % L == 0, "tile and lanes");

  __shared__ float4 tile[2][TL];  // per target: x, y, z (sentinel if masked), unused
  __shared__ float red[kWarps][6];
  __shared__ float qbox[6];       // lo xyz, hi xyz of the block's valid queries
  __shared__ int wcount[kWarps];
  extern __shared__ float dyn[];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = tid % L;  // this thread's lane of its query
  const int i = blockIdx.x * QB + tid / L;
  const int n_tiles = (T + TL - 1) / TL;
  const int per = (n_tiles + C - 1) / C;  // box slots per CTA
  float* own = dyn;                                     // [6][per]
  int* list = reinterpret_cast<int*>(dyn + 6 * per);    // [n_tiles]
  query += static_cast<size_t>(b) * Q * 3;
  tgt += static_cast<size_t>(b) * T * 3;
  tmask += static_cast<size_t>(b) * T;
  out += static_cast<size_t>(b) * Q * 10;

  const bool in_q = i < Q;
  const bool valid = in_q && (qmask == nullptr || qmask[static_cast<size_t>(b) * Q + i] != 0);
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (in_q) {
    qx = query[3 * i];
    qy = query[3 * i + 1];
    qz = query[3 * i + 2];
  }
  const float inf = __int_as_float(0x7f800000);

  // 1. this CTA's tile boxes: tiles rank + s * C, one warp per tile
  for (int s = warp; rank + s * C < n_tiles; s += kWarps) {
    const int base = (rank + s * C) * TL;
    const int n = min(TL, T - base);
    float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
#pragma unroll 4
    for (int p = lane; p < n; p += 32) {
      const int t = base + p;
      const bool ok = tmask[t] != 0;  // loaded beside the point, not before it
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float v = tgt[3 * t + a];
        lo[a] = fminf(lo[a], ok ? v : inf);
        hi[a] = fmaxf(hi[a], ok ? v : -inf);
      }
    }
    warp_box(lo, hi);
    if (lane == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        own[a * per + s] = lo[a];
        own[(a + 3) * per + s] = hi[a];
      }
    }
  }
  // the box of the block's valid queries
  {
    float lo[3] = {valid ? qx : inf, valid ? qy : inf, valid ? qz : inf};
    float hi[3] = {valid ? qx : -inf, valid ? qy : -inf, valid ? qz : -inf};
    warp_box(lo, hi);
    if (lane == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        red[warp][a] = lo[a];
        red[warp][a + 3] = hi[a];
      }
    }
    __syncthreads();
    if (tid < 6) {
      float m = red[0][tid];
      for (int w = 1; w < kWarps; ++w) m = tid < 3 ? fminf(m, red[w][tid]) : fmaxf(m, red[w][tid]);
      qbox[tid] = m;
    }
  }
  cluster.sync();  // every CTA's boxes (and this CTA's qbox) are written

  // the sweep's tile staging
  float pv[kFetch][kUnit];  // the next tile, in registers
  const float nan = __int_as_float(0x7fc00000);
  // loads unit j of tile k (floats j * kUnit ...) into pv[u], the sentinel
  // applied; NaN past the cloud's end
  auto fetch = [&](int k) {
    const int base = k * TL;
    const int n_units = min(TL, T - base) * 3 / kUnit;
    const float* row = tgt + static_cast<size_t>(base) * 3;
#pragma unroll
    for (int u = 0; u < kFetch; ++u) {
      const int j = u * kThreads + tid;
      const bool in = j < n_units;
      if constexpr (VEC) {
        // floats 4j .. 4j + 3 belong to points p0 = 4j / 3 and p0 + 1
        // (both in the tile: 4j + 3 < 3n)
        const int p0 = 4 * j / 3;
        float4 v = make_float4(nan, nan, nan, nan);
        bool m0 = false, m1 = false;
        if (in) {
          v = reinterpret_cast<const float4*>(row)[j];
          m0 = tmask[base + p0] != 0;
          m1 = tmask[base + p0 + 1] != 0;
        }
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool first = (4 * j + q) / 3 == p0;
          pv[u][q] = !in || (first ? m0 : m1) ? e[q] : kSentinel;
        }
      } else {
        pv[u][0] = nan;
        if (in) pv[u][0] = tmask[base + j / 3] != 0 ? row[j] : kSentinel;
      }
    }
  };
  auto stage = [&](int buf) {
    float* t = reinterpret_cast<float*>(tile[buf]);
#pragma unroll
    for (int u = 0; u < kFetch; ++u) {
      const int j = u * kThreads + tid;
      if (j < kUnits) {
#pragma unroll
        for (int q = 0; q < kUnit; ++q) {
          const int f = j * kUnit + q;
          const int p = f / 3;
          t[4 * p + (f - 3 * p)] = pv[u][q];
        }
      }
    }
  };

  // 2. the skip test, one thread per tile; the scored tiles, ascending
  int n_list = 0;
  for (int k0 = 0; k0 < n_tiles; k0 += kThreads) {
    const int k = k0 + tid;
    bool scored = false;
    float tb[6];
    if (k < n_tiles) {
      const float* box = cluster.map_shared_rank(own, k % C);
#pragma unroll
      for (int a = 0; a < 6; ++a) tb[a] = box[a * per + k / C];
      scored = gap2(tb, qbox) <= r2;
    }
    const unsigned vote = __ballot_sync(0xffffffffu, scored);
    if (lane == 0) wcount[warp] = __popc(vote);
    __syncthreads();
    int off = n_list, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    if (scored) list[off + __popc(vote & ((1u << lane) - 1u))] = k;
    n_list += total;
    __syncthreads();  // wcount is read before the next chunk rewrites it
  }
  // the first listed tile's loads go out before the arrival, so they
  // overlap it; this CTA reads no other CTA's boxes from here on, and each
  // waits for every arrival only before it leaves
  if (n_list > 0) fetch(list[0]);
  cluster_arrive();

  // 3. the sweep over the listed tiles
  float c = 0.f, s1x = 0.f, s1y = 0.f, s1z = 0.f;
  float xx = 0.f, xy = 0.f, xz = 0.f, yy = 0.f, yz = 0.f, zz = 0.f;
  int buf = 0;
  if (n_list > 0) stage(0);
  __syncthreads();
  for (int li = 0; li < n_list; ++li) {
    const bool more = li + 1 < n_list;
    if (more) fetch(list[li + 1]);
    if (valid) {
      const float4* cur = tile[buf];
#pragma unroll 8
      for (int st = 0; st < TL / L; ++st) {
        const float4 p = cur[st * L + h];
        const float dx = __fsub_rn(p.x, qx);
        const float dy = __fsub_rn(p.y, qy);
        const float dz = __fsub_rn(p.z, qz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        if (d2 <= r2) {
          c += 1.f;
          s1x += dx;
          s1y += dy;
          s1z += dz;
          xx = fmaf(dx, dx, xx);
          xy = fmaf(dx, dy, xy);
          xz = fmaf(dx, dz, xz);
          yy = fmaf(dy, dy, yy);
          yz = fmaf(dy, dz, yz);
          zz = fmaf(dz, dz, zz);
        }
      }
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  // merge a query's lanes (a fixed butterfly) and write its row
  float acc[10] = {c, s1x, s1y, s1z, xx, xy, xz, yy, yz, zz};
#pragma unroll
  for (int o = 1; o < L; o <<= 1) {
#pragma unroll
    for (int m = 0; m < 10; ++m) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
  }
  if (in_q) {
    float* o = out + static_cast<size_t>(i) * 10;
#pragma unroll
    for (int m = 0; m < 10; ++m)
      if (m % L == h) o[m] = acc[m];
  }
  cluster_wait();  // no CTA leaves while another may read its boxes
}

struct Geometry {
  int C;        // cluster size: query blocks sharing one set of tile boxes
  int blocks;   // grid x: query blocks rounded up to whole clusters
  int n_tiles;  // target tiles per batch row
  size_t smem;  // dynamic shared memory per CTA
};

// C is the smallest power of two that holds the row's query blocks, at
// most kMaxCluster.
Geometry geometry(int Q, int T) {
  Geometry g;
  const int n_qb = (Q + kQb - 1) / kQb;
  g.C = 1;
  while (g.C < kMaxCluster && g.C < n_qb) g.C *= 2;
  g.blocks = (n_qb + g.C - 1) / g.C * g.C;
  g.n_tiles = (T + kTile - 1) / kTile;
  const int per = (g.n_tiles + g.C - 1) / g.C;
  g.smem = (6 * static_cast<size_t>(per) + g.n_tiles) * 4;
  return g;
}

bool bad_sizes(int B, int Q, int T) {
  return B <= 0 || B > 65535 || Q <= 0 || T <= 0 || (T + kTile - 1) / kTile > kMaxTiles ||
         (Q + kQb - 1) / kQb > (1 << 30) / kMaxCluster;
}

template <bool VEC>
cudaError_t launch(const Geometry& g, int B, cudaStream_t stream, const float* query,
                   const uint8_t* qmask, const float* tgt, const uint8_t* tmask, int Q, int T,
                   float r2, float* out) {
  auto* kernel = ball_moments_kernel<kQb, kTile, kLanes, VEC>;
  if (g.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.blocks, B, 1);
  cfg.blockDim = dim3(kQb * kLanes, 1, 1);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, query, qmask, tgt, tmask, Q, T, r2, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The launch geometry of ball_moments_launch for these sizes:
// out[0..8] = grid x, grid y, cluster size, threads per CTA, queries per
// CTA, targets per tile, threads per query, 16-byte target loads for a
// 16-byte aligned cloud (0/1), dynamic shared memory bytes.  Returns cudaErrorInvalidValue for sizes the kernel refuses.
extern "C" int ball_moments_geometry(int B, int Q, int T, int* out) {
  if (bad_sizes(B, Q, T)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(Q, T);
  const int v[9] = {g.blocks, B, g.C, kQb * kLanes, kQb, kTile, kLanes, T % 4 == 0,
                    static_cast<int>(g.smem)};
  for (int k = 0; k < 9; ++k) out[k] = v[k];
  return 0;
}

// query (B,Q,3) f32, qmask (B,Q) bool or null (every query valid), tgt
// (B,T,3) f32, tmask (B,T) bool, all contiguous on one device; out (B,Q,10)
// f32 = count, S1 xyz, S2 xx xy xz yy yz zz.  r2: the squared radius as
// f32.  Returns the launch's CUDA error.
extern "C" int ball_moments_launch(const float* query, const uint8_t* qmask, const float* tgt,
                                   const uint8_t* tmask, int B, int Q, int T, float r2,
                                   float* out, cudaStream_t stream) {
  if (bad_sizes(B, Q, T)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(Q, T);
  const bool vec = T % 4 == 0 && reinterpret_cast<uintptr_t>(tgt) % 16 == 0;
  const cudaError_t err =
      vec ? launch<true>(g, B, stream, query, qmask, tgt, tmask, Q, T, r2, out)
          : launch<false>(g, B, stream, query, qmask, tgt, tmask, Q, T, r2, out);
  return static_cast<int>(err);
}
