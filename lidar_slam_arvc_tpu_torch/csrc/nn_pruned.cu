// Distance-adaptive pruned nearest-neighbour sweep (K5) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel _pruned_kernel in
// lidar_slam_arvc_tpu/ops/nn_pruned.py (reached from
// nn_search_pruned_presorted; ICP's nn_impl="pruned").  Both clouds arrive
// Morton-sorted and padded to whole blocks; the wrapper (ops/nn_pruned.py)
// computes, per (source block i, target block), a lower bound on their
// squared distance, pushed to 1e12 beyond the gate, and the nearest-first
// visiting order perm[i, :] with the bounds in that order, tile_d2[i, :]
// (a stable argsort: among equal bounds, the lower block first).
//
// One CUDA block per (pair, source block of `sb` rows), one thread per row:
//   * for j in perm order: the block reduces bound = max over its rows of
//     (best + |s|^2) (every thread computes the same value, so the branch
//     is uniform) and skips target block perm[i, j] when
//     tile_d2[i, j] > bound: no row can improve there;
//   * otherwise it stages the `tb` targets and their t2 = |t|^2 + pen in
//     shared memory and each row scores t2 - 2 ((sx*tx + sy*ty) + sz*tz),
//     every operation rounded on its own (__fmul_rn/__fadd_rn) as in the
//     plain PyTorch version, replacing its best only on a strict <, so
//     across blocks the earlier-visited block wins a tie;
//   * invalid source rows start at -1e12, so they never hold the bound up,
//     and come out with d2 = 0 and index 0;
//   * it writes d2 = max(best + |s|^2, 0) and the index clipped to
//     [0, Tp - 1].
// The result is exact for every row whose nearest neighbour lies inside the
// gate, and equal bit for bit to the plain version (ops/nn_pruned.py
// pruned_sweep_plain), which visits and skips by the same rules.
//
// Bound on this card: FP32 instruction throughput on the blocks that are
// not skipped (7 rounded operations, a compare and a select per scored
// pair).  Limit of this first version: the skip is decided per source
// block, so a block has the reference's `sb` (512) rows, and at the bench
// shape (4 pairs, 2048 strided source points) the grid is only 16 blocks
// on 132 SMs.  Splitting the target walk across blocks is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 1024;     // source rows per block (threads)
constexpr int kMaxTile = 2048;     // target rows per block (shared memory)
constexpr float kNeg = -1e12f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kMaxRows)
nn_pruned_kernel(const float* __restrict__ ss, const uint8_t* __restrict__ sv,
                 const float* __restrict__ ts, const float* __restrict__ t2,
                 const int32_t* __restrict__ perm, const float* __restrict__ tile_d2,
                 int Sp, int Tp, int sb, int tb, int32_t* __restrict__ out_idx,
                 float* __restrict__ out_d2) {
  extern __shared__ float tile[];   // x[tb], y[tb], z[tb], t2[tb]
  __shared__ float red[kMaxRows / 32];
  float* tx = tile;
  float* ty = tile + tb;
  float* tz = tile + 2 * tb;
  float* tt = tile + 3 * tb;

  const int b = blockIdx.y;
  const int i = blockIdx.x;
  const int n_i = Sp / sb;
  const int n_j = Tp / tb;
  const int r = threadIdx.x;
  const bool row = r < sb;
  const int s = i * sb + r;
  ss += static_cast<size_t>(b) * Sp * 3;
  sv += static_cast<size_t>(b) * Sp;
  ts += static_cast<size_t>(b) * Tp * 3;
  t2 += static_cast<size_t>(b) * Tp;
  perm += (static_cast<size_t>(b) * n_i + i) * n_j;
  tile_d2 += (static_cast<size_t>(b) * n_i + i) * n_j;

  const float inf = __int_as_float(0x7f800000);
  float sx = 0.f, sy = 0.f, sz = 0.f, s2 = 0.f, best = -inf;
  int best_i = 0;
  if (row) {
    sx = ss[3 * s];
    sy = ss[3 * s + 1];
    sz = ss[3 * s + 2];
    s2 = __fadd_rn(__fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sy, sy)), __fmul_rn(sz, sz));
    best = sv[s] != 0 ? inf : kNeg;
  }
  const int n_warps = (blockDim.x + 31) / 32;
  const int warp = r / 32, lane = r % 32;

  for (int j = 0; j < n_j; ++j) {
    // worst outstanding distance of the block (threads past sb add -inf)
    float v = warp_max(row ? __fadd_rn(best, s2) : -inf);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float bound = red[0];
    for (int w = 1; w < n_warps; ++w) bound = fmaxf(bound, red[w]);
    __syncthreads();  // red is rewritten next step; the old tile is consumed
    if (!(tile_d2[j] <= bound)) continue;

    const int k = perm[j];
    for (int q = r; q < tb; q += blockDim.x) {
      const int t = k * tb + q;
      tx[q] = ts[3 * t];
      ty[q] = ts[3 * t + 1];
      tz[q] = ts[3 * t + 2];
      tt[q] = t2[t];
    }
    __syncthreads();
    if (row) {
      for (int q = 0; q < tb; ++q) {
        const float c = __fadd_rn(__fadd_rn(__fmul_rn(sx, tx[q]), __fmul_rn(sy, ty[q])),
                                  __fmul_rn(sz, tz[q]));
        const float score = __fsub_rn(tt[q], __fmul_rn(2.f, c));
        if (score < best) {
          best = score;
          best_i = k * tb + q;
        }
      }
    }
  }
  if (row) {
    const size_t o = static_cast<size_t>(b) * Sp + s;
    out_d2[o] = fmaxf(__fadd_rn(best, s2), 0.f);
    out_idx[o] = min(max(best_i, 0), Tp - 1);
  }
}

}  // namespace

// ss (B,Sp,3) f32 and sv (B,Sp) bool: the sorted, padded source; ts
// (B,Tp,3) f32 and t2 (B,Tp) f32 = |t|^2 + (0, or 1e12 for a masked
// target): the sorted, padded target; perm (B,n_i,n_j) int32 and tile_d2
// (B,n_i,n_j) f32, n_i = Sp/sb, n_j = Tp/tb; all contiguous on one device.
// idx (B,Sp) int32 and d2 (B,Sp) f32 are written.  Returns
// cudaGetLastError() after the launch.
extern "C" int nn_pruned_launch(const float* ss, const uint8_t* sv, const float* ts,
                                const float* t2, const int32_t* perm,
                                const float* tile_d2, int B, int Sp, int Tp, int sb,
                                int tb, int32_t* idx, float* d2, cudaStream_t stream) {
  if (B <= 0 || sb <= 0 || tb <= 0 || sb > kMaxRows || tb > kMaxTile || Sp <= 0 ||
      Tp <= 0 || Sp % sb != 0 || Tp % tb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (sb + 31) / 32 * 32;
  const size_t smem = 4 * static_cast<size_t>(tb) * sizeof(float);
  const dim3 grid(Sp / sb, B);
  nn_pruned_kernel<<<grid, threads, smem, stream>>>(ss, sv, ts, t2, perm, tile_d2, Sp, Tp,
                                                    sb, tb, idx, d2);
  return static_cast<int>(cudaGetLastError());
}
