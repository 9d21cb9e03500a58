// The exhaustive nearest-neighbour sweep shared by K1 and K3 (nn_sweep.cu)
// and K4 (nn_sweep_vals.cu), for NVIDIA Hopper (sm_90a).
//
// One thread per source point holds its point and its running best
// (value, index) in registers; the block stages each target tile once in
// shared memory, where every thread reads the same word at the same time
// (a broadcast).  The TPU grid's sequential target axis is the tile loop.
// Ties go to the lowest target index: targets are visited in ascending
// order and the running best is replaced only on a strict <.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn/
// __fsub_rn): nvcc would otherwise contract a*b + c into an FMA, and the
// plain PyTorch versions, which round each operation, would differ in the
// last bit of d2 and so on near-tie indices.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nn_sweep {

constexpr int kThreads = 128;   // source points per block, one per thread
constexpr int kTile = 1024;     // targets staged in shared memory per step
constexpr float kSentinel = -4e7f;

// The d2 form, after the TPU kernel whose numbers it reproduces.
enum Form : int {
  // _nn_kernel_vpu_t, _vpu2, _vpu_tq: masked targets moved to the
  // sentinel, d2 = (dx*dx + dy*dy) + dz*dz
  kSentinelForm = 0,
  // _nn_kernel_vpu: d2 = ((dx*dx + dy*dy) + dz*dz) + pen, where the
  // per-target pen (0, or 1e12 for a masked target) is an input
  kPenaltyForm = 1,
  // _nn_kernel_mxu: score = t2 - 2 ((sx*tx + sy*ty) + sz*tz), where the
  // per-target t2 = |t|^2 + pen is an input; the caller adds |s|^2 after
  kMatmulForm = 2,
};

// Sweeps the T targets of one batch row for source point s (S sources);
// aux is the per-target pen (kPenaltyForm) or t2 (kMatmulForm), unread in
// kSentinelForm.  Every thread of the block must call it (it synchronises);
// threads with s >= S sweep a dummy point.
template <int F>
__device__ __forceinline__ void sweep(const float* __restrict__ src,
                                      const float* __restrict__ tgt,
                                      const uint8_t* __restrict__ tmask,
                                      const float* __restrict__ aux, int S, int T,
                                      int s, float* sx_out, float* best_out,
                                      int* best_i_out) {
  __shared__ float tx[kTile];
  __shared__ float ty[kTile];
  __shared__ float tz[kTile];
  __shared__ float ta[F == kSentinelForm ? 1 : kTile];

  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (s < S) {
    sx = src[3 * s];
    sy = src[3 * s + 1];
    sz = src[3 * s + 2];
  }
  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = 0;

  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    __syncthreads();  // the previous tile is no longer being read
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const int t = base + k;
      if constexpr (F == kSentinelForm) {
        const bool ok = tmask[t] != 0;
        tx[k] = ok ? tgt[3 * t] : kSentinel;
        ty[k] = ok ? tgt[3 * t + 1] : kSentinel;
        tz[k] = ok ? tgt[3 * t + 2] : kSentinel;
      } else {
        tx[k] = tgt[3 * t];
        ty[k] = tgt[3 * t + 1];
        tz[k] = tgt[3 * t + 2];
        ta[k] = aux[t];
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      float d2;
      if constexpr (F == kMatmulForm) {
        const float c = __fadd_rn(__fadd_rn(__fmul_rn(sx, tx[k]), __fmul_rn(sy, ty[k])),
                                  __fmul_rn(sz, tz[k]));
        d2 = __fsub_rn(ta[k], __fmul_rn(2.f, c));
      } else {
        const float dx = __fsub_rn(tx[k], sx);
        const float dy = __fsub_rn(ty[k], sy);
        const float dz = __fsub_rn(tz[k], sz);
        d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        if constexpr (F == kPenaltyForm) d2 = __fadd_rn(d2, ta[k]);
      }
      if (d2 < best) {
        best = d2;
        best_i = base + k;
      }
    }
  }
  sx_out[0] = sx;
  sx_out[1] = sy;
  sx_out[2] = sz;
  *best_out = best;
  *best_i_out = best_i;
}

}  // namespace nn_sweep
