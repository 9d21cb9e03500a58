// Exact nearest-neighbour sweeps K1 and K3 for NVIDIA Hopper (sm_90a).
//
// Replaces four TPU kernels of lidar_slam_arvc_tpu/ops/nn_pallas.py, all
// reached from nn_search_pallas: for every source point, the index and
// squared distance of the nearest VALID target, ties to the lowest index.
// One compile-time form per TPU kernel (nn_sweep.cuh), each equal bit for
// bit to its plain PyTorch version (ops/nn.py nn_search_plain):
//   * K1, impl="vpu_t" (_nn_kernel_vpu_t) and K3 impl="vpu2"
//     (_nn_kernel_vpu2): masked targets at the sentinel (-4e7, -4e7, -4e7),
//     d2 = (dx*dx + dy*dy) + dz*dz; a masked winner (only when every target
//     is masked) reports d2 >= ~4.8e15;
//   * K3 impl="vpu" (_nn_kernel_vpu): d2 = ((dx*dx + dy*dy) + dz*dz) + pen
//     with pen = 1e12 for a masked target (a masked winner reports ~1e12
//     plus its real distance);
//   * K3 impl="mxu" (_nn_kernel_mxu): the matmul form, score =
//     t2 - 2 (s . t) with t2 = |t|^2 + pen, then d2 = max(best + |s|^2, 0)
//     (a masked winner reports ~1e12).  s . t = (sx*tx + sy*ty) + sz*tz in
//     plain f32: no tensor cores, no TF32.
// The wrapper computes the per-target pen and t2 rows outside the kernel,
// as the JAX wrapper does.
//
// Bound on this card: FP32 instruction throughput.  Each (source, target)
// pair costs 8 (sentinel), 9 (penalty) or 7 (matmul) rounded f32
// operations plus a compare and a select, and S*T pairs are scored (8192^2
// per pair of scans at full source resolution); nothing is read from
// device memory but the clouds.  Tensor cores do not apply (the
// contraction depth is 3).  The leading batch dimension is the grid's y
// axis, so one launch serves a whole ICP group.
//
// Not yet done (later work): several sources per thread to amortise the
// shared-memory loads, TMA staging, and splitting the target axis across
// blocks when S is small (at S = 2048, B = 4 the grid is 64 blocks on 132
// SMs).

#include "nn_sweep.cuh"

namespace {

using namespace nn_sweep;

template <int F>
__global__ void __launch_bounds__(kThreads)
nn_sweep_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                const uint8_t* __restrict__ tmask, const float* __restrict__ aux,
                int S, int T, int32_t* __restrict__ out_idx, float* __restrict__ out_d2) {
  const int b = blockIdx.y;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  src += static_cast<size_t>(b) * S * 3;
  tgt += static_cast<size_t>(b) * T * 3;
  tmask += static_cast<size_t>(b) * T;
  if (aux != nullptr) aux += static_cast<size_t>(b) * T;

  float p[3], best;
  int best_i;
  sweep<F>(src, tgt, tmask, aux, S, T, s, p, &best, &best_i);
  if (s < S) {
    if constexpr (F == kMatmulForm) {
      const float s2 = __fadd_rn(__fadd_rn(__fmul_rn(p[0], p[0]), __fmul_rn(p[1], p[1])),
                                 __fmul_rn(p[2], p[2]));
      best = fmaxf(__fadd_rn(best, s2), 0.f);
    }
    out_idx[static_cast<size_t>(b) * S + s] = best_i;
    out_d2[static_cast<size_t>(b) * S + s] = best;
  }
}

template <int F>
int launch(const float* src, const float* tgt, const uint8_t* tmask, const float* aux,
           int B, int S, int T, int32_t* idx, float* d2, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (F != kSentinelForm && aux == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kThreads - 1) / kThreads, B);
  nn_sweep_kernel<F><<<grid, kThreads, 0, stream>>>(src, tgt, tmask, aux, S, T, idx, d2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src (B,S,3) f32, tgt (B,T,3) f32, tmask (B,T) uint8/bool, all
// contiguous on one device; idx (B,S) int32 and d2 (B,S) f32 are written.
// form: 0 = sentinel (K1 vpu_t, K3 vpu2; aux unread), 1 = penalty (K3 vpu,
// aux = pen (B,T) f32), 2 = matmul (K3 mxu, aux = t2 (B,T) f32).  Returns
// cudaGetLastError() after the launch.
extern "C" int nn_sweep_launch(int form, const float* src, const float* tgt,
                               const uint8_t* tmask, const float* aux, int B, int S,
                               int T, int32_t* idx, float* d2, cudaStream_t stream) {
  switch (form) {
    case kSentinelForm:
      return launch<kSentinelForm>(src, tgt, tmask, nullptr, B, S, T, idx, d2, stream);
    case kPenaltyForm:
      return launch<kPenaltyForm>(src, tgt, tmask, aux, B, S, T, idx, d2, stream);
    case kMatmulForm:
      return launch<kMatmulForm>(src, tgt, tmask, aux, B, S, T, idx, d2, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
