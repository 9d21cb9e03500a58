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
// The per-target pen and t2 rows, which the JAX wrapper builds outside its
// kernel, are formed here while each target tile is staged.
//
// What bounds it and what the design does about it: nn_sweep.cuh (FP32
// issue, no FMA, so at most ~50% of a roofline that counts an FMA as two
// operations; occupied tiles only, one running minimum a pair, several
// sources a thread, the target axis split across a cluster,
// double-buffered tiles).  The leading batch dimension is the grid's y
// axis, so one launch serves a whole ICP group.

#include "nn_sweep.cuh"

namespace {

using namespace nn_sweep;

template <int F, int R>
__global__ void __launch_bounds__(kThreads)
nn_sweep_kernel(const float* __restrict__ src, const uint8_t* __restrict__ smask,
                const float* __restrict__ tgt, const uint8_t* __restrict__ tmask, int S,
                int T, int stride, int32_t* __restrict__ out_idx, float* __restrict__ out_d2) {
  const Outputs out{out_idx, out_d2, nullptr, nullptr, nullptr};
  sweep<F, false, R>(src, smask, tgt, tmask, S, T, stride, out);
}

template <int F>
int launch(const float* src, const uint8_t* smask, const float* tgt, const uint8_t* tmask,
           int B, int S, int T, int n_sm, int32_t* idx, float* d2, cudaStream_t stream) {
  const Geometry g = geometry(B, S, T, n_sm);
  return static_cast<int>(by_rows(g.rows, [&](auto rows) {
    return launch_clustered(nn_sweep_kernel<F, decltype(rows)::value>, g, B, stream, src,
                            smask, tgt, tmask, S, T, g.stride, idx, d2);
  }));
}

}  // namespace

// The launch geometry of nn_sweep_launch and nn_sweep_vals_launch for
// these sizes on a card of n_sm SMs: out[0..6] = grid x, grid y, cluster
// size (the CTAs that share a source block, target tiles dealt to them
// round robin), targets per tile, threads per CTA, sources per thread,
// targets per sub-tile.
extern "C" void nn_sweep_geometry(int B, int S, int T, int n_sm, int* out) {
  const Geometry g = geometry(B, S, T, n_sm);
  out[0] = g.blocks * g.split;
  out[1] = B;
  out[2] = g.split;
  out[3] = kTile;
  out[4] = kThreads;
  out[5] = g.rows;
  out[6] = kSub;
}

// src (B,S,3) f32, smask (B,S) uint8/bool or null (every source valid),
// tgt (B,T,3) f32, tmask (B,T) uint8/bool, all contiguous on one device;
// idx (B,S) int32 and d2 (B,S) f32 are written, index 0 and d2 0.0 for a
// masked source.  form: 0 = sentinel (K1 vpu_t, K3 vpu2), 1 = penalty (K3
// vpu), 2 = matmul (K3 mxu).  n_sm: the card's SM count (sets the
// geometry).  Returns the launch's CUDA error.
extern "C" int nn_sweep_launch(int form, const float* src, const uint8_t* smask,
                               const float* tgt, const uint8_t* tmask, int B, int S, int T,
                               int n_sm, int32_t* idx, float* d2, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || S <= 0 || T <= 0 || n_sm <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (form) {
    case kSentinelForm:
      return launch<kSentinelForm>(src, smask, tgt, tmask, B, S, T, n_sm, idx, d2, stream);
    case kPenaltyForm:
      return launch<kPenaltyForm>(src, smask, tgt, tmask, B, S, T, n_sm, idx, d2, stream);
    case kMatmulForm:
      return launch<kMatmulForm>(src, smask, tgt, tmask, B, S, T, n_sm, idx, d2, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
