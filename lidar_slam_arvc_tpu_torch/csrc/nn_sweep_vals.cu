// Nearest-neighbour sweep returning the winner's values (K4) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel _nn_kernel_vpu_tq in
// lidar_slam_arvc_tpu/ops/nn_pallas.py (reached from nn_search_pallas_vals,
// ICP's nn_impl="vpu_tq"): K1's sweep (sentinel form, nn_sweep.cuh), but it
// returns, per source point, d2 and the winning target's point q and normal
// n instead of its index, so ICP needs no gathers.  d2 is bit-equal to K1's;
// q and n are tgt[idx] and normals[idx] exactly.  A masked winner (every
// target masked) returns its real coordinates, not the sentinel.
//
// The TPU kernel selects the winner's values with a one-hot matmul per tile
// on its otherwise idle matrix unit.  Here that would cost a tile of extra
// work for what is one indexed read: the sweep tracks the best index as
// K1 does and, after the cluster's merge, the epilogue reads the merged
// winner's six floats from device memory (L2-resident: the target cloud
// is 96 KB per scan).
//
// Bound on this card: FP32 instruction issue, as K1 (nn_sweep.cuh, with
// K1's geometry); the epilogue adds 24 bytes read and 28 bytes written per
// source point.

#include "nn_sweep.cuh"

namespace {

using namespace nn_sweep;

__global__ void __launch_bounds__(kThreads)
nn_sweep_vals_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                     const uint8_t* __restrict__ tmask,
                     const float* __restrict__ normals, int S, int T, int chunk,
                     float* __restrict__ out_d2, float* __restrict__ out_q,
                     float* __restrict__ out_n) {
  const Outputs out{nullptr, out_d2, normals, out_q, out_n};
  sweep<kSentinelForm, true>(src, tgt, tmask, S, T, chunk, out);
}

}  // namespace

// src (B,S,3), tgt (B,T,3), normals (B,T,3) f32, tmask (B,T) uint8/bool,
// all contiguous on one device; d2 (B,S), q (B,S,3) and n (B,S,3) f32 are
// written.  n_sm: the card's SM count (sets the split, as
// nn_sweep_geometry reports it).  Returns the launch's CUDA error.
extern "C" int nn_sweep_vals_launch(const float* src, const float* tgt,
                                    const uint8_t* tmask, const float* normals,
                                    int B, int S, int T, int n_sm, float* d2, float* q,
                                    float* n, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || S <= 0 || T <= 0 || n_sm <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(B, S, T, n_sm);
  return static_cast<int>(launch_clustered(nn_sweep_vals_kernel, g, B, stream, src, tgt,
                                           tmask, normals, S, T, g.chunk, d2, q, n));
}
