// One ICP step's update for NVIDIA Hopper (sm_90a): K6.
//
// Replaces no TPU kernel.  The JAX package's ICP iteration
// (lidar_slam_arvc_tpu/registration/icp.py) runs everything after the
// correspondence search as XLA operations that jit fuses into its loop
// body.  The port ran them as ~186 small PyTorch launches and a host read a
// step (registration/icp.py's eager step, which stays the CPU path and the
// plain version of this kernel).  K6 is that update in one launch, for
// every pair of an ICP group, after the search (K1, K3, K4, K5 or the
// matmul form) has found each source's correspondence:
//
//   pass A  gate = mask * [d2 <= thr2]; the fitness, the inlier RMSE and
//           the first Welsch sigma^2 (the gated mean-square distance);
//   pass B  w1 = gate * exp(-d2 / 2 sigma^2) and the second sigma^2
//           (robust only);
//   pass C  the final weights; the correspondence's point and normal
//           (gathered by the search's index, or K4's values); residual and
//           Jacobian; the sums of the Gauss-Newton system, H (21) and b (6)
//           point-to-plane, or the 16 sums of the point-to-point closed
//           form;
//   solve   the Tikhonov floor 1e-6 (tr H / 6 + 1), a 6x6 LU with partial
//           pivoting, a non-finite xi taken as 0; T' = exp(xi) T (so3_exp's
//           and _V_matrix's small-angle branches as in geom/); T, delta,
//           fitness and RMSE kept where the pair is active; it += active;
//           active = it < max_iters && delta > tol;
//   next    the sources under the new T, for the next search.
//
// What bounds it: latency, not bytes or operations.  A pair at S = 32768
// reads ~1.5 MB (d2, mask, p, index, the gathered q and n, the sources) and
// writes 0.4 MB, from and to L2; its three passes are sums, and each needs
// the whole pair's sum before the next pass starts.  The design:
//   * one thread block cluster per pair (grid (cluster, B)), up to 8 CTAs
//     (portable), each over a contiguous slice of the pair's sources; a CTA
//     keeps its sources' d2, mask and gate in registers across the three
//     passes (kPer a thread; a larger slice re-reads them, in rounds);
//   * every sum in a fixed order: each thread over its sources in order, a
//     warp by shuffles, the warps in order, then the cluster's CTAs in rank
//     order through distributed shared memory.  No atomics, so a run is
//     bit-for-bit repeatable;
//   * every CTA sums the partials of passes A and B itself (the same values
//     in the same order, so the same result), which saves a broadcast; the
//     leader CTA (rank 0) alone sums pass C, solves and updates the state,
//     and writes the new pose into every CTA's shared memory before the
//     last cluster barrier;
//   * full f32: IEEE division and sqrtf, expf, sinf, cosf (no fast-math
//     intrinsics), no tensor cores.  torch.clamp's NaN is kept (clamp_min),
//     so a non-finite system reaches the solve as it does in PyTorch.  The
//     next sources round each product and sum on its own in geom/se3.py's
//     order, so they equal transform_points of the same T bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                   // sources a thread keeps in registers
constexpr int kRound = kThreads * kPer;    // sources a CTA holds at once
constexpr int kMaxCluster = 8;             // portable cluster size
constexpr int kMaxSums = 27;               // point-to-plane: 21 of H, 6 of b

// the sums pass C takes: point-to-plane 21 of H and 6 of b, point-to-point
// the closed form's 16
__host__ __device__ constexpr int sums(bool plane) { return plane ? 27 : 16; }

struct Args {
  const float* src;     // (B, S, 3) the phase's sources
  const float* p;       // (B, S, 3) the sources under the current T
  const float* mask;    // (B, S) 1 for a valid source, else 0
  const float* d2;      // (B, S) squared distance to the correspondence
  const int32_t* idx;   // (B, S) its target index, or null (values form)
  const float* tgt;     // (B, T, 3) targets (index form)
  const float* nrm;     // (B, T, 3) target normals (index form)
  const float* q;       // (B, S, 3) the correspondence's point (values form)
  const float* n;       // (B, S, 3) and its normal (values form)
  float* p_next;        // (B, S, 3) written: the sources under the new T
  float* T;             // (B, 4, 4) the state, updated in place
  float* delta;         // (B,)
  float* fit;           // (B,)
  float* rmse;          // (B,)
  int32_t* it;          // (B,)
  uint8_t* active;      // (B,)
  int S, Tn, slice, rounds, max_iters, robust;
  float thr2, tol;
};

struct Geometry {
  int cluster;  // CTAs per pair
  int slice;    // sources per CTA
  int rounds;   // register loads per pass (1: d2, mask and gate stay in registers)
};

inline Geometry geometry(int S) {
  Geometry g;
  const int ctas = (S + kThreads - 1) / kThreads;
  g.cluster = ctas < 1 ? 1 : (ctas > kMaxCluster ? kMaxCluster : ctas);
  g.slice = (S + g.cluster - 1) / g.cluster;
  g.rounds = (g.slice + kRound - 1) / kRound;
  return g;
}

// torch.clamp(x, min=lo): a NaN stays NaN (fmaxf would return lo)
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// out[k] = the CTA's sum of v[k], k < N: each warp by shuffles, then the
// warps in order.  out is read after a barrier.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float (*warp_part)[kMaxSums],
                                          float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) warp_part[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = warp_part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += warp_part[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// tot[k] = the sum of every CTA's part[k] in rank order (after a cluster
// barrier that follows block_sum); tot is read after the __syncthreads here.
template <int N>
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster, float* part,
                                            float* tot) {
  if (threadIdx.x < N) {
    float s = cluster.map_shared_rank(part, 0)[threadIdx.x];
    for (int c = 1; c < static_cast<int>(cluster.num_blocks()); ++c)
      s += cluster.map_shared_rank(part, c)[threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// Adds source's terms with weight w: point-to-plane (r = n.(p - q),
// J = [p x n, n]) the upper triangle of w J^T J, row by row, then w J r;
// point-to-point the closed form's sums: w (p p^T - |p|^2 I) (upper),
// w p, w, w (p x r), w r with r = p - q.
template <bool kPlane>
__device__ __forceinline__ void accumulate(float (&v)[sums(kPlane)], float w, float px,
                                           float py, float pz, float qx, float qy, float qz,
                                           float nx, float ny, float nz) {
  if constexpr (kPlane) {
    const float r = (nx * (px - qx) + ny * (py - qy)) + nz * (pz - qz);
    const float J[6] = {py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx, nx, ny, nz};
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float jw = J[i] * w;
#pragma unroll
      for (int j = i; j < 6; ++j) v[k++] += jw * J[j];
      v[21 + i] += jw * r;
    }
  } else {
    const float rx = px - qx, ry = py - qy, rz = pz - qz;
    const float pp = (px * px + py * py) + pz * pz;
    v[0] += (px * px - pp) * w;
    v[1] += (px * py) * w;
    v[2] += (px * pz) * w;
    v[3] += (py * py - pp) * w;
    v[4] += (py * pz) * w;
    v[5] += (pz * pz - pp) * w;
    v[6] += px * w;
    v[7] += py * w;
    v[8] += pz * w;
    v[9] += w;
    v[10] += (py * rz - pz * ry) * w;
    v[11] += (pz * rx - px * rz) * w;
    v[12] += (px * ry - py * rx) * w;
    v[13] += rx * w;
    v[14] += ry * w;
    v[15] += rz * w;
  }
}

// The 6x6 system H x = b from the summed terms (registration/icp.py's
// _gn_point_to_plane / _gn_point_to_point).
template <bool kPlane>
__device__ __forceinline__ void assemble(const float (&v)[kMaxSums], float (&H)[6][6],
                                         float (&b)[6]) {
  if constexpr (kPlane) {
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) {
        H[i][j] = v[k];
        H[j][i] = v[k];
        ++k;
      }
      b[i] = -v[21 + i];
    }
  } else {
    // Hww = -sum w hat(p)^2, Hwv = sum w hat(p), Hvv = sum(w) I
    const float ww[3][3] = {{-v[0], -v[1], -v[2]}, {-v[1], -v[3], -v[4]},
                            {-v[2], -v[4], -v[5]}};
    const float wv[3][3] = {{0.f, -v[8], v[7]}, {v[8], 0.f, -v[6]}, {-v[7], v[6], 0.f}};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        H[i][j] = ww[i][j];
        H[i][3 + j] = wv[i][j];
        H[3 + j][i] = wv[i][j];
        H[3 + i][3 + j] = i == j ? v[9] : 0.f;
      }
      b[i] = -v[10 + i];
      b[3 + i] = -v[13 + i];
    }
  }
}

// x = (H + damp I)^-1 b by LU with partial pivoting (the first largest
// pivot); a non-finite x becomes 0.  Every index is a compile-time
// constant once unrolled, so the system stays in registers.
__device__ __forceinline__ void solve6(float (&A)[6][6], float (&x)[6]) {
  float tr = A[0][0];
#pragma unroll
  for (int i = 1; i < 6; ++i) tr += A[i][i];
  const float damp = 1e-6f * (tr / 6.f + 1.f);
#pragma unroll
  for (int i = 0; i < 6; ++i) A[i][i] += damp;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int piv = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        piv = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == piv) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float t = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = t;
        }
        const float t = x[k];
        x[k] = x[i];
        x[i] = t;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float f = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= f * A[k][j];
      x[i] -= f * x[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) ok = ok && fabsf(x[i]) <= 3.402823466e38f;  // not inf, not NaN
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = 0.f;
  }
}

// E = exp(xi) (geom/se3.py::se3_exp: rotation so3_exp(w), translation
// _V_matrix(w) v), rows 0..2 of the 4x4.
__device__ __forceinline__ void se3_exp(const float (&xi)[6], float (&E)[3][4]) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float theta2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const float theta = sqrtf(clamp_min(theta2, 1e-24f));
  const bool small = theta2 < 1e-12f;
  const float s = sinf(theta), c = cosf(theta);
  const float A = small ? 1.f - theta2 / 6.f : s / theta;
  const float Bc = small ? 0.5f - theta2 / 24.f : (1.f - c) / clamp_min(theta2, 1e-24f);
  const float C = small ? 1.f / 6.f - theta2 / 120.f
                        : (theta - s) / clamp_min(theta2 * theta, 1e-24f);
  const float hat[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  const float wv[3] = {w0, w1, w2};
  float V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.f : 0.f;
      const float hs = wv[i] * wv[j] - (i == j ? theta2 : 0.f);   // hat(w)^2
      E[i][j] = (eye + A * hat[i][j]) + Bc * hs;
      V[i][j] = (eye + Bc * hat[i][j]) + C * hs;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) E[i][3] = (V[i][0] * xi[3] + V[i][1] * xi[4]) + V[i][2] * xi[5];
}

template <bool kPlane>
__global__ void __launch_bounds__(kThreads) icp_step_kernel(const Args a) {
  constexpr int kSums = sums(kPlane);
  __shared__ float warp_part[kWarps][kMaxSums];
  __shared__ float part_a[3], part_b[2], part_c[kMaxSums];
  __shared__ float tot_a[3], tot_b[2], tot_c[kMaxSums];
  __shared__ float pose[12];  // the new T's rows 0..2, written by the leader

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(b) * a.S;
  const int begin = min(a.S, rank * a.slice);
  const int end = min(a.S, begin + a.slice);
  const float* d2 = a.d2 + row;
  const float* mask = a.mask + row;

  // the thread's sources of round r: begin + r * kRound + k * kThreads + tid
  float rd2[kPer], rm[kPer], rg[kPer];
  auto load = [&](int r) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int s = begin + r * kRound + k * kThreads + tid;
      const bool in = s < end;
      rd2[k] = in ? d2[s] : 0.f;
      rm[k] = in ? mask[s] : 0.f;
      rg[k] = rm[k] * (rd2[k] <= a.thr2 ? 1.f : 0.f);
    }
  };
  const bool cached = a.rounds == 1;

  // pass A: sum mask, sum gate, sum d2 * gate
  float va[3] = {0.f, 0.f, 0.f};
  for (int r = 0; r < a.rounds; ++r) {
    load(r);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      va[0] += rm[k];
      va[1] += rg[k];
      va[2] += rd2[k] * rg[k];
    }
  }
  block_sum<3>(va, warp_part, part_a);
  cluster.sync();
  cluster_sum<3>(cluster, part_a, tot_a);
  // Welsch scale from the gated mean-square distance
  float den = clamp_min(2.f * (tot_a[2] / clamp_min(tot_a[1], 1.f)), 1e-8f);

  // pass B: sharpened once by reweighting
  if (a.robust) {
    float vb[2] = {0.f, 0.f};
    for (int r = 0; r < a.rounds; ++r) {
      if (!cached) load(r);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float w1 = rg[k] * expf(-rd2[k] / den);
        vb[0] += w1 * rd2[k];
        vb[1] += w1;
      }
    }
    block_sum<2>(vb, warp_part, part_b);
    cluster.sync();
    cluster_sum<2>(cluster, part_b, tot_b);
    den = clamp_min(2.f * (tot_b[0] / clamp_min(tot_b[1], 1e-6f)), 1e-8f);
  }

  // pass C: the normal equations' sums
  float vc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) vc[k] = 0.f;
  const float* p = a.p + 3 * row;
  // the correspondence's point and normal: the target row the index names,
  // or the values form's own row
  const bool by_index = a.idx != nullptr;
  const float* qv = by_index ? a.tgt : a.q;
  const float* nv = by_index ? a.nrm : a.n;
  for (int r = 0; r < a.rounds; ++r) {
    if (!cached) load(r);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int s = begin + r * kRound + k * kThreads + tid;
      if (s < end) {
        const float w = a.robust ? rg[k] * expf(-rd2[k] / den) : rg[k];
        const size_t c = 3 * (by_index ? static_cast<size_t>(b) * a.Tn + a.idx[row + s]
                                       : row + s);
        const float* ps = p + 3 * s;
        if constexpr (kPlane) {
          accumulate<true>(vc, w, ps[0], ps[1], ps[2], qv[c], qv[c + 1], qv[c + 2], nv[c],
                           nv[c + 1], nv[c + 2]);
        } else {
          accumulate<false>(vc, w, ps[0], ps[1], ps[2], qv[c], qv[c + 1], qv[c + 2], 0.f, 0.f,
                            0.f);
        }
      }
    }
  }
  block_sum<kSums>(vc, warp_part, part_c);
  cluster.sync();

  if (rank == 0) {
    cluster_sum<kSums>(cluster, part_c, tot_c);
    if (tid == 0) {
      float H[6][6], xi[6];
      assemble<kPlane>(tot_c, H, xi);
      solve6(H, xi);
      float E[3][4];
      se3_exp(xi, E);
      float* Tb = a.T + 16 * b;
      float T0[4][4], T1[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) T0[i][j] = Tb[4 * i + j];
      }
      // T' = exp(xi) T, each entry summed left to right (geom/se3.py::compose)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e[4] = {i < 3 ? E[i][0] : 0.f, i < 3 ? E[i][1] : 0.f,
                            i < 3 ? E[i][2] : 0.f, i < 3 ? E[i][3] : 1.f};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          T1[i][j] = ((e[0] * T0[0][j] + e[1] * T0[1][j]) + e[2] * T0[2][j]) + e[3] * T0[3][j];
      }
      const float dn = sqrtf(((((xi[0] * xi[0] + xi[1] * xi[1]) + xi[2] * xi[2]) +
                               xi[3] * xi[3]) + xi[4] * xi[4]) + xi[5] * xi[5]);
      const float n_src = clamp_min(tot_a[0], 1.f);
      const bool act = a.active[b] != 0;
      float dl = a.delta[b];
      if (act) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) Tb[4 * i + j] = T1[i][j];
        }
        dl = dn;
        a.delta[b] = dn;
        a.fit[b] = tot_a[1] / n_src;
        a.rmse[b] = sqrtf(tot_a[2] / clamp_min(tot_a[1], 1.f));
      }
      const int it = a.it[b] + (act ? 1 : 0);
      a.it[b] = it;
      a.active[b] = (it < a.max_iters && dl > a.tol) ? 1 : 0;
      for (int c = 0; c < static_cast<int>(cluster.num_blocks()); ++c) {
        float* dst = cluster.map_shared_rank(pose, c);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) dst[4 * i + j] = act ? T1[i][j] : T0[i][j];
        }
      }
    }
  }
  cluster.sync();

  // the next sources: ((R0 x + R1 y) + R2 z) + t, each operation rounded
  // on its own (geom/se3.py::transform_points)
  const float* src = a.src + 3 * row;
  float* out = a.p_next + 3 * row;
  for (int s = begin + tid; s < end; s += kThreads) {
    const float x = src[3 * s], y = src[3 * s + 1], z = src[3 * s + 2];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      out[3 * s + i] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(pose[4 * i], x), __fmul_rn(pose[4 * i + 1], y)),
                    __fmul_rn(pose[4 * i + 2], z)),
          pose[4 * i + 3]);
    }
  }
}

}  // namespace

// The launch icp_step_launch makes for S sources a pair: out[0..3] = CTAs
// per pair (the cluster), sources per CTA, register rounds per pass,
// threads per CTA.
extern "C" void icp_step_geometry(int S, int* out) {
  const Geometry g = geometry(S);
  out[0] = g.cluster;
  out[1] = g.slice;
  out[2] = g.rounds;
  out[3] = kThreads;
}

// One ICP step's update for B pairs of S sources (see the top of this
// file).  All arrays contiguous f32 on one device unless stated: src, p,
// p_next (B, S, 3); mask, d2 (B, S); the index form gives idx (B, S) int32,
// tgt and nrm (B, T, 3), q = n = null; the values form q and n (B, S, 3),
// idx = tgt = nrm = null.  State, in place: Tm (B, 4, 4), delta, fit, rmse
// (B,), it (B,) int32, active (B,) bool.  Returns the launch's CUDA error.
extern "C" int icp_step_launch(int point_to_plane, int robust, const float* src,
                               const float* p, const float* mask, const float* d2,
                               const int32_t* idx, const float* tgt, const float* nrm,
                               const float* q, const float* n, int B, int S, int T,
                               float thr2, int max_iters, float tol, float* p_next, float* Tm,
                               float* delta, float* fit, float* rmse, int32_t* it,
                               uint8_t* active, cudaStream_t stream) {
  const bool by_index = idx != nullptr && tgt != nullptr && nrm != nullptr && T > 0 &&
                        q == nullptr && n == nullptr;
  const bool by_value = idx == nullptr && q != nullptr && n != nullptr;
  if (B <= 0 || B > 65535 || S <= 0 || !(by_index || by_value))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(S);
  const Args a{src, p, mask, d2, idx, tgt, nrm, q, n, p_next, Tm, delta, fit, rmse, it, active,
               S, T, g.slice, g.rounds, max_iters, robust, thr2, tol};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.cluster, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = point_to_plane ? cudaLaunchKernelEx(&cfg, icp_step_kernel<true>, a)
                                         : cudaLaunchKernelEx(&cfg, icp_step_kernel<false>, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
