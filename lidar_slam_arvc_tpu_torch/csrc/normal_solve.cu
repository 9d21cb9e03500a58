// K7: the normal of each ball's covariance, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel.  The normal of a point is the eigenvector of the
// smallest eigenvalue of its ball's covariance, from Smith's trigonometric
// closed form (ops/eigh3.py).  In f32 that form cannot resolve two small
// eigenvalues that meet: a ball of 3-4 nearly coplanar points, which a
// full-resolution scan has far out, comes back up to ~90 degrees off.  For
// each of n rows this kernel reads the f32 covariance and
//
//   1. solves it in f32 as ops/eigh3.py::smallest_eigenvector_sym3 does,
//      operation for operation, each rounded alone (no FMA contraction);
//   2. solves it again in float64 by the same closed form (the eigenvalue
//      from det(B)/2 of B = (A - qI)/p, then the largest of the cross
//      products of rows (0, 1), (0, 2), (1, 2) of A - lambda_min I, the
//      first on a tie; +z where that product vanishes);
//   3. writes the f32 normal where |n32 . n64| >= 1 - off, and the float64
//      normal, rounded to f32, elsewhere.
//
// Its plain version is ops/eigh3.py::resolved_normals_plain (the same
// operations; the float64 sums may associate differently, at float64
// rounding, and the card's acosf and cosf are not the host's).  One thread
// a row: 36 bytes read, 12 written, ~110 f32 and ~150 float64 operations.
// Bound by bytes: 262,144 rows (4 x 65536) move 12.6 MB, ~3.8 us at
// 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr double kPi = 3.141592653589793;  // Python's math.pi

// f32 arithmetic rounded per operation, as PyTorch's elementwise ops are
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ void cross32(const float* a, const float* b, float* c) {
  c[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  c[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  c[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

__device__ __forceinline__ float sq32(const float* v) {
  return add(add(mul(v[0], v[0]), mul(v[1], v[1])), mul(v[2], v[2]));
}

// smallest_eigenvector_sym3 (eigvals_sym3's e_min, then the cross products)
__device__ void solve_f32(const float (&a)[3][3], float* out) {
  const float a00 = a[0][0], a11 = a[1][1], a22 = a[2][2];
  const float a01 = a[0][1], a02 = a[0][2], a12 = a[1][2];
  const float p1 = add(add(mul(a01, a01), mul(a02, a02)), mul(a12, a12));
  const float q = div(add(add(a00, a11), a22), 3.0f);
  const float b00 = sub(a00, q), b11 = sub(a11, q), b22 = sub(a22, q);
  const float p2 = add(add(add(mul(b00, b00), mul(b11, b11)), mul(b22, b22)), mul(2.0f, p1));
  const float p6 = div(p2, 6.0f);
  const float p = __fsqrt_rn(p6 != p6 ? p6 : fmaxf(p6, 1e-30f));
  const float num = add(sub(mul(b00, sub(mul(b11, b22), mul(a12, a12))),
                            mul(a01, sub(mul(a01, b22), mul(a12, a02)))),
                        mul(a02, sub(mul(a01, a12), mul(b11, a02))));
  const float detB = div(num, mul(mul(p, p), p));
  const float r = clamp(div(detB, 2.0f), -1.0f, 1.0f);
  const float phi = div(acosf(r), 3.0f);
  const float e_min = add(q, mul(mul(2.0f, p), cosf(add(phi, static_cast<float>(2.0 * kPi / 3.0)))));
  const float lam = p2 < 1e-24f ? q : e_min;  // isotropic: every eigenvalue is q

  float m[3][3];
#pragma unroll
  for (int r_ = 0; r_ < 3; ++r_)
#pragma unroll
    for (int k = 0; k < 3; ++k) m[r_][k] = r_ == k ? sub(a[r_][k], lam) : a[r_][k];
  float c01[3], c02[3], c12[3];
  cross32(m[0], m[1], c01);
  cross32(m[0], m[2], c02);
  cross32(m[1], m[2], c12);
  const float n01 = sq32(c01), n02 = sq32(c02), n12 = sq32(c12);
  const bool best01 = (n01 >= n02) && (n01 >= n12);
  const bool best02 = (n02 > n01) && (n02 >= n12);
  const float* v = best01 ? c01 : (best02 ? c02 : c12);
  const float nv = __fsqrt_rn(sq32(v));
  if (nv > 1e-18f) {
    const float s = fmaxf(nv, 1e-30f);
    out[0] = div(v[0], s);
    out[1] = div(v[1], s);
    out[2] = div(v[2], s);
  } else {
    out[0] = 0.0f;
    out[1] = 0.0f;
    out[2] = 1.0f;
  }
}

__device__ __forceinline__ void cross64(const double* a, const double* b, double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// smallest_eigenvector_sym3_f64
__device__ void solve_f64(const float (&a32)[3][3], double* u) {
  double a[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) a[r][k] = static_cast<double>(a32[r][k]);
  const double q = (a[0][0] + a[1][1] + a[2][2]) / 3.0;
  double b[3][3];
  double p2 = 0.0;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      b[r][k] = a[r][k] - (r == k ? q : 0.0);
      p2 += b[r][k] * b[r][k];
    }
  const double p = sqrt(fmax(p2 / 6.0, 1e-30));
  double x[3];
  cross64(b[1], b[2], x);
  const double det = b[0][0] * x[0] + b[0][1] * x[1] + b[0][2] * x[2];
  const double rr = fmin(fmax(det / (2.0 * p * p * p), -1.0), 1.0);
  const double lam = q + 2.0 * p * cos(acos(rr) / 3.0 + 2.0 * kPi / 3.0);

  double m[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) m[r][k] = a[r][k] - (r == k ? lam : 0.0);
  double c01[3], c02[3], c12[3];
  cross64(m[0], m[1], c01);
  cross64(m[0], m[2], c02);
  cross64(m[1], m[2], c12);
  const double n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2];
  const double n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2];
  const double n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2];
  const double* v = c01;
  double best = n01;
  if (n02 > best) { v = c02; best = n02; }
  if (n12 > best) { v = c12; best = n12; }
  const double nv = sqrt(best);
  u[0] = 0.0;
  u[1] = 0.0;
  u[2] = 1.0;
  if (nv > 1e-18) {
    const double s = fmax(nv, 1e-30);
    u[0] = v[0] / s;
    u[1] = v[1] / s;
    u[2] = v[2] / s;
  }
}

__global__ void __launch_bounds__(kThreads)
    normal_solve_kernel(const float* __restrict__ cov, float* __restrict__ nrm, int64_t n,
                        double off) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* c = cov + 9 * i;
  float a[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) a[r][k] = c[3 * r + k];

  float n32[3];
  double u[3];
  solve_f32(a, n32);
  solve_f64(a, u);
  // |n32 . n64| summed left to right, as the plain version's torch.sum
  const double dot = fabs(__dadd_rn(__dadd_rn(__dmul_rn(static_cast<double>(n32[0]), u[0]),
                                              __dmul_rn(static_cast<double>(n32[1]), u[1])),
                                    __dmul_rn(static_cast<double>(n32[2]), u[2])));
  float* o = nrm + 3 * i;
  if (dot < 1.0 - off) {
    o[0] = static_cast<float>(u[0]);
    o[1] = static_cast<float>(u[1]);
    o[2] = static_cast<float>(u[2]);
  } else {
    o[0] = n32[0];
    o[1] = n32[1];
    o[2] = n32[2];
  }
}

}  // namespace

// n rows: cov (n, 3, 3) f32 in, nrm (n, 3) f32 out, contiguous on one
// device.  Returns the launch's CUDA error.
extern "C" int normal_solve_launch(const float* cov, float* nrm, int64_t n, double off,
                                   cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  normal_solve_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(cov, nrm, n, off);
  return static_cast<int>(cudaGetLastError());
}
