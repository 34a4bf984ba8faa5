// B7: squared Sampson error of one E (or F) per match,
// out[m] = C^2 / max(|Ex|_12^2 + |E^T x2|_12^2, eps), C = x2^T E x1, with
// both points divided by their z + eps first.
//
// Replaces: glomap_tpu/ops/pallas_kernels.py sampson_score
// (_sampson_kernel), which computes glomap_tpu/math/two_view.py
// sampson_error_sq_rows line for line. On the TPU it tiled the (9, M) and
// (3, M) row stacks into VMEM blocks of 128-lane vectors; here a thread per
// match reads its 15 floats straight from the row stacks, each row read by
// a warp as one contiguous 128-byte line.
//
// Bound on an H100: memory. It reads 15 and writes 1 f32 per match, 64 B
// (M = 10,238,895 matches: 655 MB, about 0.196 ms at 3.35 TB/s); its ~40
// f32 operations per match are 0.4 GFLOP, about 6 us at 67 TFLOP/s.
//
// Numerics: inlier decisions compare this value with a threshold, so every
// operation rounds once, in the plain version's order: the adds, products
// and divisions are the _rn intrinsics (IEEE round to nearest, never
// contracted into an FMA, no fast reciprocal). Build without
// --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

__global__ void __launch_bounds__(kThreads)
sampson_kernel(const float* __restrict__ E, const float* __restrict__ x1,
               const float* __restrict__ x2, float* __restrict__ out,
               int num) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= num) return;
  const size_t n = static_cast<size_t>(num);
  float e[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) e[r] = E[r * n + m];
  const float z1 = add(x1[2 * n + m], kEps);
  const float z2 = add(x2[2 * n + m], kEps);
  const float a0 = __fdiv_rn(x1[m], z1), a1 = __fdiv_rn(x1[n + m], z1);
  const float b0 = __fdiv_rn(x2[m], z2), b1 = __fdiv_rn(x2[n + m], z2);
  // the plain version's "* one" terms are exact and left out
  const float Ex0 = add(add(mul(e[0], a0), mul(e[1], a1)), e[2]);
  const float Ex1 = add(add(mul(e[3], a0), mul(e[4], a1)), e[5]);
  const float Ex2 = add(add(mul(e[6], a0), mul(e[7], a1)), e[8]);
  const float Et0 = add(add(mul(e[0], b0), mul(e[3], b1)), e[6]);
  const float Et1 = add(add(mul(e[1], b0), mul(e[4], b1)), e[7]);
  const float C = add(add(mul(Ex0, b0), mul(Ex1, b1)), Ex2);
  const float denom = add(add(add(mul(Ex0, Ex0), mul(Ex1, Ex1)),
                              mul(Et0, Et0)), mul(Et1, Et1));
  out[m] = __fdiv_rn(mul(C, C), fmaxf(denom, kEps));
}

}  // namespace

// E (9, M), x1 (3, M), x2 (3, M) f32 row stacks, M contiguous; out (M,).
// Returns cudaGetLastError() after the launch.
extern "C" int glomap_sampson(const float* E, const float* x1, const float* x2,
                              float* out, int num, cudaStream_t stream) {
  if (num > 0) {
    const int blocks = (num + kThreads - 1) / kThreads;
    sampson_kernel<<<blocks, kThreads, 0, stream>>>(E, x1, x2, out, num);
  }
  return static_cast<int>(cudaGetLastError());
}
