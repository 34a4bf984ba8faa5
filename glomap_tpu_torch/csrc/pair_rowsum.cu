// B4: fused pair-product segment sums,
// out[s, r] = sum_{o in s} sum_{(a, b) in pairs[r]} U[a, o] * V[b, o].
//
// Replaces: glomap_tpu/ops/pallas_kernels.py sorted_segment_pair_rowsum
// (_pair_rowsum_kernel, and through _accum_call _pair_rowsum_vmem_kernel
// and _pair_rowsum_accum_kernel). It builds the BA gradients J^T r, the
// Gram blocks B_f, B_p, B_c and the Schur corrections without ever storing
// the (R, O) product rows. On the TPU `pairs` was a static argument baked
// into each compiled kernel, and ids had to sit in a bounded window; here
// `pairs` arrives as a small int32 term table and the id axis as a CSR, so
// one compiled kernel serves every pattern and every id order.
//
// Bound on an H100: memory at the bench sizes. It must read the ku + kv
// rows of U and V and O ids and write n_seg * R sums (for the 6x6 frame
// Gram, U = V with 12 rows: 5.2 MB with the ids, about 1.6 us at
// 3.35 TB/s); the products are 2 * terms * O flops, far below the f32
// rate. The camera axis is one segment of 100,100 observations with
// R = 256, where the work per block is long and the kernel is bound by
// its one-block-per-segment tiling.
//
// Design: deterministic, no atomics. Block (s, c) owns segment s and up to
// kMaxCols outputs from c * cols. Its threads stride over the segment's
// observations in CSR order, form each output's products in registers
// (terms are read from the table, the same address for every thread, so
// each read is a broadcast), and accumulate; then a fixed warp-shuffle
// tree and a shuffle over the warps' partials in shared memory reduce the
// block. Empty segments write zeros.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// terms: [R + 1 offsets | num_terms a-rows | num_terms b-rows]
__global__ void __launch_bounds__(kThreads)
pair_rowsum_kernel(const float* __restrict__ U, const float* __restrict__ V,
                   const int* __restrict__ terms, const int* __restrict__ perm,
                   const int* __restrict__ offsets, float* __restrict__ out,
                   int R, int num_terms, int num_obs, int cols) {
  const int s = blockIdx.x;
  const int c0 = blockIdx.y * cols;
  const int nc = min(cols, R - c0);
  const int beg = offsets[s];
  const int end = offsets[s + 1];
  const size_t n = static_cast<size_t>(num_obs);
  const int* t_off = terms;
  const int* t_a = terms + R + 1;
  const int* t_b = t_a + num_terms;

  float acc[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.0f;
  for (int i = beg + threadIdx.x; i < end; i += kThreads) {
    const size_t o = static_cast<size_t>(perm[i]);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < nc) {
        float p = 0.0f;
        for (int t = t_off[c0 + c]; t < t_off[c0 + c + 1]; ++t)
          p += U[t_a[t] * n + o] * V[t_b[t] * n + o];
        acc[c] += p;
      }
    }
  }

  __shared__ float part[kMaxCols][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const float w = warp_sum(acc[c]);
    if (lane == 0) part[c][warp] = w;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const float t = warp_sum(lane < kWarps ? part[c][lane] : 0.0f);
      if (lane == 0 && c < nc) out[static_cast<size_t>(s) * R + c0 + c] = t;
    }
  }
}

}  // namespace

// U (ku, O), V (kv, O) f32, O contiguous; terms as above, row indices
// checked by the caller; perm (O,), offsets (n_seg + 1,) int32, the CSR of
// the id axis; out (n_seg, R). cols in [1, 8] outputs per block. Returns
// cudaGetLastError() after the launch.
extern "C" int glomap_pair_rowsum(const float* U, const float* V,
                                  const int* terms, const int* perm,
                                  const int* offsets, float* out, int R,
                                  int num_terms, int num_obs, int n_seg,
                                  int cols, cudaStream_t stream) {
  if (cols < 1 || cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg > 0 && R > 0) {
    const dim3 grid(n_seg, (R + cols - 1) / cols);
    pair_rowsum_kernel<<<grid, kThreads, 0, stream>>>(
        U, V, terms, perm, offsets, out, R, num_terms, num_obs, cols);
  }
  return static_cast<int>(cudaGetLastError());
}
