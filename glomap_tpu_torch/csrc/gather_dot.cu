// B5: fused J * gather(v), out[r, o] = sum_j U[r * k + j, o] *
// tab[ids[o], j] for r < nr.
//
// Replaces: glomap_tpu/ops/pallas_kernels.py sorted_segment_gather_dot
// (_gather_dot_kernel). On the TPU it DMA'd the 128-aligned table window a
// sorted block could touch and expanded it with a one-hot matmul, under a
// `width` contract that could drop values when ids strayed outside it.
// Here each thread reads its table row by exact index: any ids work,
// sorted or not, and nothing is windowed.
//
// Bound on an H100: memory. It reads nr * k rows of U and the ids and
// writes nr rows (BA's frame-sensor axis, k = 22, nr = 2, O = 100,100:
// 188 B per observation, 18.8 MB, about 5.6 us at 3.35 TB/s). The
// tables on the solvers' paths (at most a few thousand rows of <= 28
// floats) stay in L1/L2; the (k, O) gathered row stack of the unfused
// composition never passes through device memory.
//
// Design: one thread per observation (grid-stride), reading its id once;
// each U row of a warp is one contiguous line. Each output sums its k
// products left to right from 0, every product and add rounded once
// (_rn intrinsics, no FMA contraction), so its first-order error is at
// most k * 2^-24 * sum_j |U tab|.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_dot_kernel(const float* __restrict__ tab, const int* __restrict__ ids,
                  const float* __restrict__ U, float* __restrict__ out,
                  int k, int nr, int num_obs) {
  const size_t n = static_cast<size_t>(num_obs);
  for (int o = blockIdx.x * blockDim.x + threadIdx.x; o < num_obs;
       o += gridDim.x * blockDim.x) {
    const float* row = tab + static_cast<size_t>(ids[o]) * k;
    for (int r = 0; r < nr; ++r) {
      const float* u = U + static_cast<size_t>(r) * k * n + o;
      float acc = 0.0f;
      for (int j = 0; j < k; ++j)
        acc = __fadd_rn(acc, __fmul_rn(u[j * n], row[j]));
      out[r * n + o] = acc;
    }
  }
}

}  // namespace

// tab (num_rows, k) f32 row-major; ids (O,) int32 in [0, num_rows),
// checked by the caller; U (nr * k, O); out (nr, O). Returns
// cudaGetLastError() after the launch.
extern "C" int glomap_gather_dot(const float* tab, const int* ids,
                                 const float* U, float* out, int num_rows,
                                 int k, int nr, int num_obs,
                                 cudaStream_t stream) {
  (void)num_rows;
  if (num_obs > 0 && nr > 0) {
    const int blocks = (num_obs + kThreads - 1) / kThreads;
    gather_dot_kernel<<<blocks, kThreads, 0, stream>>>(tab, ids, U, out, k,
                                                       nr, num_obs);
  }
  return static_cast<int>(cudaGetLastError());
}
