// B2: row gather into the observation axis, out[j, o] = tab[ids[o], j].
//
// Replaces: glomap_tpu/ops/pallas_kernels.py sorted_segment_gather
// (_sorted_gather_kernel). On the TPU a lane-axis gather ran at a few GB/s,
// so the kernel DMA'd the table window a sorted block could touch and
// expanded it with a one-hot matmul, under a `width` contract and with
// precision flags to keep the f32 values exact. None of that is needed
// here: this is a plain indexed copy, exact by construction, for any ids.
//
// Bound on an H100: memory. It reads O ids and writes k * O floats; the
// tables on the BA path are at most 1001 x 24 floats and stay in L2, so
// the (k + 1) * 4 * O bytes are the floor (k = 24, O = 100,100: 10 MB,
// about 3 us at 3.35 TB/s).
//
// Design: one thread per observation reads its id once and walks the k
// columns of its table row; the writes of a warp to each output row are
// contiguous and coalesce. The table reads are scattered but hit L1/L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ tab, const int* __restrict__ ids,
              float* __restrict__ out, int k, int num_obs) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= num_obs) return;
  const float* src = tab + static_cast<size_t>(ids[o]) * k;
  const size_t n = static_cast<size_t>(num_obs);
  for (int j = 0; j < k; ++j) out[j * n + o] = src[j];
}

}  // namespace

// tab (num_rows, k) f32 row-major; ids (O,) int32 in [0, num_rows), checked
// by the caller; out (k, O). Returns cudaGetLastError() after the launch.
extern "C" int glomap_gather(const float* tab, const int* ids, float* out,
                             int num_rows, int k, int num_obs,
                             cudaStream_t stream) {
  (void)num_rows;
  if (num_obs > 0 && k > 0) {
    const int blocks = (num_obs + kThreads - 1) / kThreads;
    gather_kernel<<<blocks, kThreads, 0, stream>>>(tab, ids, out, k,
                                                   num_obs);
  }
  return static_cast<int>(cudaGetLastError());
}
