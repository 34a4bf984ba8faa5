// B2: row gather into the observation axis, out[j, o] = tab[ids[o], j].
//
// Replaces: glomap_tpu/ops/pallas_kernels.py sorted_segment_gather
// (_sorted_gather_kernel). On the TPU a lane-axis gather ran at a few GB/s,
// so the kernel DMA'd the table window a sorted block could touch and
// expanded it with a one-hot matmul, under a `width` contract and with
// precision flags to keep the f32 values exact. Here it is a plain indexed
// copy, exact by construction, for any ids.
//
// Bound on an H100: memory. It reads O ids and the table once and writes
// k * O floats (BA's frame-sensor axis, k = 24, O = 100,100: 10 MB, 3 us
// at 3.35 TB/s; the sweep's 53-row expand of 10.2M matches: 2.2 GB,
// 0.66 ms).
//
// What measurements on an H100 80GB HBM3 decided (PERF.md; the numbers
// below from utils/profile_gather.py):
//  * At the solvers' sizes (1e5-2e5 observations, 2-10 us) a launch is a
//    launch and one latency chain; a block per 256 observations, one wave,
//    beat tiles walked by a grid sized to the card.
//  * One observation a thread with 4-byte stores beat groups of four with
//    16-byte stores at every table width above 2 (the 53-row expand 1.01 ms
//    against 1.29); groups of four win only on two-column tables over long
//    axes (the sweep's tie rows, 0.044 ms against 0.056), where a thread
//    otherwise writes two floats.
//  * A table staged in shared memory pays only where a warp's loads of a
//    wide table fall on many rows at once: the frame-sensor table on a
//    point-major axis (24 columns, 4.9 us against 5.6 read in place).
//    Windows staged per tile on the sorted point and pair axes lost to
//    reading in place, where L1 broadcasts the one row a warp reads.
//
// Design (the host's plan, kernels.gather_plan, picks mode and width):
//  * kDirect: each thread reads its table row in place, 8 values at once
//    so that misses to L2 overlap, except in a warp whose lanes all read
//    one row (a sorted axis) in a launch of many waves (the sweep), which
//    streamed faster one value at a time in exploratory builds.
//  * kWhole: each block stages the table with 4-byte cp.async into shared
//    memory, rows at the odd pitch k | 1 so that lanes on neighbouring
//    rows fall on different banks, then reads it from there.
//  * width 4: thread t writes observations h + 4t .. h + 4t + 3 of its
//    tile with one 16-byte store a row, h (0-3) the floats before the
//    row's first 16-byte boundary (rows start at j * O, so h changes from
//    row to row unless O % 4 == 0); the head and tail floats go one a
//    thread.
// The values are copied, never computed: the output is bit for bit
// tab[ids].T in every mode.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// where a launch reads its table (kernels.gather_plan)
constexpr int kDirect = 0;  // in place, through L1
constexpr int kWhole = 1;   // staged whole in shared memory by each block

// Stage the table (rows x k floats) into tab_s at `pitch` with 4-byte
// cp.async, and wait for it.
__device__ __forceinline__ void stage_table(float* tab_s,
                                            const float* __restrict__ tab,
                                            int rows, int k, int pitch) {
  const int total = rows * k;
  const int step_r = kThreads / k, step_c = kThreads % k;
  int r = threadIdx.x / k, c = threadIdx.x % k;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    __pipeline_memcpy_async(tab_s + r * pitch + c, tab + e, 4);
    r += step_r;
    c += step_c;
    if (c >= k) {
      c -= k;
      ++r;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// A block writes a tile of V * kThreads observations, V (1 or 4) a thread
// with one V * 4-byte store a row; kMode: where the table is read.
template <int V, int kMode>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ tab, const int* __restrict__ ids,
              float* __restrict__ out, int num_rows, int k, int num_obs,
              int pitch, int one_wave) {
  constexpr int kIds = V == 1 ? 1 : 8;  // ids a thread holds
  extern __shared__ float tab_s[];
  const int t = threadIdx.x;
  const int o0 = blockIdx.x * V * kThreads;
  const int n = min(V * kThreads, num_obs - o0);
  // ids V t .. V t + kIds - 1 of the tile; past the end, a valid id whose
  // values are never stored
  int id[kIds];
#pragma unroll
  for (int e = 0; e < kIds; ++e)
    id[e] = __ldg(ids + min(o0 + V * t + e, num_obs - 1));
  if (kMode == kWhole) stage_table(tab_s, tab, num_rows, k, pitch);
  const float* src = kMode == kWhole ? tab_s : tab;
  const int stride = kMode == kWhole ? pitch : k;
  if constexpr (V == 1) {
    // one observation a thread: its table row, one 4-byte store a row.
    // Reading the table in place, a thread takes 8 values at once (misses
    // to L2 overlap; a launch of one wave is one latency chain a thread),
    // unless its warp's lanes all read one row (a sorted axis) in a launch
    // of many waves, where one value at a time streams best.
    const bool deep =
        kMode == kDirect &&
        (one_wave != 0 ||
         !__all_sync(0xffffffffu,
                     id[0] == __shfl_sync(0xffffffffu, id[0], 0)));
    if (t >= n) return;
    const float* row = src + id[0] * stride;
    float* dst = out + o0 + t;
    if (deep) {
#pragma unroll 8
      for (int j = 0; j < k; ++j)
        dst[static_cast<size_t>(j) * num_obs] = __ldg(row + j);
    } else {
#pragma unroll 1
      for (int j = 0; j < k; ++j)
        dst[static_cast<size_t>(j) * num_obs] =
            kMode == kWhole ? row[j] : __ldg(row + j);
    }
  } else {
    int off[kIds];
#pragma unroll
    for (int e = 0; e < kIds; ++e) off[e] = id[e] * stride;
    auto load = [=](int i) {
      return kMode == kWhole ? tab_s[i] : __ldg(tab + i);
    };
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
      float* row = out + static_cast<size_t>(j) * num_obs + o0;
      // floats before the row's first 16-byte boundary in the tile
      const int h = static_cast<int>(
          ((16u - (reinterpret_cast<uintptr_t>(row) & 15u)) & 15u) >> 2);
      const int head = min(h, n);
      const int groups = (n - head) / 4;
      const int tail = head + 4 * groups;
      if (t < groups) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // off[h + e] with h uniform: selects, not an indexed register
          int q = off[e];
#pragma unroll
          for (int s = 1; s < 4; ++s)
            if (h == s) q = off[s + e];
          v[e] = load(q + j);
        }
        *reinterpret_cast<float4*>(row + head + 4 * t) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      if (t < head + n - tail) {
        // the head and tail floats, one a thread (at most 6)
        const int e = t < head ? t : tail + t - head;
        row[e] = load(__ldg(ids + o0 + e) * stride + j);
      }
    }
  }
}

int g_sms = 0;

template <int V>
void launch(int mode, const float* tab, const int* ids, float* out,
            int num_rows, int k, int num_obs, int pitch, int smem_bytes,
            cudaStream_t stream) {
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int blocks = (num_obs + V * kThreads - 1) / (V * kThreads);
  // 8 blocks of 256 threads fill an SM
  const int one_wave = blocks <= 8 * g_sms;
  if (mode == kWhole)
    gather_kernel<V, kWhole><<<blocks, kThreads, smem_bytes, stream>>>(
        tab, ids, out, num_rows, k, num_obs, pitch, one_wave);
  else
    gather_kernel<V, kDirect><<<blocks, kThreads, 0, stream>>>(
        tab, ids, out, num_rows, k, num_obs, pitch, one_wave);
}

}  // namespace

// tab (num_rows, k) f32 row-major; ids (O,) int32 in [0, num_rows), checked
// by the caller; out (k, O), 4-byte aligned. The plan (kernels.gather_plan):
// mode 1 stages the whole table in each block's shared memory, rows
// `pitch` floats apart (smem_bytes), mode 0 reads it in place; a thread
// writes `width` (1 or 4) observations of each row with one store, a
// block 256 threads. Returns cudaGetLastError() after the launch.
extern "C" int glomap_gather(const float* tab, const int* ids, float* out,
                             int num_rows, int k, int num_obs, int mode,
                             int width, int pitch, int smem_bytes,
                             cudaStream_t stream) {
  if (num_obs > 0 && k > 0) {
    if (width == 4)
      launch<4>(mode, tab, ids, out, num_rows, k, num_obs, pitch, smem_bytes,
                stream);
    else
      launch<1>(mode, tab, ids, out, num_rows, k, num_obs, pitch, smem_bytes,
                stream);
  }
  return static_cast<int>(cudaGetLastError());
}
