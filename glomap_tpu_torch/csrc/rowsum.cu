// B3: per-segment sums of a (k, O) row stack, out[s, j] = sum_{o in s}
// vals[j, o].
//
// Replaces: glomap_tpu/ops/pallas_kernels.py sorted_segment_rowsum
// (_sorted_seg_kernel, and through _accum_call the VMEM-resident
// _sorted_seg_vmem_kernel and the HBM read-modify-write
// _sorted_seg_accum_kernel). The TPU version needed ids sorted inside a
// bounded window and summed with one-hot matmuls. Here the id axis comes
// with a CSR built once per solve (perm = stable argsort of ids, offsets),
// so any ids work -- sorted, windowed, unsorted, one giant segment -- and
// no value can fall outside a window.
//
// Bound on an H100: memory. It must read k * O values and O ids and write
// n_seg * k sums (k = 22, O = 100,100: 9.2 MB, under 3 us at 3.35 TB/s).
// Two things stand between the kernel and that bound. Segments range from
// a few to 10^5 observations, so a grid of one block per segment leaves
// SMs idle and runs long serial chains; and on BA's frame axes the data is
// point-major, so every load through perm touches its own 32-byte sector.
//
// Design: split-segment, one launch, deterministic, no atomics on values.
// The axis carries a chunk plan (ops/kernels.py SegmentAxis): segment s of
// length len_s is cut into nc_s = max(1, ceil(len_s / L)) chunks of L CSR
// entries, and each chunk is one warp's work item. Items are numbered
// chunk-major (every segment's chunk 0, then every chunk 1, ...), so the
// eight warps of a block read chunk c of eight neighbouring segments: on
// a point-major axis those are neighbouring observations, and the block's
// strided loads share their lines in L1 instead of each fetching its own
// from L2. A warp reads all k columns of its chunk once (column groups of
// up to 32 reuse perm), each lane keeping the loads of two to eight
// observations in flight (more for the wider column groups).
// The loads through perm stay strided there all the same: each warp load
// touches 32 lines, and L1's line rate, not the bytes, sets the pace
// (PERF.md). A segment of one chunk is written directly; otherwise each
// chunk's partial goes to the axis's scratch, and the warp that arrives
// last on the segment's counter (__threadfence, then atomicAdd on an int)
// adds the partials in chunk order and resets the counter to 0.
//
// Summation order, a function of the segment's length and its members'
// CSR order only (never of where the segment sits in the axis):
//   lane l of chunk c:  P[c, l] = (...((0 + v[c L + l]) + v[c L + l + 32])
//                                  + ...)  over the chunk, in order;
//   chunk partial:      Q[c] = B32(P[c, 0..31]), a balanced butterfly that
//                       adds lanes l and l ^ w for w = 16, 8, 4, 2, 1;
//   output:             out = (...((Q[0] + Q[1]) + Q[2]) + ...) + Q[nc-1],
// with v[i] = vals[j, perm[offsets[s] + i]]. Every value passes at most
// ceil(min(len, L) / 32) + 5 + (nc - 1) roundings.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// One halving step of transpose_sum at lane bit W, then the next: lanes
// with the bit set keep the upper W values, the others the lower, each
// adding its partner's copy. W is a template argument so that every index
// is a constant and v stays in registers.
template <int W, int NV>
__device__ __forceinline__ void halve(float (&v)[NV], int lane) {
  if constexpr (W >= 1) {
    const bool up = (lane & W) != 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float send = up ? v[i] : v[i + W];
      const float keep = up ? v[i + W] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, W);
    }
    halve<W / 2>(v, lane);
  }
}

// v[0..NV) on each lane -> on lane l, the sum over the 32 lanes of
// v[l % NV]: a butterfly over lane bits 16..1 that halves the values a
// lane carries once they fit (NV a power of two, at most 32).
template <int NV>
__device__ __forceinline__ float transpose_sum(float (&v)[NV], int lane) {
#pragma unroll
  for (int w = 16; w >= NV; w >>= 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __shfl_xor_sync(kFull, v[i], w);
  }
  halve<NV / 2>(v, lane);
  return v[0];
}

// items: [n_items segment ids | n_items chunk indices], chunk-major;
// chunk_base (n_seg + 1,): each segment's first scratch slot.
template <int NV>
__global__ void __launch_bounds__(kThreads)
rowsum_kernel(const float* __restrict__ vals, const int* __restrict__ perm,
              const int* __restrict__ offsets, const int* __restrict__ items,
              const int* __restrict__ chunk_base, int* __restrict__ counters,
              float* __restrict__ scratch, float* __restrict__ out, int k,
              int num_obs, int n_items, int L) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;  // the whole warp
  const int s = items[item];
  const int c = items[n_items + item];
  const int beg = offsets[s];
  const int len = offsets[s + 1] - beg;
  const int nc = max(1, (len + L - 1) / L);
  const int cnt = max(0, min(L, len - c * L));
  const int* pp = perm + beg + c * L;
  const size_t n = static_cast<size_t>(num_obs);
  float* slot = nc > 1 ? scratch + static_cast<size_t>(chunk_base[s] + c) * k
                       : out + static_cast<size_t>(s) * k;

  // observations a lane has in flight: more for narrow column groups
  constexpr int kUnroll = NV <= 4 ? 2 : (NV <= 8 ? 4 : 8);
  for (int j0 = 0; j0 < k; j0 += NV) {
    const int kc = min(NV, k - j0);
    const float* col = vals + j0 * n;
    float acc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = 0.0f;
#pragma unroll kUnroll
    for (int p = lane; p < cnt; p += 32) {
      const size_t o = static_cast<size_t>(pp[p]);
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (j < kc) acc[j] += col[j * n + o];
    }
    const float v = transpose_sum<NV>(acc, lane);
    if (lane < kc) slot[j0 + lane] = v;
  }
  if (nc == 1) return;

  // the segment's last warp adds the chunk partials in chunk order
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(counters + s, 1) == nc - 1;
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();
  const float* base = scratch + static_cast<size_t>(chunk_base[s]) * k;
  for (int j = lane; j < k; j += 32) {
    float sum = __ldcg(base + j);
#pragma unroll 16
    for (int cc = 1; cc < nc; ++cc)
      sum += __ldcg(base + static_cast<size_t>(cc) * k + j);
    out[static_cast<size_t>(s) * k + j] = sum;
  }
  if (lane == 0) counters[s] = 0;
}

template <int NV>
void launch(const float* vals, const int* perm, const int* offsets,
            const int* items, const int* chunk_base, int* counters,
            float* scratch, float* out, int k, int num_obs, int n_items,
            int L, cudaStream_t stream) {
  const int blocks = (n_items + kWarps - 1) / kWarps;
  rowsum_kernel<NV><<<blocks, kThreads, 0, stream>>>(
      vals, perm, offsets, items, chunk_base, counters, scratch, out, k,
      num_obs, n_items, L);
}

}  // namespace

// vals (k, O) f32, O contiguous; perm (O,) and offsets (n_seg + 1,) int32,
// the CSR of the id axis; items (2, n_items), chunk_base (n_seg + 1,) and
// counters (n_seg,) int32 from the axis's chunk plan for chunk length L
// (counters all 0 between calls); scratch at least chunk_base[n_seg] * k
// f32; out (n_seg, k). Returns cudaGetLastError() after the launch.
extern "C" int glomap_rowsum(const float* vals, const int* perm,
                             const int* offsets, const int* items,
                             const int* chunk_base, int* counters,
                             float* scratch, float* out, int k, int num_obs,
                             int n_items, int L, cudaStream_t stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_items > 0 && k > 0) {
    if (k <= 4)
      launch<4>(vals, perm, offsets, items, chunk_base, counters, scratch,
                out, k, num_obs, n_items, L, stream);
    else if (k <= 8)
      launch<8>(vals, perm, offsets, items, chunk_base, counters, scratch,
                out, k, num_obs, n_items, L, stream);
    else
      launch<32>(vals, perm, offsets, items, chunk_base, counters, scratch,
                 out, k, num_obs, n_items, L, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
