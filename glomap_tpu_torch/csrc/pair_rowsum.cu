// B4: fused pair-product segment sums,
// out[s, r] = sum_{o in s} sum_{(a, b) in pairs[r]} U[a, o] * V[b, o].
//
// Replaces: glomap_tpu/ops/pallas_kernels.py sorted_segment_pair_rowsum
// (_pair_rowsum_kernel, and through _accum_call _pair_rowsum_vmem_kernel
// and _pair_rowsum_accum_kernel). It builds the BA gradients J^T r, the
// Gram blocks B_f, B_p, B_c and the Schur corrections without ever storing
// the (R, O) product rows. On the TPU `pairs` was a static argument baked
// into each compiled kernel, and ids had to sit in a bounded window; here
// the id axis is a CSR with a chunk plan, and `pairs` arrives as the
// product form every BA table has (ops/kernels.py product_form):
//   out[s, i m + j] = sum_o sum_{t < T} A_t[i] B_t[j],
//   A_t[i] = staged row a0 + i sa_i + t sa_t,  B_t[j] = row b0 + j sb_j + t sb_t,
// an (n x m) block of T rank-1 terms per observation: J^T r (m = 1, T = 2),
// the Grams (T = 2) and the Schur corrections (T = 3).
//
// Bound on an H100: memory. It must read the ku + kv rows of U and V (ku
// when U is V) and O ids and write n_seg * R sums; the products are
// 2 T n m O flops, under the f32 rate. The camera axis of the bench is one
// segment of 100,100 observations with R = 256 (12.8 MB for the 16x16
// Gram, 3.8 us; 38 MB for the correction, 11.5 us).
//
// Design: split-segment, one launch, deterministic, no atomics on values.
// The axis's chunk plan cuts segment s into nc_s = max(1, ceil(len_s / L))
// chunks of L CSR entries; each chunk is one block's work item, so a
// single segment spreads over the card. The block gathers its chunk's U
// and V rows through perm into shared memory once (4-byte cp.async, so a
// strided gather keeps thousands of loads in flight without registers),
// in a ring of kStages sub-tiles of S observations (two gathers run
// ahead of the sub-tile being summed), and forms all R outputs
// from there: each warp owns a TI x TJ tile of the n x m block (4 x 8, or
// 16 x 1 for J^T r) and its lanes take the chunk's observations modulo 32,
// loading TI + TJ values per term for TI TJ FMAs. Lane l reads column l of
// a staged row, so a warp's loads are 32 consecutive words: no bank
// conflicts, no padding. When the block has fewer tiles than warps, the
// WG = 8 / tiles warps of a tile split the chunk by rows of 32
// observations. A segment of one chunk is written directly; otherwise the
// chunk's partial goes to scratch and the block that arrives last on the
// segment's counter (__threadfence, then atomicAdd on an int) adds the
// partials in chunk order and resets the counter to 0.
//
// Summation order, a function of the segment's length, its members' CSR
// order and the form only (never of where the segment sits in the axis):
//   lane l, group g:  P = fma chain over the chunk's observations p with
//                     p % 32 == l and (p / 32) % WG == g, ascending, and
//                     over t = 0..T-1 within each observation;
//   warp:             B32(P over the 32 lanes), a balanced butterfly that
//                     adds lanes l and l ^ w for w = 16, 8, 4, 2, 1;
//   chunk partial:    Q[c] = (...(W[0] + W[1]) + ...) + W[WG-1] over groups;
//   output:           out = (...((Q[0] + Q[1]) + Q[2]) + ...) + Q[nc-1].
// Every product passes at most T ceil(min(len, L) / 32) + 5 + (WG - 1)
// + (nc - 1) roundings.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxShared = 232448;  // 227 KB, the most a block may take
constexpr int kTermUnroll = 3;
// sub-tile buffers in flight: up to kStages - 1 gathers run ahead of
// the sub-tile being summed (ops/kernels.py PAIR_STAGES)
constexpr int kStages = 3;

struct Form {
  int n, m, T;
  int a0, sa_i, sa_t;
  int b0, sb_j, sb_t;
};

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
// v[l % NV] (see rowsum.cu).
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

// Shared memory, all dynamic: buf [kStages][rows][S] f32 | sperm [L] int |
// red [WG * R] f32 | the last-block flag, one int.
// rows = ku staged U rows, then kv V rows unless U is V (b0 says where
// B's rows start). S is a power of two, 1 << lg_s.
template <int TI, int TJ>
__global__ void __launch_bounds__(kThreads)
pair_rowsum_kernel(const float* __restrict__ U, const float* __restrict__ V,
                   const int* __restrict__ perm,
                   const int* __restrict__ offsets,
                   const int* __restrict__ items,
                   const int* __restrict__ chunk_base,
                   int* __restrict__ counters, float* __restrict__ scratch,
                   float* __restrict__ out, Form f, int ku, int rows,
                   int num_obs, int n_items, int L, int lg_s) {
  extern __shared__ float smem[];
  const int S = 1 << lg_s;
  float* buf = smem;
  int* sperm = reinterpret_cast<int*>(smem + kStages * rows * S);
  float* red = reinterpret_cast<float*>(sperm + L);
  const int R = f.n * f.m;
  const int ntj = (f.m + TJ - 1) / TJ;
  const int nt = ((f.n + TI - 1) / TI) * ntj;  // at most kWarps (launcher)
  const int wg = kWarps / nt;
  int* s_last = reinterpret_cast<int*>(red + wg * R);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = items[blockIdx.x];
  const int c = items[n_items + blockIdx.x];
  const int beg = offsets[s];
  const int len = offsets[s + 1] - beg;
  const int nc = max(1, (len + L - 1) / L);
  const int cnt = max(0, min(L, len - c * L));
  const int tile = warp % nt;
  const int g = warp / nt;  // warps with g >= wg only join the shuffles
  const int i0 = (tile / ntj) * TI;
  const int j0 = (tile % ntj) * TJ;
  const size_t n = static_cast<size_t>(num_obs);

  for (int p = tid; p < cnt; p += kThreads) sperm[p] = perm[beg + c * L + p];
  __syncthreads();

  // a thread stages fixed columns q of the sub-tile: one perm read each,
  // then its rows r_first, r_first + r_step, ... of [U; V]
  const bool wide = S >= kThreads;
  const int q_first = wide ? tid : (tid & (S - 1));
  const int q_step = wide ? kThreads : S;
  const int r_first = wide ? 0 : (tid >> lg_s);
  const int r_step = wide ? 1 : (kThreads >> lg_s);
  auto issue = [&](int sub) {
    float* dst = buf + (sub % kStages) * rows * S;
    const int first = sub * S;
    const int w = min(S, cnt - first);
    for (int q = q_first; q < w; q += q_step) {
      const int o = sperm[first + q];
      for (int r = r_first; r < rows; r += r_step) {
        const float* src = (r < ku ? U + r * n : V + (r - ku) * n) + o;
        __pipeline_memcpy_async(dst + r * S + q, src, sizeof(float));
      }
    }
    __pipeline_commit();
  };

  float acc[TI * TJ];
#pragma unroll
  for (int i = 0; i < TI * TJ; ++i) acc[i] = 0.0f;
  const int nsub = (cnt + S - 1) >> lg_s;
  for (int sub = 0; sub < kStages - 1; ++sub) {
    if (sub < nsub) issue(sub); else __pipeline_commit();
  }
  for (int sub = 0; sub < nsub; ++sub) {
    // one group committed per sub-tile (empty past the end), so sub's
    // gather is done once at most kStages - 1 later groups are pending
    if (sub + kStages - 1 < nsub) issue(sub + kStages - 1);
    else __pipeline_commit();
    __pipeline_wait_prior(kStages - 1);
    __syncthreads();
    if (g < wg) {
      const float* b = buf + (sub % kStages) * rows * S;
      const int w = min(S, cnt - sub * S);
      for (int q = 0; q * 32 < w; ++q) {
        const int p = q * 32 + lane;
        if ((((sub * S) >> 5) + q) % wg != g || p >= w) continue;
        const float* bp = b + p;
        // terms in groups of kTermUnroll, so the loads of the next term
        // issue while this one's products run
        for (int t0 = 0; t0 < f.T; t0 += kTermUnroll) {
#pragma unroll
          for (int tt = 0; tt < kTermUnroll; ++tt) {
            const int t = t0 + tt;
            if (t < f.T) {
              float a[TI], v[TJ];
#pragma unroll
              for (int ii = 0; ii < TI; ++ii)
                a[ii] = i0 + ii < f.n
                            ? bp[(f.a0 + (i0 + ii) * f.sa_i + t * f.sa_t) * S]
                            : 0.0f;
#pragma unroll
              for (int jj = 0; jj < TJ; ++jj)
                v[jj] = j0 + jj < f.m
                            ? bp[(f.b0 + (j0 + jj) * f.sb_j + t * f.sb_t) * S]
                            : 0.0f;
#pragma unroll
              for (int ii = 0; ii < TI; ++ii)
#pragma unroll
                for (int jj = 0; jj < TJ; ++jj)
                  acc[ii * TJ + jj] = fmaf(a[ii], v[jj], acc[ii * TJ + jj]);
            }
          }
        }
      }
    }
    __syncthreads();  // this buffer is refilled by the next issue
  }

  // warp partials -> red[g][r], then the groups in order
  const float v = transpose_sum<TI * TJ>(acc, lane);
  const int idx = lane % (TI * TJ);
  const int i = i0 + idx / TJ;
  const int j = j0 + idx % TJ;
  if (g < wg && lane < TI * TJ && i < f.n && j < f.m) red[g * R + i * f.m + j] = v;
  __syncthreads();
  float part = 0.0f;
  if (tid < R) {
    part = red[tid];
    for (int gg = 1; gg < wg; ++gg) part += red[gg * R + tid];
  }
  if (nc == 1) {
    if (tid < R) out[static_cast<size_t>(s) * R + tid] = part;
    return;
  }

  // the segment's last block adds the chunk partials in chunk order
  if (tid < R)
    scratch[static_cast<size_t>(chunk_base[s] + c) * R + tid] = part;
  __threadfence();
  __syncthreads();
  if (tid == 0) *s_last = atomicAdd(counters + s, 1) == nc - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  if (tid < R) {
    const float* base = scratch + static_cast<size_t>(chunk_base[s]) * R + tid;
    float sum = __ldcg(base);
#pragma unroll 16
    for (int cc = 1; cc < nc; ++cc)
      sum += __ldcg(base + static_cast<size_t>(cc) * R);
    out[static_cast<size_t>(s) * R + tid] = sum;
  }
  if (tid == 0) counters[s] = 0;
}

template <int TI, int TJ>
int launch(const float* U, const float* V, const int* perm,
           const int* offsets, const int* items, const int* chunk_base,
           int* counters, float* scratch, float* out, const Form& f, int ku,
           int rows, int num_obs, int n_items, int L, int lg_s,
           cudaStream_t stream) {
  const int nt = ((f.n + TI - 1) / TI) * ((f.m + TJ - 1) / TJ);
  if (nt > kWarps) return static_cast<int>(cudaErrorInvalidValue);
  const int R = f.n * f.m;
  const size_t shared = sizeof(float) * (kStages * static_cast<size_t>(rows) << lg_s)
                        + sizeof(int) * L
                        + sizeof(float) * (kWarps / nt) * R + sizeof(int);
  if (shared > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB only once raised, per process and instantiation
  static size_t allowed = 48 << 10;
  if (shared > allowed) {
    const cudaError_t rc = cudaFuncSetAttribute(
        pair_rowsum_kernel<TI, TJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    allowed = shared;
  }
  pair_rowsum_kernel<TI, TJ><<<n_items, kThreads, shared, stream>>>(
      U, V, perm, offsets, items, chunk_base, counters, scratch, out, f, ku,
      rows, num_obs, n_items, L, lg_s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// U (ku, O), V (kv, O) f32, O contiguous (V may be U: rows = ku, and b0
// indexes U's rows; otherwise rows = ku + kv and b0 counts from ku); the
// form (n, m, T, a0, sa_i, sa_t, b0, sb_j, sb_t) as above, every row index
// checked by the caller; perm (O,), offsets (n_seg + 1,) int32, the CSR of
// the id axis; items (2, n_items), chunk_base (n_seg + 1,), counters
// (n_seg,) int32 from the axis's chunk plan for chunk length L (counters
// all 0 between calls); scratch at least chunk_base[n_seg] * n * m f32;
// out (n_seg, n * m); sub-tiles of 1 << lg_s observations. Returns a CUDA
// error code: invalid value for a form of more than 8 tiles or a shared
// memory footprint above 227 KB, else cudaGetLastError() after the launch.
extern "C" int glomap_pair_rowsum(const float* U, const float* V,
                                  const int* perm, const int* offsets,
                                  const int* items, const int* chunk_base,
                                  int* counters, float* scratch, float* out,
                                  int n, int m, int T, int a0, int sa_i,
                                  int sa_t, int b0, int sb_j, int sb_t,
                                  int ku, int rows, int num_obs, int n_items,
                                  int L, int lg_s, cudaStream_t stream) {
  if (n < 1 || m < 1 || T < 1 || L < 1 || lg_s < 5)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items == 0) return static_cast<int>(cudaGetLastError());
  const Form f{n, m, T, a0, sa_i, sa_t, b0, sb_j, sb_t};
  if (m == 1)
    return launch<16, 1>(U, V, perm, offsets, items, chunk_base, counters,
                         scratch, out, f, ku, rows, num_obs, n_items, L,
                         lg_s, stream);
  return launch<4, 8>(U, V, perm, offsets, items, chunk_base, counters,
                      scratch, out, f, ku, rows, num_obs, n_items, L, lg_s,
                      stream);
}
