// B6: the solvers' whole Huber IRLS weight step in one launch. From the
// residual rows r (k, O) and an optional per-observation weight o_w (O,):
//   x  = ((r0 r0 + r1 r1) + r2 r2) ...      (squares added in row order)
//   rn = sqrt(max(x, 1e-30))
//   w  = x <= delta^2 ? 1 : delta / rn      (Ceres' HuberLoss(delta))
//   c  = x <= delta^2 ? x : 2 delta rn - delta^2
//   out: (o_w w, o_w c), or (w, c) without o_w.
//
// Replaces: glomap_tpu/ops/pallas_kernels.py huber_weight_cost
// (_huber_kernel), the pair _huber_weight + _huber_cost that the JAX
// solvers inline (estimators/global_positioning.py:54-63,
// estimators/bundle_adjustment.py:109-117), together with the squares and
// the weight products around it at every call site. On the TPU XLA fused
// those elementwise neighbours into one pass; on the card each was a
// launch of its own, three or four around each 1.8 us Huber launch.
//
// Bound on an H100: memory. It reads (k + 1) * 4 B and writes 8 B per
// observation (BA, k = 2, O = 100,100: 1.6 MB, 0.5 us at 3.35 TB/s), so at
// the solvers' sizes the launch sets its time, and absorbing the launches
// around it is the gain.
//
// Design: a grid-stride loop of V observations a thread, V = 2 (8-byte
// loads and stores) where O and the pointers' alignment allow, else 1;
// k = 2 and 3 unrolled, so that all the loads of a thread are in flight
// together: a launch this short is its launch and one round trip to
// memory. In exploratory builds on an H100 80GB HBM3, 16-byte vectors,
// which halve the blocks (fewer than one a SM at BA's 100,100
// observations), and loads issued one row at a time were both slower.
//
// Numerics: the LM accept test compares costs, so every operation rounds
// once, in the order above, as the plain f32 version (huber_irls_plain)
// does: _rn intrinsics for the products, sums and difference (never
// contracted into an FMA), IEEE square root and division. The kernel is bit
// for bit that plain version. delta, delta^2 and 2 delta come in as the f32
// values PyTorch rounds the plain version's Python scalars to. Build without
// --use_fast_math.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int V>
struct Vec;
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<1> {
  using T = float;
};

template <int V>
__device__ __forceinline__ void load(const float* p, float (&x)[V]) {
  const typename Vec<V>::T v = *reinterpret_cast<const typename Vec<V>::T*>(p);
  static_assert(sizeof(v) == V * sizeof(float), "vector width");
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int e = 0; e < V; ++e) x[e] = f[e];
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  typename Vec<V>::T v;
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int e = 0; e < V; ++e) f[e] = x[e];
  *reinterpret_cast<typename Vec<V>::T*>(p) = v;
}

// kK rows (2 or 3): every row's and the weight's loads are issued before
// the first use, one round trip.
template <int V, int kK>
__global__ void __launch_bounds__(kThreads)
huber_kernel(const float* __restrict__ r, const float* __restrict__ o_w,
             float* __restrict__ w_out, float* __restrict__ c_out,
             float delta, float d2, float two_delta, int num) {
  const size_t n = static_cast<size_t>(num);
  const int groups = num / V;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += gridDim.x * blockDim.x) {
    const size_t o = static_cast<size_t>(g) * V;
    float y[kK][V], ow[V] = {};
#pragma unroll
    for (int j = 0; j < kK; ++j) load<V>(r + j * n + o, y[j]);
    if (o_w != nullptr) load<V>(o_w + o, ow);
    float x[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      x[e] = __fmul_rn(y[0][e], y[0][e]);
#pragma unroll
      for (int j = 1; j < kK; ++j)
        x[e] = __fadd_rn(x[e], __fmul_rn(y[j][e], y[j][e]));
    }
    float w[V], c[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      // clamp as torch.clamp does: a NaN stays NaN
      const float rn = __fsqrt_rn(x[e] < 1e-30f ? 1e-30f : x[e]);
      const bool inside = x[e] <= d2;
      w[e] = inside ? 1.0f : __fdiv_rn(delta, rn);
      c[e] = inside ? x[e] : __fsub_rn(__fmul_rn(two_delta, rn), d2);
      if (o_w != nullptr) {
        w[e] = __fmul_rn(ow[e], w[e]);
        c[e] = __fmul_rn(ow[e], c[e]);
      }
    }
    store<V>(w_out + o, w);
    store<V>(c_out + o, c);
  }
}

int g_sms = 0;

template <int V, int kK>
void launch_k(const float* r, const float* o_w, float* w, float* c,
              float delta, float d2, float two_delta, int num,
              cudaStream_t stream) {
  const int groups = num / V;
  // a few blocks per SM, at most one group a thread
  const int blocks = std::min((groups + kThreads - 1) / kThreads, 8 * g_sms);
  huber_kernel<V, kK><<<blocks, kThreads, 0, stream>>>(
      r, o_w, w, c, delta, d2, two_delta, num);
}

template <int V>
void launch(const float* r, const float* o_w, float* w, float* c, int k,
            float delta, float d2, float two_delta, int num,
            cudaStream_t stream) {
  if (k == 2)
    launch_k<V, 2>(r, o_w, w, c, delta, d2, two_delta, num, stream);
  else
    launch_k<V, 3>(r, o_w, w, c, delta, d2, two_delta, num, stream);
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

// r (k, O) f32 row-major, k 2 or 3; o_w (O,) or null; w, c (O,). Returns
// cudaGetLastError() after the launch.
extern "C" int glomap_huber_irls(const float* r, const float* o_w, float* w,
                                 float* c, int k, float delta, float d2,
                                 float two_delta, int num,
                                 cudaStream_t stream) {
  if (num > 0) {
    if (g_sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const bool all8 = aligned(r, 8) && aligned(o_w, 8) && aligned(w, 8) &&
                      aligned(c, 8);
    if (num % 2 == 0 && all8)
      launch<2>(r, o_w, w, c, k, delta, d2, two_delta, num, stream);
    else
      launch<1>(r, o_w, w, c, k, delta, d2, two_delta, num, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
