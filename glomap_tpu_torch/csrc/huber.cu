// B6: the Huber IRLS sweep, squared norms r2 -> (weight w, cost c) of
// Ceres' HuberLoss(delta):
//   rn = sqrt(max(r2, 1e-30))
//   w  = r2 <= delta^2 ? 1  : delta / rn
//   c  = r2 <= delta^2 ? r2 : 2 delta rn - delta^2
//
// Replaces: glomap_tpu/ops/pallas_kernels.py huber_weight_cost
// (_huber_kernel), the pair _huber_weight + _huber_cost that the JAX
// solvers inline (estimators/global_positioning.py:54-63,
// estimators/bundle_adjustment.py:109-117). On the TPU it tiled the padded
// (1, O) row into VMEM blocks with delta a compile-time constant; here a
// thread per element reads r2 once and writes both outputs, and delta is
// an argument (stage 6 and the GP anneal use several values).
//
// Bound on an H100: memory. It reads 4 B and writes 8 B per element
// (O = 2e5: 2.4 MB, under a microsecond at 3.35 TB/s), so the launch sets
// its time at the solvers' sizes.
//
// Numerics: the LM accept test compares costs, so every operation rounds
// once, as the plain f32 version does: IEEE square root and division, the
// product and difference as _rn intrinsics (never contracted into an FMA).
// delta, delta^2 and 2 delta come in as the f32 values PyTorch rounds the
// plain version's Python scalars to. Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
huber_kernel(const float* __restrict__ r2_in, float* __restrict__ w_out,
             float* __restrict__ c_out, float delta, float d2,
             float two_delta, int num) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= num) return;
  const float r2 = r2_in[o];
  // clamp as torch.clamp does: a NaN stays NaN
  const float rn = __fsqrt_rn(r2 < 1e-30f ? 1e-30f : r2);
  const bool inside = r2 <= d2;
  w_out[o] = inside ? 1.0f : __fdiv_rn(delta, rn);
  c_out[o] = inside ? r2 : __fsub_rn(__fmul_rn(two_delta, rn), d2);
}

}  // namespace

// r2, w, c (O,) f32. Returns cudaGetLastError() after the launch.
extern "C" int glomap_huber(const float* r2, float* w, float* c, float delta,
                            float d2, float two_delta, int num,
                            cudaStream_t stream) {
  if (num > 0) {
    const int blocks = (num + kThreads - 1) / kThreads;
    huber_kernel<<<blocks, kThreads, 0, stream>>>(r2, w, c, delta, d2,
                                                  two_delta, num);
  }
  return static_cast<int>(cudaGetLastError());
}
