// B1: fused projection residual + closed-form Jacobian, every camera kind.
//
// Replaces: glomap_tpu/ops/pallas_kernels.py projection_resid_jac (the
// _projection_kernel body) together with its XLA helper
// projection_base_rows. On the TPU the atan/tan base map ran outside the
// kernel because Mosaic had no lowering for them; here atanf/tanf run
// inside, so the kernel reads only its true inputs.
//
// Bound on an H100: memory. Per observation it reads 43 (46 with the rig
// rows) and writes 52 (64) floats, about 380 bytes, against some 300
// flops: at 3.35 TB/s the 100,100-observation bench problem needs about
// 11 us, the f32 ALUs under 1 us.
//
// Design: one thread per observation. Every (k, O) row stack has the
// observation axis contiguous, so each of a warp's loads and stores is
// one coalesced 128-byte transaction per row. Nothing is staged in shared
// memory: there is no reuse across observations. J row `col + zdim * i`
// holds d r_i / d z_col for z = [w(3) dt(3) dX(3) intr(16) [ws(3) dts(3)]],
// the layout of the TPU kernel. The guards are the TPU kernel's: a depth
// below 1e-9 in magnitude becomes +1e-9 (this also flips the sign of tiny
// negative depths), small_r switches the base map to its series, and
// w_ok leaves FOV cameras with a tiny omega as perspective.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kRig>
__global__ void __launch_bounds__(kThreads)
projection_kernel(const float* __restrict__ Mr, const float* __restrict__ Sr,
                  const float* __restrict__ br, const float* __restrict__ Xr,
                  const float* __restrict__ uvr,
                  const float* __restrict__ kr,
                  const float* __restrict__ kindr,
                  const float* __restrict__ tsr, float* __restrict__ r,
                  float* __restrict__ J, int num_obs) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= num_obs) return;
  const size_t n = static_cast<size_t>(num_obs);
  constexpr int zdim = kRig ? 31 : 25;
  auto row = [&](const float* p, int i) { return p[i * n + o]; };

  float M[9], S[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    M[i] = row(Mr, i);
    S[i] = row(Sr, i);
  }
  const float X0 = row(Xr, 0), X1 = row(Xr, 1), X2 = row(Xr, 2);
  const float p0 = M[0] * X0 + M[1] * X1 + M[2] * X2 + row(br, 0);
  const float p1 = M[3] * X0 + M[4] * X1 + M[5] * X2 + row(br, 1);
  const float p2 = M[6] * X0 + M[7] * X1 + M[8] * X2 + row(br, 2);
  const float fx = row(kr, 0), fy = row(kr, 1), cx = row(kr, 2),
              cy = row(kr, 3);
  const float k1 = row(kr, 4), k2 = row(kr, 5), k3 = row(kr, 6),
              k4 = row(kr, 7);
  const float d1 = row(kr, 8), d2 = row(kr, 9), d3 = row(kr, 10);
  const float tp1 = row(kr, 11), tp2 = row(kr, 12);
  const float sx1 = row(kr, 13), sy1 = row(kr, 14), omega = row(kr, 15);
  const float kind = row(kindr, 0);

  const float z = fabsf(p2) < 1e-9f ? 1e-9f : p2;
  const float iz = 1.0f / z;
  const float x = p0 * iz;
  const float y = p1 * iz;

  // kind base map: (u, v) = a (x, y); kq = a'(r)/r; da_dw = d a / d omega
  const bool is_fe = kind == 1.0f;
  const bool is_fov = kind == 2.0f;
  const float rr2 = x * x + y * y;
  const float rr = sqrtf(fmaxf(rr2, 1e-18f));
  const bool small_r = rr < 1e-6f;
  const float rr2s = fmaxf(rr2, 1e-18f);
  const float a_fe = small_r ? 1.0f - rr2 / 3.0f : atanf(rr) / rr;
  const float kq_fe =
      small_r ? -2.0f / 3.0f : (1.0f / (1.0f + rr2) - a_fe) / rr2s;
  const bool w_ok = fabsf(omega) > 1e-6f;
  const float w_safe = w_ok ? omega : 1e-6f;
  const float tanh_ = tanf(0.5f * w_safe);
  const float q = 2.0f * rr * tanh_;
  const float atq = atanf(q);
  const float iden_q = 1.0f / (1.0f + q * q);
  const float a_fov_raw =
      small_r ? 2.0f * tanh_ / w_safe : atq / (w_safe * rr);
  const float kq_fov_raw =
      small_r ? -(16.0f * tanh_ * tanh_ * tanh_) / (3.0f * w_safe)
              : (2.0f * tanh_ * iden_q / w_safe - a_fov_raw) / rr2s;
  const float sec2h = 1.0f + tanh_ * tanh_;
  const float da_dw_raw =
      small_r ? sec2h / w_safe - 2.0f * tanh_ / (w_safe * w_safe)
              : (rr * sec2h * iden_q - atq / w_safe) / (w_safe * rr);
  const float a_fov = w_ok ? a_fov_raw : 1.0f;
  const float kq_fov = w_ok ? kq_fov_raw : 0.0f;
  const float da_dw = (is_fov && w_ok) ? da_dw_raw : 0.0f;
  const float a = is_fe ? a_fe : (is_fov ? a_fov : 1.0f);
  const float kq = is_fe ? kq_fe : (is_fov ? kq_fov : 0.0f);

  const float u = x * a, v = y * a;
  const float G2xx = a + kq * x * x;
  const float G2xy = kq * x * y;
  const float G2yy = a + kq * y * y;

  // polynomial distortion on (u, v)
  const float r2 = u * u + v * v;
  const float r4 = r2 * r2;
  const float r6 = r4 * r2;
  const float num = 1.0f + k1 * r2 + k2 * r4 + k3 * r6 + k4 * r4 * r4;
  const float den = 1.0f + d1 * r2 + d2 * r4 + d3 * r6;
  const float iden = 1.0f / den;
  const float radial = num * iden;
  const float xy2 = 2.0f * u * v;
  const float du = u * radial + tp1 * xy2 + tp2 * (r2 + 2.0f * u * u) +
                   sx1 * r2;
  const float dv = v * radial + tp2 * xy2 + tp1 * (r2 + 2.0f * v * v) +
                   sy1 * r2;
  r[o] = fx * du + cx - row(uvr, 0);
  r[n + o] = fy * dv + cy - row(uvr, 1);

  const float dnum = k1 + 2.0f * k2 * r2 + 3.0f * k3 * r4 + 4.0f * k4 * r6;
  const float dden = d1 + 2.0f * d2 * r2 + 3.0f * d3 * r4;
  const float drad = (dnum - radial * dden) * iden;
  const float Dxx = radial + 2.0f * u * u * drad + 2.0f * tp1 * v +
                    6.0f * tp2 * u + 2.0f * sx1 * u;
  const float Dxy = 2.0f * u * v * drad + 2.0f * tp1 * u + 2.0f * tp2 * v +
                    2.0f * sx1 * v;
  const float Dyx = 2.0f * u * v * drad + 2.0f * tp2 * v + 2.0f * tp1 * u +
                    2.0f * sy1 * u;
  const float Dyy = radial + 2.0f * v * v * drad + 2.0f * tp2 * u +
                    6.0f * tp1 * v + 2.0f * sy1 * v;
  const float g00 = fx * (Dxx * G2xx + Dxy * G2xy);
  const float g01 = fx * (Dxx * G2xy + Dxy * G2yy);
  const float g10 = fy * (Dyx * G2xx + Dyy * G2xy);
  const float g11 = fy * (Dyx * G2xy + Dyy * G2yy);

  auto put = [&](int c, float j0, float j1) {
    J[c * n + o] = j0;
    J[(zdim + c) * n + o] = j1;
  };
  // column from dp/dth = (e0, e1, e2) through the perspective divide
  auto col = [&](int c, float e0, float e1, float e2) {
    const float dx = iz * (e0 - x * e2);
    const float dy = iz * (e1 - y * e2);
    put(c, g00 * dx + g01 * dy, g10 * dx + g11 * dy);
  };
  auto mcol = [&](int c, float v0, float v1, float v2) {
    col(c, M[0] * v0 + M[1] * v1 + M[2] * v2,
        M[3] * v0 + M[4] * v1 + M[5] * v2,
        M[6] * v0 + M[7] * v1 + M[8] * v2);
  };
  // d p / d w = -M [X]x
  mcol(0, 0.0f, -X2, X1);
  mcol(1, X2, 0.0f, -X0);
  mcol(2, -X1, X0, 0.0f);
  // d p / d t_f = R_s; d p / d X = M
  col(3, S[0], S[3], S[6]);
  col(4, S[1], S[4], S[7]);
  col(5, S[2], S[5], S[8]);
  col(6, M[0], M[3], M[6]);
  col(7, M[1], M[4], M[7]);
  col(8, M[2], M[5], M[8]);
  // intrinsics, canonical slot s -> column 9 + s
  put(9, du, 0.0f);
  put(10, 0.0f, dv);
  put(11, 1.0f, 0.0f);
  put(12, 0.0f, 1.0f);
  const float fxu = fx * u * iden;
  const float fyv = fy * v * iden;
  float rp = 1.0f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {  // k1..k4
    rp = rp * r2;
    put(13 + s, fxu * rp, fyv * rp);
  }
  rp = 1.0f;
#pragma unroll
  for (int s = 0; s < 3; ++s) {  // d1..d3
    rp = rp * r2;
    put(17 + s, -fxu * radial * rp, -fyv * radial * rp);
  }
  put(20, fx * xy2, fy * (r2 + 2.0f * v * v));
  put(21, fx * (r2 + 2.0f * u * u), fy * xy2);
  put(22, fx * r2, 0.0f);
  put(23, 0.0f, fy * r2);
  const float du_dw = x * da_dw;
  const float dv_dw = y * da_dw;
  put(24, fx * (Dxx * du_dw + Dxy * dv_dw), fy * (Dyx * du_dw + Dyy * dv_dw));

  if constexpr (kRig) {
    // sensor pose: dp/dws_k = (S e_k) x (p - t_s); dp/dts = I
    const float a0 = p0 - row(tsr, 0);
    const float a1 = p1 - row(tsr, 1);
    const float a2 = p2 - row(tsr, 2);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float s0 = S[k], s1 = S[3 + k], s2 = S[6 + k];
      col(25 + k, s1 * a2 - s2 * a1, s2 * a0 - s0 * a2, s0 * a1 - s1 * a0);
    }
    col(28, 1.0f, 0.0f, 0.0f);
    col(29, 0.0f, 1.0f, 0.0f);
    col(30, 0.0f, 0.0f, 1.0f);
  }
}

}  // namespace

// Row stacks (k, O) f32 with O contiguous; ts may be null (zdim 25).
// Returns cudaGetLastError() after the launch.
extern "C" int glomap_projection_resid_jac(
    const float* M, const float* S, const float* b, const float* X,
    const float* uv, const float* intr, const float* kind, const float* ts,
    float* r, float* J, int num_obs, cudaStream_t stream) {
  if (num_obs > 0) {
    const int blocks = (num_obs + kThreads - 1) / kThreads;
    if (ts != nullptr) {
      projection_kernel<true><<<blocks, kThreads, 0, stream>>>(
          M, S, b, X, uv, intr, kind, ts, r, J, num_obs);
    } else {
      projection_kernel<false><<<blocks, kThreads, 0, stream>>>(
          M, S, b, X, uv, intr, kind, ts, r, J, num_obs);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
