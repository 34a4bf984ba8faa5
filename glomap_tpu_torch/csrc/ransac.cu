// B8: a chunk of stage 2's relative-pose RANSAC in one launch. R rounds of
// H 8-point hypotheses per pair: draw the sample slots, solve the 8-point
// nullspace, project it onto the essential manifold, count the pair's table
// slots whose squared Sampson error falls under the pair's threshold, and
// fold the best hypothesis into the pair's running best.
//
// Replaces no Pallas kernel: it is the port's counterpart of the JAX
// package's chunk of rounds (glomap_tpu/estimators/relpose.py
// _ransac_rounds, a lax.scan that XLA compiles into one program on the
// TPU). The plain version is ops/kernels.py ransac_chunk_plain, which calls
// estimators/relpose.py _ransac_round once a round; that chain launches
// about a hundred library kernels a round and writes each round's
// (P, H, 9, 9) systems and (P, H, cap) Sampson blocks to device memory.
//
// Bound on an H100: operations. A hypothesis costs ~2.9k f32 operations to
// solve and ~44 a table slot to score (cap 512: ~25k in all, counted in
// chip_smoke.py RANSAC_SOLVE_OPS and RANSAC_SLOT_OPS); a pair's table is
// 6 * cap f32 and is read once a round. Nothing but the draws, the tables
// and one (count, E) a (pair, round) crosses device memory.
//
// Design: a block per (pair, round), blocks pair-major, so a tail chunk of
// n pairs still runs 8n blocks (R = 8). The block stages the pair's lifted
// table in shared memory, 32 bytes a slot (a0 a1 b0 b1 | b0a0 b0a1 b1a0
// b1a1; cap 512: 16 KB), and each of its 64 threads takes hypotheses h,
// h + 64, ...: it reads its 8 samples from the table in device memory,
// solves in registers and scores every slot from shared memory, where the
// whole warp reads one slot at a time (a broadcast). The block's first
// maximum (count, then the smaller h) goes to scratch; the block that
// arrives last on the pair's counter (__threadfence, then atomicAdd) folds
// the R round maxima in round order into the incoming best, replacing it
// only where a count is strictly greater. That is R sequential rounds of
// the plain version.
//
// Numerics, f32 throughout, in the plain version's order (smallalg.py,
// relpose.py _ransac_round). Every value derived elementwise there rounds
// once here (the _rn intrinsics: never contracted into an FMA, no fast
// reciprocal or square root); the products the plain version takes from a
// matrix product (the 8-point Gram matrix, the Cholesky's inner products,
// the triangular solves, E^T E, E v and U V^T) are FMA chains in index
// order. The score, which is compared with a threshold, rounds each
// operation once: the epipolar lines E a and E^T b, C = E . kron(b, a) over
// its 9 terms, their squares, the clamped denominator and the division.
// A masked slot gets a0 = NaN, so its error is NaN and never an inlier.
// Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSamples = 8;
constexpr int kIters = 8;          // min_eigvec9's inverse iterations
constexpr float kEps = 1e-12f;     // z offset, Sampson clamp, pivot clamp
constexpr float kTiny = 1e-30f;    // trace and norm clamps
constexpr float kShift = 1e-8f;    // of the trace, on the Gram diagonal
constexpr float kTwoPi3 = 2.0943951023931953f;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// entry (i, j), i >= j, of a packed lower triangle
__host__ __device__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

__device__ __forceinline__ float sum_sq3(const float (&v)[3]) {
  return add(add(mul(v[0], v[0]), mul(v[1], v[1])), mul(v[2], v[2]));
}

// smallalg._unit
__device__ __forceinline__ void unit3(float (&v)[3]) {
  const float n = __fsqrt_rn(clamp_min(sum_sq3(v), kTiny));
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = dvd(v[i], n);
}

// torch.linalg.cross
__device__ __forceinline__ void cross3(const float (&u)[3],
                                       const float (&v)[3], float (&w)[3]) {
  w[0] = sub(mul(u[1], v[2]), mul(u[2], v[1]));
  w[1] = sub(mul(u[2], v[0]), mul(u[0], v[2]));
  w[2] = sub(mul(u[0], v[1]), mul(u[1], v[0]));
}

// E v for row-major e (9)
__device__ __forceinline__ void matvec3(const float (&e)[9],
                                        const float (&v)[3], float (&w)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    w[i] = fmaf(e[3 * i + 2], v[2], fmaf(e[3 * i + 1], v[1],
                                         mul(e[3 * i], v[0])));
}

// smallalg.min_eigvec9 on the Gram matrix G (its lower triangle, packed),
// which becomes the Cholesky factor of G + 1e-8 tr(G) I
__device__ __forceinline__ void min_eigvec9(float (&G)[45], float (&x)[9]) {
  float tr = G[tri(0, 0)];
#pragma unroll
  for (int i = 1; i < 9; ++i) tr = add(tr, G[tri(i, i)]);
  const float trc = clamp_min(tr, kTiny);
  const float shift = mul(kShift, trc);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    x[i] = add(1.0f, dvd(mul(0.1f, G[tri(i, i)]), trc));
    G[tri(i, i)] = add(G[tri(i, i)], shift);
  }
  // cholesky_unrolled: column j, each pivot's square clamped at 1e-12
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    float d = G[tri(j, j)];
    if (j > 0) {
      float s = mul(G[tri(j, 0)], G[tri(j, 0)]);
#pragma unroll
      for (int k = 1; k < j; ++k) s = add(s, mul(G[tri(j, k)], G[tri(j, k)]));
      d = sub(d, s);
    }
    const float ljj = __fsqrt_rn(clamp_min(d, kEps));
    G[tri(j, j)] = ljj;
    const float inv = dvd(1.0f, ljj);
#pragma unroll
    for (int i = j + 1; i < 9; ++i) {
      float v = G[tri(i, j)];
      if (j > 0) {
        float s = mul(G[tri(i, 0)], G[tri(j, 0)]);
#pragma unroll
        for (int k = 1; k < j; ++k) s = fmaf(G[tri(i, k)], G[tri(j, k)], s);
        v = sub(v, s);
      }
      G[tri(i, j)] = mul(v, inv);
    }
  }
  // inverse iteration: L y = x, L^T x = y, normalize
  float y[9];
#pragma unroll 1
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      float s = x[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s = fmaf(-G[tri(i, k)], y[k], s);
      y[i] = dvd(s, G[tri(i, i)]);
    }
#pragma unroll
    for (int i = 8; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < 9; ++k) s = fmaf(-G[tri(k, i)], x[k], s);
      x[i] = dvd(s, G[tri(i, i)]);
    }
    float n2 = mul(x[0], x[0]);
#pragma unroll
    for (int i = 1; i < 9; ++i) n2 = add(n2, mul(x[i], x[i]));
    const float n = __fsqrt_rn(clamp_min(n2, kTiny));
#pragma unroll
    for (int i = 0; i < 9; ++i) x[i] = dvd(x[i], n);
  }
}

// smallalg.essential_project of row-major e (9), in place: v3 the null
// vector of E^T E at its smallest Cardano eigenvalue, (v1, v2) its tangent
// pair, u1 = unit(E v1), u2 = unit(E v2 - (E v2 . u1) u1), and
// E' = u1 v1^T + u2 v2^T
__device__ __forceinline__ void essential_project(float (&e)[9]) {
  float a00 = mul(e[0], e[0]), a01 = mul(e[0], e[1]), a02 = mul(e[0], e[2]);
  float a11 = mul(e[1], e[1]), a12 = mul(e[1], e[2]), a22 = mul(e[2], e[2]);
#pragma unroll
  for (int i = 1; i < 3; ++i) {
    const float r0 = e[3 * i], r1 = e[3 * i + 1], r2 = e[3 * i + 2];
    a00 = fmaf(r0, r0, a00);
    a01 = fmaf(r0, r1, a01);
    a02 = fmaf(r0, r2, a02);
    a11 = fmaf(r1, r1, a11);
    a12 = fmaf(r1, r2, a12);
    a22 = fmaf(r2, r2, a22);
  }
  // _cardano
  const float q = dvd(add(add(a00, a11), a22), 3.0f);
  const float b00 = sub(a00, q), b11 = sub(a11, q), b22 = sub(a22, q);
  const float p2 = add(
      add(add(mul(b00, b00), mul(b11, b11)), mul(b22, b22)),
      mul(2.0f, add(add(mul(a01, a01), mul(a02, a02)), mul(a12, a12))));
  const float p = __fsqrt_rn(clamp_min(dvd(p2, 6.0f), kTiny));
  const float ip = dvd(1.0f, p);
  const float c00 = mul(b00, ip), c11 = mul(b11, ip), c22 = mul(b22, ip);
  const float c01 = mul(a01, ip), c02 = mul(a02, ip), c12 = mul(a12, ip);
  float hd = mul(0.5f, add(
      sub(mul(c00, sub(mul(c11, c22), mul(c12, c12))),
          mul(c01, sub(mul(c01, c22), mul(c12, c02)))),
      mul(c02, sub(mul(c01, c12), mul(c11, c02)))));
  hd = hd < -1.0f ? -1.0f : (hd > 1.0f ? 1.0f : hd);
  const float phi = dvd(acosf(hd), 3.0f);
  const float lam = add(q, mul(mul(2.0f, p), cosf(add(phi, kTwoPi3))));
  // _null_vector: the longest cross product of the rows of E^T E - lam I
  const float r0[3] = {sub(a00, lam), a01, a02};
  const float r1[3] = {a01, sub(a11, lam), a12};
  const float r2[3] = {a02, a12, sub(a22, lam)};
  float c01v[3], c12v[3], c20v[3];
  cross3(r0, r1, c01v);
  cross3(r1, r2, c12v);
  cross3(r2, r0, c20v);
  const float n01 = sum_sq3(c01v), n12 = sum_sq3(c12v), n20 = sum_sq3(c20v);
  float v3[3];
  const bool first = n01 >= fmaxf(n12, n20), second = n12 >= n20;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    v3[i] = first ? c01v[i] : (second ? c12v[i] : c20v[i]);
  unit3(v3);
  // _tangent_pair
  const bool ex = fabsf(v3[0]) < 0.9f;
  const float ax[3] = {ex ? 1.0f : 0.0f, ex ? 0.0f : 1.0f, 0.0f};
  float v1[3], v2[3];
  cross3(v3, ax, v1);
  unit3(v1);
  cross3(v3, v1, v2);
  float u1[3], u2[3];
  matvec3(e, v1, u1);
  unit3(u1);
  matvec3(e, v2, u2);
  const float d = add(add(mul(u2[0], u1[0]), mul(u2[1], u1[1])),
                      mul(u2[2], u1[2]));
#pragma unroll
  for (int i = 0; i < 3; ++i) u2[i] = sub(u2[i], mul(d, u1[i]));
  unit3(u2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      e[3 * i + j] = fmaf(u2[i], v2[j], mul(u1[i], v1[j]));
}

// u (R, P, 2, H) int64 draws in [0, 2^30); tab (P, 6, cap) rows x1 y1 z1 x2
// y2 z2; mask (P, cap); counts, best_cnt, out_cnt (P,) int64; thr (P,);
// best_E, out_E (P, 9); scratch (P, R) counts and (P, R, 9) E; counters
// (P,) zero on entry, zero again on exit.
__global__ void __launch_bounds__(kThreads)
ransac8_kernel(const long long* __restrict__ u, const float* __restrict__ tab,
               const unsigned char* __restrict__ mask,
               const long long* __restrict__ counts,
               const float* __restrict__ thr,
               const float* __restrict__ best_E,
               const long long* __restrict__ best_cnt,
               int* __restrict__ scratch_cnt, float* __restrict__ scratch_E,
               int* __restrict__ counters, float* __restrict__ out_E,
               long long* __restrict__ out_cnt, int P, int R, int H, int cap) {
  extern __shared__ float4 smem[];
  float4* sab = smem;         // a0 a1 b0 b1 per slot
  float4* skr = smem + cap;   // b0 a0, b0 a1, b1 a0, b1 a1 per slot
  __shared__ unsigned long long warp_max[kWarps];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31;
  const int p = blockIdx.x / R, r = blockIdx.x % R;
  const size_t cs = static_cast<size_t>(cap);
  const float* t = tab + static_cast<size_t>(p) * 6 * cs;

  // relpose._lift: a = (x1, y1) / (z1 + eps), b likewise, and the products
  // of kron(b, a) that are not a copy of a0, a1, b0, b1 or 1
  const unsigned char* m = mask + static_cast<size_t>(p) * cs;
  for (int s = tid; s < cap; s += kThreads) {
    const float iz1 = dvd(1.0f, add(t[2 * cs + s], kEps));
    const float iz2 = dvd(1.0f, add(t[5 * cs + s], kEps));
    float a0 = mul(t[s], iz1);
    const float a1 = mul(t[cs + s], iz1);
    const float b0 = mul(t[3 * cs + s], iz2), b1 = mul(t[4 * cs + s], iz2);
    if (!m[s]) a0 = __int_as_float(0x7fffffff);
    sab[s] = make_float4(a0, a1, b0, b1);
    skr[s] = make_float4(mul(b0, a0), mul(b0, a1), mul(b1, a0), mul(b1, a1));
  }
  __syncthreads();

  const long long n = counts[p] > 1 ? counts[p] : 1;
  const long long n1 = n - 1 > 1 ? n - 1 : 1;
  const float th = thr[p];
  const long long* ur = u + (static_cast<size_t>(r) * P + p) * 2 * H;
  unsigned long long key = 0;  // (count << 32) | ~h of the thread's best
  float best[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) best[i] = 0.0f;
  for (int h = tid; h < H; h += kThreads) {
    // the samples: slots (b + k step) mod n
    const int b = static_cast<int>(ur[h] % n);
    const int step = 1 + static_cast<int>(ur[H + h] % n1);
    float G[45];
#pragma unroll
    for (int k = 0; k < kSamples; ++k) {
      const int idx = (b + k * step) % static_cast<int>(n);
      float s1[3], s2[3], row[9];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s1[c] = t[c * cs + idx];
        s2[c] = t[(3 + c) * cs + idx];
      }
      // the epipolar row kron(s2, s1): row[3i + j] = s2_i s1_j
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) row[3 * i + j] = mul(s2[i], s1[j]);
#pragma unroll
      for (int i = 0; i < 9; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j)
          G[tri(i, j)] = k == 0 ? mul(row[i], row[j])
                                : fmaf(row[i], row[j], G[tri(i, j)]);
    }
    float e[9];
    min_eigvec9(G, e);
    essential_project(e);

    // relpose._sampson_tab_block, counted under the threshold
    unsigned cnt = 0;
#pragma unroll 4
    for (int s = 0; s < cap; ++s) {
      const float4 ab = sab[s], kr = skr[s];
      const float Ex0 = add(add(mul(e[0], ab.x), mul(e[1], ab.y)), e[2]);
      const float Ex1 = add(add(mul(e[3], ab.x), mul(e[4], ab.y)), e[5]);
      const float Et0 = add(add(mul(e[0], ab.z), mul(e[3], ab.w)), e[6]);
      const float Et1 = add(add(mul(e[1], ab.z), mul(e[4], ab.w)), e[7]);
      float C = add(mul(e[0], kr.x), mul(e[1], kr.y));
      C = add(C, mul(e[2], ab.z));
      C = add(C, mul(e[3], kr.z));
      C = add(C, mul(e[4], kr.w));
      C = add(C, mul(e[5], ab.w));
      C = add(C, mul(e[6], ab.x));
      C = add(C, mul(e[7], ab.y));
      C = add(C, e[8]);
      const float den = add(add(mul(Ex0, Ex0), mul(Ex1, Ex1)),
                            add(mul(Et0, Et0), mul(Et1, Et1)));
      cnt += dvd(mul(C, C), clamp_min(den, kEps)) < th;
    }
    const unsigned long long k =
        (static_cast<unsigned long long>(cnt) << 32) | (kFull - h);
    if (k > key) {
      key = k;
#pragma unroll
      for (int i = 0; i < 9; ++i) best[i] = e[i];
    }
  }

  // the round's first maximum: the largest count, then the smallest h
  unsigned long long mx = key;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(kFull, mx, o);
    mx = other > mx ? other : mx;
  }
  if (lane == 0) warp_max[tid >> 5] = mx;
  __syncthreads();
  mx = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = warp_max[w] > mx ? warp_max[w] : mx;
  const size_t pr = static_cast<size_t>(p) * R + r;
  if (key == mx) {  // the one thread that holds it
    scratch_cnt[pr] = static_cast<int>(key >> 32);
#pragma unroll
    for (int i = 0; i < 9; ++i) scratch_E[pr * 9 + i] = best[i];
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(counters + p, 1) == R - 1;
  }
  __syncthreads();
  if (!last || tid != 0) return;

  // the pair's last block folds the rounds in order into the running best
  __threadfence();
  long long bc = best_cnt[p];
  int rb = -1;
  for (int rr = 0; rr < R; ++rr) {
    const long long c = __ldcg(scratch_cnt + static_cast<size_t>(p) * R + rr);
    if (c > bc) {
      bc = c;
      rb = rr;
    }
  }
  out_cnt[p] = bc;
  const float* src = rb < 0 ? best_E + static_cast<size_t>(p) * 9
                            : scratch_E + (static_cast<size_t>(p) * R + rb) * 9;
#pragma unroll
  for (int i = 0; i < 9; ++i)
    out_E[static_cast<size_t>(p) * 9 + i] = rb < 0 ? src[i] : __ldcg(src + i);
  counters[p] = 0;
}

}  // namespace

// See ransac8_kernel for the layouts; every pointer on the card, counters
// zero. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for R, H or cap below 1, or a table too large for shared memory).
extern "C" int glomap_ransac_chunk(
    const long long* u, const float* tab, const unsigned char* mask,
    const long long* counts, const float* thr, const float* best_E,
    const long long* best_cnt, int* scratch_cnt, float* scratch_E,
    int* counters, float* out_E, long long* out_cnt, int P, int R, int H,
    int cap, cudaStream_t stream) {
  if (R < 1 || H < 1 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float4) * static_cast<size_t>(cap);
  if (P > 0) {
    if (smem > (48u << 10)) {
      const cudaError_t err = cudaFuncSetAttribute(
          ransac8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    ransac8_kernel<<<static_cast<unsigned>(P) * R, kThreads, smem, stream>>>(
        u, tab, mask, counts, thr, best_E, best_cnt, scratch_cnt, scratch_E,
        counters, out_E, out_cnt, P, R, H, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
