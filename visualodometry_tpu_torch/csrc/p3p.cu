// The P3P minimal solver (Grunert) for sm_90a: one thread a sample, the
// whole solve in registers, from the three world points and bearings to
// four poses and their flags.
//
// Replaces no TPU kernel. The JAX package's `p3p_grunert`
// (visualodometry_tpu/estimation/p3p.py) is batched scalar and complex64
// arithmetic, which XLA fuses under `jit`. The port runs eagerly, where
// the same chain is one launch per operation: ~4,050 launches a call at
// 512 samples, ~3,690 of them Durand-Kerner's 40 Gauss-Seidel iterations
// over 4 roots. This kernel is the port's counterpart of that fusion: one
// launch for the whole (H, 3) batch of samples.
//
// What it computes for each sample (estimation/p3p.py
// `_p3p_grunert_torch`, the plain version, in its order):
//   f_p = (x_p, y_p, 1) / |(x_p, y_p, 1)|, the unit bearings
//   A, B = |X2 - X3|^2 / nz, |X1 - X2|^2 / nz, nz = max(|X1 - X3|^2, 1e-12)
//   ca, cb, cg = f2.f3, f1.f3, f1.f2
//   the resultant R(v) of the two monic quadratics in u, sampled at the
//       five abscissae, its coefficients c0..c4 = S @ Vinv^T (k = 0..4)
//   the quartic's roots by 40 Durand-Kerner iterations in complex64, the
//       roots updated one after the other (Gauss-Seidel), from the seeds
//   3 Newton steps on v = Re(root) against R evaluated directly,
//       h = 1e-4 (1 + |v|) fixed, the step clamped to +-0.1
//   the gates real (|Im| < 1e-3 (1 + |v|)), v > 1e-6, u > 1e-6, w > 1e-9
//   d1 = sqrt(nz / max(w, 1e-12)), d2 = u d1, d3 = v d1, the camera points
//       d_p f_p, and the pose by triad composition R = F_c F_w^T,
//       t = P_c1 - R X1; ok also asks R and t finite
// Every elementwise operation of the plain version is one kernel there
// and is rounded on its own, so each is an `_rn` intrinsic here, in its
// order: nvcc contracts none of them on its own. Where PyTorch's CUDA
// build itself forms a fused multiply-add, the kernel fuses the same term
// with `__fmaf_rn` (measured against the card's own operations, bit for
// bit on ~200,000 inputs each): the first product of c10::complex's
// product (ac - bd, ad + bc), the terms of its quotient (numpy's scaled
// division, which branches on |c| >= |d|; a 0 / 0 gives what IEEE
// division by zero gives), the first product of each cross-product term,
// and the matrix products (the Vandermonde product and F_c F_w^T, over k
// in order, as a GEMM forms them). A modulus is `hypotf`; a 3-term sum or
// norm adds (x0 + x2) + x1, the card's reduction order. The clamps and the
// `torch.where` floors keep their NaN behaviour: a clamp lets a NaN
// through, a floor on |x| > eps replaces it. Where R and t are NaN in the
// plain version (a degenerate triad), they are NaN here, in the same
// slots.
//
// Where its bits may still differ from the plain version's: on the card,
// the einsum R X1 reduces in an order cuBLAS picks by batch size, and the
// last bits of the Durand-Kerner chain part in about half of the slots
// (measured at 256-4096 samples); on the CPU, the vectorised complex
// division, the reductions and the products round otherwise. Durand-Kerner
// amplifies a last-bit difference near a double root (two roots may trade
// slots there), so the two agree to a tolerance, not bit for bit
// (tests/test_torch_p3p.py gives the measurements).
//
// What bounds it on an H100: latency. It reads H x 60 bytes (X and xy)
// and the 152 bytes of constants, and writes H x 196 bytes (R, t and the
// flags): ~130 KB at H = 512, 0.04 us at 3.35 TB/s. It does ~14,500
// floating-point operations a sample (chip_smoke.py `p3p_ops`), ~7.4 MFLOP
// at H = 512, about 0.1 us of the card's float32 rate. Its time is the chain of each thread: 160
// dependent Durand-Kerner updates, each a product of three differences,
// a Horner evaluation of five complex steps and a complex division. What
// the design does about it: one thread keeps a sample's coefficients and
// roots in registers for all 40 iterations (the Gauss-Seidel order makes
// the four roots of a sample depend on each other, so they cannot be
// split over threads); blocks of 128 threads spread the samples over as
// many SMs as they fill; the constants are read once a thread through the
// read-only path. H is a run-time argument: every configuration shares
// the one kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // samples a block
constexpr int ITERS = 40;     // Durand-Kerner iterations
constexpr int NEWTON = 3;     // Newton steps on the real part

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fused(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// max(s, lo) that lets a NaN through, as torch.clamp(min=) does
__device__ __forceinline__ float clamp_min(float s, float lo) { return s < lo ? lo : s; }
// torch.clamp(s, lo, hi): a NaN stays NaN
__device__ __forceinline__ float clamp(float s, float lo, float hi) {
  return s != s ? s : fminf(fmaxf(s, lo), hi);
}
// torch.where(|s| > eps, s, eps): a NaN becomes eps
__device__ __forceinline__ float floor_abs(float s, float eps) {
  return fabsf(s) > eps ? s : eps;
}

struct cplx {
  float re, im;
};

__device__ __forceinline__ cplx csub(cplx a, cplx b) { return {sub(a.re, b.re), sub(a.im, b.im)}; }
__device__ __forceinline__ cplx cadd(cplx a, cplx b) { return {add(a.re, b.re), add(a.im, b.im)}; }
// c10::complex's product (ac - bd, ad + bc), its first product fused
__device__ __forceinline__ cplx cmul(cplx x, cplx y) {
  return {fused(x.re, y.re, -mul(x.im, y.im)), fused(x.re, y.im, mul(x.im, y.re))};
}
// c10::complex's operator/=, numpy's scaled division, each product that
// meets a sum fused
__device__ __forceinline__ cplx cdiv(cplx x, cplx y) {
  const float a = x.re, b = x.im, c = y.re, d = y.im;
  const float abs_c = fabsf(c), abs_d = fabsf(d);
  if (abs_c >= abs_d) {
    if (abs_c == 0.0f && abs_d == 0.0f) return {dvd(a, abs_c), dvd(b, abs_d)};
    const float rat = dvd(d, c);
    const float scl = dvd(1.0f, fused(d, rat, c));
    return {mul(fused(b, rat, a), scl), mul(fused(-a, rat, b), scl)};
  }
  const float rat = dvd(c, d);
  const float scl = dvd(1.0f, fused(c, rat, d));
  return {mul(fused(a, rat, b), scl), mul(fused(b, rat, -a), scl)};
}
// torch.where(|z| > eps, z, eps) on a complex z
__device__ __forceinline__ cplx floor_cabs(cplx z, float eps) {
  return hypotf(z.re, z.im) > eps ? z : cplx{eps, 0.0f};
}

// the per-sample quantities the resultant is built from
struct Sample {
  float A, B, ca, cb, cg;
};

// (b1, c1, b2, c2) of Q1 and Q2 at v, and w(v)
struct Quad {
  float w, b1, c1, b2, c2;
};

__device__ __forceinline__ Quad quadratics(const Sample& s, float v) {
  Quad q;
  q.w = sub(add(mul(v, v), 1.0f), mul(mul(2.0f, v), s.cb));
  q.b1 = mul(-2.0f, s.cg);
  q.c1 = sub(1.0f, mul(s.B, q.w));
  q.b2 = mul(mul(-2.0f, v), s.ca);
  q.c2 = sub(mul(v, v), mul(s.A, q.w));
  return q;
}

// the resultant of u^2 + b1 u + c1 and u^2 + b2 u + c2 at v
__device__ __forceinline__ float resultant(const Sample& s, float v) {
  const Quad q = quadratics(s, v);
  const float d = sub(q.c1, q.c2);
  return sub(mul(d, d), mul(sub(q.b2, q.b1), sub(mul(q.b1, q.c2), mul(q.b2, q.c1))));
}

// a reduction over three entries (torch.sum, vector_norm), in the order of
// the card's shuffle tree: (x0 + x2) + x1
__device__ __forceinline__ float sum3(float x0, float x1, float x2) { return add(add(x0, x2), x1); }

__device__ __forceinline__ float dot3(const float (&a)[3], const float (&b)[3]) {
  return sum3(mul(a[0], b[0]), mul(a[1], b[1]), mul(a[2], b[2]));
}

__device__ __forceinline__ float norm3(const float (&a)[3]) { return __fsqrt_rn(dot3(a, a)); }

// a x b, as torch.linalg.cross forms it, each first product fused
__device__ __forceinline__ void cross3(const float (&a)[3], const float (&b)[3], float (&c)[3]) {
  c[0] = fused(a[1], b[2], -mul(a[2], b[1]));
  c[1] = fused(a[2], b[0], -mul(a[0], b[2]));
  c[2] = fused(a[0], b[1], -mul(a[1], b[0]));
}

// the orthonormal frame of three points (rows of P), as columns F[i][k] =
// a_k[i]: a1 along P2 - P1, a2 the rest of P3 - P1 (NaN when it is
// shorter than 1e-9), a3 = a1 x a2
__device__ __forceinline__ void triad(const float (&P)[3][3], float (&F)[3][3]) {
  float e1[3], e2[3], a1[3], r2[3], a2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    e1[i] = sub(P[1][i], P[0][i]);
    e2[i] = sub(P[2][i], P[0][i]);
  }
  const float n1 = clamp_min(norm3(e1), 1e-12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) a1[i] = dvd(e1[i], n1);
  const float proj = dot3(e2, a1);
#pragma unroll
  for (int i = 0; i < 3; ++i) r2[i] = sub(e2[i], mul(proj, a1[i]));
  const float n2 = norm3(r2);
  const float n2f = n2 > 1e-9f ? n2 : __int_as_float(0x7fffffff);
#pragma unroll
  for (int i = 0; i < 3; ++i) a2[i] = dvd(r2[i], n2f);
  float a3[3];
  cross3(a1, a2, a3);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    F[i][0] = a1[i];
    F[i][1] = a2[i];
    F[i][2] = a3[i];
  }
}

// One sample: X (3, 3) rows of world points, xy (3, 2) normalised image
// points; writes R (4, 3, 3), t (4, 3) and ok (4,). vs, vinv_t (5, 5) and
// seeds (4 complex, interleaved) are the plain version's constants.
__device__ __forceinline__ void solve_sample(const float* __restrict__ Xg,
                                             const float* __restrict__ xyg,
                                             const float* __restrict__ vs,
                                             const float* __restrict__ vinv_t,
                                             const float* __restrict__ seeds,
                                             float* __restrict__ Rg, float* __restrict__ tg,
                                             uint8_t* __restrict__ okg) {
  float X[3][3], f[3][3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int i = 0; i < 3; ++i) X[p][i] = __ldg(Xg + 3 * p + i);
    const float b[3] = {__ldg(xyg + 2 * p), __ldg(xyg + 2 * p + 1), 1.0f};
    const float nb = norm3(b);
#pragma unroll
    for (int i = 0; i < 3; ++i) f[p][i] = dvd(b[i], nb);
  }
  float d13[3], d23[3], d12[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    d13[i] = sub(X[0][i], X[2][i]);
    d23[i] = sub(X[1][i], X[2][i]);
    d12[i] = sub(X[0][i], X[1][i]);
  }
  const float nz = clamp_min(dot3(d13, d13), 1e-12f);
  Sample s;
  s.A = dvd(dot3(d23, d23), nz);
  s.B = dvd(dot3(d12, d12), nz);
  s.ca = dot3(f[1], f[2]);
  s.cb = dot3(f[0], f[2]);
  s.cg = dot3(f[0], f[1]);

  // the resultant at the abscissae, and its coefficients c0..c4
  float S[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) S[k] = resultant(s, __ldg(vs + k));
  float coef[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    float acc = mul(S[0], __ldg(vinv_t + j));
#pragma unroll
    for (int k = 1; k < 5; ++k) acc = fused(S[k], __ldg(vinv_t + 5 * k + j), acc);
    coef[j] = acc;
  }

  // Durand-Kerner on the monic quartic, Gauss-Seidel order
  const cplx scale = floor_cabs(cplx{coef[4], 0.0f}, 1e-12f);
  cplx mon[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) mon[k] = cdiv(cplx{coef[k], 0.0f}, scale);
  cplx z[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) z[i] = cplx{__ldg(seeds + 2 * i), __ldg(seeds + 2 * i + 1)};
#pragma unroll 1
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cplx denom{1.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j != i) denom = cmul(denom, csub(z[i], z[j]));
      denom = floor_cabs(denom, 1e-12f);
      cplx r{0.0f, 0.0f};
#pragma unroll
      for (int k = 4; k >= 0; --k) r = cadd(cmul(r, z[i]), mon[k]);
      z[i] = csub(z[i], cdiv(r, denom));
    }
  }

  float Fw[3][3];
  triad(X, Fw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // Newton polish of the real part against the resultant itself
    float v = z[i].re;
    const float h = mul(add(fabsf(v), 1.0f), 1e-4f);
    const float h2 = mul(2.0f, h);
#pragma unroll
    for (int n = 0; n < NEWTON; ++n) {
      const float r0 = resultant(s, v);
      const float dr = dvd(sub(resultant(s, add(v, h)), resultant(s, sub(v, h))), h2);
      v = sub(v, clamp(dvd(r0, floor_abs(dr, 1e-12f)), -0.1f, 0.1f));
    }
    const bool real = fabsf(z[i].im) < mul(add(fabsf(v), 1.0f), 1e-3f);
    const bool pos = v > 1e-6f;

    // the common root u of the two quadratics, and the distances
    const Quad q = quadratics(s, v);
    const float u = dvd(sub(q.c1, q.c2), floor_abs(sub(q.b2, q.b1), 1e-9f));
    const float d1 = __fsqrt_rn(dvd(nz, clamp_min(q.w, 1e-12f)));
    bool ok = real && pos && u > 1e-6f && q.w > 1e-9f;
    const float d[3] = {d1, mul(u, d1), mul(v, d1)};
    float Pc[3][3];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int k = 0; k < 3; ++k) Pc[p][k] = mul(d[p], f[p][k]);
    }

    // triad composition: R = F_c F_w^T, t = P_c1 - R X1
    float Fc[3][3], R[3][3], t[3];
    triad(Pc, Fc);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        float acc = mul(Fc[a][0], Fw[b][0]);
        acc = fused(Fc[a][1], Fw[b][1], acc);
        R[a][b] = fused(Fc[a][2], Fw[b][2], acc);
        ok = ok && isfinite(R[a][b]);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float Rx[3] = {mul(R[a][0], X[0][0]), mul(R[a][1], X[0][1]), mul(R[a][2], X[0][2])};
      t[a] = sub(Pc[0][a], sum3(Rx[0], Rx[1], Rx[2]));
      ok = ok && isfinite(t[a]);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) Rg[9 * i + 3 * a + b] = R[a][b];
      tg[3 * i + a] = t[a];
    }
    okg[i] = ok ? 1 : 0;
  }
}

__global__ void __launch_bounds__(THREADS)
p3p_kernel(const float* __restrict__ X, const float* __restrict__ xy,
           const float* __restrict__ vs, const float* __restrict__ vinv_t,
           const float* __restrict__ seeds, float* __restrict__ R, float* __restrict__ t,
           uint8_t* __restrict__ ok, int H) {
  const long long h = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (h >= H) return;
  solve_sample(X + 9 * h, xy + 6 * h, vs, vinv_t, seeds, R + 36 * h, t + 12 * h, ok + 4 * h);
}

}  // namespace

// Launch on `stream` for H samples: X (H, 3, 3) and xy (H, 3, 2)
// contiguous float32; vs (5,), vinv_t (5, 5) and seeds (4,) complex64 the
// plain version's constants on the device; writes R (H, 4, 3, 3), t (H, 4,
// 3) and ok (H, 4) bytes. Returns cudaGetLastError() (0 on success). No
// synchronisation, no allocation.
extern "C" int p3p_launch(const float* X, const float* xy, const float* vs,
                          const float* vinv_t, const float* seeds, float* R, float* t,
                          uint8_t* ok, int H, void* stream) {
  if (H < 0) return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const int blocks = (int)(((long long)H + THREADS - 1) / THREADS);
  p3p_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(X, xy, vs, vinv_t, seeds, R, t,
                                                           ok, H);
  return (int)cudaGetLastError();
}
