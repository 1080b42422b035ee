// PnP's IRLS Gauss-Newton pose polish for sm_90a: one thread block a
// problem, every round and iteration inside it.
//
// Replaces no TPU kernel. The JAX package's polish (the truncated-Huber
// loop of visualodometry_tpu/estimation/pnp.py around `refine_pose_gn`) is
// batched tensor arithmetic, a 6x6 unrolled Cholesky and `se3_exp`, which
// XLA fuses under `jit`. The port runs eagerly, where the same chain is
// ~300 launches per Gauss-Newton iteration, ~4,300 for 3 rounds of 8 + 3 + 3
// iterations, at ~9-10 us of host time each. This kernel is the port's
// counterpart of that fusion: one launch for the whole polish.
//
// What it computes (ops/pose_polish.py `_polish_pose_torch`), from the
// camera-from-world T0 over N correspondences X <-> (U, V):
//   rounds times:
//     w = min(delta / r, 1) * (r^2 < cut_sq) * valid * (z > 0), r the
//         reprojection error at the round's starting pose, r^2 clamped
//         below at 1e-12
//     iters times (iters0 in the first round, iters_later after):
//       H = sum_n J^T w J, b = sum_n J^T w res (J the 2x6 Jacobian of the
//           pixel under a left twist, as projection_jacobian_point and
//           -so3_hat give it; res the pixel residual)
//       H_jj += 1e-3 H_jj + 1e-9
//       delta = cho_solve(cholesky(H), b), pivots sqrt(max(s, 1e-20))
//       T = se3_exp(-delta) T
// Each thread walks its share of the points (n = tid, tid + 512, ...) and
// sums the 21 entries of H's lower triangle and the 6 of b in registers;
// a warp-shuffle tree and then a fixed-order sum over the warps combine
// them, with no atomics, so two calls agree bit for bit. One thread then
// damps, factors, solves and exponentiates, and publishes T through
// shared memory for the next pass.
//
// Where it may differ from the plain version in the last bits: the sums
// over the points (H and b, the plain version's `einsum`s, whose order is
// PyTorch's) and the two 3-term sums of |phi|^2 and the camera point's
// matrix product. Every other scalar operation is an `_rn` intrinsic in the
// plain version's order, so that nvcc contracts none of them into an FMA;
// a division by a constant is a multiply by its float reciprocal, as
// PyTorch's CUDA division by a Python number is, and `1 / x` is a
// reciprocal. A point of weight 0 is skipped: the plain version adds its
// zero products, which changes nothing while its Jacobian is finite.
//
// What bounds it on an H100: latency. It reads N x 21 bytes once (X, U, V
// and the valid byte: 86 KB, ~0.03 us at 3.35 TB/s at N = 4096) and does
// ~10 MFLOP there (~0.15 us at 67 TFLOP/s). Its time is 14 dependent block
// reductions and the serial 6x6 solves between them. What the design does
// about it: one block keeps the whole loop on one SM, so a pass waits on
// one __syncthreads and no other launch. The points are read through the
// read-only path on every pass and stay in the SM's L1 (86 KB of its
// 256 KB) after the first, so nothing is staged; the weights of a round
// live in shared memory, 4 bytes a point, written and read by the thread
// that owns the point. N, the rounds, the iterations and the scalars are
// run-time arguments: every configuration shares the one kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NH = 21;        // H's lower triangle, row by row
constexpr int NSUM = NH + 6;  // and b
constexpr float TINY = 1e-20f;
constexpr float Z_EPS = 1e-8f;  // project_points' depth floor

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// max(s, lo) and min(s, hi) that let a NaN through, as torch.clamp does
__device__ __forceinline__ float clamp_min(float s, float lo) { return s < lo ? lo : s; }
__device__ __forceinline__ float clamp_max(float s, float hi) { return s > hi ? hi : s; }

// H's packed lower triangle and the Cholesky factor's: (i, j), j <= i
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

struct Cam {
  float fx, fy, cx, cy;
};

// the camera point p = R X + t, its floored depth and its pixel
// (geometry/camera.py project_points); T holds rows 0-2 of the pose
struct Proj {
  float p[3], zs, u, v;
};

__device__ __forceinline__ Proj project(const float (&T)[12], float x0, float x1, float x2,
                                        const Cam& c) {
  Proj q;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    q.p[i] = add(add(add(mul(T[4 * i], x0), mul(T[4 * i + 1], x1)), mul(T[4 * i + 2], x2)),
                 T[4 * i + 3]);
  q.zs = fabsf(q.p[2]) < Z_EPS ? Z_EPS : q.p[2];
  q.u = add(mul(c.fx, dvd(q.p[0], q.zs)), c.cx);
  q.v = add(mul(c.fy, dvd(q.p[1], q.zs)), c.cy);
  return q;
}

// the truncated-Huber weight of one point at the round's starting pose
__device__ __forceinline__ float irls_weight(const Proj& q, float U, float V, bool valid,
                                             float delta, float cut_sq) {
  const float du = sub(q.u, U), dv = sub(q.v, V);
  const float err = add(mul(du, du), mul(dv, dv));
  const float r = __fsqrt_rn(clamp_min(err, 1e-12f));
  float w = clamp_max(mul(__frcp_rn(r), delta), 1.0f);
  w = mul(w, err < cut_sq ? 1.0f : 0.0f);
  w = mul(w, valid ? 1.0f : 0.0f);
  return mul(w, q.p[2] > 0.0f ? 1.0f : 0.0f);
}

// adds one point's J^T w J (lower triangle) and J^T w res to acc
__device__ __forceinline__ void accumulate(const Proj& q, float U, float V, float w,
                                           const Cam& c, float (&acc)[NSUM]) {
  const float px = q.p[0], py = q.p[1], pz = q.p[2];
  const float res[2] = {sub(q.u, U), sub(q.v, V)};
  const float inv_z = __frcp_rn(q.zs);
  const float inv_z2 = mul(inv_z, inv_z);
  const float a = mul(c.fx, inv_z), d = mul(c.fy, inv_z);
  const float b = mul(mul(-c.fx, px), inv_z2), e = mul(mul(-c.fy, py), inv_z2);
  // (d uv / d p) [I | -hat(p)], the products with its zeros left out
  const float J[2][6] = {
      {a, 0.0f, b, mul(b, py), add(mul(a, pz), mul(b, -px)), -mul(a, py)},
      {0.0f, d, e, add(mul(d, -pz), mul(e, py)), -mul(e, px), mul(d, px)},
  };
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    float Jw[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) Jw[k] = mul(J[row][k], w);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
#pragma unroll
      for (int l = 0; l <= k; ++l) acc[tri(k, l)] = __fmaf_rn(Jw[k], J[row][l], acc[tri(k, l)]);
      acc[NH + k] = __fmaf_rn(Jw[k], res[row], acc[NH + k]);
    }
  }
}

// the block's sums of acc into tot (warp 0 holds them after a __syncwarp):
// a shuffle tree in each warp, then the warps' partials in warp order
__device__ __forceinline__ void block_sum(const float (&acc)[NSUM], float* part, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NSUM; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = add(s, __shfl_down_sync(0xffffffffu, s, off));
    if (lane == 0) part[warp * NSUM + k] = s;
  }
  __syncthreads();
  if (threadIdx.x < NSUM) {
    float s = part[threadIdx.x];
    for (int w = 1; w < WARPS; ++w) s = add(s, part[w * NSUM + threadIdx.x]);
    tot[threadIdx.x] = s;
  }
  __syncwarp();
}

// one damped Gauss-Newton update of T (4 x 4, row-major) from the sums:
// refine_pose_gn's damping, cholesky_small, cho_solve_small and
// T <- se3_exp(-delta) T
__device__ void gn_update(const float* tot, float* T) {
  float L[NH];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float h = tot[tri(j, j)];
    float s = add(add(h, mul(h, 1e-3f)), 1e-9f);
#pragma unroll
    for (int k = 0; k < j; ++k) s = sub(s, mul(L[tri(j, k)], L[tri(j, k)]));
    const float dj = __fsqrt_rn(clamp_min(s, TINY));
    L[tri(j, j)] = dj;
    const float inv_d = __frcp_rn(dj);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float r = tot[tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) r = sub(r, mul(L[tri(i, k)], L[tri(j, k)]));
      L[tri(i, j)] = mul(r, inv_d);
    }
  }
  float x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = tot[NH + i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = sub(s, mul(L[tri(i, k)], x[k]));
    x[i] = dvd(s, L[tri(i, i)]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = sub(s, mul(L[tri(k, i)], x[k]));
    x[i] = dvd(s, L[tri(i, i)]);
  }

  // se3_exp(-delta): rho = -x[0:3], phi = -x[3:6]
  const float rho[3] = {-x[0], -x[1], -x[2]};
  const float f0 = -x[3], f1 = -x[4], f2 = -x[5];
  const float theta_sq = add(add(mul(f0, f0), mul(f1, f1)), mul(f2, f2));
  const float theta = __fsqrt_rn(add(theta_sq, 1e-16f));
  const bool small = theta_sq < 1e-8f;
  const float W[3][3] = {{0.0f, -f2, f1}, {f2, 0.0f, -f0}, {-f1, f0, 0.0f}};
  float W2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[i][j] = add(add(mul(W[i][0], W[0][j]), mul(W[i][1], W[1][j])), mul(W[i][2], W[2][j]));
  const float ca = small ? sub(1.0f, mul(theta_sq, 1.0f / 6.0f)) : dvd(sinf(theta), theta);
  const float cb = small ? sub(0.5f, mul(theta_sq, 1.0f / 24.0f))
                         : dvd(sub(1.0f, cosf(theta)), theta_sq);
  const float cc = small ? sub(1.0f / 6.0f, mul(theta_sq, 1.0f / 120.0f))
                         : dvd(sub(theta, sinf(theta)), mul(theta_sq, theta));
  float E[4][4];  // make_T(so3_exp(phi), V rho)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      E[i][j] = add(add(eye, mul(ca, W[i][j])), mul(cb, W2[i][j]));
      const float v = add(add(eye, mul(cb, W[i][j])), mul(cc, W2[i][j]));
      t = j == 0 ? mul(v, rho[0]) : add(t, mul(v, rho[j]));
    }
    E[i][3] = t;
    E[3][i] = 0.0f;
  }
  E[3][3] = 1.0f;
  float out[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = mul(E[i][0], T[j]);
#pragma unroll
      for (int k = 1; k < 4; ++k) s = add(s, mul(E[i][k], T[4 * k + j]));
      out[4 * i + j] = s;
    }
#pragma unroll
  for (int i = 0; i < 16; ++i) T[i] = out[i];
}

__global__ void __launch_bounds__(THREADS, 1)
pose_polish_kernel(const float* __restrict__ T0, const float* __restrict__ X,
                   const float* __restrict__ uv, const uint8_t* __restrict__ valid,
                   const float* __restrict__ K, float* __restrict__ T_out, int n, int rounds,
                   int iters0, int iters_later, float delta, float cut_sq) {
  extern __shared__ float w_s[];  // the round's weights, one a point
  __shared__ float T_s[16];
  __shared__ float part[WARPS * NSUM];
  __shared__ float tot[NSUM];
  const int tid = threadIdx.x;
  if (tid < 16) T_s[tid] = T0[tid];
  const Cam cam{__ldg(K + 0), __ldg(K + 4), __ldg(K + 2), __ldg(K + 5)};
  __syncthreads();

  for (int rnd = 0; rnd < rounds; ++rnd) {
    float T[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) T[i] = T_s[i];
    for (int i = tid; i < n; i += THREADS) {
      const Proj q = project(T, __ldg(X + 3 * i), __ldg(X + 3 * i + 1), __ldg(X + 3 * i + 2), cam);
      w_s[i] = irls_weight(q, __ldg(uv + 2 * i), __ldg(uv + 2 * i + 1), __ldg(valid + i) != 0,
                           delta, cut_sq);
    }
    const int iters = rnd == 0 ? iters0 : iters_later;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int i = 0; i < 12; ++i) T[i] = T_s[i];
      float acc[NSUM];
#pragma unroll
      for (int k = 0; k < NSUM; ++k) acc[k] = 0.0f;
      for (int i = tid; i < n; i += THREADS) {
        const float w = w_s[i];
        if (w == 0.0f) continue;
        const Proj q =
            project(T, __ldg(X + 3 * i), __ldg(X + 3 * i + 1), __ldg(X + 3 * i + 2), cam);
        accumulate(q, __ldg(uv + 2 * i), __ldg(uv + 2 * i + 1), w, cam, acc);
      }
      block_sum(acc, part, tot);
      if (tid == 0) gn_update(tot, T_s);
      __syncthreads();
    }
  }
  if (tid < 16) T_out[tid] = T_s[tid];
}

}  // namespace

// Launch on `stream` for one problem: T0 (4, 4), X (n, 3), uv (n, 2), valid
// (n,) bytes, K (3, 3), all contiguous float32 but `valid`; writes T_out
// (4, 4). Returns cudaGetLastError() (0 on success). No synchronisation,
// no allocation.
extern "C" int pose_polish_launch(const float* T0, const float* X, const float* uv,
                                  const uint8_t* valid, const float* K, float* T_out, int n,
                                  int rounds, int iters0, int iters_later, float delta,
                                  float cut_sq, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pose_polish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pose_polish_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      T0, X, uv, valid, K, T_out, n, rounds, iters0, iters_later, delta, cut_sq);
  return (int)cudaGetLastError();
}
