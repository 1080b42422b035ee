// Smallest eigenvector of small symmetric matrices for sm_90a: one thread
// a matrix, the whole shifted inverse iteration in registers.
//
// Replaces no TPU kernel. The JAX package's `smallest_eigvec` for n > 3
// (visualodometry_tpu/geometry/linalg.py) is an unrolled Cholesky and 24
// inverse-iteration passes of batched scalar arithmetic, which XLA fuses
// under `jit`. The port runs eagerly, where the same chain is one launch
// per scalar operation: ~920 launches at n = 4 and ~7,700 at n = 12, at
// ~12-15 us of host time each. This kernel is the port's counterpart of
// that fusion: one launch for the whole (..., n, n) batch.
//
// What it computes, for each symmetric (n, n) matrix M of a flattened
// batch, in the plain path's order (ops/small_eig.py `_smallest_eigvec_torch`):
//   tr  = M[0][0] + ... + M[n-1][n-1]          (summed in index order)
//   eps = |tr| * (1 / n) * 1e-6 + 1e-12
//   L   = cholesky(M + eps * I), each pivot sqrt(max(s, 1e-20))
//   v   = 1 + 0.01 * i
//   iters times: v = (L L^T)^-1 v, then v /= max(|v|, 1e-20)
// Every scalar operation of the plain path is one kernel there and is
// rounded on its own, so each is an `_rn` intrinsic here: nvcc contracts
// none of them into an FMA. The factor keeps the plain path's reciprocal
// then multiply (`1.0 / d` is `reciprocal(d) * 1.0` in PyTorch, and a
// tensor divided by the Python int n is a multiply by the float 1 / n on
// CUDA); the solves and the normalisation keep true division. The clamps
// let a NaN through, as `torch.clamp` does. Only the two sums (the trace
// and the squared norm) may be ordered otherwise by PyTorch's reductions,
// so the kernel agrees with the plain path on the card to a tolerance and
// not always bit for bit.
//
// What bounds it on an H100: latency. The data is tiny (147 KB at the DLT
// PnP's (256, 12, 12), 262 KB at triangulation's (4096, 4, 4)), and each
// thread runs a dependent chain of 24 x 2n divisions. What the design does
// about it: nothing is gained by more threads a matrix, whose passes are
// sequential; the gain is in launches. Blocks of one warp spread the batch
// over as many SMs as it fills. The block's matrices are staged through
// shared memory so that the loads and stores are coalesced; the row stride
// there is odd, so a thread's reads of its own matrix hit distinct banks.
// The factor lives in registers (n (n + 1) / 2 floats, 136 at n = 16), the
// vector in place through both substitutions; every index is a
// compile-time constant in the template on n (4 <= n <= 16), and the pass
// loop is not unrolled, so the body stays small.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;  // matrices a block
constexpr float TINY = 1e-20f;

// max(s, TINY) that lets a NaN through, as torch.clamp(min=) does
__device__ __forceinline__ float clamp_tiny(float s) { return s < TINY ? TINY : s; }

// the packed lower triangle: L(i, j), j <= i
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <int N>
__global__ void __launch_bounds__(THREADS)
small_eig_kernel(const float* __restrict__ M, float* __restrict__ out, int batch,
                 int iters) {
  constexpr int NN = N * N;
  constexpr int MS = NN | 1;  // odd row stride of a staged matrix
  constexpr int VS = N | 1;   // odd row stride of a staged vector
  __shared__ float tile[THREADS * MS];

  const long long first = (long long)blockIdx.x * THREADS;
  const int count = (int)min((long long)THREADS, (long long)batch - first);
  const float* src = M + first * NN;
  for (int e = threadIdx.x; e < count * NN; e += THREADS)
    tile[(e / NN) * MS + e % NN] = src[e];
  __syncthreads();

  const int t = threadIdx.x;
  float v[N];
  if (t < count) {
    const float* A = tile + t * MS;
    float tr = A[0];
#pragma unroll
    for (int i = 1; i < N; ++i) tr = __fadd_rn(tr, A[i * N + i]);
    const float eps =
        __fadd_rn(__fmul_rn(__fmul_rn(fabsf(tr), 1.0f / N), 1e-6f), 1e-12f);
    // M + eps * I, written as the plain path's sum so that a NaN or an
    // infinite eps reaches the off-diagonal entries as it does there
    const float eps_off = __fmul_rn(eps, 0.0f);

    float L[N * (N + 1) / 2];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = __fadd_rn(A[j * N + j], eps);
#pragma unroll
      for (int k = 0; k < j; ++k) s = __fsub_rn(s, __fmul_rn(L[tri(j, k)], L[tri(j, k)]));
      const float d = __fsqrt_rn(clamp_tiny(s));
      L[tri(j, j)] = d;
      const float inv_d = __frcp_rn(d);
#pragma unroll
      for (int i = j + 1; i < N; ++i) {
        float r = __fadd_rn(A[i * N + j], eps_off);
#pragma unroll
        for (int k = 0; k < j; ++k) r = __fsub_rn(r, __fmul_rn(L[tri(i, k)], L[tri(j, k)]));
        L[tri(i, j)] = __fmul_rn(r, inv_d);
      }
    }

#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __fadd_rn(__fmul_rn((float)i, 0.01f), 1.0f);

#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
      // L y = v, then L^T x = y, each in place
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float s = v[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = __fsub_rn(s, __fmul_rn(L[tri(i, k)], v[k]));
        v[i] = __fdiv_rn(s, L[tri(i, i)]);
      }
#pragma unroll
      for (int i = N - 1; i >= 0; --i) {
        float s = v[i];
#pragma unroll
        for (int k = i + 1; k < N; ++k) s = __fsub_rn(s, __fmul_rn(L[tri(k, i)], v[k]));
        v[i] = __fdiv_rn(s, L[tri(i, i)]);
      }
      float ss = __fmul_rn(v[0], v[0]);
#pragma unroll
      for (int i = 1; i < N; ++i) ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
      const float nrm = clamp_tiny(__fsqrt_rn(ss));
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = __fdiv_rn(v[i], nrm);
    }
  }
  __syncthreads();  // every thread is done reading the staged matrices
  if (t < count) {
#pragma unroll
    for (int i = 0; i < N; ++i) tile[t * VS + i] = v[i];
  }
  __syncthreads();
  float* dst = out + first * N;
  for (int e = threadIdx.x; e < count * N; e += THREADS)
    dst[e] = tile[(e / N) * VS + e % N];
}

template <int N>
int launch(const float* M, float* out, int batch, int iters, cudaStream_t st) {
  const int blocks = (int)(((long long)batch + THREADS - 1) / THREADS);
  small_eig_kernel<N><<<blocks, THREADS, 0, st>>>(M, out, batch, iters);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` for `batch` contiguous (n, n) float32 matrices, n in
// 4 .. 16; writes `batch` contiguous (n,) vectors. Returns
// cudaGetLastError() (0 on success). No synchronisation, no allocation.
extern "C" int small_eig_launch(const float* M, float* out, int batch, int n,
                                int iters, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 4: return launch<4>(M, out, batch, iters, st);
    case 5: return launch<5>(M, out, batch, iters, st);
    case 6: return launch<6>(M, out, batch, iters, st);
    case 7: return launch<7>(M, out, batch, iters, st);
    case 8: return launch<8>(M, out, batch, iters, st);
    case 9: return launch<9>(M, out, batch, iters, st);
    case 10: return launch<10>(M, out, batch, iters, st);
    case 11: return launch<11>(M, out, batch, iters, st);
    case 12: return launch<12>(M, out, batch, iters, st);
    case 13: return launch<13>(M, out, batch, iters, st);
    case 14: return launch<14>(M, out, batch, iters, st);
    case 15: return launch<15>(M, out, batch, iters, st);
    case 16: return launch<16>(M, out, batch, iters, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
