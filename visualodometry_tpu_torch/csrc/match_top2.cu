// Top-2 squared-L2 descriptor matching (kNN, k = 2) for sm_90a.
//
// Replaces: visualodometry_tpu/ops/match_pallas.py, `_match_kernel` and its
// wrapper `match_top2_pallas` (the Pallas TPU kernel).
//
// Computes, for every query row a of desc0 (n0, d) against every train row
// b of desc1 (n1, d): d2 = max(|a|^2 + |b|^2 - 2 a.b, 0), with d2 = 1e30 for
// train rows whose valid1 flag is 0. Outputs per query: the best d2, the
// second-best d2 (minimum over all columns except the argbest, so a
// duplicate of the best distance is the second) and the argbest (lowest
// index on ties) -- the semantics of `_top2_jnp` (frontend/matcher.py).
//
// What bounds it on an H100: operations. At the main path's 4096 x 4096 x
// 128 it is 4.29 GFLOP against 4.2 MB of input, far above the card's
// operations-per-byte balance point, and the products run in float32 on
// the CUDA cores (67 TFLOP/s peak), not the tensor cores: the port keeps
// float32 products so that the kernel agrees with the float32 reference
// matcher; the TPU kernel's bf16 products are not carried over.
//
// What the design does about it: the (n0, n1) distance matrix never
// reaches device memory (the point of the TPU kernel). One block owns 32
// query rows, staged once in shared memory, transposed so a thread reads
// its four rows' values with one broadcast 16-byte load. The block walks
// the train set in tiles of 128 rows, staged in 32-dimension chunks
// through shared memory; each of its 8 warps owns 4 query rows and each
// lane 4 train columns (a 4 x 4 register tile of FMAs). The selection is
// fused: each lane keeps a running (best, second, argbest) per row in
// registers, and a warp-shuffle merge combines the lanes at the end. Train
// norms are accumulated from the same staged values, so the kernel reads
// each input once from device memory per block and writes 12 bytes per
// query. A first, simple kernel: no tensor cores, no TMA, no split of the
// train set across blocks (128 blocks for 4096 queries on 132 SMs).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;        // query rows per block
constexpr int BN = 128;       // train rows per tile
constexpr int BK = 32;        // descriptor dimensions per staged chunk
constexpr int THREADS = 256;  // 8 warps; warp w owns rows 4w .. 4w+3
constexpr int RPT = 4;        // query rows per thread
constexpr int CPT = 4;        // train columns per thread (lane + 32 j)
constexpr int QLD = BM + 4;   // transposed query tile stride (16-byte rows)
constexpr int TLD = BN + 1;   // train chunk stride (conflict-free stores)
constexpr float BIG = 1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Top2 {
  float b1;
  float b2;
  int i1;
};

// Columns arrive in increasing order per thread, so a tie with the best
// keeps the earlier (lower) index and becomes the second.
__device__ __forceinline__ void push(Top2& s, float d, int c) {
  if (d < s.b1) {
    s.b2 = s.b1;
    s.b1 = d;
    s.i1 = c;
  } else if (d < s.b2) {
    s.b2 = d;
  }
}

__device__ __forceinline__ void merge(Top2& s, float ob1, float ob2, int oi1) {
  const bool other = (ob1 < s.b1) || (ob1 == s.b1 && oi1 < s.i1);
  if (other) {
    s.b2 = fminf(ob2, s.b1);
    s.b1 = ob1;
    s.i1 = oi1;
  } else {
    s.b2 = fminf(s.b2, ob1);
  }
}

__global__ void __launch_bounds__(THREADS)
match_top2_kernel(const float* __restrict__ d0, const float* __restrict__ d1,
                  const uint8_t* __restrict__ valid1,
                  float* __restrict__ best, float* __restrict__ second,
                  int* __restrict__ idx, int n0, int n1, int d) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [d][QLD]: Qs[k * QLD + m] = d0[row0 + m, k]
  float* Ts = smem + d * QLD;  // [BK][TLD]: Ts[k * TLD + c] = d1[c0 + c, k0 + k]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * BM;
  const int m0 = warp * RPT;

  for (int e = tid; e < BM * d; e += THREADS) {
    const int m = e / d;
    const int k = e - m * d;
    const int r = row0 + m;
    Qs[k * QLD + m] = (r < n0) ? d0[(size_t)r * d + k] : 0.f;
  }
  __syncthreads();

  float sq0[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float s = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float v = Qs[k * QLD + m0 + i];
      s = fmaf(v, v, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    sq0[i] = s;
  }

  Top2 st[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    st[i].b1 = INFINITY;
    st[i].b2 = BIG;
    st[i].i1 = 0x7fffffff;
  }

  for (int c0 = 0; c0 < n1; c0 += BN) {
    float acc[RPT][CPT];
    float nb[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      nb[j] = 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < d; k0 += BK) {
      __syncthreads();  // the previous chunk has been consumed
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int c = e / BK;
        const int k = e - c * BK;
        const int col = c0 + c;
        const int kk = k0 + k;
        Ts[k * TLD + c] = (col < n1 && kk < d) ? d1[(size_t)col * d + kk] : 0.f;
      }
      __syncthreads();
      const int kn = min(BK, d - k0);
      for (int k = 0; k < kn; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(Qs + (k0 + k) * QLD + m0);
        const float av[RPT] = {a.x, a.y, a.z, a.w};
        float bv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) bv[j] = Ts[k * TLD + lane + 32 * j];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          nb[j] = fmaf(bv[j], bv[j], nb[j]);
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = c0 + lane + 32 * j;
      if (col < n1) {
        const bool ok = valid1[col] != 0;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float dd = fmaxf(sq0[i] + nb[j] - 2.f * acc[i][j], 0.f);
          push(st[i], ok ? dd : BIG, col);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob1 = __shfl_xor_sync(FULL, st[i].b1, o);
      const float ob2 = __shfl_xor_sync(FULL, st[i].b2, o);
      const int oi1 = __shfl_xor_sync(FULL, st[i].i1, o);
      merge(st[i], ob1, ob2, oi1);
    }
    const int r = row0 + m0 + i;
    if (lane == 0 && r < n0) {
      best[r] = st[i].b1;
      second[r] = st[i].b2;
      idx[r] = st[i].i1;
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int match_top2_launch(const float* d0, const float* d1,
                                 const uint8_t* valid1, float* best,
                                 float* second, int* idx, int n0, int n1,
                                 int d, void* stream) {
  if (n0 <= 0) return 0;
  const size_t smem = (size_t)(d * QLD + BK * TLD) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        match_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n0 + BM - 1) / BM;
  match_top2_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      d0, d1, valid1, best, second, idx, n0, n1, d);
  return (int)cudaGetLastError();
}
