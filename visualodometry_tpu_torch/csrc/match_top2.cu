// Top-2 squared-L2 descriptor matching (kNN, k = 2) for sm_90a: 3xTF32
// products on the tensor cores (`wgmma`), the train set split across blocks.
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
// What bounds it on an H100: tensor operations. The ratio test needs
// float32-grade distances, so every float32 value x is split into
// big = tf32(x) and small = tf32(x - big), both rounded to nearest
// (`cvt.rna`; the tensor core itself would truncate), and a.b is formed as
// small*big + big*small + big*big with float32 accumulation ("3xTF32").
// At the main path's 4096 x 4096 x 128 that is 3 x 4.29 = 12.9 GFLOP at
// the 495 TFLOP/s dense TF32 peak, 0.026 ms, against 4.2 MB of input.
//
// What the design does about it:
//  - `wgmma.mma_async.m64n128k8.f32.tf32.tf32`, both operands K-major in
//    shared memory in the 128-byte-swizzled layout (one swizzled row is 32
//    floats of depth), the sums in 64 registers a thread. A block is two
//    warpgroups, each owning 64 query rows, sharing every train tile.
//  - The split is made once per staged element, on the way from device
//    memory through registers into shared memory; the norms |a|^2, |b|^2
//    are summed from the same float32 values there. Up to depth 128 the
//    block's 128 query rows are staged once and stay; a deeper query tile
//    is streamed in 32-float chunks beside the train chunks.
//  - Train chunks (128 rows x 32 floats, big and small) are double
//    buffered: the loads of chunk i + 1 are started before the MMAs of
//    chunk i and converted and stored while those run.
//  - The selection is fused into the epilogue: each thread turns its
//    accumulator fragment into distances and keeps a running (best, second,
//    argbest) for its two rows; the four lanes that share a row merge by
//    shuffle. The (n0, n1) matrix never reaches device memory.
//  - The grid is query tiles x S train splits, S chosen by the wrapper so
//    that the blocks fill the SMs (4 at the main path: 32 x 4 blocks).
//    Each block writes its partial triple to scratch; `merge_splits_kernel`
//    combines the S partials of a row in split order with the same rule as
//    the in-block merge (lower index wins a tie, a duplicate of the best
//    is the second). No float atomics: the result does not depend on the
//    order in which blocks run.
//  - Any n0, n1 and d: rows past the end are staged as zeros and never
//    pushed; the depth is zero-padded to a multiple of 8 (a zero adds
//    exactly nothing).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // query rows per block: two warpgroups of 64
constexpr int BN = 128;       // train rows per tile (the wgmma's N)
constexpr int BK = 32;        // floats per chunk: one 128-byte swizzled row
constexpr int THREADS = 256;
constexpr int SLAB = 128 * 128;  // bytes: 128 rows x one swizzled row
constexpr int PAIR = 2 * SLAB;   // a chunk's big slab, then its small slab
constexpr int MAX_RESIDENT_CHUNKS = 4;  // query tile stays up to d = 128
constexpr int MAX_SPLITS = 32;
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
  const bool lt = d < s.b1;
  s.b2 = lt ? s.b1 : fminf(s.b2, d);
  s.i1 = lt ? c : s.i1;
  s.b1 = fminf(s.b1, d);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float tf32_round(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// Shared-memory matrix descriptor of a K-major, 128-byte-swizzled slab:
// rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t slab_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3ffffu) >> 4);
  d |= (uint64_t)1 << 16;            // leading offset: unused when swizzled
  d |= (uint64_t)(1024 >> 4) << 32;  // stride between 8-row groups
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

// acc (64 x 128 per warpgroup) = or += A (64 x 8) . B (128 x 8)^T
__device__ __forceinline__ void wgmma_tf32(float (&c)[64], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]),
        "+f"(c[5]), "+f"(c[6]), "+f"(c[7]), "+f"(c[8]), "+f"(c[9]),
        "+f"(c[10]), "+f"(c[11]), "+f"(c[12]), "+f"(c[13]), "+f"(c[14]),
        "+f"(c[15]), "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]), "+f"(c[24]),
        "+f"(c[25]), "+f"(c[26]), "+f"(c[27]), "+f"(c[28]), "+f"(c[29]),
        "+f"(c[30]), "+f"(c[31]), "+f"(c[32]), "+f"(c[33]), "+f"(c[34]),
        "+f"(c[35]), "+f"(c[36]), "+f"(c[37]), "+f"(c[38]), "+f"(c[39]),
        "+f"(c[40]), "+f"(c[41]), "+f"(c[42]), "+f"(c[43]), "+f"(c[44]),
        "+f"(c[45]), "+f"(c[46]), "+f"(c[47]), "+f"(c[48]), "+f"(c[49]),
        "+f"(c[50]), "+f"(c[51]), "+f"(c[52]), "+f"(c[53]), "+f"(c[54]),
        "+f"(c[55]), "+f"(c[56]), "+f"(c[57]), "+f"(c[58]), "+f"(c[59]),
        "+f"(c[60]), "+f"(c[61]), "+f"(c[62]), "+f"(c[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous MMAs.
__device__ __forceinline__ void fence_acc(float (&c)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(c[i])::"memory");
}

// 16 consecutive floats of one row: a thread's share of a 32-float chunk.
struct Frag {
  float4 v[4];
};

__device__ __forceinline__ Frag load_frag(const float* __restrict__ base,
                                          int row, int nrows, int d, int k0,
                                          bool vec) {
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * i;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < nrows && k < d) {
      const float* p = base + (size_t)row * d + k;
      if (vec) {  // d % 4 == 0 and a 16-byte-aligned base: all in or all out
        v = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        v.x = __ldg(p);
        if (k + 1 < d) v.y = __ldg(p + 1);
        if (k + 2 < d) v.z = __ldg(p + 2);
        if (k + 3 < d) v.w = __ldg(p + 3);
      }
    }
    f.v[i] = v;
  }
  return f;
}

// Split the fragment and store it into the chunk's big and small slabs at
// (row, 16-byte columns 4 * half ..), swizzled; returns its sum of squares.
__device__ __forceinline__ float store_frag(uint8_t* pair, int row, int half,
                                            const Frag& f) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = f.v[i];
    const float4 b = make_float4(tf32_round(v.x), tf32_round(v.y),
                                 tf32_round(v.z), tf32_round(v.w));
    const float4 r = make_float4(tf32_round(v.x - b.x), tf32_round(v.y - b.y),
                                 tf32_round(v.z - b.z), tf32_round(v.w - b.w));
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
    const int off = row * 128 + (((4 * half + i) ^ (row & 7)) << 4);
    *reinterpret_cast<float4*>(pair + off) = b;
    *reinterpret_cast<float4*>(pair + SLAB + off) = r;
  }
  return s;
}

__global__ void __launch_bounds__(THREADS, 1)
match_top2_kernel(const float* __restrict__ d0, const float* __restrict__ d1,
                  const uint8_t* __restrict__ valid1, float* __restrict__ pb1,
                  float* __restrict__ pb2, int* __restrict__ pi1, int n0,
                  int n1, int d, int vec0, int vec1) {
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;    // warpgroup: query rows 64 wg .. 64 wg + 63
  const int srow = tid >> 1;  // the row this thread stages, of 128
  const int half = tid & 1;   // and which 16 floats of its 32-float chunk
  const int row0 = blockIdx.x * BM;

  const int ksteps = (d + 7) / 8;
  const int nchunks = (d + BK - 1) / BK;
  const bool resident = nchunks <= MAX_RESIDENT_CHUNKS;
  const int qslots = resident ? nchunks : 2;

  // slabs start on a 1024-byte boundary, as the swizzle wants
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* Qa = smem;                  // qslots pairs
  uint8_t* Ta = smem + qslots * PAIR;  // 2 pairs
  float* nbv = reinterpret_cast<float*>(Ta + 2 * PAIR);  // [2][BN]
  float* sq0s = nbv + 2 * BN;                            // [BM]

  const int ttiles = (n1 + BN - 1) / BN;
  const int S = gridDim.y;
  const int t_begin = (int)((long long)ttiles * blockIdx.y / S);
  const int t_end = (int)((long long)ttiles * (blockIdx.y + 1) / S);
  const int n_it = (t_end - t_begin) * nchunks;

  float sq0p = 0.f;  // this thread's share of |a|^2 of query row srow
  float sq1p = 0.f;  // and of |b|^2 of the train row it stages

  auto store_q = [&](int c, int slot, const Frag& f) {
    sq0p += store_frag(Qa + slot * PAIR, srow, half, f);
    if (c == nchunks - 1) {
      const float tot = sq0p + __shfl_xor_sync(FULL, sq0p, 1);
      if (half == 0) sq0s[srow] = tot;
    }
  };
  // train chunk g of this block's walk: tile t_begin + g / nchunks
  auto load_t = [&](int g, int& ok) {
    const int tile = t_begin + g / nchunks;
    const int c = g - (g / nchunks) * nchunks;
    const int col = tile * BN + srow;
    ok = (col < n1) ? (int)__ldg(valid1 + col) : 0;
    return load_frag(d1, col, n1, d, c * BK + 16 * half, vec1);
  };
  auto store_t = [&](int g, const Frag& f, int ok) {
    const int tile = t_begin + g / nchunks;
    const int c = g - (g / nchunks) * nchunks;
    const float s = store_frag(Ta + (g & 1) * PAIR, srow, half, f);
    sq1p = (c == 0) ? s : sq1p + s;
    if (c == nchunks - 1) {
      const float tot = sq1p + __shfl_xor_sync(FULL, sq1p, 1);
      // a norm is never negative: -1 marks an invalid train row
      if (half == 0) nbv[(tile & 1) * BN + srow] = ok ? tot : -1.f;
    }
  };

  Top2 st[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st[h].b1 = INFINITY;
    st[h].b2 = BIG;
    st[h].i1 = 0x7fffffff;
  }

  if (n_it > 0) {
    if (resident) {
      for (int c = 0; c < nchunks; ++c)
        store_q(c, c, load_frag(d0, row0 + srow, n0, d, c * BK + 16 * half, vec0));
    } else {
      store_q(0, 0, load_frag(d0, row0 + srow, n0, d, 16 * half, vec0));
    }
    int ok;
    const Frag f = load_t(0, ok);
    store_t(0, f, ok);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  float acc[64];  // one chunk's products, summed by the tensor core
  float sum[64];  // the tile's: chunks added in float32, round to nearest
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
  // the rows and columns of this thread's accumulator fragment
  const int frow = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int fcol = 2 * (lane & 3);

  for (int it = 0; it < n_it; ++it) {
    const int tile = t_begin + it / nchunks;
    const int c = it - (it / nchunks) * nchunks;
    const bool more = it + 1 < n_it;
    const int cn = (c + 1 == nchunks) ? 0 : c + 1;  // the next chunk's depth
    const bool next_q = more && !resident;

    Frag ft, fq;
    int ok = 0;
    if (more) ft = load_t(it + 1, ok);
    if (next_q) fq = load_frag(d0, row0 + srow, n0, d, cn * BK + 16 * half, vec0);

    const uint32_t qa =
        smem_u32(Qa + (resident ? c : (it & 1)) * PAIR) + wg * 64 * 128;
    const uint32_t ta = smem_u32(Ta + (it & 1) * PAIR);
    const uint64_t q_big = slab_desc(qa), q_small = slab_desc(qa + SLAB);
    const uint64_t t_big = slab_desc(ta), t_small = slab_desc(ta + SLAB);
    const int ks_n = min(4, ksteps - 4 * c);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // A chunk's sum starts from zero in the tensor core, whose float32
    // accumulation truncates: short sums of small partial products lose
    // little, and the chunks are added below with round-to-nearest. The
    // small cross terms go in first, the large product last. 8 floats are
    // 32 bytes along the swizzled row: 2 in descriptor units.
    for (int ks = 0; ks < ks_n; ++ks) {
      wgmma_tf32(acc, q_small + 2 * ks, t_big + 2 * ks, ks != 0);
      wgmma_tf32(acc, q_big + 2 * ks, t_small + 2 * ks, 1);
    }
    for (int ks = 0; ks < ks_n; ++ks)
      wgmma_tf32(acc, q_big + 2 * ks, t_big + 2 * ks, 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");

    // while the MMAs run: split and store the next chunk into the other
    // buffer, which the MMAs of the step before have finished reading
    if (more) store_t(it + 1, ft, ok);
    if (next_q) {
      // only the first tile's pass over the query chunks sums |a|^2
      if (it + 1 < nchunks) {
        store_q(cn, (it + 1) & 1, fq);
      } else {
        store_frag(Qa + ((it + 1) & 1) * PAIR, srow, half, fq);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = (c == 0) ? acc[i] : sum[i] + acc[i];

    if (c == nchunks - 1) {
      // epilogue: distances of this tile, pushed into the running top-2
      const float* nb = nbv + (tile & 1) * BN;
      const float a0 = sq0s[frow], a1 = sq0s[frow + 8];
      const int c0 = tile * BN + fcol;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 n2 = *reinterpret_cast<const float2*>(nb + 8 * j + fcol);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int col = c0 + 8 * j + p;
          const float nbp = p ? n2.y : n2.x;
          if (col < n1) {
            const float x0 = sum[4 * j + p], x1 = sum[4 * j + 2 + p];
            const float e0 = fmaxf(fmaf(-2.f, x0, a0 + nbp), 0.f);
            const float e1 = fmaxf(fmaf(-2.f, x1, a1 + nbp), 0.f);
            push(st[0], nbp < 0.f ? BIG : e0, col);
            push(st[1], nbp < 0.f ? BIG : e1, col);
          }
        }
      }
    }
    __syncthreads();
  }

  // the four lanes of a quad hold the same two rows: merge, lane 0 writes
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float ob1 = __shfl_xor_sync(FULL, st[h].b1, o);
      const float ob2 = __shfl_xor_sync(FULL, st[h].b2, o);
      const int oi1 = __shfl_xor_sync(FULL, st[h].i1, o);
      merge(st[h], ob1, ob2, oi1);
    }
    const int r = row0 + frow + 8 * h;
    if ((lane & 3) == 0 && r < n0) {
      const size_t o = (size_t)blockIdx.y * n0 + r;
      pb1[o] = st[h].b1;
      pb2[o] = st[h].b2;
      pi1[o] = st[h].i1;
    }
  }
}

// Combine the S partial triples of each query row, in split order.
__global__ void merge_splits_kernel(const float* __restrict__ pb1,
                                    const float* __restrict__ pb2,
                                    const int* __restrict__ pi1,
                                    float* __restrict__ best,
                                    float* __restrict__ second,
                                    int* __restrict__ idx, int n0, int S) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n0) return;
  Top2 s = {INFINITY, BIG, 0x7fffffff};
  for (int k = 0; k < S; ++k) {
    const size_t o = (size_t)k * n0 + r;
    merge(s, pb1[o], pb2[o], pi1[o]);
  }
  best[r] = s.b1;
  second[r] = s.b2;
  idx[r] = s.i1;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). `scratch`
// holds 3 * splits * n0 32-bit words: the blocks' partial best, second and
// argbest. `splits` is between 1 and 32 and at most the number of 128-row
// train tiles.
extern "C" int match_top2_launch(const float* d0, const float* d1,
                                 const uint8_t* valid1, float* best,
                                 float* second, int* idx, void* scratch,
                                 int n0, int n1, int d, int splits,
                                 void* stream) {
  if (n0 <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int ttiles = (n1 + BN - 1) / BN;
  if (d < 1 || splits < 1 || splits > MAX_SPLITS ||
      splits > (ttiles > 1 ? ttiles : 1))
    return (int)cudaErrorInvalidValue;
  float* pb1 = static_cast<float*>(scratch);
  float* pb2 = pb1 + (size_t)splits * n0;
  int* pi1 = reinterpret_cast<int*>(pb2 + (size_t)splits * n0);

  const int nchunks = (d + BK - 1) / BK;
  const int qslots = nchunks <= MAX_RESIDENT_CHUNKS ? nchunks : 2;
  const int smem = 1024 + (qslots + 2) * PAIR + (2 * BN + BM) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      match_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec0 = (d % 4 == 0) && ((uintptr_t)d0 % 16 == 0);
  const int vec1 = (d % 4 == 0) && ((uintptr_t)d1 % 16 == 0);
  const dim3 grid((n0 + BM - 1) / BM, splits);
  match_top2_kernel<<<grid, THREADS, smem, st>>>(d0, d1, valid1, pb1, pb2, pi1,
                                                 n0, n1, d, vec0, vec1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_splits_kernel<<<(n0 + 255) / 256, 256, 0, st>>>(pb1, pb2, pi1, best,
                                                        second, idx, n0, splits);
  return (int)cudaGetLastError();
}
