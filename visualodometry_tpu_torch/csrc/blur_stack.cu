// Gaussian blur stack for sm_90a: (B, H, W) bases -> (B, C, H, W).
//
// Replaces: visualodometry_tpu/ops/pyramid.py, `_blur_stack_kernel` and its
// wrappers `_blur_stack_batched` / `blur_stack_pallas` (the Pallas TPU
// kernel).
//
// Computes, for every channel c with the T = 2R + 1 taps w_c,
//   h_c[y, x]   = sum_t w_c[t] * base[clamp(y), clamp(x + t - R)]
//   out_c[y, x] = sum_t w_c[t] * h_c[clamp(y + t - R), x]
// i.e. the edge-padded separable convolution, all channels at one radius.
// Float32 throughout; every sum starts at tap 0 and accumulates with fmaf
// in tap order, so a pixel's value depends on neither the batch size nor
// the tile it falls in.
//
// What bounds it on an H100: operations. Per output value the two passes
// need 2 * T multiply-adds (62 at T = 31) against 4 * (1 + C) / C bytes of
// traffic, so the float32 CUDA-core rate (67 TFLOP/s), not the memory rate,
// is the floor at C = 5. In practice the shared-memory loads that feed the
// FMAs bind first.
//
// What the design does about it: the TPU kernel turned the blur into
// block-band matmuls because its matrix unit was the only fast unit; here
// the direct stencil is natural. One block owns a TH x TW output tile of
// one frame. It loads the tile plus its halo once, with clamped indices,
// into shared memory, and that one read feeds all C channels. Per channel
// it runs the horizontal pass over the tile's rows plus halo rows into a
// second shared buffer, then the vertical pass, and writes the tile. Each
// thread produces SEG = 4 neighbouring outputs from a sliding register
// window, SEG taps per step: 8 shared loads feed 16 FMAs. The taps are
// zero-padded to a multiple of SEG (a zero tap adds exactly nothing), and
// the buffers carry the matching extra rows and columns. In the horizontal
// pass the lanes of a warp run down the rows, so the buffers' row strides
// are odd to keep those accesses free of bank conflicts; in the vertical
// pass the lanes run along x.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TH = 32;  // output tile rows
constexpr int TW = 64;  // output tile columns
constexpr int SEG = 4;  // outputs per thread = taps per step
constexpr int MAX_SMEM = 227 * 1024;

struct Layout {
  int tp;     // taps padded to a multiple of SEG
  int rows;   // rows of the input tile and of the horizontal result
  int cols;   // columns of the input tile
  int s_in;   // row stride of the input tile (odd)
  int s_h;    // row stride of the horizontal result (odd)
};

__host__ __device__ inline Layout make_layout(int T) {
  Layout l;
  l.tp = (T + SEG - 1) / SEG * SEG;
  l.rows = TH + l.tp;
  l.cols = TW + l.tp;
  l.s_in = l.cols | 1;
  l.s_h = TW + 1;
  return l;
}

__host__ __device__ inline size_t smem_floats(const Layout& l, int C) {
  return (size_t)C * l.tp + (size_t)l.rows * l.s_in + (size_t)l.rows * l.s_h;
}

// acc[k] += sum_j w[j] * win[j + k], j ascending (tap order)
__device__ __forceinline__ void fma_step(float (&acc)[SEG], const float (&w)[SEG],
                                         const float (&win)[2 * SEG]) {
#pragma unroll
  for (int j = 0; j < SEG; ++j) {
#pragma unroll
    for (int k = 0; k < SEG; ++k) acc[k] = fmaf(w[j], win[j + k], acc[k]);
  }
}

__global__ void __launch_bounds__(THREADS)
blur_stack_kernel(const float* __restrict__ base, const float* __restrict__ taps,
                  float* __restrict__ out, int C, int T, int H, int W) {
  extern __shared__ float smem[];
  const Layout l = make_layout(T);
  const int R = (T - 1) / 2;
  float* taps_s = smem;                  // (C, tp), zero-padded
  float* in_s = taps_s + C * l.tp;       // (rows, s_in)
  float* h_s = in_s + l.rows * l.s_in;   // (rows, s_h)

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const float* img = base + (size_t)b * H * W;

  for (int e = tid; e < C * l.tp; e += THREADS) {
    const int c = e / l.tp;
    const int t = e - c * l.tp;
    taps_s[e] = t < T ? taps[c * T + t] : 0.0f;
  }
  for (int e = tid; e < l.rows * l.cols; e += THREADS) {
    const int r = e / l.cols;
    const int q = e - r * l.cols;
    const int gy = min(max(y0 - R + r, 0), H - 1);
    const int gx = min(max(x0 - R + q, 0), W - 1);
    in_s[r * l.s_in + q] = __ldg(img + (size_t)gy * W + gx);
  }
  __syncthreads();

  for (int c = 0; c < C; ++c) {
    const float* w_c = taps_s + c * l.tp;

    // horizontal pass: h_s[r, x] = sum_t w[t] * in_s[r, x + t]
    for (int e = tid; e < l.rows * (TW / SEG); e += THREADS) {
      const int seg = e / l.rows;
      const int r = e - seg * l.rows;
      const float* src = in_s + r * l.s_in + seg * SEG;
      float acc[SEG] = {0.0f, 0.0f, 0.0f, 0.0f};
      float win[2 * SEG];
#pragma unroll
      for (int j = 0; j < SEG; ++j) win[j] = src[j];
      for (int t0 = 0; t0 < l.tp; t0 += SEG) {
        float w[SEG];
#pragma unroll
        for (int j = 0; j < SEG; ++j) {
          w[j] = w_c[t0 + j];
          win[SEG + j] = src[t0 + SEG + j];
        }
        fma_step(acc, w, win);
#pragma unroll
        for (int j = 0; j < SEG; ++j) win[j] = win[SEG + j];
      }
      float* dst = h_s + r * l.s_h + seg * SEG;
#pragma unroll
      for (int k = 0; k < SEG; ++k) dst[k] = acc[k];
    }
    __syncthreads();

    // vertical pass: out[y, x] = sum_t w[t] * h_s[y + t, x]
    float* plane = out + ((size_t)b * C + c) * H * W;
    for (int e = tid; e < (TH / SEG) * TW; e += THREADS) {
      const int g = e / TW;
      const int x = e - g * TW;
      const float* src = h_s + (g * SEG) * l.s_h + x;
      float acc[SEG] = {0.0f, 0.0f, 0.0f, 0.0f};
      float win[2 * SEG];
#pragma unroll
      for (int j = 0; j < SEG; ++j) win[j] = src[j * l.s_h];
      for (int t0 = 0; t0 < l.tp; t0 += SEG) {
        float w[SEG];
#pragma unroll
        for (int j = 0; j < SEG; ++j) {
          w[j] = w_c[t0 + j];
          win[SEG + j] = src[(t0 + SEG + j) * l.s_h];
        }
        fma_step(acc, w, win);
#pragma unroll
        for (int j = 0; j < SEG; ++j) win[j] = win[SEG + j];
      }
      const int gx = x0 + x;
      if (gx < W) {
#pragma unroll
        for (int k = 0; k < SEG; ++k) {
          const int gy = y0 + g * SEG + k;
          if (gy < H) plane[(size_t)gy * W + gx] = acc[k];
        }
      }
    }
    __syncthreads();  // h_s is rewritten by the next channel
  }
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success). `base` is
// (B, H, W), `taps` (C, T) with T odd, `out` (B, C, H, W), all float32 and
// contiguous on the device.
extern "C" int blur_stack_launch(const float* base, const float* taps,
                                 float* out, int B, int C, int T, int H,
                                 int W, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return 0;
  if (T <= 0 || T % 2 == 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const Layout l = make_layout(T);
  const size_t bytes = smem_floats(l, C) * sizeof(float);
  if (bytes > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        blur_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  blur_stack_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      base, taps, out, C, T, H, W);
  return (int)cudaGetLastError();
}
