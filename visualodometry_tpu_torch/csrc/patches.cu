// Per-keypoint window gather for sm_90a.
//
// Replaces: visualodometry_tpu/ops/patches.py, `_patch_kernel` and its
// wrapper `extract_patches` (the Pallas TPU kernel).
//
// Computes out[k] = field[lvl[k], y0[k] : y0[k] + py, x0[k] : x0[k] + px]
// for an (L, H, W) int32 field (each word a bitcast (gx, gy) bf16 gradient
// pair, frontend/sift.py) and K in-bounds origins; the wrapper checks the
// origins. Output (K, py, px) int32.
//
// What bounds it on an H100: bytes. It does no arithmetic; at the main
// path's shapes it writes ~75.5 MB of patches per frame (K = 2048, 1024,
// 1024 windows of 72 x 64 words) and reads those windows out of ~15.3 MB
// of fields, so its floor is the memory rate (3.35 TB/s).
//
// What the design does about it: one block per keypoint reads its own
// (lvl, y0, x0) -- the block-level counterpart of the TPU kernel's scalar
// prefetch -- and copies the window row by row in 16-byte words: each
// thread stores one aligned int4 of output, built from the one or two
// aligned int4 loads of the field row that cover it (x0 need not be a
// multiple of 4: the two loads are shifted into place in registers, and
// neighbouring threads share those loads through L1). None of the TPU
// kernel's Mosaic constraints (y0 % 8, W % 128, K % 8, the 128-lane
// over-fetch and roll) apply. A scalar path covers W or px that are not
// multiples of 4, or unaligned pointers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int4 shift_int4(const int4 lo, const int4 hi, int s) {
  switch (s) {
    case 1: return make_int4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_int4(lo.z, lo.w, hi.x, hi.y);
    default: return make_int4(lo.w, hi.x, hi.y, hi.z);
  }
}

__global__ void __launch_bounds__(THREADS)
patch_gather_kernel(const int32_t* __restrict__ field,
                    const int32_t* __restrict__ lvl,
                    const int32_t* __restrict__ y0,
                    const int32_t* __restrict__ x0,
                    int32_t* __restrict__ out, int H, int W, int py, int px,
                    int vec) {
  const int k = blockIdx.x;
  const int xs = x0[k];
  const size_t plane = (size_t)lvl[k] * H + y0[k];  // first window row
  int32_t* dst = out + (size_t)k * py * px;
  if (vec) {
    // W % 4 == 0 and px % 4 == 0: every field row starts 16-byte aligned
    const int qpr = px / 4;  // int4 words per output row
    const int s = xs & 3;
    for (int e = threadIdx.x; e < py * qpr; e += THREADS) {
      const int r = e / qpr;
      const int q = e - r * qpr;
      const size_t off = (plane + r) * (size_t)W + xs + 4 * q;
      const int4* src = reinterpret_cast<const int4*>(field + (off - s));
      const int4 lo = __ldg(src);
      int4 v = lo;
      if (s != 0) v = shift_int4(lo, __ldg(src + 1), s);
      reinterpret_cast<int4*>(dst)[e] = v;
    }
  } else {
    for (int e = threadIdx.x; e < py * px; e += THREADS) {
      const int r = e / px;
      const int c = e - r * px;
      dst[e] = __ldg(field + (plane + r) * (size_t)W + xs + c);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int patches_launch(const int32_t* field, const int32_t* lvl,
                              const int32_t* y0, const int32_t* x0,
                              int32_t* out, int K, int H, int W, int py,
                              int px, void* stream) {
  if (K <= 0) return 0;
  const int vec = (W % 4 == 0) && (px % 4 == 0) &&
                  ((uintptr_t)field % 16 == 0) && ((uintptr_t)out % 16 == 0);
  patch_gather_kernel<<<K, THREADS, 0, (cudaStream_t)stream>>>(
      field, lvl, y0, x0, out, H, W, py, px, vec);
  return (int)cudaGetLastError();
}
