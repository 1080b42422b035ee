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
// Float32 throughout; every sum starts from 0.0 and accumulates with fmaf
// in ascending tap order, so a pixel's value depends on neither the batch
// size nor the tile it falls in.
//
// What bounds it on an H100: operations. Per output value the two passes
// need 2 * T multiply-adds (62 at T = 31) against 4 * (1 + C) / C bytes of
// traffic, so the float32 CUDA-core rate (67 TFLOP/s), not the memory rate,
// is the floor at C = 5; at C = 1, T = 9 it is the bytes.
//
// What the design does about it:
// - The taps are FMA operands, not shared loads. The host packs them into a
//   parameter struct passed by value (`__grid_constant__`); at the start of
//   each channel a thread reads that channel's TP taps from the parameter
//   bank into registers, and the fully unrolled tap loops use them there.
//   The kernel is templated on the padded tap count TP; the pyramid's pairs
//   (C = 5 at TP = 32, C = 1 at TP = 12 and 16) have instantiations of their
//   own, with their tile heights, and any other C <= 8 runs the generic one
//   for its TP. (Unrolling the channel loop as well, so that every tap is a
//   constant-bank operand, was slower at C = 5: five copies of the
//   unrolled passes overflow the instruction cache.)
// - The host pads the taps with s = (-R) mod 4 leading zeros and trailing
//   zeros up to TP (a zero tap adds exactly nothing to a finite sum that
//   starts at 0.0, so the result is bit for bit the unpadded chain). The
//   padded radius RA = R + s is a multiple of 4, so a tile's left edge
//   x0 - RA is 16-byte aligned whenever the row pitch is.
// - Wide register windows: in the horizontal pass a thread makes 8
//   neighbouring outputs of one row, one 16-byte shared load per 4 taps
//   (32 FMAs); in the vertical pass it makes a 4-column x VR-row block,
//   one 16-byte load per tap (4 * VR FMAs). Row strides are 4 mod 8 floats,
//   so a quarter warp's 16-byte accesses down 8 rows, or along 8 column
//   groups, touch 8 distinct bank groups.
// - Tall tiles: TH = 128 output rows for TP <= 48, so the horizontal pass
//   runs over TH + TP - 1 rows, 24% more than the output at TP = 32. The
//   octave stack drops to 64-row tiles (three blocks an SM) on octaves with
//   fewer 128-row tiles than block slots, unless they are so small that
//   split one channel an item they all run at once.
// - With several channels, persistent blocks (as many as fit, two or three
//   an SM) walk the tiles; a launch's last, partial round of tiles goes one
//   channel an item when it would leave SMs idle. With one channel, a block
//   takes one tile and the hardware spreads the many short blocks. The input tile is copied with cp.async: where a
//   4-float chunk lies inside the image, 16 bytes at once if the row pitch
//   is a multiple of 16 bytes (W = 2452), two 8-byte copies if it is a
//   multiple of 8 (W = 1226), else 4-byte copies, which also take the
//   clamped edges. The next tile's copy starts as soon as the last
//   channel's horizontal pass has read the current one, and runs under the
//   vertical pass. Outputs go straight from registers to device memory,
//   as wide as the pitch allows in the same way.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr int TW = 64;        // output tile columns
constexpr int MAX_C = 8;      // channels of the generic instantiations
constexpr int MAX_SMEM = 227 * 1024;

// Output tile rows for a padded tap count: tall where shared memory allows.
template <int TP>
constexpr int TILE_ROWS = TP <= 48 ? 128 : (TP <= 96 ? 64 : 32);

template <int TP, int TH>
struct Layout {
  static constexpr int ROWS = TH + TP - 1;  // input rows = horizontal-result rows
  static constexpr int COLS = TW + TP;      // input columns (a multiple of 4)
  static constexpr int S_IN = COLS % 8 == 4 ? COLS : COLS + 4;  // 4 mod 8
  static constexpr int S_H = TW + 4;                            // 4 mod 8
  static constexpr int VR = TH / 16;  // rows a thread makes in the vertical pass
  static constexpr size_t SMEM = (size_t)ROWS * (S_IN + S_H) * sizeof(float);
  static_assert(TP % 4 == 0 && TH % 16 == 0, "layout");
  static_assert((TH / VR) * (TW / 4) == THREADS, "one vertical block a thread");
  static_assert(SMEM <= MAX_SMEM, "shared memory");
};

template <int N>
struct Taps {
  float w[N];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ld4(float* r, const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}

__device__ __forceinline__ void st4(float* d, const float* r) {
  *reinterpret_cast<float4*>(d) = make_float4(r[0], r[1], r[2], r[3]);
}

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int tile, int tiles_x, int tiles_y, int TH) {
  Tile t;
  const int per_frame = tiles_x * tiles_y;
  t.b = tile / per_frame;
  const int rest = tile - t.b * per_frame;
  const int ty = rest / tiles_x;
  t.y0 = ty * TH;
  t.x0 = (rest - ty * tiles_x) * TW;
  return t;
}

// Start copying a tile's input (rows y0 - RA .., columns x0 - RA .., both
// clamped to the image) into in_s; the caller commits and waits.
template <int TP, int TH>
__device__ __forceinline__ void load_tile(float* in_s, const float* __restrict__ base,
                                          const Tile& t, int RA, int H, int W, int vec) {
  using L = Layout<TP, TH>;
  constexpr int CHUNKS = L::COLS / 4;
  const float* img = base + (size_t)t.b * H * W;
  const int gy0 = t.y0 - RA;
  const int gx0 = t.x0 - RA;  // a multiple of 4
  for (int e = threadIdx.x; e < L::ROWS * CHUNKS; e += THREADS) {
    const int r = e / CHUNKS;
    const int q = (e - r * CHUNKS) * 4;
    const int gy = min(max(gy0 + r, 0), H - 1);
    const int gx = gx0 + q;
    const float* row = img + (size_t)gy * W;
    float* dst = in_s + r * L::S_IN + q;
    if (vec == 4 && gx >= 0 && gx + 3 < W) {
      cp_async16(dst, row + gx);
    } else if (vec == 2 && gx >= 0 && gx + 3 < W) {
      cp_async8(dst, row + gx);
      cp_async8(dst + 2, row + gx + 2);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) cp_async4(dst + i, row + min(max(gx + i, 0), W - 1));
    }
  }
}

// h_s[r, x] = sum_t w[t] * in_s[r, x + t] over the tile's TW columns and
// all ROWS rows. Lanes run down the rows; a thread makes 8 columns.
template <int TP, int TH>
__device__ __forceinline__ void horizontal(const float* in_s, float* h_s, const float (&w)[TP]) {
  using L = Layout<TP, TH>;
  for (int e = threadIdx.x; e < L::ROWS * (TW / 8); e += THREADS) {
    const int seg = e / L::ROWS;
    const int r = e - seg * L::ROWS;
    const float* src = in_s + r * L::S_IN + seg * 8;
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
    float win[12];  // win[i] = src[t0 + i]
    ld4(win, src);
    ld4(win + 4, src + 4);
    ld4(win + 8, src + 8);
#pragma unroll
    for (int t0 = 0; t0 < TP; t0 += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = fmaf(w[t0 + j], win[k + j], acc[k]);
      }
      if (t0 + 4 < TP) {
#pragma unroll
        for (int i = 0; i < 8; ++i) win[i] = win[i + 4];
        ld4(win + 8, src + t0 + 12);
      }
    }
    float* dst = h_s + r * L::S_H + seg * 8;
    st4(dst, acc);
    st4(dst + 4, acc + 4);
  }
}

// out[y0 + y, x0 + x] = sum_t w[t] * h_s[y + t, x]. Each thread makes a
// 4-column x VR-row block from a ring of VR rows in registers.
template <int TP, int TH>
__device__ __forceinline__ void vertical(const float* h_s, float* __restrict__ plane,
                                         const float (&w)[TP], const Tile& t, int H, int W,
                                         int vec) {
  using L = Layout<TP, TH>;
  constexpr int VR = L::VR;
  const int cg = threadIdx.x % (TW / 4);
  const int rg = threadIdx.x / (TW / 4);
  const float* src = h_s + rg * VR * L::S_H + cg * 4;
  float acc[VR][4];
  float win[VR][4];  // row i of src lives in win[i % VR]
#pragma unroll
  for (int k = 0; k < VR; ++k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < VR - 1; ++i) ld4(win[i], src + i * L::S_H);
#pragma unroll
  for (int tap = 0; tap < TP; ++tap) {
    ld4(win[(tap + VR - 1) % VR], src + (tap + VR - 1) * L::S_H);
#pragma unroll
    for (int k = 0; k < VR; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[k][q] = fmaf(w[tap], win[(k + tap) % VR][q], acc[k][q]);
    }
  }
  const int gx = t.x0 + cg * 4;
  if (gx >= W) return;
  const int width = gx + 3 < W ? vec : 1;
#pragma unroll
  for (int k = 0; k < VR; ++k) {
    const int gy = t.y0 + rg * VR + k;
    if (gy >= H) break;
    float* dst = plane + (size_t)gy * W + gx;
    if (width == 4) {
      st4(dst, acc[k]);
    } else if (width == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(acc[k][0], acc[k][1]);
      *reinterpret_cast<float2*>(dst + 2) = make_float2(acc[k][2], acc[k][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (gx + q < W) dst[q] = acc[k][q];
    }
  }
}

// One channel of the current item: horizontal pass, then (once the item's
// last channel has read the input tile) the next item's copy, then the
// vertical pass. `c` is the channel among all C of the output; its taps go
// from the parameter bank into registers first.
template <int TP, int TH, typename TapsT>
__device__ __forceinline__ void channel(int c, bool last, float* in_s, float* h_s,
                                        const TapsT& taps, const float* __restrict__ base,
                                        float* __restrict__ out, const Tile& t,
                                        const Tile& tn, bool more, int C, int RA, int H,
                                        int W, int vec) {
  float w[TP];
#pragma unroll
  for (int i = 0; i < TP; ++i) w[i] = taps.w[c * TP + i];
  horizontal<TP, TH>(in_s, h_s, w);
  __syncthreads();
  if (last && more) {
    load_tile<TP, TH>(in_s, base, tn, RA, H, W, vec);
    cp_async_commit();
  }
  vertical<TP, TH>(h_s, out + ((size_t)t.b * C + c) * H * W, w, t, H, W, vec);
  __syncthreads();  // h_s is rewritten by the next channel
}

template <int TP, int TH>
constexpr int min_blocks() { return 2 * Layout<TP, TH>::SMEM <= 226 * 1024 ? 2 : 1; }

// Work items: items [0, nwhole) are tiles with all C channels; after them
// come the remaining tiles one channel an item (a launch's last, partial
// round of tiles, or a launch too small to fill the card). Split items run
// tile-major, so the channels of one tile run at about the same time and
// their input copies hit in L2.
__device__ __forceinline__ void item_at(int item, int nwhole, int C, int& tile, int& c0,
                                        int& c1) {
  if (item < nwhole) {
    tile = item;
    c0 = 0;
    c1 = C;
  } else {
    const int j = item - nwhole;
    tile = nwhole + j / C;
    c0 = j - (j / C) * C;
    c1 = c0 + 1;
  }
}

// CT: the C the instantiation is specialised for, or 0 for any C <= MAX_C.
template <int TP, int CT, int TH>
__global__ void __launch_bounds__(THREADS, (min_blocks<TP, TH>()))
blur_stack_kernel(const float* __restrict__ base, float* __restrict__ out,
                  const __grid_constant__ Taps<(CT > 0 ? CT : MAX_C) * TP> taps, int C,
                  int RA, int B, int H, int W, int vec, int nwhole) {
  using L = Layout<TP, TH>;
  extern __shared__ __align__(16) float smem[];
  float* in_s = smem;                     // (ROWS, S_IN)
  float* h_s = in_s + L::ROWS * L::S_IN;  // (ROWS, S_H)
  if constexpr (CT > 0) C = CT;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int nitems = nwhole + (tiles_x * tiles_y * B - nwhole) * C;

  int item = blockIdx.x;
  if (item >= nitems) return;
  int tile, c0, c1;
  item_at(item, nwhole, C, tile, c0, c1);
  Tile t = tile_at(tile, tiles_x, tiles_y, TH);
  load_tile<TP, TH>(in_s, base, t, RA, H, W, vec);
  cp_async_commit();
  for (; item < nitems; item += gridDim.x) {
    const int next = item + gridDim.x;
    const bool more = next < nitems;
    int tile_n, c0_n, c1_n;
    item_at(next, nwhole, C, tile_n, c0_n, c1_n);
    const Tile tn = tile_at(tile_n, tiles_x, tiles_y, TH);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int c = c0; c < c1; ++c)
      channel<TP, TH>(c, c == c1 - 1, in_s, h_s, taps, base, out, t, tn, more, C, RA, H, W,
                      vec);
    t = tn;
    c0 = c0_n;
    c1 = c1_n;
  }
}

// SMs of the current device, and blocks of this instantiation that fit on
// them at once.
template <int TP, int CT, int TH>
cudaError_t slots_for(int& sms, int& slots) {
  auto kernel = blur_stack_kernel<TP, CT, TH>;
  const int bytes = (int)Layout<TP, TH>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  slots = per_sm * sms;
  return cudaSuccess;
}

inline long long tiles_of(int B, int H, int W, int TH) {
  return (long long)((W + TW - 1) / TW) * ((H + TH - 1) / TH) * B;
}

template <int TP, int CT, int TH = TILE_ROWS<TP>>
int launch(const float* base, const float* taps_host, float* out, int B, int C, int RA,
           int H, int W, cudaStream_t stream) {
  constexpr int N = (CT > 0 ? CT : MAX_C) * TP;
  Taps<N> taps;
  std::memset(&taps, 0, sizeof(taps));
  std::memcpy(taps.w, taps_host, sizeof(float) * C * TP);
  int sms = 0, slots = 0;
  cudaError_t err = slots_for<TP, CT, TH>(sms, slots);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = tiles_of(B, H, W, TH);
  // Whole tiles for the full rounds of the slots; the last, partial round
  // one channel an item if it is too small to give every SM a tile.
  const long long tail = ntiles % slots;
  const long long nwhole = tail < sms ? ntiles - tail : ntiles;
  const long long nitems = nwhole + (ntiles - nwhole) * C;
  if (nitems > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // Several channels: persistent blocks, each copying its next item under
  // the vertical pass. One channel: a block an item, so that the hardware
  // spreads the many short items.
  const int grid = (int)(C > 1 && nitems > slots ? slots : nitems);
  // the widest access, in floats, that every row start allows
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(base) | reinterpret_cast<uintptr_t>(out);
  const int vec = (W % 4 == 0 && ptrs % 16 == 0) ? 4 : (W % 2 == 0 && ptrs % 8 == 0) ? 2 : 1;
  blur_stack_kernel<TP, CT, TH><<<grid, THREADS, Layout<TP, TH>::SMEM, stream>>>(
      base, out, taps, C, RA, B, H, W, vec, (int)nwhole);
  return (int)cudaGetLastError();
}

// The pyramid's octave stack, C = 5 at 31 taps: 128-row tiles where they
// fill every slot at least once, or where even one channel an item they
// all run at once (the smallest octaves); 64-row tiles (three blocks an SM)
// in between.
int launch_octave(const float* base, const float* taps_host, float* out, int B, int RA, int H,
                  int W, cudaStream_t stream) {
  int sms = 0, slots = 0;
  cudaError_t err = slots_for<32, 5, 128>(sms, slots);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = tiles_of(B, H, W, 128);
  if (tiles >= slots || tiles * 5 <= slots)
    return launch<32, 5, 128>(base, taps_host, out, B, 5, RA, H, W, stream);
  return launch<32, 5, 64>(base, taps_host, out, B, 5, RA, H, W, stream);
}

}  // namespace

// Which instantiation runs (C, TP): 1 specialised on (C, TP), 0 the generic
// one for TP, -1 none (the launch would be refused).
extern "C" int blur_stack_variant(int C, int TP) {
  if ((C == 5 && TP == 32) || (C == 1 && (TP == 12 || TP == 16))) return 1;
  if (C < 1 || C > MAX_C) return -1;
  switch (TP) {
    case 8: case 12: case 16: case 24: case 32: case 40: case 48:
    case 64: case 80: case 96: case 112: case 132:
      return 0;
    default:
      return -1;
  }
}

// Launch on `stream`; returns a cudaError_t (0 on success). `base` is
// (B, H, W) and `out` (B, C, H, W), float32 and contiguous on the device.
// `taps_host` is host memory, (C, TP) float32: each channel's taps after
// (-R) mod 4 leading zeros and zero-padded to TP; RA is R plus the leading
// zeros, a multiple of 4.
extern "C" int blur_stack_launch(const float* base, const float* taps_host, float* out,
                                 int B, int C, int TP, int RA, int H, int W,
                                 void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return 0;
  if (RA < 0 || RA % 4 != 0 || 2 * RA >= TP + 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (blur_stack_variant(C, TP)) {
    case 1:
      if (C == 5) return launch_octave(base, taps_host, out, B, RA, H, W, s);
      if (TP == 12) return launch<12, 1, 64>(base, taps_host, out, B, C, RA, H, W, s);
      return launch<16, 1, 64>(base, taps_host, out, B, C, RA, H, W, s);
    case 0:
      switch (TP) {
        case 8: return launch<8, 0>(base, taps_host, out, B, C, RA, H, W, s);
        case 12: return launch<12, 0>(base, taps_host, out, B, C, RA, H, W, s);
        case 16: return launch<16, 0>(base, taps_host, out, B, C, RA, H, W, s);
        case 24: return launch<24, 0>(base, taps_host, out, B, C, RA, H, W, s);
        case 32: return launch<32, 0>(base, taps_host, out, B, C, RA, H, W, s);
        case 40: return launch<40, 0>(base, taps_host, out, B, C, RA, H, W, s);
        case 48: return launch<48, 0>(base, taps_host, out, B, C, RA, H, W, s);
        case 64: return launch<64, 0>(base, taps_host, out, B, C, RA, H, W, s);
        case 80: return launch<80, 0>(base, taps_host, out, B, C, RA, H, W, s);
        case 96: return launch<96, 0>(base, taps_host, out, B, C, RA, H, W, s);
        case 112: return launch<112, 0>(base, taps_host, out, B, C, RA, H, W, s);
        case 132: return launch<132, 0>(base, taps_host, out, B, C, RA, H, W, s);
      }
  }
  return (int)cudaErrorInvalidValue;
}
