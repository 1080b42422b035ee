// Per-keypoint window gather for sm_90a: TMA box loads and bulk stores.
//
// Replaces: visualodometry_tpu/ops/patches.py, `_patch_kernel` and its
// wrapper `extract_patches` (the Pallas TPU kernel).
//
// Computes out[k] = field[lvl[k], y0[k] : y0[k] + py, x0[k] : x0[k] + px]
// for an (L, H, W) field of 32-bit words and K in-bounds origins; the
// wrapper checks the origins. Output (K, py, px). The words are opaque:
// bitcast (gx, gy) bf16 gradient pairs (frontend/sift.py) or bitcast
// float32 pixels alike.
//
// What bounds it on an H100: bytes. It does no arithmetic; at the main
// path's shapes it writes ~75.5 MB of patches per frame (K = 2048, 1024,
// 1024 windows of 72 x 64 words) and reads those windows out of ~15.3 MB
// of fields, so its floor is the memory rate (3.35 TB/s).
//
// What the design does about it: the copy engine does the addressing on
// both sides of shared memory. The field is described once per call by a
// 3-D tensor map (W, H, L), encoded on the host in the launch function.
// The card refuses a tiled TMA load whose innermost coordinate is not a
// multiple of 16 bytes (an "illegal instruction", measured: x0 % 4 != 0
// faults), so the box is 4 words wider than the window, (px + 4) x py x 1,
// and is fetched at (x0 & ~3, y0, lvl): one instruction, no per-element
// address arithmetic, and what hangs over the field's edge is zero-filled
// and never copied on. The block's eight warps then move the window from
// that buffer (row pitch px + 4 words, offset x0 & 3 words) into a compact
// buffer, 16 bytes a thread: two aligned shared loads shifted into place
// in registers, one aligned shared store; the realignment costs
// shared-memory traffic only. The compact window leaves as one contiguous
// bulk store (`cp.async.bulk.global.shared::cta`) to out + k * py * px.
// Two blocks per SM walk keypoints k = blockIdx.x, += gridDim.x, each
// through a ring of up to 4 box buffers (3 at the main path's window)
// whose loads thread 0 keeps in flight behind mbarriers, and three compact
// buffers, so a store is still reading one while the next window is
// realigned; `cp.async.bulk.wait_group.read` guards their reuse. One
// __syncthreads per window; the second block of an SM fills the gaps of
// the first. None of the TPU kernel's Mosaic constraints (y0 % 8, W % 128,
// K % 8, the 128-lane over-fetch and roll) apply.
//
// On the card this matches the one-block-per-keypoint kernel it replaces
// on the main path's largest launch, where memory binds, and is about 2 us
// behind it on the launches of 1024 windows, where each block's few
// windows pay a load and a store round trip that hardly overlap (readings
// in PERF.md).
//
// TMA needs W % 4 == 0, px % 4 == 0, box sides <= 256, 16-byte-aligned
// pointers and room for two box buffers in shared memory. Other shapes
// take the scalar loop below, one block per keypoint: the second branch of
// the same launch function.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int SCALAR_THREADS = 256;
constexpr int TMA_THREADS = 256;
constexpr int BLOCKS_PER_SM = 2;
constexpr int MAX_STAGES = 4;  // box buffers in the ring
constexpr int OUT_BUFS = 3;    // compact windows waiting for their store
constexpr int SMEM_LIMIT = 227 * 1024;  // what one block may use on sm_90
constexpr unsigned FULL = 0xffffffffu;

// Words s .. s + 3 of the eight in (lo, hi), s in 1 .. 3.
__device__ __forceinline__ int4 shift_int4(const int4 lo, const int4 hi, int s) {
  switch (s) {
    case 1: return make_int4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_int4(lo.z, lo.w, hi.x, hi.y);
    default: return make_int4(lo.w, hi.x, hi.y, hi.z);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the barrier's phase `parity` to complete. A wrong byte count
// would never complete: trap after ~2 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > 4000000000LL) __trap();
  }
}

__global__ void __launch_bounds__(TMA_THREADS)
patch_tma_kernel(const __grid_constant__ CUtensorMap map,
                 const int32_t* __restrict__ lvl,
                 const int32_t* __restrict__ y0,
                 const int32_t* __restrict__ x0, int32_t* __restrict__ out,
                 int K, int py, int px, int box_bytes, int win_bytes,
                 int stages) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // buffers start on a 128-byte boundary, as TMA wants: `stages` boxes,
  // then OUT_BUFS compact windows
  uint8_t* base = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const int box_stride = (box_bytes + 127) / 128 * 128;
  const int win_stride = (win_bytes + 127) / 128 * 128;
  uint8_t* wins = base + (size_t)stages * box_stride;
  const uint32_t bar0 = smem_u32(full);
  const uint64_t map_addr = reinterpret_cast<uint64_t>(&map);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(bar0 + 8u * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's keypoints: k = blockIdx.x + i * gridDim.x, i < n
  const int n = (K - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  auto key = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };
  // fetch keypoint j's box, at the aligned column, into buffer j % stages
  auto start_load = [&](int j, int cx, int cy, int cz) {
    const int s = j % stages;
    const uint32_t bar = bar0 + 8u * s;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(box_bytes) : "memory");
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(smem_u32(base + (size_t)s * box_stride)), "l"(map_addr),
           "r"(bar), "r"(cx & ~3), "r"(cy), "r"(cz)
        : "memory");
  };

  // the first `stages` loads: the first warp's lanes fetch one origin each
  if (warp == 0) {
    const int first = min(n, stages);
    int ox = 0, oy = 0, oz = 0;
    if (lane < first) {
      ox = __ldg(x0 + key(lane));
      oy = __ldg(y0 + key(lane));
      oz = __ldg(lvl + key(lane));
    }
    for (int j = 0; j < first; ++j) {
      const int cx = __shfl_sync(FULL, ox, j);
      const int cy = __shfl_sync(FULL, oy, j);
      const int cz = __shfl_sync(FULL, oz, j);
      if (lane == 0) start_load(j, cx, cy, cz);
    }
  }

  const int qpr = px >> 2;  // 16-byte words per window row; a box row has one more
  // each window's offset in its box is fetched one step ahead
  int shift_next = n > 0 ? __ldg(x0 + key(0)) & 3 : 0;
  for (int i = 0; i < n; ++i) {
    const int s = i % stages;
    const int shift = shift_next;
    if (i + 1 < n) shift_next = __ldg(x0 + key(i + 1)) & 3;
    // thread 0 fetches ahead the origin it refills this buffer with
    const int j = i + stages;
    int nx = 0, ny = 0, nz = 0;
    if (tid == 0 && j < n) {
      nx = __ldg(x0 + key(j));
      ny = __ldg(y0 + key(j));
      nz = __ldg(lvl + key(j));
    }
    mbar_wait(bar0 + 8u * s, (uint32_t)(i / stages) & 1u);
    // realign into compact buffer i % OUT_BUFS, which thread 0 saw free
    // before the last barrier
    const int4* box4 =
        reinterpret_cast<const int4*>(base + (size_t)s * box_stride);
    uint8_t* win = wins + (size_t)(i % OUT_BUFS) * win_stride;
    int4* win4 = reinterpret_cast<int4*>(win);
#pragma unroll 4
    for (int e = tid; e < py * qpr; e += TMA_THREADS) {
      const int r = e / qpr;
      const int4* p = box4 + r * (qpr + 1) + (e - r * qpr);
      int4 v = p[0];
      if (shift != 0) v = shift_int4(v, p[1], shift);
      win4[e] = v;
    }
    // the window realigned after this barrier, (i + 1) % OUT_BUFS, was
    // last read by store i + 1 - OUT_BUFS: all but the newest
    // OUT_BUFS - 2 stores must have read their windows
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(OUT_BUFS - 2) : "memory");
    // order these generic reads and writes before the bulk store's read
    // of the window and the refill of the box
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          :: "l"(out + (size_t)key(i) * (size_t)(win_bytes / 4)),
             "r"(smem_u32(win)), "r"(win_bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (j < n) start_load(j, nx, ny, nz);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(SCALAR_THREADS)
patch_scalar_kernel(const int32_t* __restrict__ field,
                    const int32_t* __restrict__ lvl,
                    const int32_t* __restrict__ y0,
                    const int32_t* __restrict__ x0,
                    int32_t* __restrict__ out, int H, int W, int py, int px) {
  const int k = blockIdx.x;
  const int xs = x0[k];
  const size_t plane = (size_t)lvl[k] * H + y0[k];  // first window row
  int32_t* dst = out + (size_t)k * py * px;
  for (int e = threadIdx.x; e < py * px; e += SCALAR_THREADS) {
    const int r = e / px;
    const int c = e - r * px;
    dst[e] = __ldg(field + (plane + r) * (size_t)W + xs + c);
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the CUDA library that the process has
// already loaded (libcuda.so.1), so this library links against nothing
// but the CUDA runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). Encoding
// the tensor map is host arithmetic: no device synchronisation.
extern "C" int patches_launch(const int32_t* field, const int32_t* lvl,
                              const int32_t* y0, const int32_t* x0,
                              int32_t* out, int K, int L, int H, int W,
                              int py, int px, void* stream) {
  if (K <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long win_bytes = 4LL * py * px;
  const long long box_bytes = 4LL * py * (px + 4);
  const long long win_stride = (win_bytes + 127) / 128 * 128;
  const long long box_stride = (box_bytes + 127) / 128 * 128;
  const long long stages_fit =
      (SMEM_LIMIT / BLOCKS_PER_SM - 128 - 1024 - OUT_BUFS * win_stride) / box_stride;
  const bool tma = (W % 4 == 0) && (px % 4 == 0) && px + 4 <= 256 &&
                   py <= 256 && ((uintptr_t)field % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0) && stages_fit >= 2;
  if (!tma) {
    patch_scalar_kernel<<<K, SCALAR_THREADS, 0, st>>>(field, lvl, y0, x0, out,
                                                      H, W, py, px);
    return (int)cudaGetLastError();
  }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map;
  // innermost dimension first; strides in bytes for all but the innermost
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)W * H * 4};
  const cuuint32_t box[3] = {(cuuint32_t)(px + 4), (cuuint32_t)py, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, const_cast<int32_t*>(field),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;

  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int stages = (int)(stages_fit < MAX_STAGES ? stages_fit : MAX_STAGES);
  const int smem = (int)(stages * box_stride + OUT_BUFS * win_stride) + 128;
  e = cudaFuncSetAttribute(patch_tma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = K < BLOCKS_PER_SM * sms ? K : BLOCKS_PER_SM * sms;
  patch_tma_kernel<<<blocks, TMA_THREADS, smem, st>>>(
      map, lvl, y0, x0, out, K, py, px, (int)box_bytes, (int)win_bytes, stages);
  return (int)cudaGetLastError();
}
