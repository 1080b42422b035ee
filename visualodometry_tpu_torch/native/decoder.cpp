// Native host-side image decode for the VO ingest pipeline.
//
// The port's copy of visualodometry_tpu/native/decoder.cpp, code unchanged:
// a dependency-free PNG (8-bit gray/RGB[A], non-interlaced) and PGM decoder
// plus a multithreaded batch API, so a chunk of frames decodes in parallel
// on host cores while the previous chunk runs on the device. zlib provides
// inflate; everything else (chunk walk, scanline unfiltering, grayscale
// conversion) is implemented here. JPEG is in jpeg.cpp.
//
// C ABI (consumed via ctypes from data/native_decode.py):
//   vo_image_info(path, &w, &h)            -> 0 on success
//   vo_decode_gray(path, out, w, h)        -> 0 on success; out is float32
//                                             grayscale in [0,1], row-major
//   vo_decode_batch(paths, n, out, w, h, nthreads) -> number decoded OK
//
// Built at first use by data/native_decode.py (g++ -O3 -shared -fPIC
// decoder.cpp jpeg.cpp -lz -lpthread) into csrc/build/.

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace vojpeg_api {
bool jpeg_info(const uint8_t* data, size_t size, int* w, int* h);
bool jpeg_decode_gray(const uint8_t* data, size_t size, float* out, int w,
                      int h);
}  // namespace vojpeg_api

namespace {

struct Buffer {
  std::vector<uint8_t> data;
};

bool read_file(const char* path, Buffer* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size <= 0) {
    fclose(f);
    return false;
  }
  out->data.resize(static_cast<size_t>(size));
  size_t got = fread(out->data.data(), 1, out->data.size(), f);
  fclose(f);
  return got == out->data.size();
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

struct PngHeader {
  uint32_t width = 0;
  uint32_t height = 0;
  int bit_depth = 0;
  int color_type = 0;
  int interlace = 0;
};

// Walk chunks; fill header and concatenate IDAT payloads.
bool parse_png(const Buffer& buf, PngHeader* hdr,
               std::vector<uint8_t>* idat) {
  const uint8_t* p = buf.data.data();
  size_t n = buf.data.size();
  if (n < 8 || memcmp(p, kPngSig, 8) != 0) return false;
  size_t off = 8;
  bool saw_ihdr = false;
  while (off + 8 <= n) {
    uint32_t len = be32(p + off);
    const uint8_t* type = p + off + 4;
    if (off + 12 + len > n) return false;
    const uint8_t* payload = p + off + 8;
    if (memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return false;
      hdr->width = be32(payload);
      hdr->height = be32(payload + 4);
      hdr->bit_depth = payload[8];
      hdr->color_type = payload[9];
      hdr->interlace = payload[12];
      saw_ihdr = true;
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat->insert(idat->end(), payload, payload + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    off += 12 + len;
  }
  return saw_ihdr && !idat->empty();
}

bool inflate_all(const std::vector<uint8_t>& in, std::vector<uint8_t>* out) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  zs.next_out = out->data();
  zs.avail_out = static_cast<uInt>(out->size());
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END && zs.avail_out == 0;
}

int paeth(int a, int b, int c) {
  int pp = a + b - c;
  int pa = pp > a ? pp - a : a - pp;
  int pb = pp > b ? pp - b : b - pp;
  int pc = pp > c ? pp - c : c - pp;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// In-place scanline unfiltering; raw holds height*(1+stride) bytes.
bool unfilter(std::vector<uint8_t>* raw, uint32_t height, size_t stride,
              int bpp) {
  std::vector<uint8_t> prev(stride, 0);
  uint8_t* cur;
  for (uint32_t y = 0; y < height; ++y) {
    uint8_t* line = raw->data() + y * (stride + 1);
    int filter = line[0];
    cur = line + 1;
    switch (filter) {
      case 0:
        break;
      case 1:  // Sub
        for (size_t i = bpp; i < stride; ++i) cur[i] += cur[i - bpp];
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i) cur[i] += prev[i];
        break;
      case 3:  // Average
        for (size_t i = 0; i < size_t(bpp); ++i) cur[i] += prev[i] / 2;
        for (size_t i = bpp; i < stride; ++i)
          cur[i] += (cur[i - bpp] + prev[i]) / 2;
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < size_t(bpp); ++i)
          cur[i] += paeth(0, prev[i], 0);
        for (size_t i = bpp; i < stride; ++i)
          cur[i] += paeth(cur[i - bpp], prev[i], prev[i - bpp]);
        break;
      default:
        return false;
    }
    memcpy(prev.data(), cur, stride);
  }
  return true;
}

int channels_for(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // rgb
    case 4: return 2;  // gray+alpha
    case 6: return 4;  // rgba
    default: return 0;
  }
}

bool decode_png_gray(const Buffer& buf, float* out, int w, int h) {
  PngHeader hdr;
  std::vector<uint8_t> idat;
  if (!parse_png(buf, &hdr, &idat)) return false;
  if (hdr.bit_depth != 8 || hdr.interlace != 0) return false;
  int ch = channels_for(hdr.color_type);
  if (ch == 0) return false;
  if (int(hdr.width) != w || int(hdr.height) != h) return false;

  size_t stride = size_t(hdr.width) * ch;
  std::vector<uint8_t> raw(size_t(hdr.height) * (stride + 1));
  if (!inflate_all(idat, &raw)) return false;
  if (!unfilter(&raw, hdr.height, stride, ch)) return false;

  const float inv = 1.0f / 255.0f;
  for (uint32_t y = 0; y < hdr.height; ++y) {
    const uint8_t* line = raw.data() + y * (stride + 1) + 1;
    float* dst = out + size_t(y) * hdr.width;
    if (ch == 1) {
      for (uint32_t x = 0; x < hdr.width; ++x) dst[x] = line[x] * inv;
    } else if (ch == 2) {
      for (uint32_t x = 0; x < hdr.width; ++x) dst[x] = line[2 * x] * inv;
    } else {
      // ITU-R BT.601 luma
      for (uint32_t x = 0; x < hdr.width; ++x) {
        const uint8_t* px = line + size_t(x) * ch;
        dst[x] = (0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2]) * inv;
      }
    }
  }
  return true;
}

bool parse_pgm_header(const Buffer& buf, int* w, int* h, size_t* data_off,
                      int* maxval) {
  if (buf.data.size() < 2 || buf.data[0] != 'P' || buf.data[1] != '5')
    return false;
  size_t i = 2;
  int vals[3];
  int got = 0;
  while (got < 3 && i < buf.data.size()) {
    uint8_t c = buf.data[i];
    if (c == '#') {
      while (i < buf.data.size() && buf.data[i] != '\n') ++i;
    } else if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      ++i;
    } else {
      int v = 0;
      while (i < buf.data.size() && buf.data[i] >= '0' &&
             buf.data[i] <= '9') {
        v = v * 10 + (buf.data[i] - '0');
        ++i;
      }
      vals[got++] = v;
    }
  }
  if (got != 3 || i >= buf.data.size()) return false;
  ++i;  // single whitespace after maxval
  *w = vals[0];
  *h = vals[1];
  *maxval = vals[2];
  *data_off = i;
  return true;
}

bool decode_pgm_gray(const Buffer& buf, float* out, int w, int h) {
  int pw, ph, maxval;
  size_t off;
  if (!parse_pgm_header(buf, &pw, &ph, &off, &maxval)) return false;
  if (pw != w || ph != h || maxval != 255) return false;
  if (buf.data.size() < off + size_t(w) * h) return false;
  const float inv = 1.0f / 255.0f;
  const uint8_t* src = buf.data.data() + off;
  for (size_t i = 0; i < size_t(w) * h; ++i) out[i] = src[i] * inv;
  return true;
}

bool is_jpeg(const Buffer& buf) {
  return buf.data.size() >= 4 && buf.data[0] == 0xFF && buf.data[1] == 0xD8;
}

bool decode_gray(const char* path, float* out, int w, int h) {
  Buffer buf;
  if (!read_file(path, &buf)) return false;
  if (buf.data.size() >= 8 && memcmp(buf.data.data(), kPngSig, 8) == 0)
    return decode_png_gray(buf, out, w, h);
  if (is_jpeg(buf))
    return vojpeg_api::jpeg_decode_gray(buf.data.data(), buf.data.size(),
                                        out, w, h);
  return decode_pgm_gray(buf, out, w, h);
}

}  // namespace

extern "C" {

int vo_image_info(const char* path, int* w, int* h) {
  Buffer buf;
  if (!read_file(path, &buf)) return -1;
  if (buf.data.size() >= 8 && memcmp(buf.data.data(), kPngSig, 8) == 0) {
    PngHeader hdr;
    std::vector<uint8_t> idat;
    if (!parse_png(buf, &hdr, &idat)) return -2;
    *w = int(hdr.width);
    *h = int(hdr.height);
    return 0;
  }
  if (buf.data.size() >= 4 && buf.data[0] == 0xFF && buf.data[1] == 0xD8) {
    if (vojpeg_api::jpeg_info(buf.data.data(), buf.data.size(), w, h))
      return 0;
    return -4;  // unsupported JPEG flavor (progressive, ...)
  }
  int maxval;
  size_t off;
  if (parse_pgm_header(buf, w, h, &off, &maxval)) return 0;
  return -3;
}

int vo_decode_gray(const char* path, float* out, int w, int h) {
  return decode_gray(path, out, w, h) ? 0 : -1;
}

// Decode n images of identical dims into a contiguous (n, h, w) buffer
// using a work-stealing thread pool. Returns the number decoded OK;
// frames that failed are zero-filled.
int vo_decode_batch(const char** paths, int n, float* out, int w, int h,
                    int nthreads) {
  if (nthreads < 1) nthreads = 1;
  std::atomic<int> next(0);
  std::atomic<int> ok(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      float* dst = out + size_t(i) * w * h;
      if (decode_gray(paths[i], dst, w, h)) {
        ok.fetch_add(1);
      } else {
        memset(dst, 0, size_t(w) * h * sizeof(float));
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads - 1; ++t) threads.emplace_back(work);
  work();
  for (auto& t : threads) t.join();
  return ok.load();
}

}  // extern "C"
