// Baseline JPEG (JFIF, SOF0, huffman) decoder — luma-only output.
//
// Completes the native ingest path for the JPEG datasets (Malaga `_left.jpg`
// frames, the `own` dataset's video dumps — reference loads these through
// OpenCV's C++ imread). The VO pipeline consumes grayscale, so only the Y
// component is inverse-transformed; chroma blocks are entropy-decoded (the
// bitstream must be advanced) but skip dequant/IDCT.
//
// Supported: baseline sequential DCT (SOF0), 8-bit, grayscale or YCbCr with
// any standard sampling factors (4:4:4 / 4:2:2 / 4:2:0), restart markers.
// Not supported (falls back to PIL in the Python wrapper): progressive
// (SOF2), arithmetic coding, 12-bit.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace vojpeg {

struct HuffTable {
  // Canonical code expansion: for each code length 1..16, first code and
  // index of first symbol; plus a fast path via a 9-bit lookup.
  uint16_t mincode[17] = {0};
  int32_t maxcode[18] = {0};  // -1 where no codes
  int32_t valptr[17] = {0};
  uint8_t values[256] = {0};
  bool ok = false;
};

struct Component {
  int id = 0;
  int h = 1, v = 1;  // sampling factors
  int tq = 0;        // quant table id
  int td = 0, ta = 0;  // huffman table ids (dc, ac)
  int dc_pred = 0;
};

struct BitReader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool marker_hit = false;

  BitReader(const uint8_t* data, size_t size) : p(data), n(size) {}

  // JPEG entropy stream: 0xFF is followed by a 0x00 stuffing byte; any
  // other 0xFFxx is a marker (end of scan segment).
  int next_byte() {
    if (pos >= n) return -1;
    uint8_t b = p[pos++];
    if (b == 0xFF) {
      if (pos >= n) return -1;
      uint8_t b2 = p[pos];
      if (b2 == 0x00) {
        ++pos;
        return 0xFF;
      }
      // marker: rewind so caller can see it
      --pos;
      marker_hit = true;
      return -1;
    }
    return b;
  }

  int get_bit() {
    if (bitcnt == 0) {
      int b = next_byte();
      if (b < 0) return -1;
      bitbuf = uint32_t(b);
      bitcnt = 8;
    }
    --bitcnt;
    return (bitbuf >> bitcnt) & 1;
  }

  int get_bits(int len) {
    int v = 0;
    for (int i = 0; i < len; ++i) {
      int b = get_bit();
      if (b < 0) return -1;
      v = (v << 1) | b;
    }
    return v;
  }

  void reset_at_restart() {
    bitcnt = 0;
    marker_hit = false;
    // skip the RSTn marker (0xFF 0xD0-0xD7)
    if (pos + 1 < n && p[pos] == 0xFF && p[pos + 1] >= 0xD0 &&
        p[pos + 1] <= 0xD7) {
      pos += 2;
    }
  }
};

int huff_decode(BitReader& br, const HuffTable& t) {
  int code = br.get_bit();
  if (code < 0) return -1;
  int len = 1;
  while (len <= 16 && code > t.maxcode[len]) {
    int b = br.get_bit();
    if (b < 0) return -1;
    code = (code << 1) | b;
    ++len;
  }
  if (len > 16) return -1;
  return t.values[t.valptr[len] + code - t.mincode[len]];
}

// extend a magnitude-category value to its signed value (JPEG F.2.2.1)
int extend(int v, int len) {
  if (len == 0) return 0;
  if (v < (1 << (len - 1))) return v - (1 << len) + 1;
  return v;
}

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// separable float IDCT, 8x8 (straightforward; speed is fine for ingest)
void idct8x8(const float* in, float* out) {
  static float c[8][8];
  static bool init = false;
  if (!init) {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        c[u][x] = (u == 0 ? 0.3535533906f : 0.5f) *
                  std::cos((2 * x + 1) * u * 3.14159265358979f / 16.0f);
    init = true;
  }
  float tmp[64];
  for (int u = 0; u < 8; ++u)  // rows: IDCT over columns index v
    for (int x = 0; x < 8; ++x) {
      float s = 0;
      for (int v = 0; v < 8; ++v) s += c[v][x] * in[u * 8 + v];
      tmp[u * 8 + x] = s;
    }
  for (int x = 0; x < 8; ++x)
    for (int y = 0; y < 8; ++y) {
      float s = 0;
      for (int u = 0; u < 8; ++u) s += c[u][y] * tmp[u * 8 + x];
      out[y * 8 + x] = s;
    }
}

struct Decoder {
  const uint8_t* data;
  size_t size;
  int width = 0, height = 0;
  int ncomp = 0;
  Component comp[3];
  uint16_t qt[4][64] = {{0}};
  HuffTable hdc[4], hac[4];
  int restart_interval = 0;
  size_t scan_start = 0;

  bool parse_headers() {
    size_t pos = 2;  // skip SOI
    while (pos + 4 <= size) {
      if (data[pos] != 0xFF) return false;
      uint8_t m = data[pos + 1];
      if (m == 0xD8) {
        pos += 2;
        continue;
      }
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
        pos += 2;
        continue;
      }
      int len = (data[pos + 2] << 8) | data[pos + 3];
      const uint8_t* seg = data + pos + 4;
      int seglen = len - 2;
      if (pos + 2 + len > size) return false;
      switch (m) {
        case 0xDB: {  // DQT
          int off = 0;
          while (off < seglen) {
            int pq = seg[off] >> 4, tq_id = seg[off] & 15;
            ++off;
            if (tq_id > 3) return false;
            for (int i = 0; i < 64; ++i) {
              if (pq) {
                qt[tq_id][i] = (seg[off] << 8) | seg[off + 1];
                off += 2;
              } else {
                qt[tq_id][i] = seg[off++];
              }
            }
          }
          break;
        }
        case 0xC0: {  // SOF0 baseline
          height = (seg[1] << 8) | seg[2];
          width = (seg[3] << 8) | seg[4];
          ncomp = seg[5];
          if (ncomp != 1 && ncomp != 3) return false;
          for (int i = 0; i < ncomp; ++i) {
            comp[i].id = seg[6 + 3 * i];
            comp[i].h = seg[7 + 3 * i] >> 4;
            comp[i].v = seg[7 + 3 * i] & 15;
            comp[i].tq = seg[8 + 3 * i];
          }
          break;
        }
        case 0xC1:  // extended sequential: same layout as SOF0
          return false;  // keep strict: PIL fallback
        case 0xC2:  // progressive — unsupported
        case 0xC3:
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xC9:
        case 0xCA:
        case 0xCB:
          return false;
        case 0xC4: {  // DHT
          int off = 0;
          while (off < seglen) {
            int tc = seg[off] >> 4, th = seg[off] & 15;
            ++off;
            if (th > 3) return false;
            HuffTable& t = (tc == 0) ? hdc[th] : hac[th];
            int counts[17] = {0};
            int total = 0;
            for (int l = 1; l <= 16; ++l) {
              counts[l] = seg[off++];
              total += counts[l];
            }
            if (total > 256) return false;
            for (int i = 0; i < total; ++i) t.values[i] = seg[off++];
            int code = 0, k = 0;
            for (int l = 1; l <= 16; ++l) {
              t.valptr[l] = k;
              t.mincode[l] = code;
              code += counts[l];
              k += counts[l];
              t.maxcode[l] = counts[l] ? code - 1 : -1;
              code <<= 1;
            }
            t.ok = true;
          }
          break;
        }
        case 0xDD:  // DRI
          restart_interval = (seg[0] << 8) | seg[1];
          break;
        case 0xDA: {  // SOS
          int ns = seg[0];
          if (ns != ncomp) return false;
          for (int i = 0; i < ns; ++i) {
            int cid = seg[1 + 2 * i];
            int tables = seg[2 + 2 * i];
            for (int c = 0; c < ncomp; ++c) {
              if (comp[c].id == cid) {
                comp[c].td = tables >> 4;
                comp[c].ta = tables & 15;
              }
            }
          }
          scan_start = pos + 2 + len;
          return width > 0 && height > 0;
        }
        default:
          break;  // APPn, COM, ...
      }
      pos += 2 + len;
    }
    return false;
  }

  // decode one 8x8 block's coefficients into coef (zigzag resolved)
  bool decode_block(BitReader& br, Component& c, float* coef, bool want) {
    int t = huff_decode(br, hdc[c.td]);
    if (t < 0) return false;
    int diff = t ? br.get_bits(t) : 0;
    if (diff < 0) return false;
    c.dc_pred += extend(diff, t);
    if (want) {
      memset(coef, 0, 64 * sizeof(float));
      coef[0] = float(c.dc_pred) * qt[c.tq][0];
    }
    int k = 1;
    while (k < 64) {
      int rs = huff_decode(br, hac[c.ta]);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r == 15) {
          k += 16;
          continue;
        }
        break;  // EOB
      }
      k += r;
      if (k > 63) return false;
      int v = br.get_bits(s);
      if (v < 0) return false;
      if (want) coef[kZigzag[k]] = float(extend(v, s)) * qt[c.tq][k];
      ++k;
    }
    return true;
  }

  bool decode_luma(float* out) {
    // MCU geometry
    int hmax = 1, vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      hmax = comp[i].h > hmax ? comp[i].h : hmax;
      vmax = comp[i].v > vmax ? comp[i].v : vmax;
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    Component& Y = comp[0];
    int y_blocks_w = mcux * Y.h;

    std::vector<float> luma(size_t(mcuy) * Y.v * 8 * y_blocks_w * 8, 0.0f);
    BitReader br(data + scan_start, size - scan_start);
    float coef[64], pix[64];
    int mcu_count = 0;

    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart_interval && mcu_count &&
            mcu_count % restart_interval == 0) {
          br.reset_at_restart();
          for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
        }
        for (int ci = 0; ci < ncomp; ++ci) {
          Component& c = comp[ci];
          for (int by = 0; by < c.v; ++by) {
            for (int bx = 0; bx < c.h; ++bx) {
              bool want = (ci == 0);
              if (!decode_block(br, c, coef, want)) return false;
              if (want) {
                idct8x8(coef, pix);
                int gx = (mx * Y.h + bx) * 8;
                int gy = (my * Y.v + by) * 8;
                for (int y = 0; y < 8; ++y) {
                  float* dst = luma.data() + size_t(gy + y) * y_blocks_w * 8 +
                               gx;
                  for (int x = 0; x < 8; ++x) dst[x] = pix[y * 8 + x] + 128.0f;
                }
              }
            }
          }
        }
        ++mcu_count;
      }
    }

    const float inv = 1.0f / 255.0f;
    for (int y = 0; y < height; ++y) {
      const float* src = luma.data() + size_t(y) * y_blocks_w * 8;
      float* dst = out + size_t(y) * width;
      for (int x = 0; x < width; ++x) {
        float v = src[x] * inv;
        dst[x] = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
      }
    }
    return true;
  }
};

}  // namespace vojpeg

namespace vojpeg_api {

bool jpeg_info(const uint8_t* data, size_t size, int* w, int* h) {
  if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) return false;
  vojpeg::Decoder d;
  d.data = data;
  d.size = size;
  if (!d.parse_headers()) return false;
  *w = d.width;
  *h = d.height;
  return true;
}

bool jpeg_decode_gray(const uint8_t* data, size_t size, float* out, int w,
                      int h) {
  vojpeg::Decoder d;
  d.data = data;
  d.size = size;
  if (!d.parse_headers()) return false;
  if (d.width != w || d.height != h) return false;
  return d.decode_luma(out);
}

}  // namespace vojpeg_api
