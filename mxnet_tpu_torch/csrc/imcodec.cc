// Image codec of the PyTorch/CUDA port: baseline JPEG decode and encode,
// and PNG's row filters, built by mxnet_tpu_torch/_imcodec.py with g++
// into mxnet_tpu_torch/_build/ and called through ctypes (each call runs
// without the GIL). Host code: the card sees the pixels only once a
// batch is copied to it.
//
// JPEG decode takes baseline and extended sequential Huffman files
// (SOF0 / SOF1), 8-bit, 1 or 3 components, sampling factors up to 2x2,
// restart intervals, any Huffman tables, APPn / COM segments. It follows
// libjpeg's integer "islow" IDCT (jidctint.c), its "fancy" triangle
// chroma upsampling with replicated edges (jdsample.c) and its
// fixed-point YCbCr -> RGB (jdcolor.c), so that its pixels are those of
// a libjpeg(-turbo) decode with default settings. Progressive,
// arithmetic-coded, lossless, 12-bit, CMYK / YCCK files are refused with
// the variant named.
//
// JPEG encode is baseline: libjpeg's quality scaling of the Annex K
// tables, the Annex K Huffman tables, the islow forward DCT (jfdctint.c)
// and its fixed-point RGB -> YCbCr; colour images subsampled (2x2 by
// default, as libjpeg's default).
//
// PNG: inflate and deflate are the caller's (Python's zlib); here the
// five row filters are undone (decode) or chosen and applied (encode).
//
// C ABI (consumed by mxnet_tpu_torch/_imcodec.py); every call returns 0
// or a positive size on success, kCorrupt or kUnsupported with a message
// in `err` on failure:
//   MXTTJpegDecode(buf, n, out, cap, &w, &h, &c, err, errlen)
//       out == nullptr (or cap too small): parse the headers, set w, h, c
//       and return 1; else decode into out (h * w * c bytes, HWC).
//   MXTTJpegEncode(px, w, h, c, quality, hs, vs, out, cap, err, errlen)
//       -> bytes written; hs / vs the luma sampling factors (colour).
//   MXTTPngUnfilter(in, n, w, h, depth, channels, out, err, errlen)
//       in: h rows of 1 + ceil(w * depth * channels / 8) bytes; out: one
//       byte a sample (h * w * channels), sub-byte depths unpacked.
//   MXTTPngFilter(px, w, h, channels, out) -> h * (1 + w * channels)
//       bytes: each row's filter chosen by the least sum of |signed byte|
//       (libpng's heuristic over none, up, sub and Paeth, in the order
//       Pillow tries them, so that a row is filtered as Pillow's is).
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <initializer_list>
#include <string>
#include <vector>

namespace {

constexpr int kCorrupt = -1;
constexpr int kUnsupported = -2;

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Error{kCorrupt, m}; }
[[noreturn]] void unsupported(const std::string& m) {
  throw Error{kUnsupported, m};
}

int report(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) {
    std::snprintf(err, errlen, "%s", e.msg.c_str());
  }
  return e.code;
}

const int kZigzag[64] = {  // zigzag index -> natural (row-major) index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------- IDCT
// jidctint.c, jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// libjpeg's post-IDCT range limit: the sample is (x + 128) clamped, with
// the table's wrap-around for |x| beyond its range (x & 1023).
inline uint8_t idct_limit(int32_t x) {
  int i = x & 1023;
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int32_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int32_t dc = (in[0] * qt[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int32_t z2 = in[16] * qt[16], z3 = in[48] * qt[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0] * qt[0];
    z3 = in[32] * qt[32];
    int32_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int32_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * qt[56];
    tmp1 = in[40] * qt[40];
    tmp2 = in[24] * qt[24];
    tmp3 = in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, s);
    w[56] = descale(tmp10 - tmp3, s);
    w[8] = descale(tmp11 + tmp2, s);
    w[48] = descale(tmp11 - tmp2, s);
    w[16] = descale(tmp12 + tmp1, s);
    w[40] = descale(tmp12 - tmp1, s);
    w[24] = descale(tmp13 + tmp0, s);
    w[32] = descale(tmp13 - tmp0, s);
  }
  const int s = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t v = idct_limit(descale(w[0], kPass1Bits + 3));
      std::memset(o, v, 8);
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
    int32_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = idct_limit(descale(tmp10 + tmp3, s));
    o[7] = idct_limit(descale(tmp10 - tmp3, s));
    o[1] = idct_limit(descale(tmp11 + tmp2, s));
    o[6] = idct_limit(descale(tmp11 - tmp2, s));
    o[2] = idct_limit(descale(tmp12 + tmp1, s));
    o[5] = idct_limit(descale(tmp12 - tmp1, s));
    o[3] = idct_limit(descale(tmp13 + tmp0, s));
    o[4] = idct_limit(descale(tmp13 - tmp0, s));
  }
}

// ------------------------------------------------------------- Huffman
struct Huffman {
  bool defined = false;
  uint16_t fast[512];   // 9-bit lookahead: (length << 8) | value, 0 = slow
  int32_t maxcode[18];  // largest code of each length, -1 if none
  int32_t valptr[17];
  int32_t mincode[17];
  uint8_t vals[256];
};

void build_huffman(Huffman* h, const uint8_t* counts, const uint8_t* vals,
                   int nvals) {
  std::memset(h->fast, 0, sizeof(h->fast));
  std::memcpy(h->vals, vals, nvals);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    h->valptr[len] = k;
    h->mincode[len] = code;
    for (int i = 0; i < counts[len - 1]; ++i) {
      if (len <= 9) {
        int shift = 9 - len;
        for (int j = 0; j < (1 << shift); ++j) {
          h->fast[(code << shift) | j] =
              static_cast<uint16_t>((len << 8) | vals[k]);
        }
      }
      ++code;
      ++k;
    }
    h->maxcode[len] = counts[len - 1] ? code - 1 : -1;
    if (code > (1 << len)) corrupt("bad Huffman table");
    code <<= 1;
  }
  h->maxcode[17] = 0x7fffffff;
  h->defined = true;
}

// Entropy-coded data: a left-aligned 64-bit window. Past a marker or the
// end of the buffer zero bits are fed in; consuming any of them means
// the scan is truncated.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  int phantom = 0;   // trailing bits of buf that are past the data
  int marker = -1;   // the marker that stopped the data (0x100: the end)
  const uint8_t* marker_at = nullptr;  // its 0xFF

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (marker < 0 && p < end) {
        b = *p;
        if (b == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes
          if (q < end && *q == 0x00) {
            p = q + 1;
          } else {
            marker = q < end ? *q : 0x100;
            marker_at = q - 1;
            p = q < end ? q + 1 : q;
            b = 0;
            phantom += 8;
          }
        } else {
          ++p;
        }
      } else {
        phantom += 8;
      }
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t bits(int n) {
    if (n == 0) return 0;
    if (cnt < n) fill();
    uint32_t v = static_cast<uint32_t>(buf >> (64 - n));
    buf <<= n;
    cnt -= n;
    return v;
  }
  bool overrun() const { return cnt < phantom; }
  // byte-align and drop the window (at a restart marker)
  void reset() {
    buf = 0;
    cnt = 0;
    phantom = 0;
  }
};

inline int decode_huff(BitReader& br, const Huffman& h) {
  if (br.cnt < 16) br.fill();
  uint32_t look = static_cast<uint32_t>(br.buf >> 55);
  uint16_t e = h.fast[look];
  if (e) {
    int len = e >> 8;
    br.buf <<= len;
    br.cnt -= len;
    return e & 0xFF;
  }
  uint32_t code16 = static_cast<uint32_t>(br.buf >> 48);
  for (int len = 10; len <= 16; ++len) {
    int32_t c = static_cast<int32_t>(code16 >> (16 - len));
    if (c <= h.maxcode[len]) {
      br.buf <<= len;
      br.cnt -= len;
      int idx = h.valptr[len] + c - h.mincode[len];
      if (idx < 0 || idx > 255) corrupt("bad Huffman code");
      return h.vals[idx];
    }
  }
  corrupt("bad Huffman code");
}

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1
                             : static_cast<int>(v);
}

// ------------------------------------------------------------ JPEG decode
struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;   // plane size in blocks (interleaved layout)
  int dw = 0, dh = 0;   // downsampled size in samples
  std::vector<uint8_t> plane;
  int dc_pred = 0;
};

struct JpegDecoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[3];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool saw_sof = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  size_t scan_pos = 0;  // where the first scan's header starts

  JpegDecoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8() {
    if (pos >= n) corrupt("truncated JPEG header");
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) corrupt("bad DQT table id");
      if (pq != 0) unsupported("16-bit quantization tables (12-bit JPEG)");
      for (int i = 0; i < 64; ++i) qt[tq][kZigzag[i]] = u8();
      qt_defined[tq] = true;
    }
    if (pos != end) corrupt("bad DQT length");
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) corrupt("bad DHT table id");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = u8();
      if (total > 256) corrupt("bad DHT table");
      uint8_t vals[256];
      for (int i = 0; i < total; ++i) vals[i] = u8();
      build_huffman(tc ? &ac[th] : &dc[th], counts, vals, total);
    }
    if (pos != end) corrupt("bad DHT length");
  }

  void read_sof(int marker, size_t end) {
    if (saw_sof) corrupt("two frame headers");
    saw_sof = true;
    switch (marker) {
      case 0xC0: case 0xC1: break;
      case 0xC2: unsupported("progressive JPEG (SOF2)");
      case 0xC3: unsupported("lossless JPEG (SOF3)");
      case 0xC5: case 0xC6: case 0xC7:
        unsupported("hierarchical JPEG (differential SOF)");
      default: unsupported("arithmetic-coded JPEG");
    }
    int precision = u8();
    if (precision != 8) {
      unsupported(std::to_string(precision) + "-bit JPEG");
    }
    height = u16();
    width = u16();
    ncomp = u8();
    if (width == 0) corrupt("zero image width");
    if (height == 0) unsupported("JPEG with the height in a DNL marker");
    if (ncomp == 4) unsupported("CMYK / YCCK JPEG (4 components)");
    if (ncomp != 1 && ncomp != 3) {
      unsupported(std::to_string(ncomp) + "-component JPEG");
    }
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) {
        corrupt("bad frame component");
      }
    }
    if (pos != end) corrupt("bad SOF length");
    if (ncomp == 1) comp[0].h = comp[0].v = 1;  // one block an MCU
    for (int i = 0; i < ncomp; ++i) {
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    if (hmax > 2 || vmax > 2) {
      unsupported("sampling factors above 2x2 (" + std::to_string(hmax) +
                  "x" + std::to_string(vmax) + ")");
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1)
                              / hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax -
                               1) / vmax);
    }
  }

  // headers up to the first SOS; returns with pos at the SOS's length
  void read_headers() {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) corrupt("not a JPEG");
    pos = 2;
    for (;;) {
      int b = u8();
      if (b != 0xFF) corrupt("expected a marker");
      int marker = u8();
      while (marker == 0xFF) marker = u8();
      if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) ||
          marker == 0x01) {
        continue;
      }
      if (marker == 0xD9) corrupt("no scan before EOI");
      size_t seg = pos;
      int len = u16();
      if (len < 2 || seg + len > n) corrupt("truncated JPEG segment");
      size_t end = seg + len;
      if (marker == 0xDA) {
        if (!saw_sof) corrupt("scan before frame header");
        pos = seg;
        scan_pos = seg;
        return;
      }
      if (marker == 0xDB) {
        read_dqt(end);
      } else if (marker == 0xC4) {
        read_dht(end);
      } else if (marker == 0xCC) {
        unsupported("arithmetic-coded JPEG (DAC)");
      } else if (marker == 0xDD) {
        if (len != 4) corrupt("bad DRI length");
        restart_interval = u16();
      } else if (marker >= 0xC0 && marker <= 0xCF) {
        read_sof(marker, end);
      } else if (marker == 0xE0) {
        if (len >= 7 && std::memcmp(data + seg + 2, "JFIF\0", 5) == 0) {
          saw_jfif = true;
        }
      } else if (marker == 0xEE) {
        if (len >= 14 && std::memcmp(data + seg + 2, "Adobe", 5) == 0) {
          saw_adobe = true;
          adobe_transform = data[seg + 13];
        }
      }
      pos = end;  // APPn, COM and anything else: skipped
    }
  }

  void decode_block(BitReader& br, Component& c, int bx, int by) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int t = decode_huff(br, hd);
    if (t > 16) corrupt("bad DC category");
    int diff = t ? extend(br.bits(t), t) : 0;
    c.dc_pred += diff;
    coef[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64;) {
      int rs = decode_huff(br, ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) corrupt("AC coefficient index past 63");
        coef[kZigzag[k]] = static_cast<int16_t>(extend(br.bits(s), s));
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    int stride = c.bw * 8;
    idct_islow(coef, qt[c.tq], c.plane.data() + (by * 8) * stride + bx * 8,
               stride);
  }

  // restart: the next marker must be RSTn; predictors and window reset
  void restart(BitReader& br, int* next_rst) {
    if (br.overrun()) corrupt("truncated scan");
    br.fill();
    if (br.marker != 0xD0 + *next_rst) {
      corrupt("missing restart marker");
    }
    br.marker = -1;
    br.reset();
    *next_rst = (*next_rst + 1) & 7;
    for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
  }

  // one scan from its header at `pos`; returns the position after it
  void decode_scan() {
    int len = u16();
    size_t end = pos - 2 + len;
    int ns = u8();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) corrupt("bad SOS");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), tables = u8();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j) {
        if (comp[j].id == id) c = &comp[j];
      }
      if (!c) corrupt("scan names an unknown component");
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined ||
          !ac[c->ta].defined) {
        corrupt("scan uses an undefined Huffman table");
      }
      if (!qt_defined[c->tq]) corrupt("undefined quantization table");
      sc[i] = c;
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) corrupt("bad spectral selection");
    pos = end;
    BitReader br{data + pos, data + n};
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    int next_rst = 0, todo = restart_interval;
    if (ns == 1) {  // non-interleaved: the component's own block grid
      Component& c = *sc[0];
      int bw = (c.dw + 7) / 8, bh = (c.dh + 7) / 8;
      for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
          if (restart_interval && todo == 0) {
            restart(br, &next_rst);
            todo = restart_interval;
          }
          decode_block(br, c, bx, by);
          --todo;
        }
        if (br.overrun()) corrupt("truncated scan");
      }
    } else {
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart_interval && todo == 0) {
            restart(br, &next_rst);
            todo = restart_interval;
          }
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v) {
              for (int h = 0; h < c.h; ++h) {
                decode_block(br, c, mx * c.h + h, my * c.v + v);
              }
            }
          }
          --todo;
        }
        if (br.overrun()) corrupt("truncated scan");
      }
    }
    // past the scan's data: the bytes the window has not consumed are
    // at most its padding; the next marker is where the reader stopped
    if (br.overrun()) corrupt("truncated scan");
    pos = br.marker == 0x100 ? n
        : static_cast<size_t>((br.marker >= 0 ? br.marker_at : br.p) - data);
  }

  // the markers between scans (and the EOI); true if another scan follows
  bool next_scan() {
    for (;;) {
      while (pos < n && data[pos] != 0xFF) ++pos;  // stray bytes
      if (pos + 1 >= n) return false;               // no EOI: tolerated
      int marker = data[pos + 1];
      if (marker == 0xFF) {
        ++pos;
        continue;
      }
      pos += 2;
      if (marker == 0xD9) return false;
      if (marker == 0x00 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      size_t seg = pos;
      int len = u16();
      if (len < 2 || seg + len > n) corrupt("truncated JPEG segment");
      size_t end = seg + len;
      if (marker == 0xDA) {
        pos = seg;
        return true;
      }
      if (marker == 0xDB) {
        read_dqt(end);
      } else if (marker == 0xC4) {
        read_dht(end);
      } else if (marker == 0xDD) {
        restart_interval = u16();
      }
      pos = end;
    }
  }

  void decode_planes() {
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.plane.assign(static_cast<size_t>(c.bw) * 8 * c.bh * 8, 0);
    }
    pos = scan_pos;
    do {
      decode_scan();
    } while (next_scan());
  }
};

// libjpeg's upsamplers (jdsample.c) for one component: `in` (dw x dh,
// stride `is`) to `out` (2dw or dw wide, stride `os`), edges replicated.
void upsample(const Component& c, int rh, int rv, uint8_t* out, int os) {
  const uint8_t* in = c.plane.data();
  const int is = c.bw * 8, dw = c.dw, dh = c.dh;
  auto row = [&](int y) {
    return in + static_cast<size_t>(y < 0 ? 0 : (y >= dh ? dh - 1 : y)) * is;
  };
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < dh; ++y) std::memcpy(out + y * os, row(y), dw);
  } else if (rh == 2 && rv == 1) {
    for (int y = 0; y < dh; ++y) {
      const uint8_t* p = row(y);
      uint8_t* o = out + y * os;
      if (dw <= 2) {
        for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = p[x];
        continue;
      }
      o[0] = p[0];
      o[1] = static_cast<uint8_t>((p[0] * 3 + p[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        int v = p[x] * 3;
        o[2 * x] = static_cast<uint8_t>((v + p[x - 1] + 1) >> 2);
        o[2 * x + 1] = static_cast<uint8_t>((v + p[x + 1] + 2) >> 2);
      }
      o[2 * dw - 2] = static_cast<uint8_t>((p[dw - 1] * 3 + p[dw - 2] + 1)
                                           >> 2);
      o[2 * dw - 1] = p[dw - 1];
    }
  } else if (rh == 1 && rv == 2) {
    for (int y = 0; y < dh; ++y) {
      const uint8_t* p0 = row(y);
      for (int v = 0; v < 2; ++v) {
        const uint8_t* p1 = row(v == 0 ? y - 1 : y + 1);
        int bias = v == 0 ? 1 : 2;
        uint8_t* o = out + (2 * y + v) * os;
        for (int x = 0; x < dw; ++x) {
          o[x] = static_cast<uint8_t>((p0[x] * 3 + p1[x] + bias) >> 2);
        }
      }
    }
  } else {  // 2 x 2
    for (int y = 0; y < dh; ++y) {
      const uint8_t* p0 = row(y);
      for (int v = 0; v < 2; ++v) {
        uint8_t* o = out + (2 * y + v) * os;
        if (dw <= 2) {
          for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = p0[x];
          continue;
        }
        const uint8_t* p1 = row(v == 0 ? y - 1 : y + 1);
        int this_sum = p0[0] * 3 + p1[0];
        int next_sum = p0[1] * 3 + p1[1];
        o[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        o[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 1; x < dw - 1; ++x) {
          next_sum = p0[x + 1] * 3 + p1[x + 1];
          o[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          o[2 * x + 1] =
              static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        o[2 * dw - 2] =
            static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        o[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
      }
    }
  }
}

// jdcolor.c's tables: SCALEBITS 16, ONE_HALF 1 << 15
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int32_t half = 1 << 15;
    auto fix = [](double x) {
      return static_cast<int32_t>(x * 65536.0 + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

const YccTables& ycc_tables() {
  static const YccTables t;
  return t;
}

void jpeg_decode(JpegDecoder& d, uint8_t* out) {
  d.decode_planes();
  const int W = d.width, H = d.height;
  if (d.ncomp == 1) {
    const Component& c = d.comp[0];
    for (int y = 0; y < H; ++y) {
      std::memcpy(out + static_cast<size_t>(y) * W,
                  c.plane.data() + static_cast<size_t>(y) * c.bw * 8, W);
    }
    return;
  }
  // upsample each component to full size (2 rows / columns of slack)
  const int fw = d.mcux * d.hmax * 8 + 2;
  const int fh = d.mcuy * d.vmax * 8 + 2;
  std::vector<uint8_t> full[3];
  const uint8_t* src[3];
  int stride[3];
  for (int i = 0; i < 3; ++i) {
    const Component& c = d.comp[i];
    int rh = d.hmax / c.h, rv = d.vmax / c.v;
    if (rh * c.h != d.hmax || rv * c.v != d.vmax) {
      unsupported("non-integral sampling ratios");
    }
    if (rh == 1 && rv == 1) {
      src[i] = c.plane.data();
      stride[i] = c.bw * 8;
      continue;
    }
    full[i].assign(static_cast<size_t>(fw) * fh, 0);
    upsample(c, rh, rv, full[i].data(), fw);
    src[i] = full[i].data();
    stride[i] = fw;
  }
  bool rgb;
  if (d.saw_jfif) {
    rgb = false;
  } else if (d.saw_adobe) {
    rgb = d.adobe_transform == 0;
  } else {
    rgb = d.comp[0].id == 82 && d.comp[1].id == 71 && d.comp[2].id == 66;
  }
  const YccTables& t = ycc_tables();
  for (int y = 0; y < H; ++y) {
    const uint8_t* p0 = src[0] + static_cast<size_t>(y) * stride[0];
    const uint8_t* p1 = src[1] + static_cast<size_t>(y) * stride[1];
    const uint8_t* p2 = src[2] + static_cast<size_t>(y) * stride[2];
    uint8_t* o = out + static_cast<size_t>(y) * W * 3;
    if (rgb) {
      for (int x = 0; x < W; ++x) {
        o[3 * x] = p0[x];
        o[3 * x + 1] = p1[x];
        o[3 * x + 2] = p2[x];
      }
      continue;
    }
    for (int x = 0; x < W; ++x) {
      int yy = p0[x], cb = p1[x], cr = p2[x];
      o[3 * x] = clamp255(yy + t.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
    }
  }
}

// ------------------------------------------------------------ JPEG encode
const uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 tables (counts of codes of length 1..16, then the values)
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0,
                                 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0,
                                   0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0,
                                 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1,
                                   2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffCodes {
  uint16_t code[256];
  uint8_t size[256];
};

HuffCodes make_codes(const uint8_t* bits, const uint8_t* vals) {
  HuffCodes h;
  std::memset(&h, 0, sizeof(h));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k) {
      h.code[vals[k]] = static_cast<uint16_t>(code++);
      h.size[vals[k]] = static_cast<uint8_t>(len);
    }
    code <<= 1;
  }
  return h;
}

struct ByteSink {
  uint8_t* out;
  size_t cap;
  size_t len = 0;
  void put(uint8_t b) {
    if (len >= cap) corrupt("JPEG output buffer too small");
    out[len++] = b;
  }
  void put16(int v) {
    put(static_cast<uint8_t>(v >> 8));
    put(static_cast<uint8_t>(v & 0xFF));
  }
};

struct BitWriter {
  ByteSink* sink;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t v, int size) {
    acc = (acc << size) | (v & ((1u << size) - 1));
    n += size;
    while (n >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (n - 8));
      sink->put(b);
      if (b == 0xFF) sink->put(0);
      n -= 8;
    }
  }
  void flush() {  // pad the last byte with 1 bits
    if (n > 0) put((1u << (8 - n)) - 1, 8 - n);
  }
};

// jfdctint.c, jpeg_fdct_islow: output scaled up by 8
void fdct_islow(int32_t* d) {
  for (int r = 0; r < 8; ++r) {
    int32_t* p = d + 8 * r;
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
    p[4] = (tmp10 - tmp11) * (1 << kPass1Bits);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int s = kConstBits - kPass1Bits;
    p[2] = descale(z1 + tmp13 * FIX_0_765366865, s);
    p[6] = descale(z1 + tmp12 * -FIX_1_847759065, s);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = descale(tmp4 + z1 + z3, s);
    p[5] = descale(tmp5 + z2 + z4, s);
    p[3] = descale(tmp6 + z2 + z3, s);
    p[1] = descale(tmp7 + z1 + z4, s);
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = d + c;
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale(tmp10 + tmp11, kPass1Bits);
    p[32] = descale(tmp10 - tmp11, kPass1Bits);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int s = kConstBits + kPass1Bits;
    p[16] = descale(z1 + tmp13 * FIX_0_765366865, s);
    p[48] = descale(z1 + tmp12 * -FIX_1_847759065, s);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = descale(tmp4 + z1 + z3, s);
    p[40] = descale(tmp5 + z2 + z4, s);
    p[24] = descale(tmp6 + z2 + z3, s);
    p[8] = descale(tmp7 + z1 + z4, s);
  }
}

void scaled_table(const uint8_t* base, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(base[i]) * scale + 50) / 100;
    out[i] = static_cast<uint16_t>(t < 1 ? 1 : (t > 255 ? 255 : t));
  }
}

struct EncPlane {
  std::vector<uint8_t> px;
  int w = 0, h = 0;  // padded to whole blocks of the MCU grid
};

void encode_block(BitWriter& bw, const uint8_t* src, int stride,
                  const uint16_t* q, const HuffCodes& dc,
                  const HuffCodes& ac, int* pred) {
  int32_t d[64];
  for (int r = 0; r < 8; ++r) {
    for (int c = 0; c < 8; ++c) d[8 * r + c] = src[r * stride + c] - 128;
  }
  fdct_islow(d);
  int coef[64];
  for (int i = 0; i < 64; ++i) {
    int32_t qv = q[kZigzag[i]] << 3;
    int32_t t = d[kZigzag[i]];
    coef[i] = t < 0 ? -((-t + (qv >> 1)) / qv) : (t + (qv >> 1)) / qv;
  }
  auto emit = [&](const HuffCodes& h, int sym) {
    bw.put(h.code[sym], h.size[sym]);
  };
  auto nbits = [](int v) {
    int a = v < 0 ? -v : v, n = 0;
    while (a) {
      ++n;
      a >>= 1;
    }
    return n;
  };
  int diff = coef[0] - *pred;
  *pred = coef[0];
  int s = nbits(diff);
  emit(dc, s);
  if (s) bw.put(diff < 0 ? diff - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[k];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      emit(ac, 0xF0);
      run -= 16;
    }
    s = nbits(v);
    emit(ac, (run << 4) | s);
    bw.put(v < 0 ? v - 1 : v, s);
    run = 0;
  }
  if (run) emit(ac, 0x00);
}

size_t jpeg_encode(const uint8_t* px, int w, int h, int c, int quality,
                   int hs, int vs, uint8_t* out, size_t cap) {
  if (c != 1 && c != 3) unsupported("JPEG encode takes 1 or 3 channels");
  if (w < 1 || h < 1 || w > 65535 || h > 65535) corrupt("bad image size");
  if (c == 1) hs = vs = 1;
  if (hs < 1 || hs > 2 || vs < 1 || vs > 2) {
    unsupported("sampling factors above 2x2");
  }
  const int mw = 8 * hs, mh = 8 * vs;
  const int mcux = (w + mw - 1) / mw, mcuy = (h + mh - 1) / mh;
  const int pw = mcux * mw, ph = mcuy * mh;
  // colour conversion into planes padded by edge replication (jccolor.c)
  EncPlane plane[3];
  for (int i = 0; i < c; ++i) {
    plane[i].w = pw;
    plane[i].h = ph;
    plane[i].px.resize(static_cast<size_t>(pw) * ph);
  }
  // FIX(x) = x * 65536 + 0.5 of jccolor.c's coefficients
  const int32_t half = 1 << 15, cbcr_off = 128 << 16;
  const int32_t yr = 19595, yg = 38470, yb = 7471;
  const int32_t cbr = 11059, cbg = 21709, cbb = 32768;
  const int32_t crg = 27439, crb = 5329;
  for (int y = 0; y < ph; ++y) {
    const uint8_t* row = px + static_cast<size_t>(y < h ? y : h - 1) * w * c;
    for (int x = 0; x < pw; ++x) {
      const uint8_t* p = row + static_cast<size_t>(x < w ? x : w - 1) * c;
      size_t o = static_cast<size_t>(y) * pw + x;
      if (c == 1) {
        plane[0].px[o] = p[0];
        continue;
      }
      int32_t r = p[0], g = p[1], b = p[2];
      plane[0].px[o] = static_cast<uint8_t>(
          (yr * r + yg * g + yb * b + half) >> 16);
      plane[1].px[o] = static_cast<uint8_t>(
          (-cbr * r - cbg * g + cbb * b + cbcr_off + half - 1) >> 16);
      plane[2].px[o] = static_cast<uint8_t>(
          (cbb * r - crg * g - crb * b + cbcr_off + half - 1) >> 16);
    }
  }
  // chroma downsampling (jcsample.c: alternating biases)
  for (int i = 1; i < c && (hs > 1 || vs > 1); ++i) {
    const int dw = pw / hs, dh = ph / vs;
    std::vector<uint8_t> d(static_cast<size_t>(dw) * dh);
    for (int y = 0; y < dh; ++y) {
      const uint8_t* r0 = plane[i].px.data() + static_cast<size_t>(y * vs) *
                                                   pw;
      const uint8_t* r1 = vs == 2 ? r0 + pw : r0;
      int bias = hs == 2 && vs == 2 ? 1 : 0;
      for (int x = 0; x < dw; ++x) {
        int v;
        if (hs == 2 && vs == 2) {
          v = (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias)
              >> 2;
          bias ^= 3;
        } else if (hs == 2) {
          v = (r0[2 * x] + r0[2 * x + 1] + bias) >> 1;
          bias ^= 1;
        } else {
          v = (r0[x] + r1[x] + 1) >> 1;
        }
        d[static_cast<size_t>(y) * dw + x] = static_cast<uint8_t>(v);
      }
    }
    plane[i].px.swap(d);
    plane[i].w = dw;
    plane[i].h = dh;
  }
  uint16_t ql[64], qc[64];
  scaled_table(kStdLuma, quality, ql);
  scaled_table(kStdChroma, quality, qc);
  const HuffCodes dcl = make_codes(kDcLumaBits, kDcVals);
  const HuffCodes acl = make_codes(kAcLumaBits, kAcLumaVals);
  const HuffCodes dcc = make_codes(kDcChromaBits, kDcVals);
  const HuffCodes acc = make_codes(kAcChromaBits, kAcChromaVals);

  ByteSink sink{out, cap};
  sink.put16(0xFFD8);
  const uint8_t jfif[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0,
                          1, 1, 0, 0, 1, 0, 1, 0, 0};
  for (uint8_t b : jfif) sink.put(b);
  for (int t = 0; t < (c == 3 ? 2 : 1); ++t) {
    const uint16_t* q = t ? qc : ql;
    sink.put16(0xFFDB);
    sink.put16(67);
    sink.put(static_cast<uint8_t>(t));
    for (int i = 0; i < 64; ++i) sink.put(static_cast<uint8_t>(q[kZigzag[i]]));
  }
  sink.put16(0xFFC0);
  sink.put16(8 + 3 * c);
  sink.put(8);
  sink.put16(h);
  sink.put16(w);
  sink.put(static_cast<uint8_t>(c));
  for (int i = 0; i < c; ++i) {
    sink.put(static_cast<uint8_t>(i + 1));
    sink.put(static_cast<uint8_t>(i == 0 ? (hs << 4) | vs : 0x11));
    sink.put(static_cast<uint8_t>(i == 0 ? 0 : 1));
  }
  struct Table {
    int cls, id;
    const uint8_t* bits;
    const uint8_t* vals;
    int n;
  };
  const Table tables[4] = {{0, 0, kDcLumaBits, kDcVals, 12},
                           {1, 0, kAcLumaBits, kAcLumaVals, 162},
                           {0, 1, kDcChromaBits, kDcVals, 12},
                           {1, 1, kAcChromaBits, kAcChromaVals, 162}};
  for (int t = 0; t < (c == 3 ? 4 : 2); ++t) {
    sink.put16(0xFFC4);
    sink.put16(2 + 1 + 16 + tables[t].n);
    sink.put(static_cast<uint8_t>((tables[t].cls << 4) | tables[t].id));
    for (int i = 0; i < 16; ++i) sink.put(tables[t].bits[i]);
    for (int i = 0; i < tables[t].n; ++i) sink.put(tables[t].vals[i]);
  }
  sink.put16(0xFFDA);
  sink.put16(6 + 2 * c);
  sink.put(static_cast<uint8_t>(c));
  for (int i = 0; i < c; ++i) {
    sink.put(static_cast<uint8_t>(i + 1));
    sink.put(static_cast<uint8_t>(i == 0 ? 0x00 : 0x11));
  }
  sink.put(0);
  sink.put(63);
  sink.put(0);
  BitWriter bw{&sink};
  int pred[3] = {0, 0, 0};
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      for (int i = 0; i < c; ++i) {
        const int bh = i == 0 ? hs : 1, bv = i == 0 ? vs : 1;
        const EncPlane& p = plane[i];
        for (int v = 0; v < bv; ++v) {
          for (int u = 0; u < bh; ++u) {
            const uint8_t* src = p.px.data() +
                static_cast<size_t>((my * bv + v) * 8) * p.w +
                (mx * bh + u) * 8;
            encode_block(bw, src, p.w, i == 0 ? ql : qc,
                         i == 0 ? dcl : dcc, i == 0 ? acl : acc, &pred[i]);
          }
        }
      }
    }
  }
  bw.flush();
  sink.put16(0xFFD9);
  return sink.len;
}

// ------------------------------------------------------------------ PNG
inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

void png_unfilter(const uint8_t* in, size_t n, int w, int h, int depth,
                  int channels, uint8_t* out) {
  const int bits = depth * channels;
  const size_t rowbytes = (static_cast<size_t>(w) * bits + 7) / 8;
  const int bpp = bits >= 8 ? bits / 8 : 1;
  if (n < static_cast<size_t>(h) * (rowbytes + 1)) {
    corrupt("PNG image data shorter than its size");
  }
  std::vector<uint8_t> prev(rowbytes, 0), cur(rowbytes);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = in + static_cast<size_t>(y) * (rowbytes + 1);
    int f = src[0];
    ++src;
    switch (f) {
      case 0:
        std::memcpy(cur.data(), src, rowbytes);
        break;
      case 1:
        for (size_t i = 0; i < rowbytes; ++i) {
          cur[i] = static_cast<uint8_t>(src[i] + (i >= static_cast<size_t>(bpp)
                                                      ? cur[i - bpp] : 0));
        }
        break;
      case 2:
        for (size_t i = 0; i < rowbytes; ++i) {
          cur[i] = static_cast<uint8_t>(src[i] + prev[i]);
        }
        break;
      case 3:
        for (size_t i = 0; i < rowbytes; ++i) {
          int a = i >= static_cast<size_t>(bpp) ? cur[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + ((a + prev[i]) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < rowbytes; ++i) {
          bool left = i >= static_cast<size_t>(bpp);
          cur[i] = static_cast<uint8_t>(
              src[i] + paeth(left ? cur[i - bpp] : 0, prev[i],
                             left ? prev[i - bpp] : 0));
        }
        break;
      default:
        corrupt("bad PNG filter type " + std::to_string(f));
    }
    uint8_t* o = out + static_cast<size_t>(y) * w * channels;
    if (depth == 8) {
      std::memcpy(o, cur.data(), rowbytes);
    } else {
      const int per = 8 / depth, mask = (1 << depth) - 1;
      for (int x = 0; x < w * channels; ++x) {
        int byte = cur[x / per];
        int shift = 8 - depth * (x % per + 1);
        o[x] = static_cast<uint8_t>((byte >> shift) & mask);
      }
    }
    prev.swap(cur);
  }
}

size_t png_filter(const uint8_t* px, int w, int h, int channels,
                  uint8_t* out) {
  const size_t rowbytes = static_cast<size_t>(w) * channels;
  const int bpp = channels;
  std::vector<uint8_t> zero(rowbytes, 0), cand[5];
  for (auto& v : cand) v.resize(rowbytes);
  for (int y = 0; y < h; ++y) {
    const uint8_t* cur = px + static_cast<size_t>(y) * rowbytes;
    const uint8_t* prev = y ? cur - rowbytes : zero.data();
    long best_sum = -1;
    int best = 0;
    for (int f : {0, 2, 1, 4}) {  // Pillow's candidates; ties: the earlier
      uint8_t* o = cand[f].data();
      long sum = 0;
      for (size_t i = 0; i < rowbytes; ++i) {
        bool left = i >= static_cast<size_t>(bpp);
        int a = left ? cur[i - bpp] : 0, b = prev[i];
        int c = left ? prev[i - bpp] : 0;
        int pred = f == 0 ? 0 : f == 1 ? a : f == 2 ? b
                 : f == 3 ? (a + b) >> 1 : paeth(a, b, c);
        o[i] = static_cast<uint8_t>(cur[i] - pred);
        sum += o[i] < 128 ? o[i] : 256 - o[i];
      }
      if (best_sum < 0 || sum < best_sum) {
        best_sum = sum;
        best = f;
      }
    }
    uint8_t* dst = out + static_cast<size_t>(y) * (rowbytes + 1);
    dst[0] = static_cast<uint8_t>(best);
    std::memcpy(dst + 1, cand[best].data(), rowbytes);
  }
  return static_cast<size_t>(h) * (rowbytes + 1);
}

}  // namespace

extern "C" {

int MXTTJpegDecode(const uint8_t* buf, uint64_t n, uint8_t* out,
                   uint64_t cap, int* w, int* h, int* c, char* err,
                   int errlen) {
  try {
    JpegDecoder d(buf, static_cast<size_t>(n));
    d.read_headers();
    *w = d.width;
    *h = d.height;
    *c = d.ncomp;
    if (out == nullptr ||
        cap < static_cast<uint64_t>(d.width) * d.height * d.ncomp) {
      return 1;
    }
    jpeg_decode(d, out);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Error{kCorrupt, "JPEG too large to decode"}, err, errlen);
  }
}

int64_t MXTTJpegEncode(const uint8_t* px, int w, int h, int c, int quality,
                       int hs, int vs, uint8_t* out, uint64_t cap, char* err,
                       int errlen) {
  try {
    return static_cast<int64_t>(
        jpeg_encode(px, w, h, c, quality, hs, vs, out, cap));
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}

int MXTTPngUnfilter(const uint8_t* in, uint64_t n, int w, int h, int depth,
                    int channels, uint8_t* out, char* err, int errlen) {
  try {
    png_unfilter(in, static_cast<size_t>(n), w, h, depth, channels, out);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}

int64_t MXTTPngFilter(const uint8_t* px, int w, int h, int channels,
                      uint8_t* out) {
  return static_cast<int64_t>(png_filter(px, w, h, channels, out));
}

}  // extern "C"
