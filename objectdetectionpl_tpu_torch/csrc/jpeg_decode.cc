// Baseline sequential JPEG decoder (ITU T.81), host C++17.
//
// Decodes a JPEG file at full scale to packed 8-bit RGB, equal bit for bit
// to libjpeg-turbo's default decompression to RGB (what cv2.imread and PIL
// give): the ISLOW integer IDCT with its range-limit table, "fancy"
// triangle upsampling for h2v1, h1v2 and h2v2 chroma, box replication for
// other integer factors, and the fixed-point YCbCr->RGB tables.
//
// Supported: SOF0/SOF1 with 8-bit samples, 1 or 3 components, sampling
// factors 1..4, DQT (8- and 16-bit), DHT, DRI and restart markers, one
// interleaved scan holding every component.  Everything else (progressive,
// lossless, hierarchical, arithmetic coding, 12-bit samples, 4 components,
// several scans, data that ends before the last MCU) is an error naming the
// marker or the reason.  EXIF orientation is not applied.
//
// C interface (one call per batch, on a pool of threads):
//   jpeg_decode_batch(paths, n, threads, pixels, ws, hs, codes, msgs, msg_len)
//     each worker reads file i once, parses it and decodes it into a
//     buffer of hs[i]*ws[i]*3 bytes that it allocates: pixels[i], which the
//     caller releases with jpeg_free;
//   jpeg_free(pixel_buffer).
// A file that fails leaves pixels[i] null and sets codes[i] (JPEG_OK, ...)
// and a message at msgs + i * msg_len.
// C++ interface (jpeg_decode.h): jpegdec::decode_into, one file into
// buffers the caller reuses; preproc.cc's fused decode and resize calls it.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <thread>
#include <vector>

#include "jpeg_decode.h"

namespace {

using namespace jpegdec;

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) {
  throw Error{code, msg};
}

std::string hex_marker(int m) {
  char buf[16];
  std::snprintf(buf, sizeof(buf), "0xFF%02X", m);
  return buf;
}

// zigzag index -> natural (row-major) index; 16 extra entries absorb a
// corrupt run past the end of the block, as libjpeg's table does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------------------
// Huffman tables (T.81 Annex C, decoded as in F.2.2.3)

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoffset[18];  // symbol index = code + valoffset[length]
  uint8_t vals[256];
  // the first kLookBits bits -> (length << 8) | symbol, 0 when longer
  uint16_t look[1 << kLookBits];
};

void build_huffman(HuffTable* t, const uint8_t bits[17], const uint8_t* vals,
                   int nvals, bool dc) {
  uint8_t size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l]; ++i) size[p++] = static_cast<uint8_t>(l);
  size[p] = 0;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (1u << si)) fail(JPEG_CORRUPT, "bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t->valoffset[l] = p - static_cast<int32_t>(code_of[p]);
      p += bits[l];
      t->maxcode[l] = static_cast<int32_t>(code_of[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0x7FFFFFFF;
  std::memset(t->vals, 0, sizeof(t->vals));
  std::memcpy(t->vals, vals, nvals);
  std::memset(t->look, 0, sizeof(t->look));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      uint32_t look = code_of[p] << (kLookBits - l);
      for (int c = 0; c < (1 << (kLookBits - l)); ++c)
        t->look[look + c] = static_cast<uint16_t>((l << 8) | vals[p]);
    }
  }
  if (dc)
    for (int i = 0; i < nvals; ++i)
      if (vals[i] > 15) fail(JPEG_CORRUPT, "bad DC Huffman table");
  t->defined = true;
}

// ---------------------------------------------------------------------------
// Entropy-coded data: 0xFF00 stuffing, fill bytes, markers.  Past a marker
// (or the end of the file) the buffer fills with zero bits; consuming any of
// them means the data ended early, which is an error.

class BitReader {
 public:
  BitReader(const uint8_t* p, const uint8_t* end) : p_(p), end_(end) {}

  uint32_t peek(int n) {
    if (bits_ < n) fill();
    return static_cast<uint32_t>(buf_ >> (bits_ - n)) & ((1u << n) - 1);
  }

  void skip(int n) {
    if (bits_ < n) fill();
    if (n > bits_ - fake_) fail(JPEG_CORRUPT, "data ends before the image "
                                              "does (truncated file)");
    bits_ -= n;
  }

  uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }

  int decode(const HuffTable& t) {
    uint32_t look = peek(kLookBits);
    int e = t.look[look];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = static_cast<int32_t>(peek(l));
    while (code > t.maxcode[l]) {
      if (++l > 16) fail(JPEG_CORRUPT, "corrupt Huffman code");
      code = static_cast<int32_t>(peek(l));
    }
    skip(l);
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  // At a restart interval's end: drop the padding bits, then read the RSTn
  // marker, which must be `expected`.
  void restart(int expected) {
    buf_ = 0;
    bits_ = fake_ = 0;
    if (marker_ < 0) {
      // the padding byte(s) before the marker were not read yet
      while (p_ < end_) {
        if (*p_++ != 0xFF) continue;
        while (p_ < end_ && *p_ == 0xFF) ++p_;
        if (p_ < end_ && *p_ != 0) {
          marker_ = *p_++;
          break;
        }
      }
    }
    if (marker_ != 0xD0 + expected)
      fail(JPEG_CORRUPT, "expected restart marker " +
                             hex_marker(0xD0 + expected) + ", found " +
                             (marker_ < 0 || marker_ > 0xFF
                                  ? std::string("the end of the file")
                                          : hex_marker(marker_)));
    marker_ = -1;
  }

 private:
  void fill() {
    while (bits_ <= 56) {
      uint32_t c = 0;
      if (marker_ >= 0 || p_ >= end_) {
        if (marker_ < 0) marker_ = 0x100;   // end of file: no marker
        fake_ += 8;
      } else {
        c = *p_++;
        if (c == 0xFF) {
          while (p_ < end_ && *p_ == 0xFF) ++p_;   // fill bytes
          if (p_ >= end_) {
            marker_ = 0x100;
            c = 0;
            fake_ += 8;
          } else if (*p_ == 0) {
            ++p_;                                  // stuffed 0xFF data byte
          } else {
            marker_ = *p_++;
            c = 0;
            fake_ += 8;
          }
        }
      }
      buf_ = (buf_ << 8) | c;
      bits_ += 8;
    }
  }

  const uint8_t* p_;
  const uint8_t* end_;
  uint64_t buf_ = 0;
  int bits_ = 0;
  int fake_ = 0;      // zero bits past the data, at the low end of buf_
  int marker_ = -1;   // the marker that ended the data, 0x100 for EOF
};

inline int extend(uint32_t v, int s) {
  return (v < (1u << (s - 1))) ? static_cast<int>(v) - (1 << s) + 1
                               : static_cast<int>(v);
}

// ---------------------------------------------------------------------------
// ISLOW inverse DCT: libjpeg's jidctint.c arithmetic (CONST_BITS 13,
// PASS1_BITS 2), with the post-IDCT range-limit table: the output index is
// masked to 10 bits, so values far out of range wrap as libjpeg's do.

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F_0_298631336 = 2446;
constexpr int64_t F_0_390180644 = 3196;
constexpr int64_t F_0_541196100 = 4433;
constexpr int64_t F_0_765366865 = 6270;
constexpr int64_t F_0_899976223 = 7373;
constexpr int64_t F_1_175875602 = 9633;
constexpr int64_t F_1_501321110 = 12299;
constexpr int64_t F_1_847759065 = 15137;
constexpr int64_t F_1_961570560 = 16069;
constexpr int64_t F_2_053119869 = 16819;
constexpr int64_t F_2_562915447 = 20995;
constexpr int64_t F_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

struct RangeTable {
  uint8_t idct[1024];   // centred IDCT output & 1023 -> sample
  uint8_t clamp[256 + 512 + 256];
  RangeTable() {
    for (int x = 0; x < 1024; ++x) {
      int v = x < 128 ? x + 128 : x < 512 ? 255 : x < 896 ? 0 : x - 896;
      idct[x] = static_cast<uint8_t>(v);
    }
    for (int i = 0; i < 1024; ++i)
      clamp[i] = static_cast<uint8_t>(std::min(std::max(i - 256, 0), 255));
  }
};
const RangeTable kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* col = in + c;
    const uint16_t* qc = q + c;
    if (!col[8] && !col[16] && !col[24] && !col[32] && !col[40] &&
        !col[48] && !col[56]) {
      int dc = static_cast<int>(col[0]) * static_cast<int>(qc[0])
               * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(col[16]) * qc[16];
    int64_t z3 = static_cast<int64_t>(col[48]) * qc[48];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    z2 = static_cast<int64_t>(col[0]) * qc[0];
    z3 = static_cast<int64_t>(col[32]) * qc[32];
    int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(col[56]) * qc[56];
    tmp1 = static_cast<int64_t>(col[40]) * qc[40];
    tmp2 = static_cast<int64_t>(col[24]) * qc[24];
    tmp3 = static_cast<int64_t>(col[8]) * qc[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = static_cast<int>(descale(tmp10 + tmp3, n));
    ws[7 * 8 + c] = static_cast<int>(descale(tmp10 - tmp3, n));
    ws[1 * 8 + c] = static_cast<int>(descale(tmp11 + tmp2, n));
    ws[6 * 8 + c] = static_cast<int>(descale(tmp11 - tmp2, n));
    ws[2 * 8 + c] = static_cast<int>(descale(tmp12 + tmp1, n));
    ws[5 * 8 + c] = static_cast<int>(descale(tmp12 - tmp1, n));
    ws[3 * 8 + c] = static_cast<int>(descale(tmp13 + tmp0, n));
    ws[4 * 8 + c] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  constexpr int n2 = kConstBits + kPass1Bits + 3;
  const uint8_t* lim = kRange.idct;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = lim[static_cast<int>(descale(w[0], kPass1Bits + 3)) & 1023];
      std::memset(o, v, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    int64_t tmp0 = (int64_t{w[0]} + w[4]) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (int64_t{w[0]} - w[4]) * (int64_t{1} << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = lim[static_cast<int>(descale(tmp10 + tmp3, n2)) & 1023];
    o[7] = lim[static_cast<int>(descale(tmp10 - tmp3, n2)) & 1023];
    o[1] = lim[static_cast<int>(descale(tmp11 + tmp2, n2)) & 1023];
    o[6] = lim[static_cast<int>(descale(tmp11 - tmp2, n2)) & 1023];
    o[2] = lim[static_cast<int>(descale(tmp12 + tmp1, n2)) & 1023];
    o[5] = lim[static_cast<int>(descale(tmp12 - tmp1, n2)) & 1023];
    o[3] = lim[static_cast<int>(descale(tmp13 + tmp0, n2)) & 1023];
    o[4] = lim[static_cast<int>(descale(tmp13 - tmp0, n2)) & 1023];
  }
}

// ---------------------------------------------------------------------------
// YCbCr -> RGB: libjpeg's jdcolor.c tables (SCALEBITS 16, ONE_HALF
// rounding), then a clamp to [0, 255].

constexpr int kScaleBits = 16;
constexpr int64_t kOneHalf = int64_t{1} << (kScaleBits - 1);
constexpr int64_t fix(double x) {
  return static_cast<int64_t>(x * (1 << kScaleBits) + 0.5);
}

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
    }
  }
};
const ColorTables kColor;

// ---------------------------------------------------------------------------
// The decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int dw = 0, dh = 0;        // samples of the component inside the image
  int stride = 0, rows = 0;  // the plane: whole MCUs' blocks
  std::vector<uint8_t> plane;
  int dc = 0;
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : p_(data), end_(data + size) {}

  // Reads markers up to the frame header: the image's size.
  void header(int* w, int* h) {
    if (size() < 2 || p_[0] != 0xFF || p_[1] != 0xD8)
      fail(JPEG_CORRUPT, "not a JPEG file (no SOI marker)");
    p_ += 2;
    while (!frame_) segment();
    *w = width_;
    *h = height_;
  }

  // Decodes the whole image into rgb (height * width * 3 bytes).
  void decode(uint8_t* rgb) {
    while (!scanned_) segment();
    upsample_and_convert(rgb);
  }

 private:
  size_t size() const { return static_cast<size_t>(end_ - p_); }

  int byte() {
    if (p_ >= end_) fail(JPEG_CORRUPT, "file ends inside a marker segment "
                                       "(truncated file)");
    return *p_++;
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // One marker and its segment.
  void segment() {
    int c = byte();
    if (c != 0xFF) {
      // libjpeg skips garbage before a marker with a warning
      while (c != 0xFF) c = byte();
    }
    while (c == 0xFF) c = byte();
    const int m = c;
    if (m == 0xC0 || m == 0xC1) return sof(m);
    if (m == 0xC2)
      fail(JPEG_UNSUPPORTED, "progressive JPEG (SOF2 marker 0xFFC2)");
    if ((m >= 0xC3 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC))
      fail(JPEG_UNSUPPORTED,
           "SOF marker " + hex_marker(m) +
               " (lossless, hierarchical or arithmetic-coded JPEG)");
    if (m == 0xCC)
      fail(JPEG_UNSUPPORTED, "arithmetic-coded JPEG (DAC marker 0xFFCC)");
    if (m == 0xC4) return dht();
    if (m == 0xDB) return dqt();
    if (m == 0xDD) return dri();
    if (m == 0xDA) return sos();
    if (m == 0xD9) fail(JPEG_CORRUPT, "EOI marker before any image data");
    if (m == 0xDC)
      fail(JPEG_UNSUPPORTED,
           "DNL marker 0xFFDC (height given after the scan)");
    if (m >= 0xE0 && m <= 0xEF) return app(m);
    if (m == 0xFE) return skip_segment();
    fail(JPEG_CORRUPT, "unexpected marker " + hex_marker(m));
  }

  const uint8_t* segment_body(int* len) {
    int l = u16();
    if (l < 2) fail(JPEG_CORRUPT, "bad marker segment length");
    l -= 2;
    if (size() < static_cast<size_t>(l))
      fail(JPEG_CORRUPT, "file ends inside a marker segment (truncated file)");
    const uint8_t* body = p_;
    p_ += l;
    *len = l;
    return body;
  }

  void skip_segment() {
    int len;
    segment_body(&len);
  }

  void app(int m) {
    int len;
    const uint8_t* d = segment_body(&len);
    if (m == 0xE0 && len >= 14 && !std::memcmp(d, "JFIF\0", 5)) jfif_ = true;
    if (m == 0xEE && len >= 12 && !std::memcmp(d, "Adobe", 5)) {
      adobe_ = true;
      adobe_transform_ = d[11];
    }
  }

  void dqt() {
    int len;
    const uint8_t* d = segment_body(&len);
    int i = 0;
    while (i < len) {
      int pq = d[i] >> 4, tq = d[i] & 15;
      ++i;
      if (tq > 3 || pq > 1) fail(JPEG_CORRUPT, "bad DQT table");
      int need = pq ? 128 : 64;
      if (len - i < need) fail(JPEG_CORRUPT, "bad DQT length");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (d[i + 2 * k] << 8) | d[i + 2 * k + 1] : d[i + k];
        quant_[tq][kNatural[k]] = static_cast<uint16_t>(v);
      }
      quant_defined_[tq] = true;
      i += need;
    }
  }

  void dht() {
    int len;
    const uint8_t* d = segment_body(&len);
    int i = 0;
    while (i < len) {
      if (len - i < 17) fail(JPEG_CORRUPT, "bad DHT length");
      int tc = d[i] >> 4, th = d[i] & 15;
      if (tc > 1 || th > 3) fail(JPEG_CORRUPT, "bad DHT table");
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += bits[l] = d[i + l];
      i += 17;
      if (count > 256 || len - i < count) fail(JPEG_CORRUPT, "bad DHT table");
      build_huffman(&huff_[tc][th], bits, d + i, count, tc == 0);
      i += count;
    }
  }

  void dri() {
    int len;
    const uint8_t* d = segment_body(&len);
    if (len != 2) fail(JPEG_CORRUPT, "bad DRI length");
    restart_interval_ = (d[0] << 8) | d[1];
  }

  void sof(int m) {
    if (frame_) fail(JPEG_UNSUPPORTED, "a second SOF marker");
    int len;
    const uint8_t* d = segment_body(&len);
    if (len < 6) fail(JPEG_CORRUPT, "bad SOF length");
    int precision = d[0];
    height_ = (d[1] << 8) | d[2];
    width_ = (d[3] << 8) | d[4];
    int nf = d[5];
    if (precision != 8)
      fail(JPEG_UNSUPPORTED, std::to_string(precision) + "-bit samples (SOF " +
                                 hex_marker(m) + "); only 8-bit is supported");
    if (nf == 4)
      fail(JPEG_UNSUPPORTED, "4 components (CMYK or YCCK)");
    if (nf != 1 && nf != 3)
      fail(JPEG_UNSUPPORTED, std::to_string(nf) + " components");
    if (len != 6 + 3 * nf) fail(JPEG_CORRUPT, "bad SOF length");
    if (height_ == 0)
      fail(JPEG_UNSUPPORTED, "height 0 in the SOF (DNL marker)");
    if (width_ == 0) fail(JPEG_CORRUPT, "width 0 in the SOF");
    comps_.resize(nf);
    for (int i = 0; i < nf; ++i) {
      Component& c = comps_[i];
      c.id = d[6 + 3 * i];
      c.h = d[7 + 3 * i] >> 4;
      c.v = d[7 + 3 * i] & 15;
      c.tq = d[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail(JPEG_CORRUPT, "bad sampling factors");
      if (c.tq > 3) fail(JPEG_CORRUPT, "bad quantization table index");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    frame_ = true;
  }

  void sos() {
    if (!frame_) fail(JPEG_CORRUPT, "SOS marker before SOF");
    int len;
    const uint8_t* d = segment_body(&len);
    int ns = len > 0 ? d[0] : 0;
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns)
      fail(JPEG_CORRUPT, "bad SOS length");
    if (ns != static_cast<int>(comps_.size()))
      fail(JPEG_UNSUPPORTED,
           "a scan of " + std::to_string(ns) + " of " +
               std::to_string(comps_.size()) +
               " components (non-interleaved multi-scan JPEG)");
    std::vector<Component*> scan;
    for (int i = 0; i < ns; ++i) {
      int id = d[1 + 2 * i];
      Component* c = nullptr;
      for (auto& k : comps_)
        if (k.id == id) c = &k;
      if (!c) fail(JPEG_CORRUPT, "SOS names an unknown component");
      for (Component* k : scan)
        if (k == c) fail(JPEG_CORRUPT, "SOS names a component twice");
      c->td = d[2 + 2 * i] >> 4;
      c->ta = d[2 + 2 * i] & 15;
      if (c->td > 3 || c->ta > 3)
        fail(JPEG_CORRUPT, "bad Huffman table index");
      scan.push_back(c);
    }
    int ss = d[1 + 2 * ns], se = d[2 + 2 * ns], ah = d[3 + 2 * ns] >> 4,
        al = d[3 + 2 * ns] & 15;
    if (ss != 0 || se != 63 || ah != 0 || al != 0)
      fail(JPEG_UNSUPPORTED, "a scan that is not sequential (Ss/Se/Ah/Al)");
    for (Component* c : scan) {
      if (!quant_defined_[c->tq])
        fail(JPEG_CORRUPT, "quantization table " + std::to_string(c->tq) +
                               " not defined");
      if (!huff_[0][c->td].defined || !huff_[1][c->ta].defined)
        fail(JPEG_UNSUPPORTED, "Huffman table not defined before the scan");
    }
    scan_entropy(scan);
    scanned_ = true;
  }

  void scan_entropy(const std::vector<Component*>& scan) {
    const bool single = scan.size() == 1;
    int blocks_in_mcu = 0;
    for (Component* c : scan) blocks_in_mcu += single ? 1 : c->h * c->v;
    if (blocks_in_mcu > 10)
      fail(JPEG_UNSUPPORTED, "sampling factors too large for an "
                             "interleaved scan");
    // a single-component scan has one block per MCU over the component's
    // own size; an interleaved one covers the image in Hmax x Vmax blocks
    const int hs = single ? scan[0]->h : 1, vs = single ? scan[0]->v : 1;
    const int mcux = (width_ * hs + hmax_ * 8 - 1) / (hmax_ * 8);
    const int mcuy = (height_ * vs + vmax_ * 8 - 1) / (vmax_ * 8);
    for (Component& c : comps_) {
      c.dw = (width_ * c.h + hmax_ - 1) / hmax_;
      c.dh = (height_ * c.v + vmax_ - 1) / vmax_;
      int bw = single ? mcux : mcux * c.h, bh = single ? mcuy : mcuy * c.v;
      c.stride = bw * 8;
      c.rows = bh * 8;
      c.plane.assign(static_cast<size_t>(c.stride) * c.rows, 0);
      c.dc = 0;
    }
    BitReader br(p_, end_);
    int16_t block[64];
    int restarts_left = restart_interval_;
    int next_rst = 0;
    const int total = mcux * mcuy;
    for (int mcu = 0; mcu < total; ++mcu) {
      if (restart_interval_) {
        if (restarts_left == 0) {
          br.restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          for (Component* c : scan) c->dc = 0;
          restarts_left = restart_interval_;
        }
        --restarts_left;
      }
      const int mx = mcu % mcux, my = mcu / mcux;
      for (Component* c : scan) {
        const int bh = single ? 1 : c->h, bv = single ? 1 : c->v;
        const HuffTable& dct = huff_[0][c->td];
        const HuffTable& act = huff_[1][c->ta];
        const uint16_t* q = quant_[c->tq];
        for (int by = 0; by < bv; ++by) {
          for (int bx = 0; bx < bh; ++bx) {
            std::memset(block, 0, sizeof(block));
            int s = br.decode(dct);
            if (s) c->dc += extend(br.get(s), s);
            block[0] = static_cast<int16_t>(c->dc);
            for (int k = 1; k < 64; ++k) {
              int rs = br.decode(act);
              int r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                block[kNatural[k]] =
                    static_cast<int16_t>(extend(br.get(s), s));
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
            const int col = (mx * bh + bx) * 8, row = (my * bv + by) * 8;
            idct_islow(block, q, c->plane.data() + static_cast<size_t>(row) *
                                                   c->stride + col, c->stride);
          }
        }
      }
    }
  }

  // One component's sample at (x, y) of the full-size image, as libjpeg's
  // upsampler for the component's factors computes it, into `out`
  // (width_ x height_).
  void upsample(const Component& c, uint8_t* out) const {
    const int W = width_, H = height_;
    const uint8_t* pl = c.plane.data();
    const int st = c.stride, dw = c.dw, dh = c.dh;
    auto row = [&](int y) { return pl + static_cast<size_t>(y) * st; };
    auto clamp_row = [&](int y) { return std::min(std::max(y, 0), dh - 1); };
    if (c.h == hmax_ && c.v == vmax_) {
      for (int y = 0; y < H; ++y) std::memcpy(out + y * W, row(y), W);
    } else if (c.h * 2 == hmax_ && c.v == vmax_ && dw > 2) {
      // h2v1 fancy: 3/4 nearer + 1/4 further sample
      for (int y = 0; y < H; ++y) {
        const uint8_t* in = row(y);
        uint8_t* o = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x) {
          int i = x >> 1;
          int v;
          if (!(x & 1))
            v = i == 0 ? in[0] : (in[i] * 3 + in[i - 1] + 1) >> 2;
          else
            v = i == dw - 1 ? in[i] : (in[i] * 3 + in[i + 1] + 2) >> 2;
          o[x] = static_cast<uint8_t>(v);
        }
      }
    } else if (c.h == hmax_ && c.v * 2 == vmax_) {
      // h1v2 fancy (libjpeg-turbo): the row above with bias 1, below with 2
      for (int y = 0; y < H; ++y) {
        int i = y >> 1;
        const uint8_t* near = row(i);
        const uint8_t* far = row(clamp_row(y & 1 ? i + 1 : i - 1));
        int bias = y & 1 ? 2 : 1;
        uint8_t* o = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x)
          o[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
      }
    } else if (c.h * 2 == hmax_ && c.v * 2 == vmax_ && dw > 2) {
      // h2v2 fancy: triangle filter over the column sums 3*near + far
      std::vector<int> sum(dw);
      for (int y = 0; y < H; ++y) {
        int i = y >> 1;
        const uint8_t* near = row(i);
        const uint8_t* far = row(clamp_row(y & 1 ? i + 1 : i - 1));
        for (int k = 0; k < dw; ++k) sum[k] = near[k] * 3 + far[k];
        uint8_t* o = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x) {
          int k = x >> 1;
          int v;
          if (!(x & 1))
            v = k == 0 ? (sum[0] * 4 + 8) >> 4
                       : (sum[k] * 3 + sum[k - 1] + 8) >> 4;
          else
            v = k == dw - 1 ? (sum[k] * 4 + 7) >> 4
                            : (sum[k] * 3 + sum[k + 1] + 7) >> 4;
          o[x] = static_cast<uint8_t>(v);
        }
      }
    } else if (hmax_ % c.h == 0 && vmax_ % c.v == 0) {
      // box replication (also h2v1 / h2v2 at 1 or 2 samples wide)
      const int he = hmax_ / c.h, ve = vmax_ / c.v;
      for (int y = 0; y < H; ++y) {
        const uint8_t* in = row(y / ve);
        uint8_t* o = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x) o[x] = in[x / he];
      }
    } else {
      fail(JPEG_UNSUPPORTED, "fractional sampling factors");
    }
  }

  void upsample_and_convert(uint8_t* rgb) const {
    const size_t n = static_cast<size_t>(width_) * height_;
    if (comps_.size() == 1) {
      std::vector<uint8_t> g(n);
      upsample(comps_[0], g.data());
      for (size_t i = 0; i < n; ++i)
        rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
      return;
    }
    std::vector<uint8_t> a(n), b(n), c(n);
    upsample(comps_[0], a.data());
    upsample(comps_[1], b.data());
    upsample(comps_[2], c.data());
    if (is_rgb()) {
      for (size_t i = 0; i < n; ++i) {
        rgb[3 * i] = a[i];
        rgb[3 * i + 1] = b[i];
        rgb[3 * i + 2] = c[i];
      }
      return;
    }
    const uint8_t* lim = kRange.clamp + 256;
    for (size_t i = 0; i < n; ++i) {
      int y = a[i], cb = b[i], cr = c[i];
      rgb[3 * i] = lim[y + kColor.cr_r[cr]];
      rgb[3 * i + 1] = lim[y + static_cast<int>(
                                   (kColor.cb_g[cb] + kColor.cr_g[cr]) >>
                                   kScaleBits)];
      rgb[3 * i + 2] = lim[y + kColor.cb_b[cb]];
    }
  }

  // libjpeg's default colour space for 3 components: JFIF means YCbCr, an
  // Adobe marker's transform 0 means RGB, else component ids 'R','G','B'.
  bool is_rgb() const {
    if (jfif_) return false;
    if (adobe_) return adobe_transform_ == 0;
    return comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
  }

  const uint8_t* p_;
  const uint8_t* end_;
  bool frame_ = false, scanned_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1;
  int restart_interval_ = 0;
  std::vector<Component> comps_;
  uint16_t quant_[4][64] = {};
  bool quant_defined_[4] = {false, false, false, false};
  HuffTable huff_[2][4];
};

bool read_file(const char* path, std::vector<uint8_t>* data) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  data->clear();
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof(buf), f)) > 0)
    data->insert(data->end(), buf, buf + got);
  bool ok = !std::ferror(f);
  std::fclose(f);
  return ok;
}

void set_msg(char* msg, int msg_len, const std::string& s) {
  if (!msg || msg_len <= 0) return;
  std::snprintf(msg, msg_len, "%s", s.c_str());
}

// Reads and decodes one file, its bytes into *data, its pixels into the
// buffer that alloc(bytes) returns (null: out of memory).  Returns a Code.
template <typename Alloc>
int decode_with(const char* path, std::vector<uint8_t>* data, int* w, int* h,
                char* msg, int msg_len, Alloc alloc) {
  *w = *h = 0;
  set_msg(msg, msg_len, "");
  if (!read_file(path, data)) {
    set_msg(msg, msg_len, std::string("cannot read the file: ") +
                              std::strerror(errno));
    return JPEG_IO;
  }
  try {
    Decoder d(data->data(), data->size());
    d.header(w, h);
    uint8_t* rgb = alloc(static_cast<size_t>(*w) * *h * 3);
    if (!rgb) throw std::bad_alloc();
    d.decode(rgb);
    return JPEG_OK;
  } catch (const Error& e) {
    set_msg(msg, msg_len, e.msg);
    return e.code;
  } catch (const std::bad_alloc&) {
    set_msg(msg, msg_len, "out of memory");
    return JPEG_CORRUPT;
  }
}

// One file into a buffer of *h * *w * 3 bytes that it allocates (*pixels,
// freed with jpeg_free); on an error *pixels is null.
int decode_file(const char* path, uint8_t** pixels, int* w, int* h, char* msg,
                int msg_len) {
  std::vector<uint8_t> data;
  uint8_t* rgb = nullptr;
  const int code = decode_with(path, &data, w, h, msg, msg_len,
                               [&](size_t bytes) {
                                 rgb = static_cast<uint8_t*>(
                                     std::malloc(bytes));
                                 return rgb;
                               });
  if (code != JPEG_OK) {
    std::free(rgb);
    rgb = nullptr;
  }
  *pixels = rgb;
  return code;
}

}  // namespace

extern "C" {

// Decodes file i into pixels[i] on up to `threads` threads, each file read
// once by the thread that decodes it.  A thread takes the next file when it
// is done with one: files of a batch differ in size, so a fixed share per
// thread leaves the others waiting on the one that drew the large files.
void jpeg_decode_batch(const char** paths, int n, int threads,
                       uint8_t** pixels, int* ws, int* hs, int* codes,
                       char* msgs, int msg_len) {
  const int nt = std::max(1, std::min(threads, n));
  std::atomic<int> next{0};
  auto work = [&] {
    for (int i; (i = next.fetch_add(1)) < n;)
      codes[i] = decode_file(paths[i], &pixels[i], &ws[i], &hs[i],
                             msgs + static_cast<int64_t>(i) * msg_len,
                             msg_len);
  };
  if (nt == 1) {
    work();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

void jpeg_free(uint8_t* pixels) { std::free(pixels); }

}  // extern "C"

int jpegdec::decode_into(const char* path, std::vector<uint8_t>* data,
                         std::vector<uint8_t>* rgb, int* w, int* h, char* msg,
                         int msg_len) {
  return decode_with(path, data, w, h, msg, msg_len, [&](size_t bytes) {
    rgb->resize(bytes);
    return rgb->data();
  });
}
