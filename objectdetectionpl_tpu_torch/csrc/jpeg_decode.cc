// Sequential and progressive JPEG decoder (ITU T.81), host C++17.
//
// Decodes a JPEG file to packed 8-bit RGB at 1/1, 1/2, 1/4 or 1/8 scale,
// equal bit for bit to libjpeg-turbo's decompression to RGB with that
// scale_denom (what cv2.imread, with IMREAD_REDUCED_COLOR_2/4/8 for the
// reduced scales, and PIL give): every scan's coefficients go into one
// buffer a component (libjpeg's jdcoefct.c), dequantisation and the IDCT
// run once after the last scan -- the ISLOW IDCT at full scale, the reduced
// jidctred.c IDCTs (4x4, 2x2, 1x1) below it, each with the range-limit
// table -- then the upsampler that libjpeg's jdsample.c picks at that scale
// ("fancy" triangle upsampling for h2v1, h1v2 and h2v2 chroma, box
// replication otherwise) and the fixed-point YCbCr->RGB tables.
//
// Supported: SOF0/SOF1 (sequential, one scan or several, interleaved or
// not) and SOF2 (progressive Huffman: DC first and refine scans,
// interleaved or not, AC first and refine scans with EOB runs, libjpeg's
// jdphuff.c) with 8-bit samples, 1 or 3 components, sampling factors 1..4,
// DQT (8- and 16-bit), DHT and DRI between scans, restart markers.
// Everything else (lossless, hierarchical, arithmetic coding, 12-bit
// samples, 4 components, data that ends before the last MCU, a progressive
// file whose scans leave coefficient bits unsent, which libjpeg would
// smooth) is an error naming the marker or the reason.
//
// EXIF orientation: the decoder reads the Orientation tag (0x0112) of IFD0
// from the APP1 "Exif\0\0" segments before the first scan, as OpenCV's
// ExifReader reads it (the class of that name below), and returns it with
// the pixels; jpegdec::orient turns the image as cv2.imread does.  Whether to
// turn is the caller's: the JAX package's cv2.imread does, its fused
// libjpeg loader does not.
//
// C interface (one call per batch, on a pool of threads):
//   jpeg_decode_batch(paths, n, threads, denom, exif, pixels, ws, hs,
//                     codes, msgs, msg_len)
//     each worker reads file i once, parses it and decodes it at 1/denom
//     into a buffer of hs[i]*ws[i]*3 bytes that it allocates: pixels[i],
//     which the caller releases with jpeg_free; with exif != 0 turned by
//     the file's EXIF orientation (ws[i] and hs[i] are then the turned
//     image's);
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
    if (marker_ < 0) find_marker();
    if (marker_ != 0xD0 + expected)
      fail(JPEG_CORRUPT, "expected restart marker " +
                             hex_marker(0xD0 + expected) + ", found " +
                             (marker_ > 0xFF ? std::string("the end of the file")
                                             : hex_marker(marker_)));
    marker_ = -1;
  }

  // At the scan's end: where the marker after its data begins (its 0xFF),
  // or the end of the file.  Bytes before the marker are skipped, as
  // libjpeg skips them.
  const uint8_t* marker_start() {
    if (marker_ < 0) find_marker();
    return marker_ > 0xFF ? end_ : p_ - 2;
  }

 private:
  // The next marker past the data read so far (0x100: none before the end)
  void find_marker() {
    marker_ = 0x100;
    while (p_ < end_) {
      if (*p_++ != 0xFF) continue;
      while (p_ < end_ && *p_ == 0xFF) ++p_;
      if (p_ < end_ && *p_ != 0) {
        marker_ = *p_++;
        return;
      }
    }
  }

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
// Inverse DCTs: libjpeg's jidctint.c (ISLOW, 8x8) and jidctred.c (4x4,
// 2x2, 1x1) arithmetic, CONST_BITS 13 and PASS1_BITS 2, each with the
// post-IDCT range-limit table: the output index is masked to 10 bits, so
// values far out of range wrap as libjpeg's do.

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F_0_211164243 = 1730;
constexpr int64_t F_0_298631336 = 2446;
constexpr int64_t F_0_390180644 = 3196;
constexpr int64_t F_0_509795579 = 4176;
constexpr int64_t F_0_541196100 = 4433;
constexpr int64_t F_0_601344887 = 4926;
constexpr int64_t F_0_720959822 = 5906;
constexpr int64_t F_0_765366865 = 6270;
constexpr int64_t F_0_850430095 = 6967;
constexpr int64_t F_0_899976223 = 7373;
constexpr int64_t F_1_061594337 = 8697;
constexpr int64_t F_1_175875602 = 9633;
constexpr int64_t F_1_272758580 = 10426;
constexpr int64_t F_1_451774981 = 11893;
constexpr int64_t F_1_501321110 = 12299;
constexpr int64_t F_1_847759065 = 15137;
constexpr int64_t F_1_961570560 = 16069;
constexpr int64_t F_2_053119869 = 16819;
constexpr int64_t F_2_172734803 = 17799;
constexpr int64_t F_2_562915447 = 20995;
constexpr int64_t F_3_072711026 = 25172;
constexpr int64_t F_3_624509785 = 29692;

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

inline uint8_t range_limit(int64_t x) {
  return kRange.idct[static_cast<int>(x) & 1023];
}

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
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      std::memset(o, range_limit(descale(w[0], kPass1Bits + 3)), 8);
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
    o[0] = range_limit(descale(tmp10 + tmp3, n2));
    o[7] = range_limit(descale(tmp10 - tmp3, n2));
    o[1] = range_limit(descale(tmp11 + tmp2, n2));
    o[6] = range_limit(descale(tmp11 - tmp2, n2));
    o[2] = range_limit(descale(tmp12 + tmp1, n2));
    o[5] = range_limit(descale(tmp12 - tmp1, n2));
    o[3] = range_limit(descale(tmp13 + tmp0, n2));
    o[4] = range_limit(descale(tmp13 - tmp0, n2));
  }
}

// jidctred.c's jpeg_idct_4x4: the 4-point IDCT of the even-numbered and
// odd coefficients, row and column 4 left out.
void idct_4x4(const int16_t* in, const uint16_t* q, uint8_t* out,
              int stride) {
  int ws[8 * 4];
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;           // the second pass does not use it
    const int16_t* col = in + c;
    const uint16_t* qc = q + c;
    auto dq = [&](int r) { return static_cast<int64_t>(col[8 * r]) * qc[8 * r]; };
    if (!col[8] && !col[16] && !col[24] && !col[40] && !col[48] &&
        !col[56]) {
      const int dc = static_cast<int>(dq(0) * (1 << kPass1Bits));
      for (int r = 0; r < 4; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t tmp0 = dq(0) * (int64_t{1} << (kConstBits + 1));
    int64_t tmp2 = dq(2) * F_1_847759065 + dq(6) * -F_0_765366865;
    const int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    const int64_t z1 = dq(7), z2 = dq(5), z3 = dq(3), z4 = dq(1);
    tmp0 = z1 * -F_0_211164243 + z2 * F_1_451774981 + z3 * -F_2_172734803 +
           z4 * F_1_061594337;
    tmp2 = z1 * -F_0_509795579 + z2 * -F_0_601344887 + z3 * F_0_899976223 +
           z4 * F_2_562915447;
    constexpr int n = kConstBits - kPass1Bits + 1;
    ws[0 * 8 + c] = static_cast<int>(descale(tmp10 + tmp2, n));
    ws[3 * 8 + c] = static_cast<int>(descale(tmp10 - tmp2, n));
    ws[1 * 8 + c] = static_cast<int>(descale(tmp12 + tmp0, n));
    ws[2 * 8 + c] = static_cast<int>(descale(tmp12 - tmp0, n));
  }
  constexpr int n2 = kConstBits + kPass1Bits + 3 + 1;
  for (int r = 0; r < 4; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[5] && !w[6] && !w[7]) {
      std::memset(o, range_limit(descale(w[0], kPass1Bits + 3)), 4);
      continue;
    }
    int64_t tmp0 = int64_t{w[0]} * (int64_t{1} << (kConstBits + 1));
    int64_t tmp2 = w[2] * F_1_847759065 + w[6] * -F_0_765366865;
    const int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    const int64_t z1 = w[7], z2 = w[5], z3 = w[3], z4 = w[1];
    tmp0 = z1 * -F_0_211164243 + z2 * F_1_451774981 + z3 * -F_2_172734803 +
           z4 * F_1_061594337;
    tmp2 = z1 * -F_0_509795579 + z2 * -F_0_601344887 + z3 * F_0_899976223 +
           z4 * F_2_562915447;
    o[0] = range_limit(descale(tmp10 + tmp2, n2));
    o[3] = range_limit(descale(tmp10 - tmp2, n2));
    o[1] = range_limit(descale(tmp12 + tmp0, n2));
    o[2] = range_limit(descale(tmp12 - tmp0, n2));
  }
}

// jidctred.c's jpeg_idct_2x2: the DC and the odd coefficients only.
void idct_2x2(const int16_t* in, const uint16_t* q, uint8_t* out,
              int stride) {
  int ws[8 * 2];
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;
    const int16_t* col = in + c;
    const uint16_t* qc = q + c;
    auto dq = [&](int r) { return static_cast<int64_t>(col[8 * r]) * qc[8 * r]; };
    if (!col[8] && !col[24] && !col[40] && !col[56]) {
      const int dc = static_cast<int>(dq(0) * (1 << kPass1Bits));
      ws[c] = ws[8 + c] = dc;
      continue;
    }
    const int64_t tmp10 = dq(0) * (int64_t{1} << (kConstBits + 2));
    const int64_t tmp0 = dq(7) * -F_0_720959822 + dq(5) * F_0_850430095 +
                         dq(3) * -F_1_272758580 + dq(1) * F_3_624509785;
    constexpr int n = kConstBits - kPass1Bits + 2;
    ws[c] = static_cast<int>(descale(tmp10 + tmp0, n));
    ws[8 + c] = static_cast<int>(descale(tmp10 - tmp0, n));
  }
  constexpr int n2 = kConstBits + kPass1Bits + 3 + 2;
  for (int r = 0; r < 2; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[3] && !w[5] && !w[7]) {
      o[0] = o[1] = range_limit(descale(w[0], kPass1Bits + 3));
      continue;
    }
    const int64_t tmp10 = int64_t{w[0]} * (int64_t{1} << (kConstBits + 2));
    const int64_t tmp0 = w[7] * -F_0_720959822 + w[5] * F_0_850430095 +
                         w[3] * -F_1_272758580 + w[1] * F_3_624509785;
    o[0] = range_limit(descale(tmp10 + tmp0, n2));
    o[1] = range_limit(descale(tmp10 - tmp0, n2));
  }
}

// jidctred.c's jpeg_idct_1x1: the block's mean, DC / 8.
void idct_1x1(const int16_t* in, const uint16_t* q, uint8_t* out, int) {
  *out = range_limit(descale(static_cast<int64_t>(in[0]) * q[0], 3));
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
  int bw = 0, bh = 0;          // blocks inside the image
  int gw = 0, gh = 0;          // the coefficient grid: whole MCUs' blocks
  int16_t* coef = nullptr;     // gh x gw blocks of 64, natural order
  uint16_t q[64];              // the quantization table of its first scan
  bool latched = false;        // scanned
  int bits[64];                // progressive: the Al of the last scan of
                               // each coefficient, -1 before any
  int dc = 0;                  // the DC predictor of the current scan
  // the output: the IDCT's size, the component's samples at that scale and
  // its plane (whole blocks)
  int ssize = 8, dw = 0, dh = 0, stride = 0;

  int16_t* block(int row, int col) const {
    return coef + (static_cast<size_t>(row) * gw + col) * 64;
  }
};

// The EXIF Orientation of one APP1 segment's TIFF data (the bytes after
// "Exif\0\0"), read as OpenCV's ExifReader reads it, since that is what
// cv2.imread applies: byte order "II" little-endian, anything else
// big-endian; the TIFF mark 42 at 2; IFD0 at the 32-bit offset at 4; its
// 12-byte entries in order, each read by its tag -- the string tags
// (ImageDescription, Make, Model, Software, DateTime, Copyright) check that
// their data lies inside the segment (inline when 4 bytes or fewer), the
// rational tags (X/YResolution, WhitePoint, PrimaryChromaticities,
// YCbCrCoefficients, ReferenceBlackWhite) read their 1, 2, 6, 3 or 6
// rationals, the 16-bit ones (Orientation, ResolutionUnit,
// YCbCrPositioning) read the 16 bits at entry + 8 whatever the entry's
// type, others are skipped -- and the first read outside the segment ends
// the segment's entries.  Returns true with *value (any 16-bit value) when
// an Orientation entry was read before that.  Never throws out.
class ExifReader {
 public:
  ExifReader(const uint8_t* d, size_t n)
      : d_(d), n_(n), le_(n > 1 && d[0] == 'I' && d[1] == 'I') {}

  bool orientation(int* value) const {
    try {
      if (u16(2) != 42) return false;
      size_t e = u32(4);
      const uint32_t entries = u16(e);
      e += 2;
      for (uint32_t k = 0; k < entries; ++k, e += 12) {
        const uint32_t tag = u16(e);
        switch (tag) {
          case 0x0112:                               // Orientation
            *value = static_cast<int>(u16(e + 8));
            return true;
          case 0x010E: case 0x010F: case 0x0110:     // strings
          case 0x0131: case 0x0132: case 0x8298: {
            const uint64_t size = u32(e + 4);
            const uint64_t at = size > 4 ? u32(e + 8) : 8;
            if (at > n_ || at + size > n_) throw End();
            break;
          }
          case 0x011A: case 0x011B: rationals(u32(e + 8), 1); break;
          case 0x013E: rationals(u32(e + 8), 2); break;
          case 0x013F: rationals(u32(e + 8), 6); break;
          case 0x0211: rationals(u32(e + 8), 3); break;
          case 0x0214: rationals(u32(e + 8), 6); break;
          case 0x0128: case 0x0213: u16(e + 8); break;
          default: break;
        }
      }
    } catch (const End&) {
    }
    return false;
  }

 private:
  struct End {};

  uint32_t u16(uint64_t at) const {
    if (at + 1 >= n_) throw End();
    return le_ ? d_[at] | d_[at + 1] << 8 : d_[at] << 8 | d_[at + 1];
  }
  uint32_t u32(uint64_t at) const {
    if (at + 3 >= n_) throw End();
    const uint32_t a = d_[at], b = d_[at + 1], c = d_[at + 2], e = d_[at + 3];
    return le_ ? a | b << 8 | c << 16 | e << 24
               : a << 24 | b << 16 | c << 8 | e;
  }
  void rationals(uint64_t at, int count) const {
    for (int r = 0; r < count; ++r, at += 8) {
      u32(at);
      u32(at + 4);
    }
  }

  const uint8_t* d_;
  size_t n_;
  bool le_;
};

// A component's samples at the output size: a plane and its row stride.
struct View {
  const uint8_t* p;
  int stride;
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size, Buffers* b)
      : p_(data), end_(data + size), b_(b) {}

  // Reads markers up to the frame header: the image's size.
  void header(int* w, int* h) {
    if (size() < 2 || p_[0] != 0xFF || p_[1] != 0xD8)
      fail(JPEG_CORRUPT, "not a JPEG file (no SOI marker)");
    p_ += 2;
    while (!frame_) segment();
    *w = width_;
    *h = height_;
  }

  // Reads every scan, then writes the image at 1/denom scale into rgb
  // (ceil(height / denom) * ceil(width / denom) * 3 bytes).
  void decode(int denom, uint8_t* rgb) {
    while (!done_) segment();
    check_complete();
    output(8 / denom, rgb);
  }

  // The EXIF Orientation read before the first scan, 0 without one; known
  // once decode() is done.
  int orientation() const { return orientation_; }

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
    if (scans_ && p_ >= end_) {
      // libjpeg reads the end of the file after a scan as an EOI
      eoi_missing_ = done_ = true;
      return;
    }
    int c = byte();
    if (c != 0xFF) {
      // libjpeg skips garbage before a marker with a warning
      while (c != 0xFF) c = byte();
    }
    while (c == 0xFF) c = byte();
    const int m = c;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) return sof(m);
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
    if (m == 0xD9) {
      if (!scans_) fail(JPEG_CORRUPT, "EOI marker before any image data");
      done_ = true;
      return;
    }
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
    // as cv2: every Exif segment before the first scan, until one of them
    // has an Orientation entry
    if (m == 0xE1 && !has_orientation_ && !scans_ && len >= 6 &&
        !std::memcmp(d, "Exif\0\0", 6))
      has_orientation_ = ExifReader(d + 6, len - 6).orientation(&orientation_);
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
    progressive_ = m == 0xC2;
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
    // an interleaved scan covers the image in Hmax x Vmax blocks an MCU,
    // a component's own scan its blocks inside the image (jdinput.c)
    mcux_ = ceil_div(width_, hmax_ * 8);
    mcuy_ = ceil_div(height_, vmax_ * 8);
    size_t total = 0;
    for (Component& c : comps_) {
      c.bw = ceil_div(width_ * c.h, hmax_ * 8);
      c.bh = ceil_div(height_ * c.v, vmax_ * 8);
      c.gw = mcux_ * c.h;
      c.gh = mcuy_ * c.v;
      total += static_cast<size_t>(c.gw) * c.gh * 64;
      std::fill(c.bits, c.bits + 64, -1);
    }
    b_->coef.assign(total, 0);
    int16_t* next = b_->coef.data();
    for (Component& c : comps_) {
      c.coef = next;
      next += static_cast<size_t>(c.gw) * c.gh * 64;
    }
    frame_ = true;
  }

  static int ceil_div(int64_t a, int64_t b) {
    return static_cast<int>((a + b - 1) / b);
  }

  void sos() {
    if (!frame_) fail(JPEG_CORRUPT, "SOS marker before SOF");
    int len;
    const uint8_t* d = segment_body(&len);
    int ns = len > 0 ? d[0] : 0;
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns)
      fail(JPEG_CORRUPT, "bad SOS length");
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
    int blocks_in_mcu = 0;
    for (Component* c : scan) blocks_in_mcu += ns == 1 ? 1 : c->h * c->v;
    if (blocks_in_mcu > 10)
      fail(JPEG_UNSUPPORTED, "sampling factors too large for an "
                             "interleaved scan");
    const int ss = d[1 + 2 * ns], se = d[2 + 2 * ns],
              ah = d[3 + 2 * ns] >> 4, al = d[3 + 2 * ns] & 15;
    for (Component* c : scan) {
      if (!progressive_ && c->latched)
        fail(JPEG_CORRUPT, "a component in two sequential scans");
      // libjpeg latches a component's table at its first scan
      if (c->latched) continue;
      if (!quant_defined_[c->tq])
        fail(JPEG_CORRUPT, "quantization table " + std::to_string(c->tq) +
                               " not defined");
      std::memcpy(c->q, quant_[c->tq], sizeof(c->q));
      c->latched = true;
    }
    BitReader br(p_, end_);
    for (Component* c : scan) c->dc = 0;
    eobrun_ = 0;
    if (progressive_) {
      progressive_scan(scan, &br, ss, se, ah, al);
    } else {
      // libjpeg takes any Ss/Se/Ah/Al of a sequential scan as 0/63/0/0
      // (with a warning)
      for (Component* c : scan) need_tables(*c, true, true);
      sequential_scan(scan, &br);
    }
    p_ = br.marker_start();
    ++scans_;
  }

  void need_tables(const Component& c, bool dc, bool ac) const {
    if ((dc && !huff_[0][c.td].defined) || (ac && !huff_[1][c.ta].defined))
      fail(JPEG_UNSUPPORTED, "Huffman table not defined before the scan");
  }

  // Runs block(component, coefficients) over the scan's blocks in MCU
  // order, with its restart intervals: a scan of one component covers its
  // blocks inside the image, an interleaved one whole MCUs.
  template <typename Block>
  void run_scan(const std::vector<Component*>& scan, BitReader* br,
                Block block) {
    const bool single = scan.size() == 1;
    const int mcux = single ? scan[0]->bw : mcux_;
    const int mcuy = single ? scan[0]->bh : mcuy_;
    int restarts_left = restart_interval_;
    int next_rst = 0;
    const int64_t total = static_cast<int64_t>(mcux) * mcuy;
    for (int64_t mcu = 0; mcu < total; ++mcu) {
      if (restart_interval_) {
        if (restarts_left == 0) {
          br->restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          for (Component* c : scan) c->dc = 0;
          eobrun_ = 0;
          restarts_left = restart_interval_;
        }
        --restarts_left;
      }
      const int mx = static_cast<int>(mcu % mcux);
      const int my = static_cast<int>(mcu / mcux);
      if (single) {
        block(scan[0], scan[0]->block(my, mx));
        continue;
      }
      for (Component* c : scan)
        for (int by = 0; by < c->v; ++by)
          for (int bx = 0; bx < c->h; ++bx)
            block(c, c->block(my * c->v + by, mx * c->h + bx));
    }
  }

  void sequential_scan(const std::vector<Component*>& scan, BitReader* br) {
    run_scan(scan, br, [&](Component* c, int16_t* blk) {
      int s = br->decode(huff_[0][c->td]);
      if (s) c->dc += extend(br->get(s), s);
      blk[0] = static_cast<int16_t>(c->dc);
      const HuffTable& act = huff_[1][c->ta];
      for (int k = 1; k < 64; ++k) {
        int rs = br->decode(act);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(extend(br->get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    });
  }

  // libjpeg's jdphuff.c: the checks of start_pass_phuff_decoder (where
  // libjpeg only warns of a bad progression, this decoder refuses it),
  // then one of the four kinds of scan.
  void progressive_scan(const std::vector<Component*>& scan, BitReader* br,
                        int ss, int se, int ah, int al) {
    const bool dc_band = ss == 0;
    if ((dc_band ? se != 0 : ss > se || se > 63 || scan.size() != 1) ||
        (ah != 0 && al != ah - 1) || al > 13)
      fail(JPEG_CORRUPT, "bad progressive scan parameters Ss=" +
                             std::to_string(ss) + " Se=" + std::to_string(se) +
                             " Ah=" + std::to_string(ah) +
                             " Al=" + std::to_string(al));
    for (Component* c : scan) {
      if (!dc_band && c->bits[0] < 0)
        fail(JPEG_CORRUPT, "an AC scan of component " + std::to_string(c->id) +
                               " before its DC scan");
      for (int k = ss; k <= se; ++k) {
        if (ah != std::max(c->bits[k], 0))
          fail(JPEG_CORRUPT,
               "scan Ah=" + std::to_string(ah) + " does not follow "
                   "coefficient " + std::to_string(k) + " of component " +
                   std::to_string(c->id) +
                   (c->bits[k] < 0 ? std::string(" (no scan yet)")
                                   : "'s Al=" + std::to_string(c->bits[k])));
        c->bits[k] = al;
      }
      need_tables(*c, dc_band && ah == 0, !dc_band);
    }
    const int p1 = 1 << al;            // 1 in the bit position coded
    const int m1 = -p1;                // -1 in it
    if (dc_band && ah == 0) {
      run_scan(scan, br, [&](Component* c, int16_t* blk) {
        int s = br->decode(huff_[0][c->td]);
        if (s) c->dc += extend(br->get(s), s);
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c->dc) << al);
      });
    } else if (dc_band) {
      run_scan(scan, br, [&](Component*, int16_t* blk) {
        if (br->get(1)) blk[0] = static_cast<int16_t>(blk[0] | p1);
      });
    } else if (ah == 0) {
      const HuffTable& act = huff_[1][scan[0]->ta];
      run_scan(scan, br, [&](Component*, int16_t* blk) {
        if (eobrun_ > 0) {
          --eobrun_;
          return;
        }
        for (int k = ss; k <= se; ++k) {
          const int rs = br->decode(act);
          const int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            blk[kNatural[k]] = static_cast<int16_t>(
                static_cast<uint32_t>(extend(br->get(s), s)) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun_ = (1 << r) + static_cast<int>(br->get(r)) - 1;
            break;
          }
        }
      });
    } else {
      const HuffTable& act = huff_[1][scan[0]->ta];
      // a correction bit for a coefficient already nonzero: 1 means its
      // magnitude grows by p1
      auto refine = [&](int16_t* coef) {
        if (br->get(1) && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
      };
      run_scan(scan, br, [&](Component*, int16_t* blk) {
        int k = ss;
        if (eobrun_ == 0) {
          for (; k <= se; ++k) {
            const int rs = br->decode(act);
            int r = rs >> 4, s = rs & 15;
            if (s) {
              s = br->get(1) ? p1 : m1;     // a newly nonzero coefficient
            } else if (r != 15) {
              eobrun_ = (1 << r) + static_cast<int>(br->get(r));
              break;                        // the EOB run takes the rest
            }
            // skip r zero coefficients, refining the nonzero ones passed
            do {
              int16_t* coef = blk + kNatural[k];
              if (*coef != 0) {
                refine(coef);
              } else if (--r < 0) {
                break;
              }
              ++k;
            } while (k <= se);
            if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
          }
        }
        if (eobrun_ > 0) {
          for (; k <= se; ++k) {
            int16_t* coef = blk + kNatural[k];
            if (*coef != 0) refine(coef);
          }
          --eobrun_;
        }
      });
    }
  }

  // Every component scanned and, in a progressive file, every coefficient
  // bit sent: libjpeg smooths the blocks of a file whose scans leave bits
  // unsent (jdcoefct.c's block smoothing), which this decoder does not do.
  void check_complete() const {
    const std::string truncated = eoi_missing_ ? " (truncated file)" : "";
    for (const Component& c : comps_) {
      if (!c.latched)
        fail(JPEG_CORRUPT, "component " + std::to_string(c.id) +
                               " has no scan" + truncated);
      if (!progressive_) continue;
      for (int k = 0; k < 64; ++k) {
        if (c.bits[k] == 0) continue;
        if (eoi_missing_)
          fail(JPEG_CORRUPT, "file ends before the last scan (truncated "
                             "file)");
        fail(JPEG_UNSUPPORTED,
             "incomplete progressive JPEG: coefficient " + std::to_string(k) +
                 " of component " + std::to_string(c.id) +
                 (c.bits[k] < 0 ? std::string(" is never sent")
                                : " lacks its " + std::to_string(c.bits[k]) +
                                      " low bits") +
                 " (libjpeg would smooth the blocks)");
      }
    }
  }

  // The IDCT of each component at its scaled size, then upsampling and
  // colour conversion, as libjpeg's jdmaster.c, jddctmgr.c, jdsample.c and
  // jdcolor.c do at scale_denom 8 / min_ss.
  void output(int min_ss, uint8_t* rgb) {
    const int W = ceil_div(static_cast<int64_t>(width_) * min_ss, 8);
    const int H = ceil_div(static_cast<int64_t>(height_) * min_ss, 8);
    View views[3];
    for (size_t i = 0; i < comps_.size(); ++i) {
      Component& c = comps_[i];
      // jdmaster.c: raise a subsampled component's IDCT size instead of
      // upsampling, while its factors divide the frame's
      c.ssize = min_ss;
      while (c.ssize < 8 && (hmax_ * min_ss) % (c.h * c.ssize * 2) == 0 &&
             (vmax_ * min_ss) % (c.v * c.ssize * 2) == 0)
        c.ssize *= 2;
      c.dw = ceil_div(static_cast<int64_t>(width_) * c.h * c.ssize,
                      hmax_ * 8);
      c.dh = ceil_div(static_cast<int64_t>(height_) * c.v * c.ssize,
                      vmax_ * 8);
      c.stride = c.bw * c.ssize;
      std::vector<uint8_t>& plane = b_->plane[i];
      plane.resize(static_cast<size_t>(c.stride) * c.bh * c.ssize);
      auto idct = c.ssize == 8   ? idct_islow
                  : c.ssize == 4 ? idct_4x4
                  : c.ssize == 2 ? idct_2x2
                                 : idct_1x1;
      for (int by = 0; by < c.bh; ++by) {
        uint8_t* row = plane.data() +
                       static_cast<size_t>(by) * c.ssize * c.stride;
        for (int bx = 0; bx < c.bw; ++bx)
          idct(c.block(by, bx), c.q, row + bx * c.ssize, c.stride);
      }
      views[i] = upsample(c, plane.data(), &b_->full[i], W, H, min_ss);
    }
    convert(views, W, H, rgb);
  }

  // One component at the output size (W x H), as jdsample.c's upsampler
  // for its factors at this scale computes it: the component itself when
  // its samples are the output's, else written into `full`.  "Fancy"
  // upsampling needs an IDCT size above 1 (jdmainct.c gives no context
  // rows at 1/8), and for h2v1 and h2v2 a component over 2 samples wide.
  View upsample(const Component& c, const uint8_t* pl,
                std::vector<uint8_t>* full, int W, int H, int min_ss) const {
    const int st = c.stride, dw = c.dw, dh = c.dh;
    const int h_in = c.h * c.ssize / min_ss, v_in = c.v * c.ssize / min_ss;
    const bool fancy = min_ss > 1;
    if (h_in == hmax_ && v_in == vmax_) return {pl, st};
    full->resize(static_cast<size_t>(W) * H);
    uint8_t* out = full->data();
    auto row = [&](int y) { return pl + static_cast<size_t>(y) * st; };
    auto clamp_row = [&](int y) { return std::min(std::max(y, 0), dh - 1); };
    if (h_in * 2 == hmax_ && v_in == vmax_ && fancy && dw > 2) {
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
    } else if (h_in == hmax_ && v_in * 2 == vmax_ && fancy) {
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
    } else if (h_in * 2 == hmax_ && v_in * 2 == vmax_ && fancy && dw > 2) {
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
    } else if (hmax_ % h_in == 0 && vmax_ % v_in == 0) {
      // box replication (also h2v1 / h2v2 at 1 or 2 samples wide, and
      // everything at 1/8)
      const int he = hmax_ / h_in, ve = vmax_ / v_in;
      for (int y = 0; y < H; ++y) {
        const uint8_t* in = row(y / ve);
        uint8_t* o = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x) o[x] = in[x / he];
      }
    } else {
      fail(JPEG_UNSUPPORTED, "fractional sampling factors");
    }
    return {out, W};
  }

  void convert(const View* v, int W, int H, uint8_t* rgb) const {
    if (comps_.size() == 1) {
      for (int y = 0; y < H; ++y) {
        const uint8_t* g = v[0].p + static_cast<size_t>(y) * v[0].stride;
        uint8_t* o = rgb + static_cast<size_t>(y) * W * 3;
        for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      }
      return;
    }
    const bool as_rgb = is_rgb();
    const uint8_t* lim = kRange.clamp + 256;
    for (int y = 0; y < H; ++y) {
      const uint8_t* a = v[0].p + static_cast<size_t>(y) * v[0].stride;
      const uint8_t* b = v[1].p + static_cast<size_t>(y) * v[1].stride;
      const uint8_t* c = v[2].p + static_cast<size_t>(y) * v[2].stride;
      uint8_t* o = rgb + static_cast<size_t>(y) * W * 3;
      if (as_rgb) {
        for (int x = 0; x < W; ++x) {
          o[3 * x] = a[x];
          o[3 * x + 1] = b[x];
          o[3 * x + 2] = c[x];
        }
        continue;
      }
      for (int x = 0; x < W; ++x) {
        int yy = a[x], cb = b[x], cr = c[x];
        o[3 * x] = lim[yy + kColor.cr_r[cr]];
        o[3 * x + 1] = lim[yy + static_cast<int>(
                                    (kColor.cb_g[cb] + kColor.cr_g[cr]) >>
                                    kScaleBits)];
        o[3 * x + 2] = lim[yy + kColor.cb_b[cb]];
      }
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
  Buffers* b_;
  bool frame_ = false, progressive_ = false, done_ = false;
  bool eoi_missing_ = false;
  bool jfif_ = false, adobe_ = false, has_orientation_ = false;
  int adobe_transform_ = -1, orientation_ = 0;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0, scans_ = 0, eobrun_ = 0;
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

// Reads and decodes one file, its bytes into b->data, its pixels at 1/d,
// d = pick_denom(its size, target, max_denom), into the buffer that
// alloc(bytes) returns (null: out of memory), its EXIF orientation into
// *orientation.  Returns a Code.
template <typename Alloc>
int decode_with(const char* path, Buffers* b, int target, int max_denom,
                int* w, int* h, int* ow, int* oh, int* orientation,
                char* msg, int msg_len, Alloc alloc) {
  *w = *h = *ow = *oh = *orientation = 0;
  set_msg(msg, msg_len, "");
  if (!read_file(path, &b->data)) {
    set_msg(msg, msg_len, std::string("cannot read the file: ") +
                              std::strerror(errno));
    return JPEG_IO;
  }
  try {
    if (max_denom != 1 && max_denom != 2 && max_denom != 4 && max_denom != 8)
      fail(JPEG_UNSUPPORTED, "scale 1/" + std::to_string(max_denom) +
                                 " (1/1, 1/2, 1/4 or 1/8)");
    Decoder d(b->data.data(), b->data.size(), b);
    d.header(ow, oh);
    const int denom = pick_denom(*ow, *oh, target, max_denom);
    *w = (*ow + denom - 1) / denom;
    *h = (*oh + denom - 1) / denom;
    uint8_t* rgb = alloc(static_cast<size_t>(*w) * *h * 3);
    if (!rgb) throw std::bad_alloc();
    d.decode(denom, rgb);
    *orientation = d.orientation();
    return JPEG_OK;
  } catch (const Error& e) {
    set_msg(msg, msg_len, e.msg);
    return e.code;
  } catch (const std::bad_alloc&) {
    set_msg(msg, msg_len, "out of memory");
    return JPEG_CORRUPT;
  }
}

// One file at 1/denom into a buffer of *h * *w * 3 bytes that it allocates
// (*pixels, freed with jpeg_free), turned by its EXIF orientation when
// `exif`; on an error *pixels is null.
int decode_file(const char* path, Buffers* b, int denom, bool exif,
                uint8_t** pixels, int* w, int* h, char* msg, int msg_len) {
  uint8_t* rgb = nullptr;
  int ow, oh, orientation;
  int code = decode_with(path, b, 0, denom, w, h, &ow, &oh, &orientation,
                         msg, msg_len, [&](size_t bytes) {
                           rgb = static_cast<uint8_t*>(std::malloc(bytes));
                           return rgb;
                         });
  if (code == JPEG_OK && exif && orientation >= 2 && orientation <= 8) {
    uint8_t* turned = static_cast<uint8_t*>(
        std::malloc(static_cast<size_t>(*w) * *h * 3));
    if (turned) {
      orient(rgb, *w, *h, orientation, turned, w, h);
    } else {
      set_msg(msg, msg_len, "out of memory");
      code = JPEG_CORRUPT;
    }
    std::free(rgb);
    rgb = turned;
  }
  if (code != JPEG_OK) {
    std::free(rgb);
    rgb = nullptr;
  }
  *pixels = rgb;
  return code;
}

}  // namespace

extern "C" {

// Decodes file i at 1/denom into pixels[i] on up to `threads` threads,
// each file read once by the thread that decodes it.  A thread takes the
// next file when it is done with one: files of a batch differ in size, so
// a fixed share per thread leaves the others waiting on the one that drew
// the large files.
void jpeg_decode_batch(const char** paths, int n, int threads, int denom,
                       int exif, uint8_t** pixels, int* ws, int* hs,
                       int* codes, char* msgs, int msg_len) {
  const int nt = std::max(1, std::min(threads, n));
  std::atomic<int> next{0};
  auto work = [&] {
    Buffers b;
    for (int i; (i = next.fetch_add(1)) < n;)
      codes[i] = decode_file(paths[i], &b, denom, exif != 0, &pixels[i],
                             &ws[i], &hs[i],
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

int jpegdec::pick_denom(int w, int h, int target, int max_denom) {
  int d = 1;
  while (d < max_denom && w / (d * 2) >= target && h / (d * 2) >= target)
    d *= 2;
  return d;
}

int jpegdec::decode_into(const char* path, Buffers* b, int target,
                         int max_denom, int* w, int* h, int* orig_w,
                         int* orig_h, int* orientation, char* msg,
                         int msg_len) {
  return decode_with(path, b, target, max_denom, w, h, orig_w, orig_h,
                     orientation, msg, msg_len, [&](size_t bytes) {
                       b->rgb.resize(bytes);
                       return b->rgb.data();
                     });
}

void jpegdec::orient(const uint8_t* src, int w, int h, int orientation,
                     uint8_t* dst, int* out_w, int* out_h) {
  // dst(y, x) = src at offset + x * dx + y * dy (bytes): cv2's flips and
  // transposes, 2 flip x, 3 rotate 180, 4 flip y, 5 transpose, 6 rotate 90
  // clockwise, 7 transverse, 8 rotate 90 counter-clockwise; 1 and any other
  // value copy the image.
  const int64_t row = static_cast<int64_t>(w) * 3;
  const int64_t last_x = static_cast<int64_t>(w - 1) * 3;
  const int64_t last_y = static_cast<int64_t>(h - 1) * row;
  int64_t offset = 0, dx = 3, dy = row;
  switch (orientation) {
    case 2: offset = last_x; dx = -3; break;
    case 3: offset = last_y + last_x; dx = -3; dy = -row; break;
    case 4: offset = last_y; dy = -row; break;
    case 5: dx = row; dy = 3; break;
    case 6: offset = last_y; dx = -row; dy = 3; break;
    case 7: offset = last_y + last_x; dx = -row; dy = -3; break;
    case 8: offset = last_x; dx = row; dy = -3; break;
    default: break;
  }
  const bool swap = orientation >= 5 && orientation <= 8;
  *out_w = swap ? h : w;
  *out_h = swap ? w : h;
  for (int y = 0; y < *out_h; ++y) {
    const uint8_t* s = src + offset + y * dy;
    uint8_t* d = dst + static_cast<int64_t>(y) * *out_w * 3;
    for (int x = 0; x < *out_w; ++x, s += dx, d += 3) {
      d[0] = s[0];
      d[1] = s[1];
      d[2] = s[2];
    }
  }
}
