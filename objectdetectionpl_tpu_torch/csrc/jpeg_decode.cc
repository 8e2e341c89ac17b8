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
// jdphuff.c), and their arithmetic-coded twins SOF9/SOF10 with DAC
// (jdarith.c), with 8-bit samples, 1, 3 or 4 components, sampling factors
// 1..4, DQT (8- and 16-bit), DHT and DRI between scans, restart markers.
// 4 components (CMYK, or YCCK under an Adobe transform other than 0)
// decode as cv2.imread decodes them (READ_IMREAD: libjpeg's CMYK output,
// then cv2's CMYK -> BGR); without that flag they fail, as libjpeg's RGB
// output refuses them.  Damaged data decode as libjpeg-turbo decodes them:
// zero bits past a marker or the end of the file (its source manager
// answers with FF D9) and the rest of the restart interval left zero,
// symbol 0 for a bad Huffman code, jpeg_resync_to_restart's actions on a
// missing or wrong RSTn, and the IDCTs in the 16-bit lanes of its SIMD
// code.  A progressive file whose scans leave bits of coefficients 1..9
// unsent (cut, or an unfinished scan script) is smoothed as jdcoefct.c
// smooths it: libjpeg-turbo 3's neighbour rows and columns with
// READ_IMREAD (cv2's), 2.1's without (the system library of the JAX
// package's fused loader).  Lossless files (SOF3) decode with READ_IMREAD
// as libjpeg-turbo 3 decodes them for cv2 (lossless_scan below); without
// it they fail, as the system's libjpeg 2.1 fails them.  Errors naming
// the marker or the reason: hierarchical files, 12-bit samples (refused
// by cv2's and the system's 8-bit libjpeg too) and a file cut before its
// first scan.
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
#include <functional>
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
constexpr size_t kEofPad = 65540;    // FF D9 pairs after a file's last byte

struct HuffTable {
  bool defined = false;
  int max_val = 0;        // the largest symbol (a DC table's is checked at
                          // the scan that uses it, as libjpeg checks it)
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoffset[18];  // symbol index = code + valoffset[length]
  uint8_t vals[256];
  // the first kLookBits bits -> (length << 8) | symbol, 0 when longer
  uint16_t look[1 << kLookBits];
};

void build_huffman(HuffTable* t, const uint8_t bits[17], const uint8_t* vals,
                   int nvals) {
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
  t->max_val = 0;
  for (int i = 0; i < nvals; ++i) t->max_val = std::max<int>(t->max_val, vals[i]);
  t->defined = true;
}

// The Huffman tables of T.81 K.3 (libjpeg's jstdhuff.c), which
// libjpeg-turbo's jinit_huff_decoder installs in every empty slot 0 and 1
// of a sequential Huffman file: what Motion-JPEG frames, which carry no
// DHT, are coded with.
constexpr uint8_t kBits_dc_luminance[] = {
    0x00, 0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00};
constexpr uint8_t kVal_dc_luminance[] = {
    0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b};
constexpr uint8_t kBits_ac_luminance[] = {
    0x00, 0x00, 0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04,
    0x04, 0x00, 0x00, 0x01, 0x7d};
constexpr uint8_t kVal_ac_luminance[] = {
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
constexpr uint8_t kBits_dc_chrominance[] = {
    0x00, 0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01,
    0x00, 0x00, 0x00, 0x00, 0x00};
constexpr uint8_t kVal_dc_chrominance[] = {
    0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b};
constexpr uint8_t kBits_ac_chrominance[] = {
    0x00, 0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05, 0x04,
    0x04, 0x00, 0x01, 0x02, 0x77};
constexpr uint8_t kVal_ac_chrominance[] = {
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

// ---------------------------------------------------------------------------
// Entropy-coded data: 0xFF00 stuffing, fill bytes, markers.  Past a marker
// (or the end of the file, which libjpeg's source manager turns into an EOI
// marker) the data are zero bits, as libjpeg supplies them: a scan whose
// data end early decodes on (jdhuff.c's insufficient_data, below).

class Source {
 public:
  Source(const uint8_t* p, const uint8_t* end) : p_(p), end_(end) {}

  // At a restart interval's end: libjpeg's read_restart_marker.  The marker
  // after the data read so far should be RSTn, n = `desired`; any other
  // goes to jpeg_resync_to_restart's default recovery: a marker below
  // SOF0 is skipped (scan on to the next one), RST(desired-1 or -2) is
  // skipped too, RST(desired+1 or +2) and every other valid marker stay
  // unread (the interval decodes as empty: zero bits), and anything else
  // (another RSTn) is taken as the restart.
  void read_restart_marker(int desired) {
    if (marker_ < 0) find_marker();
    if (marker_ == 0xD0 + desired) {
      marker_ = -1;
      return;
    }
    for (;;) {
      const int m = marker_ > 0xFF ? 0xD9 : marker_;   // end of file: EOI
      auto rst = [&](int k) { return m == 0xD0 + ((desired + k) & 7); };
      int action;
      if (m < 0xC0)
        action = 2;
      else if (m < 0xD0 || m > 0xD7)
        action = 3;
      else if (rst(1) || rst(2))
        action = 3;
      else if (rst(-1) || rst(-2))
        action = 2;
      else
        action = 1;
      if (action == 1) {
        marker_ = -1;
        return;
      }
      if (action == 3) return;
      find_marker();
    }
  }

  // At the scan's end: where the marker after its data begins (its 0xFF),
  // or the end of the file.  Bytes before the marker are skipped, as
  // libjpeg skips them.
  const uint8_t* marker_start() {
    if (marker_ < 0) find_marker();
    return marker_ > 0xFF ? end_ : p_ - 2;
  }

 protected:
  // The next marker past the data read so far (0x100: none before the end),
  // libjpeg's next_marker
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

  // The next data byte, 0 once a marker (or the end) has been met: a
  // stuffed 0xFF00 is 0xFF, fill bytes before a marker are dropped.
  int data_byte() {
    if (marker_ >= 0) return 0;
    if (p_ >= end_) {
      marker_ = 0x100;
      return 0;
    }
    int c = *p_++;
    if (c != 0xFF) return c;
    while (p_ < end_ && *p_ == 0xFF) ++p_;
    if (p_ >= end_) {
      marker_ = 0x100;
      return 0;
    }
    if (*p_ == 0) {
      ++p_;
      return 0xFF;
    }
    marker_ = *p_++;
    return 0;
  }

  const uint8_t* p_;
  const uint8_t* end_;
  int marker_ = -1;   // the marker that ended the data, 0x100 for EOF
};

// Huffman-coded data, read as jdhuff.c reads it: the bit buffer holds up to
// 64 bits and takes bytes while it has 56 or fewer.  Consuming a bit past
// the data sets insufficient(): libjpeg then leaves the rest of the
// interval's MCUs zero.
class BitReader : public Source {
 public:
  using Source::Source;

  uint32_t peek(int n) {
    if (bits_ < n) fill();
    return static_cast<uint32_t>(buf_ >> (bits_ - n)) & ((1u << n) - 1);
  }

  void skip(int n) {
    if (bits_ < n) fill();
    if (n > bits_ - fake_) insufficient_ = true;
    bits_ -= n;
    fake_ = std::min(fake_, bits_);
  }

  uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }

  // A symbol; a code that no table entry matches takes 17 bits and gives
  // symbol 0, as jdhuff.c's jpeg_huff_decode (a warning there).
  int decode(const HuffTable& t) {
    uint32_t look = peek(kLookBits);
    int e = t.look[look];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = static_cast<int32_t>(peek(l));
    while (l <= 16 && code > t.maxcode[l]) code = static_cast<int32_t>(peek(++l));
    skip(l);
    return l > 16 ? 0 : t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  // jdhuff.c's process_restart: drop the bits left, read the marker, and
  // decode on unless the marker stays unread.
  void restart(int desired) {
    buf_ = 0;
    bits_ = fake_ = 0;
    read_restart_marker(desired);
    if (marker_ < 0) insufficient_ = false;
  }

  bool stopped() const { return insufficient_; }
  bool insufficient() const { return insufficient_; }

 private:
  void fill() {
    while (bits_ <= 56) {
      const bool real = marker_ < 0 && p_ < end_;
      const int c = data_byte();
      if (!real || marker_ >= 0) fake_ += 8;
      buf_ = (buf_ << 8) | static_cast<uint32_t>(c);
      bits_ += 8;
    }
  }

  uint64_t buf_ = 0;
  int bits_ = 0;
  int fake_ = 0;      // zero bits past the data, at the low end of buf_
  bool insufficient_ = false;
};

// Arithmetic-coded data: T.81 Annex D's QM decoder as libjpeg's jdarith.c
// runs it (arith_decode), with jaricom.c's Qe table: entry = Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the
// fixed probability 0.5 bin.  Past a marker the data are zero bytes.
const uint32_t kAriTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

class ArithReader : public Source {
 public:
  using Source::Source;

  // A new interval: C and A cleared, two bytes to read first
  void reset() {
    c_ = a_ = 0;
    ct_ = -16;
  }

  // jdarith.c's process_restart for the reader's part
  void restart(int desired) {
    read_restart_marker(desired);
    reset();
  }

  // jdarith.c marks bad data (a spectral or magnitude overflow) with ct =
  // -1; the rest of the interval is then left alone.
  bool failed() const { return ct_ == -1; }
  bool stopped() const { return failed(); }
  bool insufficient() const { return false; }   // jdarith.c never sets it
  void set_failed() { ct_ = -1; }

  // One binary decision with the statistics bin *st (arith_decode)
  int decode(uint8_t* st) {
    while (a_ < 0x8000) {
      if (--ct_ < 0) {
        c_ = (c_ << 8) | data_byte();
        if ((ct_ += 8) < 0 && ++ct_ == 0) a_ = 0x8000;
      }
      a_ <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a_ - qe;
    a_ = temp;
    temp <<= ct_;
    if (c_ >= temp) {
      c_ -= temp;
      if (a_ < qe) {
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a_ < 0x8000) {
      if (a_ < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

 private:
  int64_t c_ = 0, a_ = 0;
  int ct_ = -16;
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

// libjpeg-turbo's SIMD ISLOW IDCT (jidctint-avx2.asm, the SSE2 one alike),
// which cv2's and the system's libjpeg-turbo run on x86: the C arithmetic
// of jidctint.c in 16-bit lanes.  On every intact file the two agree; on
// damaged data, whose coefficients can be huge, the lanes wrap and
// saturate where C's ints do not, and this follows the lanes: the
// dequantized coefficient and the sums in0 +- in4, in7 + in3, in5 + in1
// wrap to 16 bits, the products' sums to 32, each pass's output saturates
// to 16 bits, the last to 8 around the centre.  A block whose rows 1..7 are
// all zero takes the shortcut (row 0 dequantized << 2, wrapping).
inline int32_t wrap32(int64_t x) {
  return static_cast<int32_t>(static_cast<uint32_t>(x));
}
inline int16_t wrap16(int32_t x) {
  return static_cast<int16_t>(static_cast<uint16_t>(x));
}
inline int16_t sat16(int32_t x) {
  return static_cast<int16_t>(std::min(std::max(x, -32768), 32767));
}

// One 8-point pass over x[0], x[s], .. x[7s] into o[0], o[os], .., each
// descaled by n and saturated to 16 bits.
void islow_lanes(const int16_t* x, int s, int n, int16_t* o, int os) {
  const int64_t x0 = x[0], x1 = x[s], x2 = x[2 * s], x3 = x[3 * s],
                x4 = x[4 * s], x5 = x[5 * s], x6 = x[6 * s], x7 = x[7 * s];
  const int32_t tmp3 = wrap32(x2 * (F_0_541196100 + F_0_765366865) +
                              x6 * F_0_541196100);
  const int32_t tmp2 = wrap32(x2 * F_0_541196100 +
                              x6 * (F_0_541196100 - F_1_847759065));
  const int32_t tmp0 = wrap16(static_cast<int32_t>(x0 + x4)) * (1 << kConstBits);
  const int32_t tmp1 = wrap16(static_cast<int32_t>(x0 - x4)) * (1 << kConstBits);
  const int32_t tmp10 = wrap32(int64_t{tmp0} + tmp3);
  const int32_t tmp13 = wrap32(int64_t{tmp0} - tmp3);
  const int32_t tmp11 = wrap32(int64_t{tmp1} + tmp2);
  const int32_t tmp12 = wrap32(int64_t{tmp1} - tmp2);
  const int64_t z3 = wrap16(static_cast<int32_t>(x7 + x3));
  const int64_t z4 = wrap16(static_cast<int32_t>(x5 + x1));
  const int32_t z3p = wrap32(z3 * (F_1_175875602 - F_1_961570560) +
                             z4 * F_1_175875602);
  const int32_t z4p = wrap32(z3 * F_1_175875602 +
                             z4 * (F_1_175875602 - F_0_390180644));
  const int32_t o0 = wrap32(wrap32(x7 * (F_0_298631336 - F_0_899976223) +
                                   x1 * -F_0_899976223) + int64_t{z3p});
  const int32_t o1 = wrap32(wrap32(x5 * (F_2_053119869 - F_2_562915447) +
                                   x3 * -F_2_562915447) + int64_t{z4p});
  const int32_t o2 = wrap32(wrap32(x5 * -F_2_562915447 +
                                   x3 * (F_3_072711026 - F_2_562915447)) +
                            int64_t{z3p});
  const int32_t o3 = wrap32(wrap32(x7 * -F_0_899976223 +
                                   x1 * (F_1_501321110 - F_0_899976223)) +
                            int64_t{z4p});
  auto out = [&](int64_t v) {
    return sat16(wrap32(wrap32(v) + (int64_t{1} << (n - 1))) >> n);
  };
  o[0] = out(int64_t{tmp10} + o3);
  o[7 * os] = out(int64_t{tmp10} - o3);
  o[1 * os] = out(int64_t{tmp11} + o2);
  o[6 * os] = out(int64_t{tmp11} - o2);
  o[2 * os] = out(int64_t{tmp12} + o1);
  o[5 * os] = out(int64_t{tmp12} - o1);
  o[3 * os] = out(int64_t{tmp13} + o0);
  o[4 * os] = out(int64_t{tmp13} - o0);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int16_t d[64], ws[64];
  bool ac = false;
  for (int i = 0; i < 64; ++i) {
    d[i] = wrap16(static_cast<int32_t>(in[i]) * q[i]);
    ac |= i >= 8 && in[i] != 0;
  }
  if (!ac) {
    for (int c = 0; c < 8; ++c) {
      const int16_t v = wrap16(d[c] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = v;
    }
  } else {
    for (int c = 0; c < 8; ++c)
      islow_lanes(d + c, 8, kConstBits - kPass1Bits, ws + c, 8);
  }
  for (int r = 0; r < 8; ++r) {
    int16_t row[8];
    islow_lanes(ws + r * 8, 1, kConstBits + kPass1Bits + 3, row, 1);
    uint8_t* o = out + r * stride;
    for (int c = 0; c < 8; ++c)
      o[c] = static_cast<uint8_t>(std::min(std::max<int>(row[c], -128), 127) +
                                  128);
  }
}

// libjpeg-turbo's SIMD reduced IDCTs (jidctred-sse2.asm): jidctred.c's
// jpeg_idct_4x4 and jpeg_idct_2x2 arithmetic in 16-bit lanes, as for the
// ISLOW IDCT above: the dequantized coefficients wrap to 16 bits, every
// 32-bit sum wraps (the descale's rounding add too, before its arithmetic
// shift), pass 1's output saturates to 16 bits and pass 2's to 8 around
// the centre.
inline int32_t descale32(int64_t x, int n) {
  return wrap32(int64_t{wrap32(x)} + (int64_t{1} << (n - 1))) >> n;
}

inline uint8_t sat8(int32_t x) {
  return static_cast<uint8_t>(std::min(std::max<int32_t>(sat16(x), -128), 127)
                              + 128);
}

// jidctred.c's jpeg_idct_4x4: the 4-point IDCT of the even-numbered and
// odd coefficients, row and column 4 left out.  A block whose rows 1..3
// and 5..7 are all zero takes the shortcut: row 0 dequantized << 2,
// wrapping.
void idct_4x4(const int16_t* in, const uint16_t* q, uint8_t* out,
              int stride) {
  int16_t d[64], ws[8 * 4];
  bool ac = false;
  for (int i = 0; i < 64; ++i) {
    d[i] = wrap16(static_cast<int32_t>(in[i]) * q[i]);
    ac |= i >= 8 && (i < 32 || i >= 40) && in[i] != 0;
  }
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;           // the second pass does not use it
    const int16_t* col = d + c;
    if (!ac) {
      const int16_t dc = wrap16(col[0] * (1 << kPass1Bits));
      for (int r = 0; r < 4; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    auto dq = [&](int r) { return static_cast<int64_t>(col[8 * r]); };
    int64_t tmp0 = dq(0) * (int64_t{1} << (kConstBits + 1));
    int64_t tmp2 = dq(2) * F_1_847759065 + dq(6) * -F_0_765366865;
    const int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    const int64_t z1 = dq(7), z2 = dq(5), z3 = dq(3), z4 = dq(1);
    tmp0 = z1 * -F_0_211164243 + z2 * F_1_451774981 + z3 * -F_2_172734803 +
           z4 * F_1_061594337;
    tmp2 = z1 * -F_0_509795579 + z2 * -F_0_601344887 + z3 * F_0_899976223 +
           z4 * F_2_562915447;
    constexpr int n = kConstBits - kPass1Bits + 1;
    ws[0 * 8 + c] = sat16(descale32(tmp10 + tmp2, n));
    ws[3 * 8 + c] = sat16(descale32(tmp10 - tmp2, n));
    ws[1 * 8 + c] = sat16(descale32(tmp12 + tmp0, n));
    ws[2 * 8 + c] = sat16(descale32(tmp12 - tmp0, n));
  }
  constexpr int n2 = kConstBits + kPass1Bits + 3 + 1;
  for (int r = 0; r < 4; ++r) {
    const int16_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    int64_t tmp0 = int64_t{w[0]} * (int64_t{1} << (kConstBits + 1));
    int64_t tmp2 = w[2] * F_1_847759065 + w[6] * -F_0_765366865;
    const int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    const int64_t z1 = w[7], z2 = w[5], z3 = w[3], z4 = w[1];
    tmp0 = z1 * -F_0_211164243 + z2 * F_1_451774981 + z3 * -F_2_172734803 +
           z4 * F_1_061594337;
    tmp2 = z1 * -F_0_509795579 + z2 * -F_0_601344887 + z3 * F_0_899976223 +
           z4 * F_2_562915447;
    o[0] = sat8(descale32(tmp10 + tmp2, n2));
    o[3] = sat8(descale32(tmp10 - tmp2, n2));
    o[1] = sat8(descale32(tmp12 + tmp0, n2));
    o[2] = sat8(descale32(tmp12 - tmp0, n2));
  }
}

// jidctred.c's jpeg_idct_2x2: the DC and the odd coefficients only, with
// no shortcut.  The asm keeps pass 1's column 0 in 32 bits, unsaturated,
// and shifts it left by 15 in pass 2, wrapping; the odd columns saturate.
void idct_2x2(const int16_t* in, const uint16_t* q, uint8_t* out,
              int stride) {
  int16_t d[64], ws[8 * 2];
  int32_t ws0[2];
  for (int i = 0; i < 64; ++i)
    d[i] = wrap16(static_cast<int32_t>(in[i]) * q[i]);
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;
    const int16_t* col = d + c;
    auto dq = [&](int r) { return static_cast<int64_t>(col[8 * r]); };
    const int64_t tmp10 = dq(0) * (int64_t{1} << (kConstBits + 2));
    const int64_t tmp0 = dq(7) * -F_0_720959822 + dq(5) * F_0_850430095 +
                         dq(3) * -F_1_272758580 + dq(1) * F_3_624509785;
    constexpr int n = kConstBits - kPass1Bits + 2;
    const int32_t a = descale32(tmp10 + tmp0, n);
    const int32_t b = descale32(tmp10 - tmp0, n);
    if (c == 0) {
      ws0[0] = a;
      ws0[1] = b;
    } else {
      ws[c] = sat16(a);
      ws[8 + c] = sat16(b);
    }
  }
  constexpr int n2 = kConstBits + kPass1Bits + 3 + 2;
  for (int r = 0; r < 2; ++r) {
    const int16_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    const int64_t tmp10 = wrap32(int64_t{ws0[r]} << (kConstBits + 2));
    const int64_t tmp0 = w[7] * -F_0_720959822 + w[5] * F_0_850430095 +
                         w[3] * -F_1_272758580 + w[1] * F_3_624509785;
    o[0] = sat8(descale32(tmp10 + tmp0, n2));
    o[1] = sat8(descale32(tmp10 - tmp0, n2));
  }
}

// jidctred.c's jpeg_idct_1x1 (C, no SIMD): the block's mean, DC / 8.
// (The SIMD build's 16-bit multiplier changes the product by a multiple
// of 65536, which the range limit's 10 bits do not see.)
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
  int prev_bits[10];           // bits[0..9] before the last scan of it
  int bits[64];                // progressive: the Al of the last scan of
                               // each coefficient, -1 before any
  int dc = 0;                  // the DC predictor of the current scan
  int dc_ctx = 0;              // arithmetic coding: the DC context
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
  // imread: decode as cv2.imread asks libjpeg to (4-component files to
  // CMYK, then cv2's CMYK -> BGR); else as an RGB output request does,
  // which refuses them.
  Decoder(const uint8_t* data, size_t size, Buffers* b, bool imread)
      : begin_(data), p_(data), end_(data + size), b_(b), imread_(imread) {
    std::fill(dc_l_, dc_l_ + 16, 0);
    std::fill(dc_u_, dc_u_ + 16, 1);
    std::fill(ac_k_, ac_k_ + 16, 5);
  }

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
    while (!done_) {
      if (!(imread_ && output_read())) {
        segment();
        continue;
      }
      // cv2's JpegDecoder::readData has its result once the last scanline
      // is read and swallows what jpeg_finish_decompress raises while it
      // reads the markers after that scan (read_markers' JERR_UNKNOWN_MARKER
      // for 0xFF9E or 0xFFF3, get_sof's JERR_SOF_DUPLICATE, a second scan's
      // JERR_EOI_EXPECTED, a bad or cut segment): the image stands as its
      // one scan left it.  The JAX package's libjpeg loader fails such a
      // file in the same call, so without imread_ they raise.
      try {
        segment();
      } catch (const Error&) {
        done_ = true;
      }
    }
    if (lossless_) {
      if (denom != 1)
        fail(JPEG_UNSUPPORTED, "a lossless JPEG at scale 1/" +
                                   std::to_string(denom) +
                                   " (libjpeg scales no lossless file)");
      return lossless_output(rgb);
    }
    smooth_ = smoothing_ok();
    output(8 / denom, rgb);
  }

  // A TIFF JPEGTables stream (tag 347) at the decoder's position, read as
  // libtiff has libjpeg read it (jpeg_read_header(FALSE), which must end
  // in JPEG_HEADER_TABLES_ONLY): SOI, table and other segments, EOI.  Its
  // tables stay for the strip or tile at `strip`, whose SOI resets the
  // rest (jdmarker.c's get_soi: restart interval, arithmetic
  // conditioning, the JFIF and Adobe marks).
  void tables(const uint8_t* strip) {
    if (size() < 2 || p_[0] != 0xFF || p_[1] != 0xD8)
      fail(JPEG_CORRUPT, "bogus JPEGTables (no SOI marker)");
    p_ += 2;
    for (int m; (m = next_marker()) != 0xD9;) {
      if (m == 0xC4) dht();
      else if (m == 0xDB) dqt();
      else if (m == 0xDD) dri();
      else if (m == 0xCC) dac();
      else if (m >= 0xE0 && m <= 0xEF) app(m);
      else if (m == 0xFE) skip_segment();
      else fail(JPEG_CORRUPT, "bogus JPEGTables (marker " + hex_marker(m) +
                                  ")");
    }
    restart_interval_ = 0;
    std::fill(dc_l_, dc_l_ + 16, 0);
    std::fill(dc_u_, dc_u_ + 16, 1);
    std::fill(ac_k_, ac_k_ + 16, 5);
    jfif_ = adobe_ = false;
    adobe_transform_ = -1;
    p_ = strip;
  }

  // libtiff's colour request to libjpeg: TIFF_YCBCR_TO_RGB (JCS_YCbCr to
  // JCS_RGB, whatever the markers say) or TIFF_SAMPLES (JCS_UNKNOWN both
  // ways: the components as stored, interleaved, 1, 3 or 4 bytes a pixel).
  enum Tiff { NOT_TIFF, TIFF_YCBCR_TO_RGB, TIFF_SAMPLES };
  void set_tiff(Tiff t) { tiff_ = t; }
  int components() const { return static_cast<int>(comps_.size()); }
  int precision() const { return precision_; }
  int h_samp(int i) const { return comps_[i].h; }
  int v_samp(int i) const { return comps_[i].v; }

  // The EXIF Orientation read before the first scan, 0 without one; known
  // once decode() is done.
  int orientation() const { return orientation_; }

  // The bytes read so far
  size_t consumed() const { return static_cast<size_t>(p_ - begin_); }

 private:
  size_t size() const { return static_cast<size_t>(end_ - p_); }

  // libjpeg has read every scanline: a file of one scan (jdinput.c's
  // has_multiple_scans false: not progressive, its first scan holds every
  // component) whose scan is read.  Files of several scans are read to
  // their EOI inside jpeg_start_decompress, before any output.
  bool output_read() const { return scans_ > 0 && one_scan_; }

  int byte() {
    if (p_ >= end_) fail(JPEG_CORRUPT, "file ends inside a marker segment "
                                       "(truncated file)");
    return *p_++;
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // One marker and its segment, as libjpeg's read_markers takes it.
  void segment() {
    if (scans_ && p_ >= end_) {
      // libjpeg reads the end of the file after a scan as an EOI
      done_ = true;
      return;
    }
    const int m = next_marker();
    if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC9 || m == 0xCA)
      return sof(m);
    if (m == 0xC3) {
      // cv2's libjpeg-turbo 3 reads lossless files; the system libjpeg 2.1
      // of the JAX package's fused loader refuses them
      if (imread_) return sof(m);
      fail(JPEG_UNSUPPORTED, "lossless JPEG (SOF marker 0xFFC3)");
    }
    if (m >= 0xC5 && m <= 0xCF && m != 0xCC)
      fail(JPEG_UNSUPPORTED,
           "SOF marker " + hex_marker(m) +
               " (hierarchical, lossless or the JPG extension)");
    if (m == 0xCC) return dac();
    if (m == 0xC4) return dht();
    if (m == 0xDB) return dqt();
    if (m == 0xDD) return dri();
    if (m == 0xDA) return sos();
    if (m == 0xD9) {
      if (!scans_) fail(JPEG_CORRUPT, "EOI marker before any image data");
      done_ = true;
      return;
    }
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) return;   // RSTn, TEM
    if (m == 0xDC) return skip_segment();                // DNL: ignored
    if (m >= 0xE0 && m <= 0xEF) return app(m);
    if (m == 0xFE) return skip_segment();
    fail(JPEG_CORRUPT, "unexpected marker " + hex_marker(m));
  }

  // jdmarker.c's next_marker: bytes before a 0xFF are skipped with a
  // warning ("N extraneous bytes before marker"), fill bytes 0xFF are
  // swallowed, and a stuffed 0xFF00 counts as two more extraneous bytes
  int next_marker() {
    int c;
    do {
      c = byte();
      while (c != 0xFF) c = byte();
      while (c == 0xFF) c = byte();
    } while (c == 0);
    return c;
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
      build_huffman(&huff_[tc][th], bits, d + i, count);
      i += count;
    }
  }

  void dri() {
    int len;
    const uint8_t* d = segment_body(&len);
    if (len != 2) fail(JPEG_CORRUPT, "bad DRI length");
    restart_interval_ = (d[0] << 8) | d[1];
  }

  // jdmarker.c's get_dac: the arithmetic conditioning of the DC (L, U)
  // and AC (Kx) tables
  void dac() {
    int len;
    const uint8_t* d = segment_body(&len);
    if (len % 2) fail(JPEG_CORRUPT, "bad DAC length");
    for (int i = 0; i < len; i += 2) {
      const int index = d[i], val = d[i + 1];
      // Tc << 4 | Tb over libjpeg's 16 tables of each class
      if (index >= 32) fail(JPEG_CORRUPT, "bad DAC table index");
      if (index >= 16) {
        ac_k_[index - 16] = val;
      } else {
        dc_l_[index] = val & 15;
        dc_u_[index] = val >> 4;
        if (dc_l_[index] > dc_u_[index]) fail(JPEG_CORRUPT, "bad DAC value");
      }
    }
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
    lossless_ = m == 0xC3;
    precision_ = precision;
    // cv2.imread and the JAX package's library both decompress with
    // libjpeg's 8-bit interface, which refuses other precisions, but for
    // lossless files of 2 to 8 bits, whose samples it returns unscaled
    if (lossless_ && (precision < 2 || precision > 8))
      fail(JPEG_UNSUPPORTED, std::to_string(precision) +
                                 "-bit samples (SOF 0xFFC3); cv2 reads "
                                 "lossless JPEG of 2 to 8 bits");
    if (!lossless_ && precision != 8)
      fail(JPEG_UNSUPPORTED, std::to_string(precision) + "-bit samples (SOF " +
                                 hex_marker(m) + "); only 8-bit is supported");
    if (nf == 4 && !imread_)
      fail(JPEG_UNSUPPORTED, "4 components (CMYK or YCCK), which libjpeg's "
                             "RGB output refuses");
    if (nf != 1 && nf != 3 && nf != 4)
      fail(JPEG_UNSUPPORTED, std::to_string(nf) + " components");
    if (len != 6 + 3 * nf) fail(JPEG_CORRUPT, "bad SOF length");
    if (height_ == 0)
      fail(JPEG_UNSUPPORTED, "height 0 in the SOF (DNL marker)");
    if (width_ == 0) fail(JPEG_CORRUPT, "width 0 in the SOF");
    // cv2.imread's validateInputImageSize (sides up to 65535 pass 2^20)
    if (imread_ && int64_t(width_) * height_ > (int64_t(1) << 30))
      fail(JPEG_UNSUPPORTED, "a " + std::to_string(width_) + "x" +
                                 std::to_string(height_) +
                                 " image, larger than cv2 reads");
    progressive_ = m == 0xC2 || m == 0xCA;
    arith_ = m == 0xC9 || m == 0xCA;
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
    // a component's own scan its blocks inside the image (jdinput.c); a
    // lossless file's blocks are single samples
    const int unit = lossless_ ? 1 : 8;
    mcux_ = ceil_div(width_, hmax_ * unit);
    mcuy_ = ceil_div(height_, vmax_ * unit);
    size_t total = 0;
    for (Component& c : comps_) {
      c.bw = ceil_div(width_ * c.h, hmax_ * unit);
      c.bh = ceil_div(height_ * c.v, vmax_ * unit);
      c.gw = mcux_ * c.h;
      c.gh = mcuy_ * c.v;
      total += static_cast<size_t>(c.gw) * c.gh * 64;
      std::fill(c.bits, c.bits + 64, -1);
    }
    if (lossless_) {
      for (size_t i = 0; i < comps_.size(); ++i) {
        const size_t n = static_cast<size_t>(comps_[i].bw) * comps_[i].bh;
        undiff_[i].assign(n, 0);
        b_->plane[i].assign(n, 0);
      }
      frame_ = true;
      return;
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
      // jdhuff.c takes Huffman tables 0..3 (NUM_HUFF_TBLS), jdarith.c
      // conditioning tables 0..15 (NUM_ARITH_TBLS), each with its own
      // statistics
      if (c->td > (arith_ ? 15 : 3) || c->ta > (arith_ ? 15 : 3))
        fail(JPEG_CORRUPT, arith_ ? "bad arithmetic table index"
                                  : "bad Huffman table index");
      scan.push_back(c);
    }
    int blocks_in_mcu = 0;
    for (Component* c : scan) blocks_in_mcu += ns == 1 ? 1 : c->h * c->v;
    if (blocks_in_mcu > 10)
      fail(JPEG_UNSUPPORTED, "sampling factors too large for an "
                             "interleaved scan");
    const int ss = d[1 + 2 * ns], se = d[2 + 2 * ns],
              ah = d[3 + 2 * ns] >> 4, al = d[3 + 2 * ns] & 15;
    if (!scans_) one_scan_ = !progressive_ && ns == int(comps_.size());
    if (lossless_) {
      BitReader br(p_, end_);
      lossless_scan(scan, &br, ss, se, ah, al);
      p_ = br.marker_start();
      ++scans_;
      return;
    }
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
    const bool dc_first = !progressive_ || (ss == 0 && ah == 0);
    if (progressive_) check_progression(scan, ss, se, ah, al);
    if (arith_) {
      ArithReader ar(p_, end_);
      arith_scan(scan, &ar, ss, se, ah, al, dc_first);
      p_ = ar.marker_start();
    } else {
      if (!progressive_) standard_tables();
      for (Component* c : scan)
        need_tables(*c, !progressive_ || (ss == 0 && ah == 0),
                    !progressive_ || ss != 0);
      BitReader br(p_, end_);
      for (Component* c : scan) c->dc = 0;
      eobrun_ = 0;
      if (progressive_)
        progressive_scan(scan, &br, ss, se, ah, al);
      else
        // libjpeg takes any Ss/Se/Ah/Al of a sequential scan as 0/63/0/0
        // (with a warning)
        sequential_scan(scan, &br);
      p_ = br.marker_start();
    }
    ++scans_;
  }

  // jdhuff.c's jinit_huff_decoder (std_huff_tables): a sequential Huffman
  // file's empty DC and AC slots 0 and 1 take the tables of T.81 K.3 when
  // its decoding starts, in libjpeg-turbo 2.1 (the fused route) and 3 (cv2)
  // alike; a later DHT replaces them.  Progressive (jdphuff.c) and
  // lossless (jdlhuff.c) scans take no default and refuse an empty slot.
  void standard_tables() {
    const uint8_t* bits[2][2] = {{kBits_dc_luminance, kBits_dc_chrominance},
                                 {kBits_ac_luminance, kBits_ac_chrominance}};
    const uint8_t* vals[2][2] = {{kVal_dc_luminance, kVal_dc_chrominance},
                                 {kVal_ac_luminance, kVal_ac_chrominance}};
    for (int tc = 0; tc < 2; ++tc)
      for (int th = 0; th < 2; ++th)
        if (!huff_[tc][th].defined)
          build_huffman(&huff_[tc][th], bits[tc][th], vals[tc][th],
                        tc ? 162 : 12);
  }

  void need_tables(const Component& c, bool dc, bool ac) const {
    if ((dc && !huff_[0][c.td].defined) || (ac && !huff_[1][c.ta].defined))
      fail(JPEG_UNSUPPORTED, "Huffman table not defined before the scan");
    // jdhuff.c's jpeg_make_d_derived_tbl: DC categories up to 15, and up
    // to 16 in a lossless scan
    if (dc && huff_[0][c.td].max_val > (lossless_ ? 16 : 15))
      fail(JPEG_CORRUPT, "bad DC Huffman table");
  }

  // Runs block(component, coefficients) over the scan's blocks in MCU
  // order, with its restart intervals: a scan of one component covers its
  // blocks inside the image, an interleaved one whole MCUs.  At each
  // interval's end the reader reads the restart marker and on_restart()
  // resets the entropy decoder's state; an MCU after r->stopped() (data
  // that ended early, or bad arithmetic-coded data) is left as it is,
  // unless `always` (jdphuff.c's and jdarith.c's DC refinement scans read
  // on: zero data change nothing there).
  template <typename Reader, typename Restart, typename Block>
  void run_scan(const std::vector<Component*>& scan, Reader* r,
                Restart on_restart, Block block, bool always = false) {
    const bool single = scan.size() == 1;
    const int mcux = single ? scan[0]->bw : mcux_;
    const int mcuy = single ? scan[0]->bh : mcuy_;
    int restarts_left = restart_interval_;
    int next_rst = 0;
    const int64_t total = static_cast<int64_t>(mcux) * mcuy;
    for (int64_t mcu = 0; mcu < total; ++mcu) {
      // jdcoefct.c's consume_data: the iMCU row of the last MCU begun with
      // the data not yet run out (before the MCU's restart marker)
      if (!r->insufficient())
        last_good_ = static_cast<int>(mcu / mcux) / (single ? scan[0]->v : 1);
      if (restart_interval_) {
        if (restarts_left == 0) {
          r->restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          on_restart();
          restarts_left = restart_interval_;
        }
        --restarts_left;
      }
      if (r->stopped() && !always) continue;
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

  // A lossless scan as libjpeg-turbo 3 decodes it (jdlhuff.c, jddiffct.c,
  // jdlossls.c): each MCU row's sample differences (category 16 is 32768
  // with no extra bits), then, an iMCU row at a time, each component's
  // rows undifferenced modulo 2^16 -- a row after the scan's start, a
  // restart or data that ran out predicts from the left (column 0 from
  // 2^(P - Al - 1)) and switches the component to predictor Ss (column 0
  // from above) -- and shifted left by Al into 8-bit samples.  Restart
  // intervals count MCU rows (DRI / MCUs a row); an MCU row begun after
  // the data ran out is zero differences.
  void lossless_scan(const std::vector<Component*>& scan, BitReader* br,
                     int psv, int se, int ah, int al) {
    if (psv < 1 || psv > 7 || se != 0 || ah != 0 || al >= precision_)
      fail(JPEG_CORRUPT, "bad lossless scan parameters Ss=" +
                             std::to_string(psv) + " Se=" +
                             std::to_string(se) + " Ah=" + std::to_string(ah) +
                             " Al=" + std::to_string(al));
    for (Component* c : scan) need_tables(*c, true, false);
    const bool single = scan.size() == 1;
    const size_t ns = scan.size();
    const int mcux = single ? scan[0]->bw : mcux_;
    std::vector<int> width(ns);               // one iMCU row's diff row
    std::vector<std::vector<int32_t>> diff(ns);
    for (size_t k = 0; k < ns; ++k) {
      width[k] = single ? mcux : mcux * scan[k]->h;
      diff[k].assign(static_cast<size_t>(width[k]) * scan[k]->v, 0);
    }
    std::vector<bool> first_row(ns, true);
    const uint32_t rows_per_restart =
        static_cast<uint32_t>(restart_interval_) / static_cast<uint32_t>(mcux);
    uint32_t rows_to_go = rows_per_restart;
    int next_rst = 0;
    const int initial = 1 << (precision_ - al - 1);
    auto reset = [&] { std::fill(first_row.begin(), first_row.end(), true); };
    auto get_diff = [&](const HuffTable& t) -> int32_t {
      const int s = br->decode(t);
      if (s == 16) return 32768;
      return s ? extend(br->get(s), s) : 0;
    };
    for (int m = 0; m < mcuy_; ++m) {
      const bool last = m == mcuy_ - 1;
      const int mcu_rows = single ? (last ? scan[0]->bh - m * scan[0]->v
                                          : scan[0]->v)
                                  : 1;
      for (int y = 0; y < mcu_rows; ++y) {
        if (restart_interval_ && rows_to_go == 0) {
          br->restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          reset();
          rows_to_go = rows_per_restart;
        }
        if (br->insufficient()) {
          if (single)
            std::fill_n(diff[0].begin() + static_cast<size_t>(y) * mcux, mcux,
                        0);
          else
            for (auto& d : diff) std::fill(d.begin(), d.end(), 0);
          reset();
        } else if (single) {
          const HuffTable& t = huff_[0][scan[0]->td];
          int32_t* d = diff[0].data() + static_cast<size_t>(y) * mcux;
          for (int x = 0; x < mcux; ++x) d[x] = get_diff(t);
        } else {
          for (int mx = 0; mx < mcux; ++mx)
            for (size_t k = 0; k < ns; ++k) {
              const Component* c = scan[k];
              const HuffTable& t = huff_[0][c->td];
              for (int by = 0; by < c->v; ++by)
                for (int bx = 0; bx < c->h; ++bx)
                  diff[k][static_cast<size_t>(by) * width[k] + mx * c->h +
                          bx] = get_diff(t);
            }
        }
        if (restart_interval_) --rows_to_go;
      }
      for (size_t k = 0; k < ns; ++k) {
        const Component* c = scan[k];
        const int ci = static_cast<int>(c - comps_.data());
        const int rows = last ? c->bh - m * c->v : c->v;
        for (int r = 0; r < rows; ++r) {
          const int y = m * c->v + r;
          const int32_t* d = diff[k].data() + static_cast<size_t>(r) * width[k];
          uint16_t* u = undiff_[ci].data() + static_cast<size_t>(y) * c->bw;
          const uint16_t* p = u - c->bw;
          int ra;
          if (first_row[k]) {
            ra = (d[0] + initial) & 0xFFFF;
            u[0] = static_cast<uint16_t>(ra);
            for (int x = 1; x < c->bw; ++x)
              u[x] = static_cast<uint16_t>(ra = (d[x] + ra) & 0xFFFF);
            first_row[k] = false;
          } else {
            int rb = p[0], rc;
            ra = (d[0] + rb) & 0xFFFF;
            u[0] = static_cast<uint16_t>(ra);
            for (int x = 1; x < c->bw; ++x) {
              rc = rb;
              rb = p[x];
              int pred;
              switch (psv) {
                case 1: pred = ra; break;
                case 2: pred = rb; break;
                case 3: pred = rc; break;
                case 4: pred = ra + rb - rc; break;
                case 5: pred = ra + ((rb - rc) >> 1); break;
                case 6: pred = rb + ((ra - rc) >> 1); break;
                default: pred = (ra + rb) >> 1; break;
              }
              u[x] = static_cast<uint16_t>(ra = (d[x] + pred) & 0xFFFF);
            }
          }
          uint8_t* o = b_->plane[ci].data() + static_cast<size_t>(y) * c->bw;
          for (int x = 0; x < c->bw; ++x)
            o[x] = static_cast<uint8_t>(u[x] << al);
        }
      }
    }
  }

  // A lossless file's output: libjpeg-turbo converts no colour space in
  // lossless mode (jdcolor.c), so cv2's BGR request takes 3 components as
  // RGB (its default for lossless files but under an Adobe transform
  // other than 0, YCbCr, which it refuses), a grey file fails, and 4
  // components are CMYK (YCCK fails); subsampled components are
  // replicated (no "fancy" upsampling for 1-sample blocks).
  void lossless_output(uint8_t* rgb) {
    const int nf = static_cast<int>(comps_.size());
    if (nf == 1 && tiff_ != TIFF_SAMPLES)
      fail(JPEG_UNSUPPORTED, "a grey lossless JPEG, which cv2.imread refuses "
                             "(libjpeg converts no colour space of a "
                             "lossless file)");
    if (adobe_ && adobe_transform_ != 0 && tiff_ == NOT_TIFF)
      fail(JPEG_UNSUPPORTED, std::string("a lossless JPEG in ") +
                                 (nf == 3 ? "YCbCr" : "YCCK") +
                                 ", which cv2.imread refuses (libjpeg "
                                 "converts no colour space of a lossless "
                                 "file)");
    View views[4];
    for (int i = 0; i < nf; ++i) {
      Component& c = comps_[i];
      c.ssize = 1;
      c.dw = c.stride = c.bw;
      c.dh = c.bh;
      views[i] = upsample(c, b_->plane[i].data(), &b_->full[i], width_,
                          height_, 1);
    }
    convert(views, width_, height_, rgb);
  }

  void sequential_scan(const std::vector<Component*>& scan, BitReader* br) {
    auto restart = [&] {
      for (Component* c : scan) c->dc = 0;
    };
    run_scan(scan, br, restart, [&](Component* c, int16_t* blk) {
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

  // The checks of jdphuff.c's and jdarith.c's start_pass (where libjpeg
  // only warns of a bad progression, this decoder refuses it), and the
  // coefficient bits each component now has.
  void check_progression(const std::vector<Component*>& scan, int ss, int se,
                         int ah, int al) {
    const bool dc_band = ss == 0;
    if ((dc_band ? se != 0 : ss > se || se > 63 || scan.size() != 1) ||
        (ah != 0 && al != ah - 1) || al > 13)
      fail(JPEG_CORRUPT, "bad progressive scan parameters Ss=" +
                             std::to_string(ss) + " Se=" + std::to_string(se) +
                             " Ah=" + std::to_string(ah) +
                             " Al=" + std::to_string(al));
    // An AC scan before the component's DC scan, or an Ah that is not the
    // last Al of its coefficients, is only JWRN_BOGUS_PROGRESSION to
    // jdphuff.c's start_pass_phuff_decoder: the scan decodes with its own
    // Ah and Al, and the coefficients' bits become Al.
    for (Component* c : scan) {
      // the bits before this scan, which block smoothing uses for the
      // rows it did not reach (jdphuff.c's start_pass)
      for (int k = std::min(ss, 1); k <= std::min(std::max(se, 9), 9); ++k)
        c->prev_bits[k] = scans_ ? c->bits[k] : 0;
      for (int k = ss; k <= se; ++k) c->bits[k] = al;
    }
  }

  // libjpeg's jdphuff.c: one of the four kinds of progressive scan.
  void progressive_scan(const std::vector<Component*>& scan, BitReader* br,
                        int ss, int se, int ah, int al) {
    const bool dc_band = ss == 0;
    const int p1 = 1 << al;            // 1 in the bit position coded
    const int m1 = -p1;                // -1 in it
    auto restart = [&] {
      for (Component* c : scan) c->dc = 0;
      eobrun_ = 0;
    };
    if (dc_band && ah == 0) {
      run_scan(scan, br, restart, [&](Component* c, int16_t* blk) {
        int s = br->decode(huff_[0][c->td]);
        if (s) c->dc += extend(br->get(s), s);
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c->dc) << al);
      });
    } else if (dc_band) {
      run_scan(scan, br, restart, [&](Component*, int16_t* blk) {
        if (br->get(1)) blk[0] = static_cast<int16_t>(blk[0] | p1);
      }, true);
    } else if (ah == 0) {
      const HuffTable& act = huff_[1][scan[0]->ta];
      run_scan(scan, br, restart, [&](Component*, int16_t* blk) {
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
      run_scan(scan, br, restart, [&](Component*, int16_t* blk) {
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

  // libjpeg's jdarith.c: a sequential scan (decode_mcu) or one of the four
  // kinds of progressive scan, with the statistics bins of T.81 F.1.4.4:
  // DC S0 at the context (0, 4, 8, 12 or 16), SS, SP/SN, X1 at 20 and M at
  // X + 14; AC SE, S0 and SS/SP at 3 (k - 1), X2 at 189 or 217 by Kx.
  void arith_scan(const std::vector<Component*>& scan, ArithReader* ar,
                  int ss, int se, int ah, int al, bool dc_first) {
    const bool ac = !progressive_ || ss != 0;
    auto clear = [&] {
      for (Component* c : scan) {
        if (dc_first) {
          std::memset(dc_stats_[c->td], 0, sizeof(dc_stats_[0]));
          c->dc = c->dc_ctx = 0;
        }
        if (ac) std::memset(ac_stats_[c->ta], 0, sizeof(ac_stats_[0]));
      }
    };
    clear();
    ar->reset();
    // Decode_DC_DIFF (F.19, F.21-F.24): false on a magnitude overflow
    auto dc_diff = [&](Component* c) {
      uint8_t* st = dc_stats_[c->td] + c->dc_ctx;
      if (ar->decode(st) == 0) {
        c->dc_ctx = 0;
        return true;
      }
      const int sign = ar->decode(st + 1);
      st += 2 + sign;
      int m = ar->decode(st);
      if (m) {
        st = dc_stats_[c->td] + 20;
        while (ar->decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar->set_failed();
            return false;
          }
          ++st;
        }
      }
      if (m < ((1 << dc_l_[c->td]) >> 1))
        c->dc_ctx = 0;
      else if (m > ((1 << dc_u_[c->td]) >> 1))
        c->dc_ctx = 12 + sign * 4;
      else
        c->dc_ctx = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar->decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      c->dc = (c->dc + v) & 0xFFFF;
      return true;
    };
    // a nonzero AC value after its S0 bin (F.21-F.24); 0 on an overflow
    auto ac_value = [&](uint8_t* st, int tbl, int k, int* v_out) {
      const int sign = ar->decode(fixed_bin_);
      st += 2;
      int m = ar->decode(st);
      if (m && ar->decode(st)) {
        m <<= 1;
        st = ac_stats_[tbl] + (k <= ac_k_[tbl] ? 189 : 217);
        while (ar->decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar->set_failed();
            return false;
          }
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar->decode(st)) v |= m;
      v += 1;
      *v_out = sign ? -v : v;
      return true;
    };
    if (!progressive_) {
      run_scan(scan, ar, clear, [&](Component* c, int16_t* blk) {
        if (ar->failed()) return;
        if (!dc_diff(c)) return;
        blk[0] = static_cast<int16_t>(c->dc);
        const int tbl = c->ta;
        int k = 0;
        while (k < 63) {
          uint8_t* st = ac_stats_[tbl] + 3 * k;
          if (ar->decode(st)) break;                     // EOB
          for (;;) {
            ++k;
            if (ar->decode(st + 1)) break;
            st += 3;
            if (k >= 63) {
              ar->set_failed();                          // spectral overflow
              return;
            }
          }
          int v;
          if (!ac_value(st, tbl, k, &v)) return;
          blk[kNatural[k]] = static_cast<int16_t>(v);
        }
      });
    } else if (ss == 0 && ah == 0) {
      run_scan(scan, ar, clear, [&](Component* c, int16_t* blk) {
        if (ar->failed() || !dc_diff(c)) return;
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c->dc) << al);
      });
    } else if (ss == 0) {
      run_scan(scan, ar, clear, [&](Component*, int16_t* blk) {
        if (ar->decode(fixed_bin_))
          blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      }, true);
    } else if (ah == 0) {
      const int tbl = scan[0]->ta;
      run_scan(scan, ar, clear, [&](Component*, int16_t* blk) {
        for (int k = ss; k <= se; ++k) {
          uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
          if (ar->decode(st)) break;                     // EOB
          while (ar->decode(st + 1) == 0) {
            st += 3;
            if (++k > se) {
              ar->set_failed();
              return;
            }
          }
          int v;
          if (!ac_value(st, tbl, k, &v)) return;
          blk[kNatural[k]] =
              static_cast<int16_t>(static_cast<uint32_t>(v) << al);
        }
      });
    } else {
      const int tbl = scan[0]->ta;
      const int p1 = 1 << al, m1 = -p1;
      run_scan(scan, ar, clear, [&](Component*, int16_t* blk) {
        int kex = se;                   // the previous stage's end of block
        for (; kex > 0; --kex)
          if (blk[kNatural[kex]]) break;
        for (int k = ss; k <= se; ++k) {
          uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
          if (k > kex && ar->decode(st)) break;          // EOB
          for (;;) {
            int16_t* coef = blk + kNatural[k];
            if (*coef) {
              if (ar->decode(st + 2))
                *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
              break;
            }
            if (ar->decode(st + 1)) {
              *coef = static_cast<int16_t>(ar->decode(fixed_bin_) ? m1 : p1);
              break;
            }
            st += 3;
            if (++k > se) {
              ar->set_failed();
              return;
            }
          }
        }
      });
    }
  }

  // Whether libjpeg's output smooths the blocks (jdcoefct.c's
  // smoothing_ok): a progressive file whose scans leave bits of
  // coefficients 1..9 unsent, with every component's DC begun and its
  // quantization table's first entries nonzero.
  bool smoothing_ok() const {
    if (!progressive_) return false;
    bool useful = false;
    for (const Component& c : comps_) {
      if (!c.latched || c.bits[0] < 0) return false;
      for (int pos : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (c.q[pos] == 0) return false;
      for (int k = 1; k <= 9; ++k) useful |= c.bits[k] != 0;
    }
    return useful;
  }

  // jdcoefct.c's decompress_smooth_data on one component's blocks into
  // `out` (bw x bh blocks of 64, natural order): each block's coefficients
  // 1..9 still unknown (zero, their bits unsent) are predicted from the DC
  // values of its 5x5 neighbourhood (edges replicated, rows as below) --
  // and when none of
  // coefficients 1..9 has had a scan, the DC itself is smoothed.  A block
  // row past the last iMCU row that the final scan reached with data takes
  // the coefficient bits from before that scan.
  void smooth(const Component& c, std::vector<int16_t>* out) const {
    struct Rule {
      int k, pos;             // coefficient bits index (zigzag), natural pos
      bool always;            // predicted outside change_dc too
      int8_t w[25], w_dc[25]; // weights with and without change_dc
    };
    // the 5x5 weights, rows top to bottom (libjpeg-turbo's jdcoefct.c)
    static const Rule kRules[9] = {
        {1, 1, true,
         {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3,
          -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
         {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7,
          0, 0, 0, 0, 0, 0, 0, 0, 0, 0}},
        {2, 8, true,
         {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0,
          1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
         {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0,
          0, 0, -50, 0, 0, 0, 0, 7, 0, 0}},
        {3, 16, true,
         {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0,
          0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
         {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0,
          0, 0, 13, 0, 0, 0, 0, -1, 0, 0}},
        {4, 9, true,
         {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0,
          0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
         {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0,
          1, -10, 0, 10, -1, 0, 1, 0, -1, 0}},
        {5, 2, true,
         {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1,
          0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
         {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1,
          0, 0, 0, 0, 0, 0, 0, 0, 0, 0}},
        {6, 3, false,
         {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0,
          0, 1, 0, -1, 0, 0, 0, 0, 0, 0}, {}},
        {7, 10, false,
         {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0,
          0, -1, 3, -1, 0, 0, 0, 0, 0, 0}, {}},
        {8, 17, false,
         {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0,
          0, 1, 0, -1, 0, 0, 0, 0, 0, 0}, {}},
        {9, 24, false,
         {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0,
          0, -1, -2, -1, 0, 0, 0, 0, 0, 0}, {}},
    };
    static const int16_t kDc[25] = {-2, -6, -8, -6, -2, -6, 6, 42, 6, -6,
                                   -8, 42, 152, 42, -8, -6, 6, 42, 6, -6,
                                   -2, -6, -8, -6, -2};
    int cur[10], prev[10];
    for (int k = 0; k < 10; ++k) {
      cur[k] = c.bits[k];
      prev[k] = scans_ > 1 ? c.prev_bits[k] : -1;
    }
    out->resize(static_cast<size_t>(c.bw) * c.bh * 64);
    const int64_t q00 = c.q[0];
    const int last_imcu = (c.bh - 1) / c.v;
    const int padded = ceil_div(c.bh, c.v) * c.v;
    for (int by = 0; by < c.bh; ++by) {
      const int* bits = by / c.v > last_good_ ? prev : cur;
      // the neighbour rows: libjpeg-turbo 3's reach into the next iMCU row,
      // padding blocks included (the coefficient array is whole iMCU rows),
      // except from the last iMCU row, where they stop at the image's last
      // row; 2.1's (the fused route's libjpeg) take the row above for two
      // above in iMCU row 1 and the row below for two below in the last
      // iMCU row but one
      const int m = by / c.v, i = by % c.v;
      int rows[5];
      const int lim = m < last_imcu ? padded - 1 : c.bh - 1;
      for (int d = -2; d <= 2; ++d)
        rows[d + 2] = std::min(std::max(by + d, 0), lim);
      if (!imread_) {
        if (!(i > 1 || m > 1)) rows[0] = rows[1];
        if (!(i < c.v - 2 || m + 1 < last_imcu)) rows[4] = rows[3];
      }
      bool change_dc = true;
      for (int k = 1; k <= 9; ++k) change_dc &= bits[k] == -1;
      // the neighbour columns: edges replicated; 2.1's sliding registers
      // start as column 0 and, on a component 2 blocks wide, keep it for
      // the columns to the right
      int reg[5] = {0, 0, 0, 0, 0};
      for (int bx = 0; bx < c.bw; ++bx) {
        int cols[5];
        if (imread_) {
          for (int d = -2; d <= 2; ++d)
            cols[d + 2] = std::min(std::max(bx + d, 0), c.bw - 1);
        } else {
          if (bx == 0 && bx < c.bw - 1) reg[3] = 1;
          if (bx + 1 < c.bw - 1) reg[4] = bx + 2;
          std::copy(reg, reg + 5, cols);
          std::copy(reg + 1, reg + 5, reg);
        }
        int64_t dc[25];
        for (int dy = 0; dy < 5; ++dy)
          for (int dx = 0; dx < 5; ++dx)
            dc[dy * 5 + dx] = c.block(rows[dy], cols[dx])[0];
        int16_t* ws = out->data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
        std::memcpy(ws, c.block(by, bx), 64 * sizeof(int16_t));
        auto predict = [&](const auto* w, int64_t q, int al) {
          int64_t num = 0;
          for (int i = 0; i < 25; ++i) num += w[i] * dc[i];
          num *= q00;
          int64_t pred = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
          if (al > 0 && pred >= (int64_t{1} << al))
            pred = (int64_t{1} << al) - 1;
          return static_cast<int16_t>(num >= 0 ? pred : -pred);
        };
        if (change_dc) ws[0] = predict(kDc, q00, 0);
        for (const Rule& r : kRules) {
          if (!r.always && !change_dc) continue;
          const int al = bits[r.k];
          if (al != 0 && ws[r.pos] == 0)
            ws[r.pos] = predict(change_dc ? r.w : r.w_dc, c.q[r.pos], al);
        }
      }
    }
  }

  // The IDCT of each component at its scaled size, then upsampling and
  // colour conversion, as libjpeg's jdmaster.c, jddctmgr.c, jdsample.c and
  // jdcolor.c do at scale_denom 8 / min_ss.
  void output(int min_ss, uint8_t* rgb) {
    const int W = ceil_div(static_cast<int64_t>(width_) * min_ss, 8);
    const int H = ceil_div(static_cast<int64_t>(height_) * min_ss, 8);
    View views[4];
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
      std::vector<int16_t> smoothed;
      if (smooth_) smooth(c, &smoothed);
      for (int by = 0; by < c.bh; ++by) {
        uint8_t* row = plane.data() +
                       static_cast<size_t>(by) * c.ssize * c.stride;
        for (int bx = 0; bx < c.bw; ++bx)
          idct(smooth_ ? smoothed.data() +
                             (static_cast<size_t>(by) * c.bw + bx) * 64
                       : c.block(by, bx),
               c.q, row + bx * c.ssize, c.stride);
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
    if (tiff_ == TIFF_SAMPLES) {
      const int nf = static_cast<int>(comps_.size());
      for (int y = 0; y < H; ++y) {
        uint8_t* o = rgb + static_cast<size_t>(y) * W * nf;
        for (int i = 0; i < nf; ++i) {
          const uint8_t* a = v[i].p + static_cast<size_t>(y) * v[i].stride;
          for (int x = 0; x < W; ++x) o[x * nf + i] = a[x];
        }
      }
      return;
    }
    if (comps_.size() == 1) {
      for (int y = 0; y < H; ++y) {
        const uint8_t* g = v[0].p + static_cast<size_t>(y) * v[0].stride;
        uint8_t* o = rgb + static_cast<size_t>(y) * W * 3;
        for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      }
      return;
    }
    const uint8_t* lim = kRange.clamp + 256;
    if (comps_.size() == 4) {
      // libjpeg's CMYK output: Adobe transform 0 or no Adobe segment is
      // CMYK as stored, any other transform YCCK (jdcolor.c's
      // ycck_cmyk_convert: 255 - the YCbCr -> RGB value); then cv2's
      // icvCvt_CMYK2BGR_8u_C4C3R, x' = k - ((255 - x) * k >> 8)
      const bool ycck = adobe_ && adobe_transform_ != 0;
      for (int y = 0; y < H; ++y) {
        const uint8_t* row[4];
        for (int i = 0; i < 4; ++i)
          row[i] = v[i].p + static_cast<size_t>(y) * v[i].stride;
        uint8_t* o = rgb + static_cast<size_t>(y) * W * 3;
        for (int x = 0; x < W; ++x) {
          int c = row[0][x], m = row[1][x], ye = row[2][x];
          const int k = row[3][x];
          if (ycck) {
            const int yy = c, cb = m, cr = ye;
            c = lim[255 - (yy + kColor.cr_r[cr])];
            m = lim[255 - (yy + static_cast<int>(
                                    (kColor.cb_g[cb] + kColor.cr_g[cr]) >>
                                    kScaleBits))];
            ye = lim[255 - (yy + kColor.cb_b[cb])];
          }
          o[3 * x] = static_cast<uint8_t>(k - ((255 - c) * k >> 8));
          o[3 * x + 1] = static_cast<uint8_t>(k - ((255 - m) * k >> 8));
          o[3 * x + 2] = static_cast<uint8_t>(k - ((255 - ye) * k >> 8));
        }
      }
      return;
    }
    const bool as_rgb = is_rgb();
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
    if (tiff_ == TIFF_YCBCR_TO_RGB) {
      if (lossless_)
        fail(JPEG_UNSUPPORTED, "a lossless JPEG in YCbCr, which libjpeg does "
                               "not convert");
      return false;
    }
    if (lossless_) return true;
    if (jfif_) return false;
    if (adobe_) return adobe_transform_ == 0;
    return comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
  }

  const uint8_t* begin_;
  const uint8_t* p_;
  const uint8_t* end_;
  Buffers* b_;
  bool imread_;
  Tiff tiff_ = NOT_TIFF;
  bool smooth_ = false;    // libjpeg's block smoothing applies
  int last_good_ = -1;     // jdcoefct.c's last_good_iMCU_row
  bool frame_ = false, progressive_ = false, arith_ = false, done_ = false;
  bool lossless_ = false;  // SOF3: 1-sample blocks, undiff_ the samples
  bool one_scan_ = false;  // the first scan holds every component
  int precision_ = 8;
  std::vector<uint16_t> undiff_[4];
  bool jfif_ = false, adobe_ = false, has_orientation_ = false;
  int adobe_transform_ = -1, orientation_ = 0;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0, scans_ = 0, eobrun_ = 0;
  std::vector<Component> comps_;
  uint16_t quant_[4][64] = {};
  bool quant_defined_[4] = {false, false, false, false};
  HuffTable huff_[2][4];
  // arithmetic coding: conditioning (DAC; SOI's defaults) and statistics
  int dc_l_[16], dc_u_[16], ac_k_[16];
  uint8_t dc_stats_[16][64] = {}, ac_stats_[16][256] = {};
  uint8_t fixed_bin_[4] = {113, 0, 0, 0};
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
                bool imread, int* w, int* h, int* ow, int* oh, int* orientation,
                char* msg, int msg_len, Alloc alloc) {
  *w = *h = *ow = *oh = *orientation = 0;
  set_msg(msg, msg_len, "");
  if (!read_file(path, &b->data)) {
    set_msg(msg, msg_len, std::string("cannot read the file: ") +
                              std::strerror(errno));
    return JPEG_IO;
  }
  std::function<bool()> past_end;
  try {
    if (max_denom != 1 && max_denom != 2 && max_denom != 4 && max_denom != 8)
      fail(JPEG_UNSUPPORTED, "scale 1/" + std::to_string(max_denom) +
                                 " (1/1, 1/2, 1/4 or 1/8)");
    // libjpeg's source manager answers a read past the end with an EOI
    // marker, FF D9, each time it is asked: a file cut inside a segment
    // after its first scan reads on through them as libjpeg does (one
    // segment takes at most 65535 bytes of them), and a cut scan ends.
    const size_t real = b->data.size();
    b->data.resize(real + kEofPad);
    for (size_t i = real; i < b->data.size(); i += 2) {
      b->data[i] = 0xFF;
      b->data[i + 1] = 0xD9;
    }
    Decoder d(b->data.data(), b->data.size(), b, imread);
    past_end = [&] { return d.consumed() > real; };
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
    const bool cut = past_end && past_end() &&
                     e.msg.find("truncated") == std::string::npos;
    set_msg(msg, msg_len, e.msg + (cut ? " (truncated file)" : ""));
    return e.code;
  } catch (const std::bad_alloc&) {
    set_msg(msg, msg_len, "out of memory");
    return JPEG_CORRUPT;
  }
}

// One file at 1/denom into a buffer of *h * *w * 3 bytes that it allocates
// (*pixels, freed with jpeg_free), turned by its EXIF orientation when
// `exif`; on an error *pixels is null.
int decode_file(const char* path, Buffers* b, int denom, int flags,
                uint8_t** pixels, int* w, int* h, char* msg, int msg_len) {
  uint8_t* rgb = nullptr;
  int ow, oh, orientation;
  const bool exif = flags & READ_EXIF;
  int code = decode_with(path, b, 0, denom, (flags & READ_IMREAD) != 0, w, h,
                         &ow, &oh, &orientation,
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
                       int flags, uint8_t** pixels, int* ws, int* hs,
                       int* codes, char* msgs, int msg_len) {
  const int nt = std::max(1, std::min(threads, n));
  std::atomic<int> next{0};
  auto work = [&] {
    Buffers b;
    for (int i; (i = next.fetch_add(1)) < n;)
      codes[i] = decode_file(paths[i], &b, denom, flags, &pixels[i],
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

// One strip or tile of a TIFF of JPEG compression (7) as libtiff's JPEG
// codec has libjpeg (cv2's libjpeg-turbo 3) decode it for the RGBA reader
// (tif_jpeg.c's JPEGSetupDecode and JPEGPreDecode): the JPEGTables stream
// (tag 347; ntables 0 without one), then the segment's own stream, at full
// scale, checked as libtiff checks them: `comps` components, 8-bit
// samples, component 0 sampled hs x vs and the others 1 x 1, a frame of
// the segment's w x h or, for the last strip (`taller_ok`), as wide and
// taller.  With `to_rgb` (photometric YCbCr, which the RGBA reader asks
// libjpeg to convert) YCbCr becomes RGB, 3 bytes a pixel, through the
// file's upsampling; else the samples come as stored, `comps` bytes a
// pixel.  out: w * h * (to_rgb ? 3 : comps) bytes.  Returns a Code, the
// reason in msg.
int jpeg_decode_tiff(const uint8_t* tables, int64_t ntables,
                     const uint8_t* strip, int64_t nstrip, int to_rgb, int w,
                     int h, int comps, int hs, int vs, int taller_ok,
                     uint8_t* out, char* msg, int msg_len) {
  set_msg(msg, msg_len, "");
  Buffers b;
  try {
    // each stream followed by libjpeg's EOI answers past its end
    std::vector<uint8_t>& data = b.data;
    const size_t at_strip = static_cast<size_t>(ntables) + kEofPad;
    data.assign(at_strip + nstrip + kEofPad, 0);
    std::memcpy(data.data(), tables, ntables);
    std::memcpy(data.data() + at_strip, strip, nstrip);
    for (size_t i = 0; i < kEofPad; i += 2) {
      for (size_t at : {static_cast<size_t>(ntables), at_strip + nstrip}) {
        data[at + i] = 0xFF;
        data[at + i + 1] = 0xD9;
      }
    }
    const size_t from = ntables > 0 ? 0 : at_strip;
    Decoder d(data.data() + from, data.size() - from, &b, true);
    if (ntables > 0) d.tables(data.data() + at_strip);
    d.set_tiff(to_rgb ? Decoder::TIFF_YCBCR_TO_RGB : Decoder::TIFF_SAMPLES);
    int jw, jh;
    d.header(&jw, &jh);
    if (d.components() != comps)
      fail(JPEG_UNSUPPORTED, "improper JPEG component count (" +
                                 std::to_string(d.components()) + ", not " +
                                 std::to_string(comps) + ")");
    if (d.precision() != 8)
      fail(JPEG_UNSUPPORTED, "improper JPEG data precision (" +
                                 std::to_string(d.precision()) + " bits)");
    for (int i = 0; i < comps; ++i) {
      const int want_h = i ? 1 : hs, want_v = i ? 1 : vs;
      if (d.h_samp(i) != want_h || d.v_samp(i) != want_v)
        fail(JPEG_UNSUPPORTED,
             "improper JPEG sampling factors " + std::to_string(d.h_samp(i)) +
                 "," + std::to_string(d.v_samp(i)) + " (component " +
                 std::to_string(i) + "; the TIFF says " +
                 std::to_string(want_h) + "," + std::to_string(want_v) + ")");
    }
    if (jw < w || jh < h)
      fail(JPEG_UNSUPPORTED, "a JPEG strip or tile of " + std::to_string(jw) +
                                 "x" + std::to_string(jh) + ", smaller than "
                                 "its " + std::to_string(w) + "x" +
                                 std::to_string(h));
    if (jw > w || (jh > h && !taller_ok))
      fail(JPEG_CORRUPT, "a JPEG strip or tile of " + std::to_string(jw) +
                             "x" + std::to_string(jh) + ", larger than its " +
                             std::to_string(w) + "x" + std::to_string(h));
    const int px = to_rgb ? 3 : comps;
    b.rgb.resize(static_cast<size_t>(jw) * jh * px);
    d.decode(1, b.rgb.data());
    std::memcpy(out, b.rgb.data(), static_cast<size_t>(w) * h * px);
    return JPEG_OK;
  } catch (const Error& e) {
    set_msg(msg, msg_len, e.msg);
    return e.code;
  } catch (const std::bad_alloc&) {
    set_msg(msg, msg_len, "out of memory");
    return JPEG_CORRUPT;
  }
}

}  // extern "C"

int jpegdec::pick_denom(int w, int h, int target, int max_denom) {
  int d = 1;
  while (d < max_denom && w / (d * 2) >= target && h / (d * 2) >= target)
    d *= 2;
  return d;
}

int jpegdec::decode_into(const char* path, Buffers* b, int target,
                         int max_denom, bool imread, int* w, int* h, int* orig_w,
                         int* orig_h, int* orientation, char* msg,
                         int msg_len) {
  return decode_with(path, b, target, max_denom, imread, w, h, orig_w, orig_h,
                     orientation, msg, msg_len, [&](size_t bytes) {
                       b->rgb.resize(bytes);
                       return b->rgb.data();
                     });
}

int jpegdec::exif_orientation(const uint8_t* tiff, size_t len) {
  int value = 0;
  return ExifReader(tiff, len).orientation(&value) ? value : 0;
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
