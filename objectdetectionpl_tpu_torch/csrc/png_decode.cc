// PNG pixel data to packed 8-bit RGB, host C++17, as cv2.imread reads a PNG
// through libpng with IMREAD_COLOR: every colour type (grey, grey + alpha,
// palette, RGB, RGBA) at every bit depth (1, 2, 4, 8, 16), progressive
// (Adam7) or not.  Grey of 1, 2 and 4 bits scales to 8 (x 255, 85, 17:
// png_set_expand_gray_1_2_4_to_8), 16-bit samples keep their high byte
// (png_set_strip_16), alpha and tRNS are dropped with no compositing, a
// palette index past the palette's end is black (libpng's palette is 256
// entries, the missing ones zero).  The caller (data/formats.py) reads the
// chunks and inflates the image data with zlib; this file undoes the row
// filters (None, Sub, Up, Average, Paeth) and expands the samples.
//
// C interface:
//   png_unfilter(raw, raw_len, w, h, depth, color_type, interlace,
//                palette, palette_len, rgb, msg, msg_len)
//     raw: the inflated IDAT stream; rgb: h * w * 3 bytes.  Returns 0, or 3
//     with a reason in msg for data libpng refuses (too little of it, a
//     filter type above 4).
//   exif_orientation(tiff, len): the EXIF Orientation of TIFF data (a PNG's
//     eXIf chunk) as cv2 reads it, 0 without one.
//   image_orient(src, w, h, orientation, dst, out_w, out_h): an RGB image
//     turned by an EXIF orientation as cv2.imread turns it.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "jpeg_decode.h"

namespace {

int channels(int color_type) {
  switch (color_type) {
    case 0: return 1;   // grey
    case 2: return 3;   // RGB
    case 3: return 1;   // palette index
    case 4: return 2;   // grey + alpha
    case 6: return 4;   // RGBA
    default: return 0;
  }
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  return pa <= pb && pa <= pc ? a : pb <= pc ? b : c;
}

// Adam7's passes: starting column and row, column and row steps
const int kPass[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                         {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                         {0, 1, 1, 2}};

void set_msg(char* msg, int msg_len, const char* s) {
  if (msg && msg_len > 0) std::snprintf(msg, msg_len, "%s", s);
}

}  // namespace

extern "C" {

int png_unfilter(const uint8_t* raw, int64_t raw_len, int w, int h,
                 int depth, int color_type, int interlace,
                 const uint8_t* palette, int palette_len, uint8_t* rgb,
                 char* msg, int msg_len) {
  const int nch = channels(color_type);
  const int bits = nch * depth;                   // per pixel
  const int bpp = std::max(1, bits / 8);          // filter byte distance
  const uint8_t* in = raw;
  const uint8_t* end = raw + raw_len;
  std::vector<uint8_t> prev, cur;
  const int passes = interlace ? 7 : 1;
  for (int p = 0; p < passes; ++p) {
    const int x0 = interlace ? kPass[p][0] : 0, y0 = interlace ? kPass[p][1] : 0;
    const int dx = interlace ? kPass[p][2] : 1, dy = interlace ? kPass[p][3] : 1;
    const int pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
    const int ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;
    const size_t rowbytes = (static_cast<size_t>(pw) * bits + 7) / 8;
    prev.assign(rowbytes, 0);
    cur.resize(rowbytes);
    for (int r = 0; r < ph; ++r) {
      if (static_cast<size_t>(end - in) < rowbytes + 1) {
        set_msg(msg, msg_len, "not enough image data");
        return jpegdec::JPEG_CORRUPT;
      }
      const int filter = *in++;
      if (filter > 4) {
        set_msg(msg, msg_len, "bad adaptive filter value");
        return jpegdec::JPEG_CORRUPT;
      }
      for (size_t i = 0; i < rowbytes; ++i) {
        const int x = in[i];
        const int a = i >= static_cast<size_t>(bpp) ? cur[i - bpp] : 0;
        const int b = prev[i];
        const int c = i >= static_cast<size_t>(bpp) ? prev[i - bpp] : 0;
        int v = x;
        switch (filter) {
          case 1: v = x + a; break;
          case 2: v = x + b; break;
          case 3: v = x + ((a + b) >> 1); break;
          case 4: v = x + paeth(a, b, c); break;
          default: break;
        }
        cur[i] = static_cast<uint8_t>(v);
      }
      in += rowbytes;
      // expand the row's pixels into the image
      const int y = y0 + r * dy;
      for (int k = 0; k < pw; ++k) {
        uint8_t* o = rgb + (static_cast<size_t>(y) * w + x0 + k * dx) * 3;
        auto sample = [&](int ch) -> int {      // channel ch as 8 bits
          if (depth == 16) return cur[(static_cast<size_t>(k) * nch + ch) * 2];
          if (depth == 8) return cur[static_cast<size_t>(k) * nch + ch];
          const size_t bit = static_cast<size_t>(k) * depth;
          const int v = (cur[bit / 8] >> (8 - depth - bit % 8)) &
                        ((1 << depth) - 1);
          return color_type == 3 ? v : v * (255 / ((1 << depth) - 1));
        };
        if (color_type == 3) {
          const int idx = sample(0);
          for (int ch = 0; ch < 3; ++ch)
            o[ch] = idx < palette_len ? palette[idx * 3 + ch] : 0;
        } else if (nch >= 3) {
          for (int ch = 0; ch < 3; ++ch) o[ch] = static_cast<uint8_t>(sample(ch));
        } else {
          o[0] = o[1] = o[2] = static_cast<uint8_t>(sample(0));
        }
      }
      std::swap(prev, cur);
      cur.resize(rowbytes);
    }
  }
  return jpegdec::JPEG_OK;
}

int exif_orientation(const uint8_t* tiff, int64_t len) {
  return jpegdec::exif_orientation(tiff, static_cast<size_t>(len));
}

void image_orient(const uint8_t* src, int w, int h, int orientation,
                  uint8_t* dst, int* out_w, int* out_h) {
  jpegdec::orient(src, w, h, orientation, dst, out_w, out_h);
}

}  // extern "C"
