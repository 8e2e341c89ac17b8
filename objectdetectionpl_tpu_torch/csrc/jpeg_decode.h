// The decoder's C++ interface to the rest of the port's host library
// (preproc.cc); the C interface is in jpeg_decode.cc.

#pragma once

#include <cstdint>
#include <vector>

namespace jpegdec {

enum Code {
  JPEG_OK = 0,
  JPEG_IO = 1,           // the file cannot be read
  JPEG_UNSUPPORTED = 2,  // a valid JPEG of a kind this decoder does not take
  JPEG_CORRUPT = 3,      // not a JPEG, or malformed
};

// How a file is read (the `flags` of the C interface)
enum Flags {
  READ_EXIF = 1,     // turned by its EXIF orientation, as cv2.imread turns it
  READ_IMREAD = 2,   // 4-component (CMYK, YCCK) and lossless files
                     // decoded as cv2.imread decodes them; without it they
                     // fail, as libjpeg 2.1's RGB output refuses them
};

// A worker's buffers, which keep their storage from file to file: the
// file's bytes, the decoded RGB image and the decoder's own planes.
struct Buffers {
  std::vector<uint8_t> data, rgb;
  std::vector<uint8_t> turned;      // rgb turned by its EXIF orientation
  std::vector<int16_t> coef;        // every component's DCT coefficients
  std::vector<uint8_t> plane[4];    // each component after the IDCT
  std::vector<uint8_t> full[4];     // each upsampled component
};

// libjpeg's scale_denom for a W x H source and a target of S pixels, as
// the JAX package's fused loader picks it: the largest power of two d <=
// max_denom with W / (2d) >= S and H / (2d) >= S at the step to d
// (integer division).  S = 0 gives max_denom.
int pick_denom(int w, int h, int target, int max_denom);

// Reads the file at `path` into b->data and decodes it into b->rgb
// (resized to *h * *w * 3 bytes of packed RGB) at 1/d scale, d =
// pick_denom(orig_w, orig_h, target, max_denom), d in {1, 2, 4, 8}:
// *w = ceil(orig_w / d), *h = ceil(orig_h / d), as libjpeg's scale_denom
// gives.  *orig_w / *orig_h are the SOF's sizes, *orientation the EXIF
// Orientation as cv2.imread reads it (0 without one; not applied).  With
// `imread`, CMYK and YCCK files decode as cv2.imread decodes them.
// Returns a Code; on an error the reason is written to msg (msg_len bytes,
// NUL-terminated).
int decode_into(const char* path, Buffers* b, int target, int max_denom,
                bool imread, int* w, int* h, int* orig_w, int* orig_h, int* orientation,
                char* msg, int msg_len);

// The EXIF Orientation of TIFF data (an APP1 "Exif\0\0" segment's bytes
// after that mark, or a PNG's eXIf chunk) as cv2 reads it: 0 without one.
int exif_orientation(const uint8_t* tiff, size_t len);

// The w x h packed RGB image at src turned by EXIF orientation 1..8 into
// dst (w * h * 3 bytes) as cv2.imread turns it; *out_w x *out_h is the
// result's size (w and h swapped for 5..8).
void orient(const uint8_t* src, int w, int h, int orientation, uint8_t* dst,
            int* out_w, int* out_h);

}  // namespace jpegdec
