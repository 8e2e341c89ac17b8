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
  JPEG_CORRUPT = 3,      // not a JPEG, truncated or malformed
};

// Reads the file at `path` into *data and decodes it at full scale into
// *rgb (resized to *h * *w * 3 bytes of packed RGB); both buffers keep
// their storage from call to call.  Returns a Code; on an error the reason
// is written to msg (msg_len bytes, NUL-terminated).
int decode_into(const char* path, std::vector<uint8_t>* data,
                std::vector<uint8_t>* rgb, int* w, int* h, char* msg,
                int msg_len);

}  // namespace jpegdec
