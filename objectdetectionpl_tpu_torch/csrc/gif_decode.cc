// The LZW decoder of the port's GIF reader (host C++17; data/formats.py
// parses the blocks around it), decoding a frame's codes as cv2.imread's
// GifDecoder does.
//
// GIF's LZW: codes LSB first, min_code_size + 1 bits wide after a Clear
// code, one bit wider each time the next free table entry reaches the
// width's limit, up to 12 bits; the table stops growing at 4096 entries
// (a "deferred clear": the codes go on at 12 bits until a Clear).  Like
// cv2, it reads the sub-blocks' bytes one at a time as the codes need them
// and decodes every whole code they hold: the zero bits that pad the last
// byte decode as codes when the End code is missing, and codes after an
// End code decode on (from a reset code width).  cv2's checks on a frame
// of npix pixels, found by probing it: a byte may be read only while at
// most npix pixels have come; a table code that starts inside the frame
// must end inside it; a colour code, or a table code once the frame is
// full, adds its pixels past the frame unchecked.
//
// C interface:
//   gif_lzw(src, n, min_code_size, dst, npix, msg, msg_len)
// decodes the sub-blocks' data src[0..n) into the first npix indices of
// dst and returns the number of indices the codes held (more than npix
// when they run past the frame), or -1 with the reason in msg: a first
// code after a Clear that is not a colour, a code past the table, a table
// code after an End code (cv2 reads a cleared table there), or codes past
// the frame as above.

#include <cstdint>
#include <cstdio>
#include <string>

namespace {

void set_msg(char* msg, int msg_len, const std::string& s) {
  if (msg && msg_len > 0) std::snprintf(msg, msg_len, "%s", s.c_str());
}

constexpr int kTable = 4096;

}  // namespace

extern "C" {

int64_t gif_lzw(const uint8_t* src, int64_t n, int min_code_size,
                uint8_t* dst, int64_t npix, char* msg, int msg_len) {
  static thread_local uint16_t prefix[kTable], length[kTable];
  static thread_local uint8_t suffix[kTable], first[kTable];
  static thread_local uint8_t stack[kTable];
  const int clear = 1 << min_code_size, end = clear + 1;
  for (int i = 0; i < clear; ++i) {
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int width = min_code_size + 1, next = end + 1, prev = -1;
  bool ended = false;
  int64_t out = 0;
  uint32_t acc = 0;
  int nacc = 0;
  auto emit = [&](int code) {
    if (out >= npix) {                      // past the frame: counted only
      out += length[code];
      return;
    }
    int k = 0;
    for (int c = code; k < length[code]; c = prefix[c]) stack[k++] = suffix[c];
    for (int i = k - 1; i >= 0; --i) dst[out++] = stack[i];
  };
  auto refuse = [&](const char* why) {
    set_msg(msg, msg_len, why);
    return int64_t(-1);
  };
  for (int64_t i = 0; i < n; ++i) {
    if (out > npix) return refuse("LZW codes past the frame's pixels");
    acc |= uint32_t(src[i]) << nacc;
    nacc += 8;
    while (nacc >= width) {
      const int code = static_cast<int>(acc & ((1u << width) - 1));
      acc >>= width;
      nacc -= width;
      if (code == clear || code == end) {
        width = min_code_size + 1;
        next = end + 1;
        prev = -1;
        ended = code == end;                // a Clear restores the table
        if (code == clear) continue;
        break;
      }
      if (prev < 0) {
        if (code > clear)
          return refuse(ended ? "an LZW table code after the End code"
                              : "a first LZW code that is not a colour");
        emit(code);
        prev = code;
        continue;
      }
      if (code > next || (code == next && next == kTable))
        return refuse("an LZW code past the table");
      if (next < kTable) {
        prefix[next] = static_cast<uint16_t>(prev);
        length[next] = static_cast<uint16_t>(length[prev] + 1);
        first[next] = first[prev];
        suffix[next] = code == next ? first[prev] : first[code];
        ++next;
        if (next == 1 << width && width < 12) ++width;
      }
      if (code > clear && out < npix && out + length[code] > npix)
        return refuse("an LZW string that runs past the frame");
      emit(code);
      prev = code;
    }
  }
  return out;
}

}  // extern "C"
