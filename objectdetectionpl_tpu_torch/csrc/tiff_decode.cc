// The inner loops of the port's TIFF reader (data/formats.py parses the
// IFD), host C++17: a strip's or tile's LZW and PackBits data decoded as
// libtiff 4 decodes them (tif_lzw.c, tif_packbits.c).
//
// C interface, each filling dst (dst_size bytes) from src (n bytes):
//   tiff_lzw(src, n, dst, dst_size, msg, msg_len)
//   tiff_packbits(src, n, dst, dst_size, msg, msg_len)
// return 0, or 3 with the reason in msg: data that end before dst is
// full, or a code LZW's table does not hold yet.  LZW is the TIFF 6
// kind: MSB first, a Clear code first, 9 to 12-bit codes widened one code
// early; the older LSB-first kind that libtiff also reads is refused.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

struct Error {
  std::string msg;
};

void set_msg(char* msg, int msg_len, const std::string& s) {
  if (msg && msg_len > 0) std::snprintf(msg, msg_len, "%s", s.c_str());
}

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kTable = 4096;

void lzw(const uint8_t* src, int64_t n, uint8_t* dst, int64_t size) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1))
    throw Error{"old-style (LSB-first) LZW"};
  // each entry: its last byte, its first byte, its length and its prefix
  static thread_local uint8_t last[kTable], first[kTable];
  static thread_local uint16_t length[kTable], prefix[kTable];
  for (int i = 0; i < 256; ++i) {
    last[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int64_t pos = 0;            // bits read
  const int64_t total = n * 8;
  int nbits = 9, free_ent = kFirst, old = -1;
  int64_t out = 0;
  auto next_code = [&]() -> int {
    if (pos + nbits > total) return -1;
    // the three bytes that hold any 9- to 12-bit code
    const int64_t at = pos >> 3;
    uint32_t w = static_cast<uint32_t>(src[at]) << 16;
    if (at + 1 < n) w |= static_cast<uint32_t>(src[at + 1]) << 8;
    if (at + 2 < n) w |= src[at + 2];
    const int code = (w >> (24 - (pos & 7) - nbits)) & ((1 << nbits) - 1);
    pos += nbits;
    return code;
  };
  while (out < size) {
    int code = next_code();
    if (code < 0) throw Error{"LZW data end before the strip is full"};
    if (code == kEoi) break;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = 9;
      code = next_code();
      if (code < 0) throw Error{"LZW data end before the strip is full"};
      if (code == kEoi) break;
      if (code > kClear) throw Error{"a corrupted LZW table"};
      dst[out++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (old < 0) throw Error{"LZW data without a Clear code first"};
    if (code >= free_ent + 1 || free_ent >= kTable)
      throw Error{"an LZW code not yet in the table"};
    // the new entry: the previous string and the first byte of this one
    // (of the new entry itself when the code is that entry)
    prefix[free_ent] = static_cast<uint16_t>(old);
    first[free_ent] = first[old];
    length[free_ent] = static_cast<uint16_t>(length[old] + 1);
    last[free_ent] = code < free_ent ? first[code] : first[old];
    if (++free_ent > (1 << nbits) - 2 && nbits < 12) ++nbits;
    old = code;
    int len = length[code];
    int64_t end = out + len;
    int c = code;
    // written backwards; what passes the strip's end is dropped
    for (int64_t i = end - 1; i >= out; --i) {
      if (i < size) dst[i] = last[c];
      c = prefix[c];
    }
    out = end < size ? end : size;
  }
  if (out < size) throw Error{"LZW data end before the strip is full"};
}

void packbits(const uint8_t* src, int64_t n, uint8_t* dst, int64_t size) {
  int64_t in = 0, out = 0;
  while (in < n && out < size) {
    int c = src[in++];
    if (c >= 128) c -= 256;
    if (c < 0) {
      if (c == -128) continue;
      int64_t run = 1 - c;
      if (run > size - out) run = size - out;
      if (in >= n) break;
      std::memset(dst + out, src[in++], run);
      out += run;
    } else {
      int64_t lit = c + 1;
      if (lit > size - out) lit = size - out;
      if (n - in < lit) break;
      std::memcpy(dst + out, src + in, lit);
      out += lit;
      in += lit;
    }
  }
  if (out < size) throw Error{"PackBits data end before the strip is full"};
}

}  // namespace

extern "C" {

int tiff_lzw(const uint8_t* src, int64_t n, uint8_t* dst, int64_t size,
             char* msg, int msg_len) {
  try {
    lzw(src, n, dst, size);
    return 0;
  } catch (const Error& e) {
    set_msg(msg, msg_len, e.msg);
    return 3;
  }
}

int tiff_packbits(const uint8_t* src, int64_t n, uint8_t* dst, int64_t size,
                  char* msg, int msg_len) {
  try {
    packbits(src, n, dst, size);
    return 0;
  } catch (const Error& e) {
    set_msg(msg, msg_len, e.msg);
    return 3;
  }
}

}  // extern "C"
