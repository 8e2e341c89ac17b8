// The inner loops of the port's TIFF reader (data/formats.py parses the
// IFD), host C++17: a strip's or tile's LZW, PackBits, CCITT fax,
// ThunderScan and SGILog data decoded as libtiff 4.7 decodes them
// (tif_lzw.c, tif_packbits.c, tif_fax3.c, tif_thunder.c, tif_luv.c).
//
// C interface, each filling dst from src (n bytes):
//   tiff_lzw(src, n, dst, dst_size, msg, msg_len)
//   tiff_packbits(src, n, dst, dst_size, msg, msg_len)
//   tiff_fax(src, n, dst, rows, width, kind, options, fill_order, noeol,
//            runs, msg, msg_len)
//   tiff_thunder(src, n, dst, rows, width, msg, msg_len)
//   tiff_sgilog(src, n, dst, rows, width, nbytes, msg, msg_len)
// return 0, or 3 with the reason in msg where libtiff's codec fails the
// strip: data that end before dst is full, a code LZW's table does not
// hold yet, a fax row that ends early.  dst then holds what the codec
// wrote before it failed, zeros after, as libtiff's zeroed strip buffer.
//
// LZW is the TIFF 6 kind (MSB first, a Clear code first, 9 to 12-bit
// codes widened one code early) or, when the data begin with 0x00 and a
// byte of bit 0 set, the old LSB-first kind that libtiff reads through
// LZWDecodeCompat (codes widened when the table reaches the next power of
// two).  tiff_fax decodes `rows` rows of `width` pixels, ceil(width / 8)
// bytes a row, 1 for black: kind 2 Modified Huffman (CCITT RLE, each row
// from a byte boundary), 3 T.4 (Group 3: an EOL before each row; 2-D rows
// where T4Options bit 0 is set, a tag bit after each EOL), 4 T.6 (Group
// 4: 2-D rows against the row above, a white row above the first);
// fill_order 2 reads each byte's bits from the least significant.  An
// extension code (uncompressed mode) ends its row, as in libtiff.
// *noeol is the codec's FAXMODE_NOEOL, carried from strip to strip of one
// image: Group 3 data that end where an EOL was sought set it (and that
// strip is decoded again from its start, as libtiff 4.7 retries).  runs
// is the codec's run arrays, tiff_fax_runs(width, kind, options) words
// that the caller zeroes once an image: libtiff allocates them once a
// directory, and a 2-D code that reads past the reference row's end sees
// what earlier rows and strips left there.
// tiff_thunder decodes ThunderScan's rows of 4-bit pixels,
// ceil(width / 2) bytes a row; tiff_sgilog SGILog's rows of 16-bit LogL
// (nbytes 2) or 32-bit LogLuv (4) values, one uint32 a pixel.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

void set_msg(char* msg, int msg_len, const std::string& s) {
  if (msg && msg_len > 0) std::snprintf(msg, msg_len, "%s", s.c_str());
}

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kTable = 4096;

// libtiff 4.7's LZWDecode, or LZWDecodeCompat for the old kind, into dst
// (zeroed by the caller): on bad data the bytes decoded so far stay, as
// libtiff leaves them in its strip buffer.  A code before the first Clear
// fails.  Entries go on past 4095, which no 12-bit code reaches, up to
// the table's CSIZE of 5119; any code but Clear and EOI after that
// fails.
constexpr int kCsize = kTable + 1023;

void lzw(const uint8_t* src, int64_t n, uint8_t* dst, int64_t size) {
  // LZWPreDecode: old-style codes begin with a Clear code LSB first
  const bool compat = n >= 2 && src[0] == 0 && (src[1] & 1);
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
    int code;
    if (compat) {
      // GetNextCodeCompat: the low bits of each byte first
      const uint32_t le = (w >> 16) | (w & 0xFF00) | ((w & 0xFF) << 16);
      code = (le >> (pos & 7)) & ((1 << nbits) - 1);
    } else {
      code = (w >> (24 - (pos & 7) - nbits)) & ((1 << nbits) - 1);
    }
    pos += nbits;
    return code;
  };
  // the width grows when the next entry reaches the last code of this
  // width (one early), or in the old kind when it passes it
  const int early = compat ? 1 : 2;
  while (out < size) {
    int code = next_code();
    if (code < 0) throw Error{"LZW data end before the strip is full"};
    if (code == kEoi) break;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = 9;
      do {
        code = next_code();
      } while (code == kClear);
      if (code < 0) throw Error{"LZW data end before the strip is full"};
      if (code == kEoi) break;
      if (code > kClear) throw Error{"a corrupted LZW table"};
      dst[out++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (old < 0) throw Error{"LZW data without a Clear code first"};
    if (free_ent < 0 || (compat && free_ent >= kCsize))
      throw Error{"a corrupted LZW table"};
    if (code > free_ent) throw Error{"an LZW code not yet in the table"};
    // the new entry: the previous string and the first byte of this one
    // (of the new entry itself when the code is that entry)
    if (free_ent < kTable) {
      prefix[free_ent] = static_cast<uint16_t>(old);
      first[free_ent] = first[old];
      length[free_ent] = static_cast<uint16_t>(length[old] + 1);
      last[free_ent] = code < free_ent ? first[code] : first[old];
    }
    if (++free_ent > (1 << nbits) - early) {
      if (nbits < 12) ++nbits;
      if (!compat && free_ent >= kCsize) free_ent = -1;
    }
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

// ---------------------------------------------------------------------------
// CCITT fax (tif_fax3.c).  The tables are mkg3states.c's: each indexed by
// the next 7 (2-D modes), 12 (white runs) or 13 (black runs) bits, the
// first bit of the data in bit 0; a pattern that starts no code is S_Null,
// width 0.

enum FaxState {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct TabEnt {
  uint8_t state = S_Null, width = 0;
  uint32_t param = 0;
};

struct Code {
  const char* bits;    // as T.4 writes it, first bit first
  int param;
};

// T.4's run-length codes: terminating 0..63, make-up 64..1728 by 64, the
// extended make-up codes 1792..2560 that both colours share
const char* const kTermW[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000", "0010111",
    "0000011", "0000100", "0101000", "0101011", "0010011", "0100100",
    "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000",
    "00101001", "00101010", "00101011", "00101100", "00101101", "00000100",
    "00000101", "00001010", "00001011", "01010010", "01010011", "01010100",
    "01010101", "00100100", "00100101", "01011000", "01011001", "01011010",
    "01011011", "01001010", "01001011", "00110010", "00110011", "00110100"};
const char* const kMakeUpW[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011"};
const char* const kTermB[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* const kMakeUpB[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* const kMakeUp[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

struct FaxTables {
  TabEnt main[128], white[4096], black[8192];

  static void fill(TabEnt* t, int size, const char* bits, int state,
                   int param) {
    int code = 0, width = 0;
    for (; bits[width]; ++width) code |= (bits[width] - '0') << width;
    for (int i = code; i < (1 << size); i += 1 << width)
      t[i] = TabEnt{static_cast<uint8_t>(state), static_cast<uint8_t>(width),
                    static_cast<uint32_t>(param)};
  }

  FaxTables() {
    const Code modes[] = {{"0001", S_Pass}, {"001", S_Horiz}, {"1", S_V0},
                          {"0000001", S_Ext}, {"0000000", S_EOL}};
    for (const Code& c : modes) fill(main, 7, c.bits, c.param, 0);
    const Code vert[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}};
    for (const Code& c : vert) fill(main, 7, c.bits, S_VR, c.param);
    const Code left[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}};
    for (const Code& c : left) fill(main, 7, c.bits, S_VL, c.param);
    for (int i = 0; i < 27; ++i) {
      fill(white, 12, kMakeUpW[i], S_MakeUpW, 64 * (i + 1));
      fill(black, 13, kMakeUpB[i], S_MakeUpB, 64 * (i + 1));
    }
    for (int i = 0; i < 13; ++i) {
      fill(white, 12, kMakeUp[i], S_MakeUp, 1792 + 64 * i);
      fill(black, 13, kMakeUp[i], S_MakeUp, 1792 + 64 * i);
    }
    for (int i = 0; i < 64; ++i) {
      fill(white, 12, kTermW[i], S_TermW, i);
      fill(black, 13, kTermB[i], S_TermB, i);
    }
    fill(white, 12, "00000000000", S_EOL, 0);
    fill(black, 13, "00000000000", S_EOL, 0);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables t;
  return t;
}

// The bit-reversal table of libtiff's TIFFGetBitRevTable
struct Reversed {
  uint8_t v[256];
  Reversed() {
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int b = 0; b < 8; ++b) r |= ((i >> b) & 1) << (7 - b);
      v[i] = static_cast<uint8_t>(r);
    }
  }
};

// _TIFFFax3fillruns: runs alternate white and black from white, clipped
// to lastx in the array itself (the next row's reference sees the clip);
// black bits set in a row that starts all white
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    uint32_t run = runs[0];
    if (x + run > lastx || run > lastx) run = runs[0] = lastx - x;
    x += run;
    run = runs[1];
    if (x + run > lastx || run > lastx) run = runs[1] = lastx - x;
    for (uint32_t i = x; i < x + run; ++i)
      buf[i >> 3] |= static_cast<uint8_t>(0x80 >> (i & 7));
    x += run;
  }
}

enum FaxKind { kRle = 2, kG3 = 3, kG4 = 4 };

// tif_fax3.c's Fax3DecodeRLE, Fax3Decode1D, Fax3Decode2D and Fax4Decode on
// one strip or tile of `rows` rows into dst (zeroed, rows * rowbytes).
// Returns 1 when every row was decoded; 0 where libtiff's decoder returns
// its error after a premature end of the data or a run past its arrays,
// dst then holding what it filled (G4's "badly-terminated strips" return
// 1 once a row is done, as libtiff's).
uint32_t fax_nruns(int width, int kind, int options) {
  const uint32_t nruns = (static_cast<uint32_t>(width) + 1 + 31) / 32 * 32;
  return kind == kG4 || (kind == kG3 && (options & 1)) ? nruns * 2 : nruns;
}

int fax_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t rows,
               int width, int kind, int options, int fill_order,
               bool* noeol_mode, uint32_t* runs) {
  static const Reversed kReversed;
  static uint8_t identity[256];
  if (!identity[255])
    for (int i = 0; i < 256; ++i) identity[i] = static_cast<uint8_t>(i);
  const FaxTables& T = fax_tables();
  const uint8_t* bitmap = fill_order == 2 ? identity : kReversed.v;
  const bool two_d = kind == kG4 || (kind == kG3 && (options & 1));
  const int rowbytes = (width + 7) / 8;
  const uint32_t lastx = static_cast<uint32_t>(width);
  const uint32_t nruns = fax_nruns(width, kind, options);
  uint32_t* curruns = runs;
  uint32_t* refruns = two_d ? runs + nruns : nullptr;
  if (refruns) {
    refruns[0] = lastx;
    refruns[1] = 0;
  }
  // FAXMODE_NOEOL: RLE's, or Group 3's once a row found no EOL before the
  // data ended, in this strip and the image's later ones (the codec's mode)
  bool& noeol = *noeol_mode;
  if (kind == kRle) noeol = true;
  const uint8_t* cp = src;
  const uint8_t* ep = src + n;
  uint32_t BitAcc = 0;
  int BitsAvail = 0, EOLcnt = 0;
  int64_t line = 0;
  uint8_t* buf = dst;
  const TabEnt* TabEnt_ = nullptr;
  int a0 = 0, RunLength = 0, b1 = 0;
  uint32_t *pa = nullptr, *thisrun = nullptr, *pb = nullptr;
  int is1D = 1;

#define EndOfData() (cp >= ep)
#define NeedBits8(nb, eoflab)                                            \
  do {                                                                   \
    if (BitsAvail < (nb)) {                                              \
      if (EndOfData()) {                                                 \
        if (BitsAvail == 0) goto eoflab;                                 \
        BitsAvail = (nb);                                                \
      } else {                                                           \
        BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail;     \
        BitsAvail += 8;                                                  \
      }                                                                  \
    }                                                                    \
  } while (0)
#define NeedBits16(nb, eoflab)                                           \
  do {                                                                   \
    if (BitsAvail < (nb)) {                                              \
      if (EndOfData()) {                                                 \
        if (BitsAvail == 0) goto eoflab;                                 \
        BitsAvail = (nb);                                                \
      } else {                                                           \
        BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail;     \
        if ((BitsAvail += 8) < (nb)) {                                   \
          if (EndOfData()) {                                             \
            BitsAvail = (nb);                                            \
          } else {                                                       \
            BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail; \
            BitsAvail += 8;                                              \
          }                                                              \
        }                                                                \
      }                                                                  \
    }                                                                    \
  } while (0)
#define GetBits(nb) (BitAcc & ((1u << (nb)) - 1))
#define ClrBits(nb)        \
  do {                     \
    BitsAvail -= (nb);     \
    BitAcc >>= (nb);       \
  } while (0)
#define LOOKUP8(wid, tab, eoflab)     \
  do {                                \
    NeedBits8(wid, eoflab);           \
    TabEnt_ = (tab) + GetBits(wid);   \
    ClrBits(TabEnt_->width);          \
  } while (0)
#define LOOKUP16(wid, tab, eoflab)    \
  do {                                \
    NeedBits16(wid, eoflab);          \
    TabEnt_ = (tab) + GetBits(wid);   \
    ClrBits(TabEnt_->width);          \
  } while (0)
#define SETVALUE(x)                                  \
  do {                                               \
    if (pa >= thisrun + nruns) return 0;             \
    *pa++ = RunLength + (x);                         \
    a0 += (x);                                       \
    RunLength = 0;                                   \
  } while (0)
#define CLEANUP_RUNS()                                   \
  do {                                                   \
    if (RunLength) SETVALUE(0);                          \
    if (a0 != static_cast<int>(lastx)) {                 \
      while (a0 > static_cast<int>(lastx) && pa > thisrun) \
        a0 -= *--pa;                                     \
      if (a0 < static_cast<int>(lastx)) {                \
        if (a0 < 0) a0 = 0;                              \
        if ((pa - thisrun) & 1) SETVALUE(0);             \
        SETVALUE(lastx - a0);                            \
      } else if (a0 > static_cast<int>(lastx)) {         \
        SETVALUE(lastx);                                 \
        SETVALUE(0);                                     \
      }                                                  \
    }                                                    \
  } while (0)
#define CHECK_b1                                               \
  do {                                                         \
    if (pa != thisrun)                                         \
      while (b1 <= a0 && b1 < static_cast<int>(lastx)) {       \
        if (pb + 1 >= refruns + nruns) return 0;               \
        b1 += pb[0] + pb[1];                                   \
        pb += 2;                                               \
      }                                                        \
  } while (0)

  while (line < rows) {
  row_start:
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
    if (kind == kG3 && !noeol) {
      // SYNC_EOL: find 11 zero bits unless the last row ended at an EOL,
      // skip the zero bytes and bits after them and the EOL's 1
      if (EOLcnt == 0) {
        for (;;) {
          NeedBits16(11, no_eol);
          if (GetBits(11) == 0) break;
          ClrBits(1);
        }
      }
      for (;;) {
        NeedBits8(8, no_eol);
        if (GetBits(8)) break;
        ClrBits(8);
      }
      while (GetBits(1) == 0) ClrBits(1);
      ClrBits(1);
      EOLcnt = 0;
      goto synced;
    no_eol:
      // libtiff 4.7's "retry without EOL": the data end before an EOL, so
      // this row and the strip's later ones are decoded again from the
      // strip's first byte, without EOLs (the mode stays for the image)
      noeol = true;
      cp = src;
      BitAcc = 0;
      BitsAvail = 0;
      goto row_start;
    }
  synced:
    if (kind == kG3 && two_d) {
      NeedBits8(1, eof_row);
      is1D = GetBits(1);
      ClrBits(1);
    } else {
      is1D = kind != kG4;
    }
    if (two_d) {
      pb = refruns;
      b1 = static_cast<int>(*pb++);
    }
    if (is1D) {
      // EXPAND1D
      for (;;) {
        for (;;) {
          LOOKUP16(12, T.white, eof1d);
          switch (TabEnt_->state) {
            case S_EOL:
              EOLcnt = 1;
              goto done1d;
            case S_TermW:
              SETVALUE(static_cast<int>(TabEnt_->param));
              goto doneWhite1d;
            case S_MakeUpW:
            case S_MakeUp:
              a0 += TabEnt_->param;
              RunLength += TabEnt_->param;
              break;
            default:
              goto done1d;
          }
        }
      doneWhite1d:
        if (a0 >= static_cast<int>(lastx)) goto done1d;
        for (;;) {
          LOOKUP16(13, T.black, eof1d);
          switch (TabEnt_->state) {
            case S_EOL:
              EOLcnt = 1;
              goto done1d;
            case S_TermB:
              SETVALUE(static_cast<int>(TabEnt_->param));
              goto doneBlack1d;
            case S_MakeUpB:
            case S_MakeUp:
              a0 += TabEnt_->param;
              RunLength += TabEnt_->param;
              break;
            default:
              goto done1d;
          }
        }
      doneBlack1d:
        if (a0 >= static_cast<int>(lastx)) goto done1d;
        if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
      }
    eof1d:
      CLEANUP_RUNS();
      goto eof_filled;
    done1d:
      CLEANUP_RUNS();
    } else {
      // EXPAND2D
      while (a0 < static_cast<int>(lastx)) {
        if (pa >= thisrun + nruns) return 0;
        LOOKUP8(7, T.main, eof2d);
        switch (TabEnt_->state) {
          case S_Pass:
            CHECK_b1;
            if (pb + 1 >= refruns + nruns) return 0;
            b1 += *pb++;
            RunLength += b1 - a0;
            a0 = b1;
            b1 += *pb++;
            break;
          case S_Horiz:
            if ((pa - thisrun) & 1) {
              for (;;) {              // black first
                LOOKUP16(13, T.black, eof2d);
                switch (TabEnt_->state) {
                  case S_TermB:
                    SETVALUE(static_cast<int>(TabEnt_->param));
                    goto doneWhite2da;
                  case S_MakeUpB:
                  case S_MakeUp:
                    a0 += TabEnt_->param;
                    RunLength += TabEnt_->param;
                    break;
                  default:
                    goto eol2d;
                }
              }
            doneWhite2da:
              for (;;) {              // then white
                LOOKUP16(12, T.white, eof2d);
                switch (TabEnt_->state) {
                  case S_TermW:
                    SETVALUE(static_cast<int>(TabEnt_->param));
                    goto doneBlack2da;
                  case S_MakeUpW:
                  case S_MakeUp:
                    a0 += TabEnt_->param;
                    RunLength += TabEnt_->param;
                    break;
                  default:
                    goto eol2d;
                }
              }
            doneBlack2da:;
            } else {
              for (;;) {              // white first
                LOOKUP16(12, T.white, eof2d);
                switch (TabEnt_->state) {
                  case S_TermW:
                    SETVALUE(static_cast<int>(TabEnt_->param));
                    goto doneWhite2db;
                  case S_MakeUpW:
                  case S_MakeUp:
                    a0 += TabEnt_->param;
                    RunLength += TabEnt_->param;
                    break;
                  default:
                    goto eol2d;
                }
              }
            doneWhite2db:
              for (;;) {              // then black
                LOOKUP16(13, T.black, eof2d);
                switch (TabEnt_->state) {
                  case S_TermB:
                    SETVALUE(static_cast<int>(TabEnt_->param));
                    goto doneBlack2db;
                  case S_MakeUpB:
                  case S_MakeUp:
                    a0 += TabEnt_->param;
                    RunLength += TabEnt_->param;
                    break;
                  default:
                    goto eol2d;
                }
              }
            doneBlack2db:;
            }
            CHECK_b1;
            break;
          case S_V0:
            CHECK_b1;
            SETVALUE(b1 - a0);
            if (pb >= refruns + nruns) return 0;
            b1 += *pb++;
            break;
          case S_VR:
            CHECK_b1;
            SETVALUE(b1 - a0 + static_cast<int>(TabEnt_->param));
            if (pb >= refruns + nruns) return 0;
            b1 += *pb++;
            break;
          case S_VL:
            CHECK_b1;
            if (b1 < static_cast<int>(a0 + TabEnt_->param)) goto eol2d;
            SETVALUE(b1 - a0 - static_cast<int>(TabEnt_->param));
            b1 -= *--pb;
            break;
          case S_Ext:
            *pa++ = lastx - a0;
            goto eol2d;
          case S_EOL:
            *pa++ = lastx - a0;
            NeedBits8(4, eof2d);
            ClrBits(4);
            EOLcnt = 1;
            goto eol2d;
          default:
            goto eol2d;
        }
      }
      if (RunLength) {
        if (RunLength + a0 < static_cast<int>(lastx)) {
          // expect a final V0
          NeedBits8(1, eof2d);
          if (!GetBits(1)) goto eol2d;
          ClrBits(1);
        }
        SETVALUE(0);
      }
      goto eol2d;
    eof2d:
      CLEANUP_RUNS();
      goto eof_filled;
    eol2d:
      CLEANUP_RUNS();
      if (kind == kG4 && EOLcnt) goto g4_end;
    }
    fill_runs(buf, thisrun, pa, lastx);
    if (two_d) {
      if (kind == kG4 || pa < thisrun + nruns) SETVALUE(0);
      std::swap(curruns, refruns);
    }
    if (kind == kRle) {
      const int rest = BitsAvail & 7;   // the rest of the byte
      ClrBits(rest);
    }
    buf += rowbytes;
    ++line;
    continue;
  eof_row:
    CLEANUP_RUNS();
  eof_filled:
    if (kind == kG4) goto g4_end;
    fill_runs(buf, thisrun, pa, lastx);
    return 0;
  g4_end:
    // Fax4Decode's EOFG4: the row as it stands; a success once a row is
    // done ("don't error on badly-terminated strips")
    fill_runs(buf, thisrun, pa, lastx);
    return line != 0;
  }
  return 1;
#undef EndOfData
#undef NeedBits8
#undef NeedBits16
#undef GetBits
#undef ClrBits
#undef LOOKUP8
#undef LOOKUP16
#undef SETVALUE
#undef CLEANUP_RUNS
#undef CHECK_b1
}

// ---------------------------------------------------------------------------
// ThunderScan (tif_thunder.c): 4-bit pixels, two a byte, from codes of a
// 2-bit kind and 6 bits of data: runs of the last pixel, three 2-bit or
// two 3-bit deltas, or a raw pixel.  Each row is decoded alone
// (ThunderDecodeRow), the last pixel starting at 0.

bool thunder_row(const uint8_t** bp, int64_t* cc, uint8_t* op,
                 int64_t maxpixels, int64_t* done) {
  static const int kTwo[4] = {0, 1, 0, -1};
  static const int kThree[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  unsigned lastpixel = 0;
  int64_t npixels = 0;
  auto setpixel = [&](unsigned v) {
    lastpixel = v & 0xf;
    if (npixels < maxpixels) {
      if (npixels++ & 1) *op++ |= static_cast<uint8_t>(lastpixel);
      else op[0] = static_cast<uint8_t>(lastpixel << 4);
    }
  };
  while (*cc > 0 && npixels < maxpixels) {
    int n = *(*bp)++, delta;
    --*cc;
    switch (n & 0xc0) {
      case 0x00:                      // a run of the last pixel, n times
        n &= 0x3f;
        if (npixels & 1) {
          op[0] |= static_cast<uint8_t>(lastpixel);
          lastpixel = *op++;
          ++npixels;
          --n;
        } else {
          lastpixel |= lastpixel << 4;
        }
        npixels += n;
        // (a run that ends the row is written too: cv2's libtiff fills it)
        if (npixels <= maxpixels)
          for (; n > 0; n -= 2) *op++ = static_cast<uint8_t>(lastpixel);
        if (n == -1) *--op &= 0xf0;
        lastpixel &= 0xf;
        break;
      case 0x40:                      // three 2-bit deltas, 2 skips
        if ((delta = (n >> 4) & 3) != 2) setpixel(lastpixel + kTwo[delta]);
        if ((delta = (n >> 2) & 3) != 2) setpixel(lastpixel + kTwo[delta]);
        if ((delta = n & 3) != 2) setpixel(lastpixel + kTwo[delta]);
        break;
      case 0x80:                      // two 3-bit deltas, 4 skips
        if ((delta = (n >> 3) & 7) != 4) setpixel(lastpixel + kThree[delta]);
        if ((delta = n & 7) != 4) setpixel(lastpixel + kThree[delta]);
        break;
      default:                        // a raw pixel
        setpixel(static_cast<unsigned>(n));
        break;
    }
  }
  *done = npixels;
  return npixels == maxpixels;
}

// ---------------------------------------------------------------------------
// SGILog (tif_luv.c's LogL16Decode and LogLuvDecode32): each row's values
// as byte planes, most significant first, each plane runs (a byte of 128 +
// n - 2, then the byte n times) and literals (n, then n bytes).

bool sgilog_row(const uint8_t** bp, int64_t* cc, uint32_t* tp,
                int64_t npixels, int nbytes) {
  std::fill(tp, tp + npixels, 0u);
  for (int shft = 8 * (nbytes - 1); shft >= 0; shft -= 8) {
    int64_t i = 0;
    while (i < npixels && *cc > 0) {
      const uint8_t* b = *bp;
      if (b[0] >= 128) {                  // a run
        if (*cc < 2) break;
        int rc = b[0] + (2 - 128);
        const uint32_t v = static_cast<uint32_t>(b[1]) << shft;
        *bp += 2;
        *cc -= 2;
        while (rc-- && i < npixels) tp[i++] |= v;
      } else {                            // literals; a 0 is a no-op
        int rc = *(*bp)++;
        while (--*cc && rc-- && i < npixels)
          tp[i++] |= static_cast<uint32_t>(*(*bp)++) << shft;
      }
    }
    if (i != npixels) return false;
  }
  return true;
}

}  // namespace

extern "C" {

int tiff_lzw(const uint8_t* src, int64_t n, uint8_t* dst, int64_t size,
             char* msg, int msg_len) {
  std::memset(dst, 0, size);
  try {
    lzw(src, n, dst, size);
    return 0;
  } catch (const Error& e) {
    set_msg(msg, msg_len, e.msg);
    return 3;
  }
}

int64_t tiff_fax_runs(int width, int kind, int options) {
  return 2 * static_cast<int64_t>(fax_nruns(width, kind, options)) + 2;
}

int tiff_fax(const uint8_t* src, int64_t n, uint8_t* dst, int64_t rows,
             int width, int kind, int options, int fill_order, int* noeol,
             uint32_t* runs, char* msg, int msg_len) {
  std::memset(dst, 0, static_cast<size_t>(rows) * ((width + 7) / 8));
  bool mode = *noeol != 0;
  const int ok = fax_decode(src, n, dst, rows, width, kind, options,
                            fill_order, &mode, runs);
  *noeol = mode;
  if (ok) return 0;
  set_msg(msg, msg_len, "CCITT data end or fail before the strip is full");
  return 3;
}

int tiff_thunder(const uint8_t* src, int64_t n, uint8_t* dst, int64_t rows,
                 int width, char* msg, int msg_len) {
  const int64_t rowbytes = (width + 1) / 2;
  std::memset(dst, 0, rows * rowbytes);
  // a run's whole bytes may pass the row's end: a row of slack
  std::vector<uint8_t> row(static_cast<size_t>(rowbytes) + 64);
  for (int64_t r = 0; r < rows; ++r) {
    std::fill(row.begin(), row.end(), 0);
    int64_t done = 0;
    const bool ok = thunder_row(&src, &n, row.data(), width, &done);
    // of a failed row cv2's libtiff shows its whole bytes: the pixels
    // decoded, an odd last one dropped
    std::memcpy(dst + r * rowbytes, row.data(),
                ok ? rowbytes : std::min<int64_t>(done, width) / 2);
    if (!ok) {
      set_msg(msg, msg_len, "ThunderScan data end or overrun a row");
      return 3;
    }
  }
  return 0;
}

int tiff_sgilog(const uint8_t* src, int64_t n, uint32_t* dst, int64_t rows,
                int width, int nbytes, char* msg, int msg_len) {
  std::memset(dst, 0, static_cast<size_t>(rows) * width * sizeof(uint32_t));
  for (int64_t r = 0; r < rows; ++r) {
    // a failed row stays zero, as the codec converts a row only when whole
    std::vector<uint32_t> row(width);
    if (!sgilog_row(&src, &n, row.data(), width, nbytes)) {
      set_msg(msg, msg_len, "SGILog data end before the strip is full");
      return 3;
    }
    std::memcpy(dst + r * width, row.data(), width * sizeof(uint32_t));
  }
  return 0;
}

int tiff_packbits(const uint8_t* src, int64_t n, uint8_t* dst, int64_t size,
                  char* msg, int msg_len) {
  std::memset(dst, 0, size);
  try {
    packbits(src, n, dst, size);
    return 0;
  } catch (const Error& e) {
    set_msg(msg, msg_len, e.msg);
    return 3;
  }
}

}  // extern "C"
