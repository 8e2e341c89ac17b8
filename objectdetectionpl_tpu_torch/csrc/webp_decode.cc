// WebP decoder (RFC 9649), host C++17: the two bitstreams inside a WebP
// file, decoded as libwebp decodes them for cv2.imread (its
// WebPDecodeBGRInto: no dithering, "fancy" chroma upsampling).  The RIFF
// container, VP8X and animation are parsed in data/formats.py.
//
// VP8 (lossy, RFC 6386 key frames): the boolean decoder as libwebp's
// bit_reader runs it; the frame header with up to 4 segments (quantiser
// and filter level, absolute or relative) and the segment map, the loop
// filter header with mode/ref deltas, 1/2/4/8 token partitions (one per
// macroblock row in turn), the quantiser deltas, the token probability
// updates and the skip probability; per macroblock the intra modes (16x16
// or sixteen 4x4, chroma 8x8) and the residual tokens with their
// contexts; dequantisation (the Y2 DC x2, the Y2 AC x155/100 and at least
// 8), the inverse WHT and DCT; prediction on libwebp's edge samples (127
// above the frame, 129 left of it, the top-right samples of the rightmost
// sub-blocks taken from the macroblock row above); the simple or normal
// loop filter over the whole frame in macroblock order, with sharpness,
// per-segment levels, deltas, high edge variance, and the inner edges of
// a macroblock with no coefficients and no 4x4 prediction skipped; then
// the "fancy" upsampler (9-3-3-1) and libwebp's fixed-point YUV -> RGB,
// cropped to the picture.  Data that end before the last macroblock fail,
// as libwebp fails them.
//
// VP8L (lossless): the prefix codes (the 1-2 symbol simple code, or code
// lengths coded with the repeat codes 16/17/18), the meta prefix-code
// image, the colour cache, LZ77 with the 120 short distance codes; the
// predictor (14 modes), cross-colour, subtract-green and colour-indexing
// (bundled 1/2/4-bit indices) transforms undone in reverse order; alpha
// dropped.  The same code reads an ALPH chunk's lossless stream (no
// header) so that a bad one fails the file as it fails libwebp.
//
// C interface:
//   webp_vp8(data, size, w, h, rgb, msg, msg_len)
//   webp_vp8l(data, size, headerless, w, h, rgb, msg, msg_len)
// write w * h * 3 bytes of RGB (rgb may be null for an ALPH stream) and
// return 0, or 3 with the reason in msg.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

// ---------------------------------------------------------------------------
// Tables (the VP8 ones from RFC 6386, the order of libwebp's tree_dec.c)

// RFC 6386 section 13.5: default token probabilities [type][band][ctx][node]
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

// RFC 6386 section 13.4: token probability update probabilities
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

// RFC 6386 section 11.5: key-frame sub-block mode probabilities
// [above][left][node], modes in this file's order (kB*)
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

// RFC 6386 section 14.1: dequantisation factors by index
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// WebP lossless: the 120 short distance codes as (dy << 4) | (8 - dx)
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// sub-block modes in libwebp's order (the 16x16 and chroma modes are
// DC, TM, V and H of these)
enum { kBDc = 0, kBTm, kBVe, kBHe, kBRd, kBVr, kBLd, kBVl, kBHd, kBHu };
constexpr int kDcNoTop = 10, kDcNoLeft = 11, kDcNoTopLeft = 12;  // DC at
                                                                 // edges

// ---------------------------------------------------------------------------
// VP8's boolean decoder, as libwebp's VP8GetBit runs it: range_ holds the
// range minus 1, value_ the bits read, bits_ those below the 8-bit window.
// A byte wanted past the end reads as 0 once and sets eof, which fails
// the frame at the end of the macroblock (or of the row's modes).

class BoolReader {
 public:
  void init(const uint8_t* p, size_t n) {
    p_ = p;
    end_ = p + n;
    value_ = 0;
    bits_ = -8;
    range_ = 255 - 1;
    eof_ = false;
    load();
  }
  bool eof() const { return eof_; }

  int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    int b;
    if (value > split) {
      range -= split;
      value_ -= static_cast<uint64_t>(split + 1) << pos;
      b = 1;
    } else {
      range = split + 1;
      b = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return b;
  }
  int value(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value(n);
    return value(1) ? -v : v;
  }

 private:
  void load() {
    if (p_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *p_++;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }

  const uint8_t* p_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  int bits_ = 0;
  uint32_t range_ = 0;
  bool eof_ = false;
};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

// ---------------------------------------------------------------------------
// VP8 transforms and predictors (libwebp's dsp/dec.c)

constexpr int BPS = 32;                 // the work buffer's row stride

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  int* t = tmp;
  for (int i = 0; i < 4; ++i, ++in, t += 4) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    t[0] = a + d;
    t[1] = b + c;
    t[2] = b - c;
    t[3] = a - d;
  }
  t = tmp;
  for (int i = 0; i < 4; ++i, ++t, dst += BPS) {
    const int dc = t[0] + 4;
    const int a = dc + t[8];
    const int b = dc - t[8];
    const int c = mul2(t[4]) - mul1(t[12]);
    const int d = mul1(t[4]) + mul2(t[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

// libwebp's SSE2 transform (dec_sse2.c), which cv2's x86 build runs for
// blocks with coefficients past the third: the arithmetic of transform()
// in 16-bit lanes, each sum wrapping, the multiplications as
// _mm_mulhi_epi16 by 20091 and 35468 - 65536, the residual added in 16
// bits and saturated to 8.  Equal to transform() unless a damaged file's
// coefficients overflow 16 bits.
inline int16_t w16(int v) { return static_cast<int16_t>(v); }
inline int16_t mulhi(int16_t a, int k) { return w16((a * k) >> 16); }

void transform_lanes(const int16_t* x0, const int16_t* x1, const int16_t* x2,
                     const int16_t* x3, int16_t* o0, int16_t* o1, int16_t* o2,
                     int16_t* o3, int bias, int shift) {
  for (int j = 0; j < 4; ++j) {
    const int16_t dc = w16(x0[j] + bias);
    const int16_t a = w16(dc + x2[j]), b = w16(dc - x2[j]);
    const int16_t c = w16(w16(x1[j] - x3[j]) +
                          w16(mulhi(x1[j], -30068) - mulhi(x3[j], 20091)));
    const int16_t d = w16(w16(x1[j] + x3[j]) +
                          w16(mulhi(x1[j], 20091) + mulhi(x3[j], -30068)));
    o0[j] = w16(w16(a + d) >> shift);
    o1[j] = w16(w16(b + c) >> shift);
    o2[j] = w16(w16(b - c) >> shift);
    o3[j] = w16(w16(a - d) >> shift);
  }
}

void transform_sse2(const int16_t* in, uint8_t* dst) {
  int16_t t[4][4], u[4][4], v[4][4], o[4][4];
  transform_lanes(in, in + 4, in + 8, in + 12, t[0], t[1], t[2], t[3], 0, 0);
  for (int r = 0; r < 4; ++r)
    for (int m = 0; m < 4; ++m) u[m][r] = t[r][m];
  transform_lanes(u[0], u[1], u[2], u[3], v[0], v[1], v[2], v[3], 4, 3);
  for (int r = 0; r < 4; ++r)
    for (int m = 0; m < 4; ++m) o[m][r] = v[r][m];
  for (int y = 0; y < 4; ++y, dst += BPS)
    for (int x = 0; x < 4; ++x) dst[x] = clip8(w16(dst[x] + o[y][x]));
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
  }
}

inline uint8_t avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline uint8_t avg2(int a, int b) { return (a + b + 1) >> 1; }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

// 16x16 (size 16) and chroma (size 8) prediction; mode is a kB* of DC,
// TM, VE, HE or a kDc* edge case
void predict_block(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 5 : 4;
  int dc = 0;
  switch (mode) {
    case kBDc:
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      return fill(dst, size, (dc + size) >> shift);
    case kDcNoTop:
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      return fill(dst, size, (dc + size / 2) >> (shift - 1));
    case kDcNoLeft:
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      return fill(dst, size, (dc + size / 2) >> (shift - 1));
    case kDcNoTopLeft:
      return fill(dst, size, 0x80);
    case kBTm:
      return true_motion(dst, size);
    case kBVe:
      for (int j = 0; j < size; ++j)
        std::memcpy(dst + j * BPS, dst - BPS, size);
      return;
    default:   // kBHe
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      return;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3],
            E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS];
  switch (mode) {
    case kBDc: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, dc >> 3, 4);
      break;
    }
    case kBTm:
      true_motion(dst, 4);
      break;
    case kBVe: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case kBHe: {
      const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                            avg3(K, L, L)};
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, v[i], 4);
      break;
    }
    case kBRd:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case kBLd:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case kBVr:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case kBVl:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case kBHd:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:   // kBHu
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}

#undef DST

// ---------------------------------------------------------------------------
// The loop filters (RFC 6386 section 15, libwebp's dsp/dec.c)

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// `step` across the edge, `next` along it, n samples
void simple_filter(uint8_t* p, int step, int next, int n, int thresh) {
  const int t = 2 * thresh + 1;
  for (int i = 0; i < n; ++i, p += next)
    if (needs_filter(p, step, t)) filter2(p, step);
}

void normal_filter(uint8_t* p, int step, int next, int n, int thresh,
                   int ithresh, int hev_t, bool edge) {
  const int t = 2 * thresh + 1;
  for (int i = 0; i < n; ++i, p += next) {
    if (!needs_filter2(p, step, t, ithresh)) continue;
    if (hev(p, step, hev_t))
      filter2(p, step);
    else if (edge)
      filter6(p, step);
    else
      filter4(p, step);
  }
}

// ---------------------------------------------------------------------------
// The VP8 frame

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t uvmode = 0, segment = 0;
  bool i4x4 = false, skip = false;
  uint32_t nz_y = 0, nz_uv = 0;
};

struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev = 0;
};

class VP8 {
 public:
  VP8(const uint8_t* data, size_t size) : d_(data), n_(size) {}

  void decode(int want_w, int want_h, uint8_t* rgb) {
    headers();
    if (width_ != want_w || height_ != want_h)
      fail("the VP8 frame is " + std::to_string(width_) + "x" +
           std::to_string(height_) + ", not the container's " +
           std::to_string(want_w) + "x" + std::to_string(want_h));
    frame();
    output(rgb);
  }

 private:
  void headers() {
    if (n_ < 10) fail("a VP8 frame of " + std::to_string(n_) + " bytes");
    const uint32_t bits = d_[0] | d_[1] << 8 | d_[2] << 16;
    if (bits & 1) fail("not a VP8 key frame");
    if (((bits >> 1) & 7) > 3) fail("a VP8 profile above 3");
    if (!((bits >> 4) & 1)) fail("a VP8 frame that is not shown");
    const uint32_t part0 = bits >> 5;
    if (d_[3] != 0x9d || d_[4] != 0x01 || d_[5] != 0x2a)
      fail("bad VP8 start code");
    width_ = (d_[7] << 8 | d_[6]) & 0x3fff;
    height_ = (d_[9] << 8 | d_[8]) & 0x3fff;
    if (!width_ || !height_) fail("a VP8 frame of size 0");
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    const uint8_t* buf = d_ + 10;
    size_t left = n_ - 10;
    if (part0 > left) fail("bad VP8 partition length");
    BoolReader& br = br_;
    br.init(buf, part0);
    buf += part0;
    left -= part0;
    br.value(1);                          // colour space
    br.value(1);                          // clamping type
    // segment header
    use_segment_ = br.value(1);
    if (use_segment_) {
      update_map_ = br.value(1);
      if (br.value(1)) {                  // update data
        absolute_delta_ = br.value(1);
        for (int s = 0; s < 4; ++s)
          quantizer_[s] = br.value(1) ? br.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength_[s] = br.value(1) ? br.signed_value(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s)
          segment_proba_[s] = br.value(1) ? br.value(8) : 255;
    }
    if (br.eof()) fail("cannot parse the VP8 segment header");
    // filter header
    simple_ = br.value(1);
    level_ = br.value(6);
    sharpness_ = br.value(3);
    use_lf_delta_ = br.value(1);
    if (use_lf_delta_ && br.value(1)) {
      for (int i = 0; i < 4; ++i)
        if (br.value(1)) ref_lf_delta_[i] = br.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.value(1)) mode_lf_delta_[i] = br.signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br.eof()) fail("cannot parse the VP8 filter header");
    // token partitions
    const int last = (1 << br.value(2)) - 1;
    num_parts_minus_one_ = last;
    if (left < static_cast<size_t>(3 * last))
      fail("cannot parse the VP8 partitions");
    const uint8_t* sizes = buf;
    const uint8_t* part = buf + 3 * last;
    const uint8_t* end = buf + left;
    size_t size_left = left - 3 * last;
    for (int p = 0; p < last; ++p) {
      size_t psize = sizes[0] | sizes[1] << 8 | sizes[2] << 16;
      if (psize > size_left) psize = size_left;
      parts_[p].init(part, psize);
      part += psize;
      size_left -= psize;
      sizes += 3;
    }
    parts_[last].init(part, size_left);
    if (part >= end) fail("the VP8 data end before the last partition");
    // quantisers
    const int base_q0 = br.value(7);
    const int dqy1_dc = br.value(1) ? br.signed_value(4) : 0;
    const int dqy2_dc = br.value(1) ? br.signed_value(4) : 0;
    const int dqy2_ac = br.value(1) ? br.signed_value(4) : 0;
    const int dquv_dc = br.value(1) ? br.signed_value(4) : 0;
    const int dquv_ac = br.value(1) ? br.signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int s = 0; s < 4; ++s) {
      int q;
      if (use_segment_) {
        q = quantizer_[s];
        if (!absolute_delta_) q += base_q0;
      } else if (s > 0) {
        std::memcpy(dqm_[s], dqm_[0], sizeof(dqm_[0]));
        continue;
      } else {
        q = base_q0;
      }
      int* m = dqm_[s];
      m[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m[1] = kAcTable[clip(q, 127)];
      m[2] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m[3] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m[3] < 8) m[3] = 8;
      m[4] = kDcTable[clip(q + dquv_dc, 117)];
      m[5] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br.value(1);                          // refresh entropy probs: ignored
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = br.bit(kCoeffsUpdateProba[t][b][c][p])
                                     ? br.value(8)
                                     : kCoeffsProba0[t][b][c][p];
    use_skip_proba_ = br.value(1);
    if (use_skip_proba_) skip_p_ = br.value(8);
    filter_strengths();
  }

  void filter_strengths() {
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (use_segment_) {
        base = filter_strength_[s];
        if (!absolute_delta_) base += level_;
      }
      for (int i4 = 0; i4 <= 1; ++i4) {
        FInfo& f = fstrengths_[s][i4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          f.ilevel = static_cast<uint8_t>(ilevel);
          f.limit = static_cast<uint8_t>(2 * level + ilevel);
          f.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
        }
        f.inner = static_cast<uint8_t>(i4);
      }
    }
  }

  void parse_modes(MBData* row) {
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      MBData& b = row[mb_x];
      uint8_t* top = intra_t_.data() + 4 * mb_x;
      uint8_t* left = intra_l_;
      BoolReader& br = br_;
      if (update_map_)
        b.segment = !br.bit(segment_proba_[0])
                        ? br.bit(segment_proba_[1])
                        : br.bit(segment_proba_[2]) + 2;
      else
        b.segment = 0;
      b.skip = use_skip_proba_ ? br.bit(skip_p_) : false;
      b.i4x4 = !br.bit(145);
      if (!b.i4x4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? kBTm : kBHe)
                                      : (br.bit(163) ? kBVe : kBDc);
        b.imodes[0] = static_cast<uint8_t>(ymode);
        std::memset(top, ymode, 4);
        std::memset(left, ymode, 4);
      } else {
        uint8_t* modes = b.imodes;
        for (int y = 0; y < 4; ++y) {
          int ymode = left[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba[top[x]][ymode];
            ymode = !br.bit(prob[0])   ? kBDc
                    : !br.bit(prob[1]) ? kBTm
                    : !br.bit(prob[2]) ? kBVe
                    : !br.bit(prob[3])
                        ? (!br.bit(prob[4]) ? kBHe
                                            : (!br.bit(prob[5]) ? kBRd : kBVr))
                        : (!br.bit(prob[6])
                               ? kBLd
                               : (!br.bit(prob[7])
                                      ? kBVl
                                      : (!br.bit(prob[8]) ? kBHd : kBHu)));
            top[x] = static_cast<uint8_t>(ymode);
          }
          std::memcpy(modes, top, 4);
          modes += 4;
          left[y] = static_cast<uint8_t>(ymode);
        }
      }
      b.uvmode = !br.bit(142)   ? kBDc
                 : !br.bit(114) ? kBVe
                 : br.bit(183)  ? kBTm
                                : kBHe;
    }
    if (br_.eof()) fail("the VP8 data end inside the first partition");
  }

  // GetCoeffs: the tokens of one block from position n, dequantised by
  // dq[0] (DC) and dq[1] (AC); returns the position after the last
  // non-zero one (0 for none)
  int get_coeffs(BoolReader* br, int type, int ctx, const int* dq, int n,
                 int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br->bit(p[0])) return n;
      while (!br->bit(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      const int band = kBands[n + 1];
      if (!br->bit(p[2])) {
        v = 1;
        p = proba_[type][band][1];
      } else {
        if (!br->bit(p[3])) {
          v = !br->bit(p[4]) ? 2 : 3 + br->bit(p[5]);
        } else if (!br->bit(p[6])) {
          if (!br->bit(p[7])) {
            v = 5 + br->bit(159);
          } else {
            v = 7 + 2 * br->bit(165);
            v += br->bit(145);
          }
        } else {
          const int bit1 = br->bit(p[8]);
          const int bit0 = br->bit(p[9 + bit1]);
          const int cat = 2 * bit1 + bit0;
          v = 0;
          for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
            v += v + br->bit(*tab);
          v += 3 + (8 << cat);
        }
        p = proba_[type][band][2];
      }
      const int s = br->bit(0x80) ? -v : v;
      out[kZigzag[n]] = static_cast<int16_t>(s * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code(uint32_t codes, int nz, int dc_nz) {
    return (codes << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
  }

  // ParseResiduals; returns true when the macroblock has no coefficients
  bool residuals(MBData* b, int mb_x, BoolReader* br) {
    const int* q = dqm_[b->segment];
    int16_t* dst = b->coeffs;
    std::memset(dst, 0, sizeof(b->coeffs));
    uint8_t& mb_nz = nz_[mb_x];
    uint8_t& mb_nz_dc = nz_dc_[mb_x];
    int first, ac_type;
    if (!b->i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb_nz_dc + left_nz_dc_;
      const int y2dq[2] = {q[2], q[3]};
      const int nz = get_coeffs(br, 1, ctx, y2dq, 0, dc);
      mb_nz_dc = left_nz_dc_ = nz > 0;
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    const int ydq[2] = {q[0], q[1]};
    uint32_t tnz = mb_nz & 0x0f;
    uint32_t lnz = left_nz_ & 0x0f;
    uint32_t nz_y = 0, nz_uv = 0;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t codes = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, ac_type, ctx, ydq, first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | (l << 7);
        codes = nz_code(codes, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
      nz_y = (nz_y << 8) | codes;
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    const int uvdq[2] = {q[4], q[5]};
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t codes = 0;
      tnz = mb_nz >> (4 + ch);
      lnz = left_nz_ >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(br, 2, ctx, uvdq, 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | (l << 3);
          codes = nz_code(codes, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      nz_uv |= codes << (4 * ch);
      out_t |= (tnz << 4) << ch;
      out_l |= (lnz & 0xf0) << ch;
    }
    mb_nz = static_cast<uint8_t>(out_t);
    left_nz_ = static_cast<uint8_t>(out_l);
    b->nz_y = nz_y;
    b->nz_uv = nz_uv;
    return !(nz_y | nz_uv);
  }

  // libwebp's DoTransform: by the block's code (its last non-zero
  // coefficient), the SSE2 transform past the third, the C ones (DC only,
  // or DC and the first two AC: transform()'s arithmetic) below
  static void add_residual(uint32_t code, const int16_t* in, uint8_t* dst) {
    if (code == 3)
      transform_sse2(in, dst);
    else if (code)
      transform(in, dst);
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode != kBDc) return mode;
    if (mb_x == 0) return mb_y == 0 ? kDcNoTopLeft : kDcNoLeft;
    return mb_y == 0 ? kDcNoTop : kBDc;
  }

  // libwebp's ReconstructRow: each macroblock predicted in a work buffer
  // whose edges hold its neighbours' unfiltered samples, its residuals
  // added, and copied to the frame's planes
  void reconstruct_row(const MBData* row, int mb_y) {
    uint8_t* const y_dst = work_ + BPS + 8;
    uint8_t* const u_dst = y_dst + BPS * 16 + BPS;
    uint8_t* const v_dst = u_dst + 16;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      const MBData& b = row[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j)
          std::memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
          std::memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
        }
      }
      uint8_t* top_y = top_y_.data() + 16 * mb_x;
      uint8_t* top_u = top_u_.data() + 8 * mb_x;
      uint8_t* top_v = top_v_.data() + 8 * mb_x;
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, top_y, 16);
        std::memcpy(u_dst - BPS, top_u, 8);
        std::memcpy(v_dst - BPS, top_v, 8);
      }
      uint32_t bits = b.nz_y;
      if (b.i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w_ - 1)
            std::memset(top_right, top_y[15], 4);
          else
            std::memcpy(top_right, top_y + 16, 4);
        }
        for (int r = 1; r <= 3; ++r)
          std::memcpy(top_right + 4 * r * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, b.imodes[n]);
          add_residual(bits >> 30, b.coeffs + n * 16, dst);
        }
      } else {
        predict_block(y_dst, 16, check_mode(mb_x, mb_y, b.imodes[0]));
        for (int n = 0; n < 16; ++n, bits <<= 2)
          add_residual(bits >> 30, b.coeffs + n * 16,
                       y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      const int uvmode = check_mode(mb_x, mb_y, b.uvmode);
      predict_block(u_dst, 8, uvmode);
      predict_block(v_dst, 8, uvmode);
      for (int c = 0; c < 2; ++c) {
        const uint32_t uv_bits = b.nz_uv >> (8 * c);
        if (!(uv_bits & 0xff)) continue;
        uint8_t* dst = c ? v_dst : u_dst;
        const int16_t* in = b.coeffs + 256 + 64 * c;
        // libwebp's DoUVTransform: every block through the SSE2 transform
        // when one has AC coefficients, else the DC-only ones alone
        for (int k = 0; k < 4; ++k) {
          uint8_t* d = dst + (k & 1) * 4 + (k >> 1) * 4 * BPS;
          if (uv_bits & 0xaa)
            transform_sse2(in + 16 * k, d);
          else if (in[16 * k])
            transform(in + 16 * k, d);
        }
      }
      if (mb_y < mb_h_ - 1) {
        std::memcpy(top_y, y_dst + 15 * BPS, 16);
        std::memcpy(top_u, u_dst + 7 * BPS, 8);
        std::memcpy(top_v, v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(Y_.data() + static_cast<size_t>(mb_y * 16 + j) * ys_ + mb_x * 16,
                    y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(U_.data() + static_cast<size_t>(mb_y * 8 + j) * uvs_ + mb_x * 8,
                    u_dst + j * BPS, 8);
        std::memcpy(V_.data() + static_cast<size_t>(mb_y * 8 + j) * uvs_ + mb_x * 8,
                    v_dst + j * BPS, 8);
      }
    }
  }

  void frame() {
    ys_ = mb_w_ * 16;
    uvs_ = mb_w_ * 8;
    Y_.assign(static_cast<size_t>(ys_) * mb_h_ * 16, 0);
    U_.assign(static_cast<size_t>(uvs_) * mb_h_ * 8, 0);
    V_.assign(U_.size(), 0);
    top_y_.assign(static_cast<size_t>(mb_w_) * 16 + 4, 0);
    top_u_.assign(static_cast<size_t>(mb_w_) * 8, 0);
    top_v_.assign(static_cast<size_t>(mb_w_) * 8, 0);
    intra_t_.assign(static_cast<size_t>(mb_w_) * 4, kBDc);
    nz_.assign(mb_w_, 0);
    nz_dc_.assign(mb_w_, 0);
    finfo_.assign(static_cast<size_t>(mb_w_) * mb_h_, FInfo());
    std::vector<MBData> row(mb_w_);
    std::memset(work_, 0, sizeof(work_));
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      BoolReader* tokens = &parts_[mb_y & num_parts_minus_one_];
      std::memset(intra_l_, kBDc, sizeof(intra_l_));
      left_nz_ = left_nz_dc_ = 0;
      parse_modes(row.data());
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        MBData& b = row[mb_x];
        bool skip = use_skip_proba_ ? b.skip : false;
        if (!skip) {
          skip = residuals(&b, mb_x, tokens);
        } else {
          left_nz_ = nz_[mb_x] = 0;
          if (!b.i4x4) left_nz_dc_ = nz_dc_[mb_x] = 0;
          b.nz_y = b.nz_uv = 0;
        }
        if (filter_type_ > 0) {
          FInfo f = fstrengths_[b.segment][b.i4x4];
          f.inner |= !skip;
          finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x] = f;
        }
        if (tokens->eof()) fail("the VP8 data end before the last macroblock");
      }
      reconstruct_row(row.data(), mb_y);
    }
    if (filter_type_ > 0)
      for (int mb_y = 0; mb_y < mb_h_; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x) loop_filter(mb_x, mb_y);
  }

  void loop_filter(int mb_x, int mb_y) {
    const FInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* y = Y_.data() + static_cast<size_t>(mb_y) * 16 * ys_ + mb_x * 16;
    const int s = ys_;
    if (filter_type_ == 1) {
      if (mb_x > 0) simple_filter(y, 1, s, 16, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k, 1, s, 16, limit);
      if (mb_y > 0) simple_filter(y, s, 1, 16, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k)
          simple_filter(y + 4 * k * s, s, 1, 16, limit);
      return;
    }
    const int us = uvs_, il = f.ilevel, hv = f.hev;
    uint8_t* u = U_.data() + static_cast<size_t>(mb_y) * 8 * us + mb_x * 8;
    uint8_t* v = V_.data() + static_cast<size_t>(mb_y) * 8 * us + mb_x * 8;
    if (mb_x > 0) {
      normal_filter(y, 1, s, 16, limit + 4, il, hv, true);
      normal_filter(u, 1, us, 8, limit + 4, il, hv, true);
      normal_filter(v, 1, us, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k)
        normal_filter(y + 4 * k, 1, s, 16, limit, il, hv, false);
      normal_filter(u + 4, 1, us, 8, limit, il, hv, false);
      normal_filter(v + 4, 1, us, 8, limit, il, hv, false);
    }
    if (mb_y > 0) {
      normal_filter(y, s, 1, 16, limit + 4, il, hv, true);
      normal_filter(u, us, 1, 8, limit + 4, il, hv, true);
      normal_filter(v, us, 1, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k)
        normal_filter(y + 4 * k * s, s, 1, 16, limit, il, hv, false);
      normal_filter(u + 4 * us, us, 1, 8, limit, il, hv, false);
      normal_filter(v + 4 * us, us, 1, 8, limit, il, hv, false);
    }
  }

  // libwebp's yuv.h: MultHi and the clip after >> 6
  static uint8_t yuv_clip(int v) {
    return (v & ~16383) == 0 ? static_cast<uint8_t>(v >> 6) : v < 0 ? 0 : 255;
  }
  static int mult_hi(int v, int c) { return (v * c) >> 8; }

  // The "fancy" upsampler (dsp/upsampling.c) and the conversion to RGB,
  // one output row from its luma row and its nearer and farther chroma
  // rows
  void output(uint8_t* rgb) const {
    const int W = width_, H = height_, uvh = (H + 1) / 2;
    const int pairs = (W - 1) >> 1;
    std::vector<int> cu(W), cv(W);
    for (int r = 0; r < H; ++r) {
      const int near = r >> 1;
      const int far = r & 1 ? std::min(near + 1, uvh - 1) : std::max(near - 1, 0);
      for (int c = 0; c < 2; ++c) {
        const uint8_t* N = (c ? V_ : U_).data() + static_cast<size_t>(near) * uvs_;
        const uint8_t* F = (c ? V_ : U_).data() + static_cast<size_t>(far) * uvs_;
        int* o = c ? cv.data() : cu.data();
        o[0] = (3 * N[0] + F[0] + 2) >> 2;
        for (int x = 1; x <= pairs; ++x) {
          const int tl = N[x - 1], t = N[x], l = F[x - 1], u = F[x];
          const int avg = tl + t + l + u + 8;
          const int d12 = (avg + 2 * (t + l)) >> 3;
          const int d03 = (avg + 2 * (tl + u)) >> 3;
          o[2 * x - 1] = (d12 + tl) >> 1;
          o[2 * x] = (d03 + t) >> 1;
        }
        if (!(W & 1)) o[W - 1] = (3 * N[pairs] + F[pairs] + 2) >> 2;
      }
      const uint8_t* y = Y_.data() + static_cast<size_t>(r) * ys_;
      uint8_t* out = rgb + static_cast<size_t>(r) * W * 3;
      for (int x = 0; x < W; ++x) {
        const int yy = mult_hi(y[x], 19077);
        out[3 * x] = yuv_clip(yy + mult_hi(cv[x], 26149) - 14234);
        out[3 * x + 1] =
            yuv_clip(yy - mult_hi(cu[x], 6419) - mult_hi(cv[x], 13320) + 8708);
        out[3 * x + 2] = yuv_clip(yy + mult_hi(cu[x], 33050) - 17685);
      }
    }
  }

  const uint8_t* d_;
  size_t n_;
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  BoolReader br_, parts_[8];
  int num_parts_minus_one_ = 0;
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = false;
  int quantizer_[4] = {0, 0, 0, 0}, filter_strength_[4] = {0, 0, 0, 0};
  int segment_proba_[3] = {255, 255, 255};
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
  int dqm_[4][6];                 // y1 dc/ac, y2 dc/ac, uv dc/ac
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  FInfo fstrengths_[4][2];
  std::vector<uint8_t> intra_t_, nz_, nz_dc_;
  uint8_t intra_l_[4];
  uint8_t left_nz_ = 0, left_nz_dc_ = 0;
  std::vector<uint8_t> Y_, U_, V_, top_y_, top_u_, top_v_;
  int ys_ = 0, uvs_ = 0;
  std::vector<FInfo> finfo_;
  uint8_t work_[BPS * 17 + BPS * 9];
};

// ---------------------------------------------------------------------------
// VP8L: the bit reader (LSB first).  Reading past the data reads zeros and
// fails the stream, as libwebp's eos does: it allows as many bits as the
// data hold, and 64 for data under 8 bytes.

class LBits {
 public:
  LBits(const uint8_t* p, size_t n)
      : p_(p), n_(n), allowed_(std::max<uint64_t>(8 * static_cast<uint64_t>(n), 64)) {}

  uint32_t read(int nbits) {
    if (nbits == 0) return 0;
    if (nbits > 24) fail("a VP8L read of more than 24 bits");
    const uint32_t v = peek(nbits);
    skip(nbits);
    return v;
  }
  uint32_t peek(int nbits) {
    while (have_ < nbits) {
      const uint64_t byte = pos_ < n_ ? p_[pos_] : 0;
      ++pos_;
      buf_ |= byte << have_;
      have_ += 8;
    }
    return static_cast<uint32_t>(buf_ & ((uint64_t{1} << nbits) - 1));
  }
  void skip(int nbits) {
    buf_ >>= nbits;
    have_ -= nbits;
    used_ += nbits;
    if (used_ > allowed_) fail("the VP8L data end early");
  }

 private:
  const uint8_t* p_;
  size_t n_;
  uint64_t allowed_;
  size_t pos_ = 0;
  uint64_t buf_ = 0;
  int have_ = 0;
  uint64_t used_ = 0;
};

// A canonical prefix code, read as libwebp's VP8LBuildHuffmanTable builds
// it: the code lengths must fill the code space exactly, but for a single
// symbol, which takes no bits.
class PrefixCode {
 public:
  // false: an invalid code
  bool build(const int* lengths, int n) {
    int count[16] = {0};
    int used = 0, single = -1;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      ++count[lengths[s]];
      if (lengths[s]) {
        ++used;
        single = s;
      }
    }
    if (used == 0) return false;
    for (int l = 1; l < 15; ++l)
      if (count[l] > (1 << l)) return false;
    symbols_.clear();
    if (used == 1) {
      single_ = single;
      return true;
    }
    single_ = -1;
    int64_t left = 1;
    for (int l = 1; l <= 15; ++l) {
      left = (left << 1) - count[l];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    std::copy(count, count + 16, count_);
    int offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + count[l];
    symbols_.assign(used, 0);
    for (int s = 0; s < n; ++s)
      if (lengths[s]) symbols_[offs[lengths[s]]++] = s;
    // the first kRoot bits (the code's first bit is the lowest) -> length
    // << 12 | symbol, 0 when the code is longer
    std::fill(root_, root_ + (1 << kRoot), 0);
    int code = 0, k = 0;
    for (int l = 1; l <= kRoot; ++l) {
      for (int i = 0; i < count[l]; ++i, ++k, ++code) {
        int rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (int r = rev; r < (1 << kRoot); r += 1 << l)
          root_[r] = static_cast<uint16_t>(l << 12 | symbols_[k]);
      }
      code <<= 1;
    }
    return true;
  }

  int read(LBits* br) const {
    if (single_ >= 0) return single_;
    const uint32_t look = br->peek(15);
    const int e = root_[look & ((1 << kRoot) - 1)];
    if (e) {
      br->skip(e >> 12);
      return e & 0xFFF;
    }
    // canonical decoding, one bit at a time past the root
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= 15; ++l) {
      code |= (look >> (l - 1)) & 1;
      const int c = count_[l];
      if (code - c < first) {
        br->skip(l);
        return symbols_[index + (code - first)];
      }
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    fail("a bad VP8L prefix code");
  }

 private:
  static constexpr int kRoot = 8;
  int single_ = -1;
  int count_[16] = {0};
  std::vector<int> symbols_;
  uint16_t root_[1 << kRoot];
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                  7, 8, 9, 10, 11, 12, 13, 14, 15};

struct Transform {
  int type, bits, xsize;            // xsize: the width it is applied at
  std::vector<uint32_t> data;
};

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
  auto ch = [](uint32_t v, int s) { return static_cast<int>((v >> s) & 0xff); };
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: {                    // Select(T, L, TL)
      int d = 0;
      for (int s = 0; s < 32; s += 8)
        d += std::abs(ch(L, s) - ch(TL, s)) - std::abs(ch(T, s) - ch(TL, s));
      return d <= 0 ? T : L;
    }
    case 12: {
      uint32_t o = 0;
      for (int s = 0; s < 32; s += 8)
        o |= static_cast<uint32_t>(clip255(ch(L, s) + ch(T, s) - ch(TL, s))) << s;
      return o;
    }
    case 13: {
      const uint32_t a = average2(L, T);
      uint32_t o = 0;
      for (int s = 0; s < 32; s += 8) {
        const int x = ch(a, s), y = ch(TL, s);
        o |= static_cast<uint32_t>(clip255(x + (x - y) / 2)) << s;
      }
      return o;
    }
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp
  }
}

class VP8L {
 public:
  VP8L(const uint8_t* p, size_t n) : br_(p, n) {}

  // The ARGB pixels of a w x h stream (after the 5-byte header when it
  // has one), its transforms undone
  std::vector<uint32_t> decode(int w, int h) {
    std::vector<uint32_t> argb = image_stream(w, h, true);
    for (int i = static_cast<int>(transforms_.size()) - 1; i >= 0; --i)
      argb = inverse(transforms_[i], argb, h);
    return argb;
  }

  void header(int* w, int* h) {
    if (br_.read(8) != 0x2f) fail("no VP8L signature");
    *w = static_cast<int>(br_.read(14)) + 1;
    *h = static_cast<int>(br_.read(14)) + 1;
    br_.read(1);                       // alpha is used
    if (br_.read(3) != 0) fail("a VP8L version other than 0");
  }

 private:
  static int sub_size(int size, int bits) {
    return (size + (1 << bits) - 1) >> bits;
  }

  std::vector<uint32_t> image_stream(int xsize, int ysize, bool level0) {
    if (level0) {
      int seen = 0;
      while (br_.read(1)) {
        Transform t;
        t.type = static_cast<int>(br_.read(2));
        if (seen & (1 << t.type)) fail("a VP8L transform used twice");
        seen |= 1 << t.type;
        t.xsize = xsize;
        t.bits = 0;
        if (t.type == 0 || t.type == 1) {
          t.bits = static_cast<int>(br_.read(3)) + 2;
          t.data = image_stream(sub_size(xsize, t.bits),
                                sub_size(ysize, t.bits), false);
        } else if (t.type == 3) {
          const int num_colors = static_cast<int>(br_.read(8)) + 1;
          t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
          std::vector<uint32_t> pal = image_stream(num_colors, 1, false);
          t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
          for (int i = 0; i < num_colors; ++i)
            t.data[i] = i ? add_pixels(pal[i], t.data[i - 1]) : pal[i];
          xsize = sub_size(xsize, t.bits);
        }
        transforms_.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = static_cast<int>(br_.read(4));
      if (cache_bits < 1 || cache_bits > 11) fail("bad VP8L colour cache bits");
    }
    // the prefix-code groups, and which one each tile uses
    int huff_bits = 0;
    std::vector<uint32_t> meta;
    int num_groups = 1;
    if (level0 && br_.read(1)) {
      huff_bits = static_cast<int>(br_.read(3)) + 2;
      meta = image_stream(sub_size(xsize, huff_bits), sub_size(ysize, huff_bits),
                          false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        num_groups = std::max<int>(num_groups, static_cast<int>(m) + 1);
      }
    }
    const int sizes[5] = {256 + 24 + (cache_bits ? 1 << cache_bits : 0), 256,
                          256, 256, 40};
    std::vector<PrefixCode> codes(static_cast<size_t>(num_groups) * 5);
    for (int g = 0; g < num_groups; ++g)
      for (int j = 0; j < 5; ++j) read_code(sizes[j], &codes[g * 5 + j]);
    return image_data(xsize, ysize, cache_bits, huff_bits, meta, codes);
  }

  void read_code(int alphabet, PrefixCode* code) {
    std::vector<int> lengths(std::max(alphabet, 256), 0);
    if (br_.read(1)) {                  // simple code
      const int num = static_cast<int>(br_.read(1)) + 1;
      const int first_bits = br_.read(1) ? 8 : 1;
      lengths[br_.read(first_bits)] = 1;
      if (num == 2) lengths[br_.read(8)] = 1;
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = static_cast<int>(br_.read(4)) + 4;
      for (int i = 0; i < num_codes; ++i)
        cl_lengths[kCodeLengthOrder[i]] = static_cast<int>(br_.read(3));
      PrefixCode cl;
      if (!cl.build(cl_lengths, 19)) fail("a bad VP8L code-length code");
      int max_symbol = alphabet;
      if (br_.read(1)) {
        const int nbits = 2 + 2 * static_cast<int>(br_.read(3));
        max_symbol = 2 + static_cast<int>(br_.read(nbits));
        if (max_symbol > alphabet) fail("a bad VP8L code length count");
      }
      int prev = 8, symbol = 0;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        const int len = cl.read(&br_);
        if (len < 16) {
          lengths[symbol++] = len;
          if (len) prev = len;
        } else {
          const int slot = len - 16;
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          const int repeat = static_cast<int>(br_.read(kExtra[slot])) + kOffset[slot];
          if (symbol + repeat > alphabet) fail("a bad VP8L code length repeat");
          const int v = slot == 0 ? prev : 0;
          for (int r = 0; r < repeat; ++r) lengths[symbol++] = v;
        }
      }
    }
    if (!code->build(lengths.data(), alphabet)) fail("a bad VP8L prefix code");
  }

  static int copy_value(int symbol, LBits* br) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + static_cast<int>(br->read(extra)) + 1;
  }

  std::vector<uint32_t> image_data(int w, int h, int cache_bits, int huff_bits,
                                   const std::vector<uint32_t>& meta,
                                   const std::vector<PrefixCode>& codes) {
    const size_t total = static_cast<size_t>(w) * h;
    std::vector<uint32_t> px(total);
    std::vector<uint32_t> cache(cache_bits ? size_t{1} << cache_bits : 0);
    const int cache_shift = 32 - cache_bits;
    size_t cached = 0;                  // pixels put into the cache
    auto insert = [&](size_t upto) {
      for (; cached < upto; ++cached)
        cache[(0x1e35a7bdu * px[cached]) >> cache_shift] = px[cached];
    };
    const int tiles_w = huff_bits ? sub_size(w, huff_bits) : 0;
    size_t pos = 0;
    while (pos < total) {
      const int x = static_cast<int>(pos % w), y = static_cast<int>(pos / w);
      const PrefixCode* g = codes.data();
      if (huff_bits)
        g += 5 * meta[static_cast<size_t>(y >> huff_bits) * tiles_w + (x >> huff_bits)];
      const int code = g[0].read(&br_);
      if (code < 256) {
        const uint32_t red = g[1].read(&br_);
        const uint32_t blue = g[2].read(&br_);
        const uint32_t alpha = g[3].read(&br_);
        px[pos++] = alpha << 24 | red << 16 | static_cast<uint32_t>(code) << 8 | blue;
      } else if (code < 256 + 24) {
        const int length = copy_value(code - 256, &br_);
        const int dist_symbol = g[4].read(&br_);
        const int dist_code = copy_value(dist_symbol, &br_);
        int dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          const int c = kCodeToPlane[dist_code - 1];
          dist = (c >> 4) * w + (8 - (c & 0xf));
          if (dist < 1) dist = 1;
        }
        if (pos < static_cast<size_t>(dist) || total - pos < static_cast<size_t>(length))
          fail("a VP8L backward reference outside the image");
        for (int i = 0; i < length; ++i, ++pos) px[pos] = px[pos - dist];
      } else {
        const size_t key = code - 256 - 24;
        if (key >= cache.size()) fail("a bad VP8L colour cache code");
        insert(pos);
        px[pos++] = cache[key];
      }
      if (cache_bits) insert(pos);
    }
    return px;
  }

  std::vector<uint32_t> inverse(const Transform& t, std::vector<uint32_t>& in,
                                int h) {
    const int w = t.xsize;
    switch (t.type) {
      case 2:                           // subtract green
        for (uint32_t& p : in) {
          const uint32_t g = (p >> 8) & 0xff;
          const uint32_t rb = ((p & 0x00ff00ffu) + (g << 16 | g)) & 0x00ff00ffu;
          p = (p & 0xff00ff00u) | rb;
        }
        return std::move(in);
      case 1: {                         // cross colour
        const int tiles_w = sub_size(w, t.bits);
        for (int y = 0; y < h; ++y)
          for (int x = 0; x < w; ++x) {
            const uint32_t m = t.data[static_cast<size_t>(y >> t.bits) * tiles_w + (x >> t.bits)];
            const int8_t g2r = static_cast<int8_t>(m & 0xff);
            const int8_t g2b = static_cast<int8_t>((m >> 8) & 0xff);
            const int8_t r2b = static_cast<int8_t>((m >> 16) & 0xff);
            uint32_t& p = in[static_cast<size_t>(y) * w + x];
            const int8_t green = static_cast<int8_t>(p >> 8);
            int red = (p >> 16) & 0xff, blue = p & 0xff;
            red = (red + ((g2r * green) >> 5)) & 0xff;
            blue += (g2b * green) >> 5;
            blue += (r2b * static_cast<int8_t>(red)) >> 5;
            blue &= 0xff;
            p = (p & 0xff00ff00u) | static_cast<uint32_t>(red) << 16 |
                static_cast<uint32_t>(blue);
          }
        return std::move(in);
      }
      case 0: {                         // predictor
        const int tiles_w = sub_size(w, t.bits);
        for (int y = 0; y < h; ++y)
          for (int x = 0; x < w; ++x) {
            const size_t i = static_cast<size_t>(y) * w + x;
            uint32_t pred;
            if (y == 0)
              pred = x == 0 ? 0xff000000u : in[i - 1];
            else if (x == 0)
              pred = in[i - w];
            else
              pred = predict((t.data[static_cast<size_t>(y >> t.bits) * tiles_w +
                                     (x >> t.bits)] >> 8) & 0xf,
                             in[i - 1], in[i - w], in[i - w + 1], in[i - w - 1]);
            in[i] = add_pixels(in[i], pred);
          }
        return std::move(in);
      }
      default: {                        // colour indexing
        const int packed_w = sub_size(w, t.bits);
        std::vector<uint32_t> out(static_cast<size_t>(w) * h);
        const int per = 1 << t.bits, nbits = 8 >> t.bits, mask = (1 << nbits) - 1;
        for (int y = 0; y < h; ++y)
          for (int x = 0; x < w; ++x) {
            const uint32_t g = (in[static_cast<size_t>(y) * packed_w + x / per] >> 8) & 0xff;
            const int index = (g >> ((x & (per - 1)) * nbits)) & mask;
            out[static_cast<size_t>(y) * w + x] = t.data[index];
          }
        return out;
      }
    }
  }

  LBits br_;
  std::vector<Transform> transforms_;
};

void set_msg(char* msg, int msg_len, const std::string& s) {
  if (msg && msg_len > 0) std::snprintf(msg, msg_len, "%s", s.c_str());
}

}  // namespace

extern "C" {

int webp_vp8(const uint8_t* data, int64_t size, int w, int h, uint8_t* rgb,
             char* msg, int msg_len) {
  try {
    VP8(data, static_cast<size_t>(size)).decode(w, h, rgb);
    return 0;
  } catch (const Error& e) {
    set_msg(msg, msg_len, e.msg);
  } catch (const std::bad_alloc&) {
    set_msg(msg, msg_len, "out of memory");
  }
  return 3;
}

int webp_vp8l(const uint8_t* data, int64_t size, int headerless, int w, int h,
              uint8_t* rgb, char* msg, int msg_len) {
  try {
    VP8L dec(data, static_cast<size_t>(size));
    if (!headerless) {
      int hw, hh;
      dec.header(&hw, &hh);
      if (hw != w || hh != h)
        fail("the VP8L image is " + std::to_string(hw) + "x" +
             std::to_string(hh) + ", not the container's " +
             std::to_string(w) + "x" + std::to_string(h));
    }
    const std::vector<uint32_t> argb = dec.decode(w, h);
    if (rgb)
      for (size_t i = 0; i < argb.size(); ++i) {
        rgb[3 * i] = static_cast<uint8_t>(argb[i] >> 16);
        rgb[3 * i + 1] = static_cast<uint8_t>(argb[i] >> 8);
        rgb[3 * i + 2] = static_cast<uint8_t>(argb[i]);
      }
    return 0;
  } catch (const Error& e) {
    set_msg(msg, msg_len, e.msg);
  } catch (const std::bad_alloc&) {
    set_msg(msg, msg_len, "out of memory");
  }
  return 3;
}

}  // extern "C"
