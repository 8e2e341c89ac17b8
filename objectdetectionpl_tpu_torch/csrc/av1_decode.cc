// The AV1 decoder of the port's AVIF reader (host C++17; data/formats.py
// parses the HEIF boxes around it): every frame of an item's temporal
// units that the asked operating point keeps, decoded by the AV1
// specification's decoding process (with libaom's motion vector stack
// and rounding), to the planes cv2.imread's libavif gets from its libaom:
// the last frame shown, or (lsel) the first shown of one spatial layer.
//
// What it reads: sized OBUs with or without extensions (those outside
// the operating point's idc dropped; the temporal delimiter, padding and
// metadata skipped); the sequence header, full or reduced still
// picture, every profile's colour config, any number of operating
// points; frame headers of every type (key, inter, intra-only, switch,
// a frame shown again from a slot) with frame ids, order hints (a slot
// whose order hint an error-resilient frame does not find filled in with
// grey for a lost frame, in the buffer libaom's buffer pool would give
// it, with that buffer's earlier frame's state), short reference
// signalling, sizes from the references, superres, the
// quantizer, segmentation (updated or from the primary reference),
// delta q / lf, loop filter with reference and mode deltas, CDEF,
// restoration, tx mode, reference select, skip mode, global motion
// parameters, film grain (or a reference's); eight reference slots
// (planes, CDFs saved at the frame's end, loop filter and segmentation
// parameters, order hints, global motion, the motion field, segment
// ids); the symbol decoder with its adaptation; every partition, intra
// mode (directional with angle deltas and the intra edge filter and
// upsampling, smooth, Paeth, CFL, filter intra), segment ids (spatial
// or predicted), skip and skip mode, cdef_idx, delta q / lf, palettes,
// intra block copy; inter blocks: single and compound references,
// NEAREST / NEAR / GLOBAL / NEW modes and their compound pairs, the
// DRL index, vectors at every precision, the projected motion field,
// switchable and dual interpolation filters, OBMC, local warp
// (libaom's sample selection and least squares), global motion (GLOBALMV
// blocks warped by the reference's model), inter-intra (smooth
// and wedge), compound average, distance, wedge and difference-weighted
// masks, the var-tx tree; prediction by the 8-tap filters (4-tap for
// narrow blocks) through scaled references (compound ones too), the
// warp filter, and a 4-sample block's chroma from each covered block;
// tx size and type, the loop restoration units, every coefficient;
// dequantization with or without quantizer matrices; the DCT 4..64, ADST
// 4..16 (flipped too), identity and the lossless WHT; then the stages
// after the tiles: the deblocking filter (inter frames' skip and level
// rules), CDEF, superres (libaom's per-tile-column upscaling), loop
// restoration and, on the output only, film grain synthesis.  Pixels are
// uint16 at the stream's bit depth, 8, 10 or 12.
//
// What it refuses, naming the tool: under an lsel, a frame that reads
// more of a slot filled in for a lost frame than its samples (libavif
// then asks libaom for every layer, whose output frames hold buffers
// longer).
// As libaom (cv2's AV1 decoder) it refuses an unsized OBU, an OBU whose
// trailing bits are missing, a header whose trailing bits are not a 1
// then zeros (or with other than zero bytes after them) or whose
// alignment bits are not zeros, an undefined level, a reduced header
// for a video, a tile whose data do not end where its symbols do, film
// grain scaling points that do not increase, an intra block copy vector
// outside the tile, not yet decoded or within the 256-sample delay, a
// motion vector out of range, references of another format or an
// invalid size, frame ids that do not match the slots, a stream that
// shows no frame.  It never returns part of an image.
//
// C interface (operating_point: a1op's index; layer: lsel's, or -1):
//   av1_probe(data, len, operating_point, layer, info, msg, msg_len)
//     the frame headers alone; info[0..21] = the shown frame's width
//     (upscaled) and height, then the last header's subsampling x, y,
//     monochrome, bit depth, colour range, matrix coefficients, colour
//     primaries, transfer, the restoration type of Y, U, V (0 none, 1
//     Wiener, 2 self-guided, 3 switchable), the superres denominator (8
//     without), the shown frame's apply_grain, the superblock size, the
//     tile columns, the coded width, allow_screen_content_tools,
//     allow_intrabc, the operating points, the frames
//   av1_decode(data, len, operating_point, layer, y, u, v, counts, msg,
//              msg_len)
//     planes of width x height (y) and the subsampled size (u, v; unused
//     for a monochrome stream), row-major; counts[0..AV1_COUNTS) (or
//     null) gets what the stream used (data/native.py's AV1_COUNTS).
// Both return 0, or 1 with the reason in msg.
//   av1_frame_marks(data, len, operating_point, out, max, msg, msg_len)
//     where each frame header lies, for the writers that rewrite one
//     (tools/format_files.py::with_global_motion): the number of headers,
//     or -1 with the reason in msg.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "av1_tables.h"

namespace {

constexpr int AV1_COUNTS = 25;

struct Fail {
  std::string msg;
};

[[noreturn]] void fail(const std::string& m) { throw Fail{m}; }

[[noreturn]] void refuse(const char* tool) {
  fail(std::string("the AV1 stream uses ") + tool +
       ", which the port does not read");
}

void set_msg(char* msg, int msg_len, const std::string& s) {
  if (msg && msg_len > 0) std::snprintf(msg, msg_len, "%s", s.c_str());
}

inline int clip3(int lo, int hi, int x) {
  return x < lo ? lo : (x > hi ? hi : x);
}
inline int round2(int64_t x, int n) {
  return n == 0 ? static_cast<int>(x)
                : static_cast<int>((x + (int64_t(1) << (n - 1))) >> n);
}
inline int floor_log2(uint32_t x) { return x ? 31 - __builtin_clz(x) : 0; }

// ---------------------------------------------------------------------------
// Constants of the specification

enum { KEY_FRAME = 0 };
enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
       D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
       PAETH_PRED, UV_CFL_PRED };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
       PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A,
       PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4 };
enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8,
       BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64,
       BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64,
       BLOCK_128X128, BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8,
       BLOCK_16X64, BLOCK_64X16, BLOCK_INVALID };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4,
       TX_8X16, TX_16X8, TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16,
       TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16 };
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
       FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
       V_ADST, H_ADST, V_FLIPADST, H_FLIPADST };
// the transform sets: intra 1 and 2, inter 1 to 3 (the specification's
// numbers; is_inter tells them apart)
enum { TX_SET_DCTONLY, TX_SET_INTRA_1, TX_SET_INTRA_2 };
enum { TX_SET_INTER_1 = 1, TX_SET_INTER_2, TX_SET_INTER_3 };
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };
enum { ONLY_4X4, TX_MODE_LARGEST, TX_MODE_SELECT };
enum { SEG_LVL_ALT_Q = 0, SEG_LVL_ALT_LF_Y_V = 1, SEG_LVL_REF_FRAME = 5,
       SEG_LVL_SKIP = 6, SEG_LVL_GLOBALMV = 7, SEG_LVL_MAX = 8 };
constexpr int MAX_SEGMENTS = 8, MAX_LOOP_FILTER = 63;
enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };
constexpr int SUPERRES_NUM = 8, SUPERRES_DENOM_MIN = 9;
constexpr int SGRPROJ_RST_BITS = 4, SGRPROJ_PRJ_BITS = 7,
              SGRPROJ_MTABLE_BITS = 20, SGRPROJ_RECIP_BITS = 12,
              SGRPROJ_SGR_BITS = 8, SGRPROJ_PRJ_SUBEXP_K = 4;
const int kRemapLrType[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER,
                             RESTORE_SGRPROJ};

const uint8_t kWide4[22] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32,
                            32, 1, 4, 2, 8, 4, 16};
const uint8_t kHigh4[22] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16,
                            32, 4, 1, 8, 2, 16, 4};
const uint8_t kTxW[19] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4,
                          16, 8, 32, 16, 64};
const uint8_t kTxH[19] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16,
                          4, 32, 8, 64, 16};
const uint8_t kMaxTxRect[22] = {
    TX_4X4,   TX_4X8,   TX_8X4,   TX_8X8,   TX_8X16,  TX_16X8,
    TX_16X16, TX_16X32, TX_32X16, TX_32X32, TX_32X64, TX_64X32,
    TX_64X64, TX_64X64, TX_64X64, TX_64X64, TX_4X16,  TX_16X4,
    TX_8X32,  TX_32X8,  TX_16X64, TX_64X16};
const uint8_t kSplitTx[19] = {
    TX_4X4,   TX_4X4,   TX_8X8,   TX_16X16, TX_32X32, TX_4X4,  TX_4X4,
    TX_8X8,   TX_8X8,   TX_16X16, TX_16X16, TX_32X32, TX_32X32, TX_4X8,
    TX_8X4,   TX_8X16,  TX_16X8,  TX_16X32, TX_32X16};
// get_plane_residual_size: [block][subsampling_x][subsampling_y]
const uint8_t kSubSize[22][2][2] = {
    {{BLOCK_4X4, BLOCK_4X4}, {BLOCK_4X4, BLOCK_4X4}},
    {{BLOCK_4X8, BLOCK_4X4}, {BLOCK_INVALID, BLOCK_4X4}},
    {{BLOCK_8X4, BLOCK_INVALID}, {BLOCK_4X4, BLOCK_4X4}},
    {{BLOCK_8X8, BLOCK_8X4}, {BLOCK_4X8, BLOCK_4X4}},
    {{BLOCK_8X16, BLOCK_8X8}, {BLOCK_INVALID, BLOCK_4X8}},
    {{BLOCK_16X8, BLOCK_INVALID}, {BLOCK_8X8, BLOCK_8X4}},
    {{BLOCK_16X16, BLOCK_16X8}, {BLOCK_8X16, BLOCK_8X8}},
    {{BLOCK_16X32, BLOCK_16X16}, {BLOCK_INVALID, BLOCK_8X16}},
    {{BLOCK_32X16, BLOCK_INVALID}, {BLOCK_16X16, BLOCK_16X8}},
    {{BLOCK_32X32, BLOCK_32X16}, {BLOCK_16X32, BLOCK_16X16}},
    {{BLOCK_32X64, BLOCK_32X32}, {BLOCK_INVALID, BLOCK_16X32}},
    {{BLOCK_64X32, BLOCK_INVALID}, {BLOCK_32X32, BLOCK_32X16}},
    {{BLOCK_64X64, BLOCK_64X32}, {BLOCK_32X64, BLOCK_32X32}},
    {{BLOCK_64X128, BLOCK_64X64}, {BLOCK_INVALID, BLOCK_32X64}},
    {{BLOCK_128X64, BLOCK_INVALID}, {BLOCK_64X64, BLOCK_64X32}},
    {{BLOCK_128X128, BLOCK_128X64}, {BLOCK_64X128, BLOCK_64X64}},
    {{BLOCK_4X16, BLOCK_4X8}, {BLOCK_INVALID, BLOCK_4X8}},
    {{BLOCK_16X4, BLOCK_INVALID}, {BLOCK_8X4, BLOCK_8X4}},
    {{BLOCK_8X32, BLOCK_8X16}, {BLOCK_INVALID, BLOCK_4X16}},
    {{BLOCK_32X8, BLOCK_INVALID}, {BLOCK_16X8, BLOCK_16X4}},
    {{BLOCK_16X64, BLOCK_16X32}, {BLOCK_INVALID, BLOCK_8X32}},
    {{BLOCK_64X16, BLOCK_INVALID}, {BLOCK_32X16, BLOCK_32X8}}};
const uint8_t kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const int kModeToAngle[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67,
                              0, 0, 0, 0};
const uint8_t kModeToTxfm[14] = {
    DCT_DCT,  ADST_DCT,  DCT_ADST, DCT_DCT,  ADST_ADST, ADST_DCT, DCT_ADST,
    DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT};
const uint8_t kFilterIntraToDir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED,
                                      DC_PRED};
const uint8_t kTxTypeInvSet1[7] = {IDTX,      DCT_DCT,  V_DCT,   H_DCT,
                                   ADST_ADST, ADST_DCT, DCT_ADST};
const uint8_t kTxTypeInvSet2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT,
                                   DCT_ADST};
const uint8_t kTxTypeInterInvSet1[16] = {
    IDTX,         V_DCT,        H_DCT,    V_ADST,       H_ADST,
    V_FLIPADST,   H_FLIPADST,   DCT_DCT,  ADST_DCT,     DCT_ADST,
    FLIPADST_DCT, DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST,
    ADST_FLIPADST, FLIPADST_ADST};
const uint8_t kTxTypeInterInvSet2[12] = {
    IDTX,         V_DCT,     H_DCT,     DCT_DCT,          ADST_DCT,
    DCT_ADST,     FLIPADST_DCT, DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST,
    ADST_FLIPADST, FLIPADST_ADST};
const uint8_t kTxTypeInterInvSet3[2] = {IDTX, DCT_DCT};
// intra block copy (spec 7.10.2 and libaom's mvref_common.c)
constexpr int MAX_REF_MV_STACK_SIZE = 8, REF_CAT_LEVEL = 640,
              MVREF_ROW_COLS = 3, INTRABC_DELAY_PIXELS = 256,
              INTRABC_DELAY_SB64 = INTRABC_DELAY_PIXELS / 64,
              MV_BORDER = 16 << 3;
constexpr int PALETTE_MAX_SIZE = 8;
const int kSegFeatureBits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
const int kSegFeatureSigned[8] = {1, 1, 1, 1, 1, 0, 0, 0};
const int kSegFeatureMax[8] = {255, 63, 63, 63, 63, 7, 0, 0};
const int kRowShift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2,
                           2, 2, 2};
const int kSigRefDiff[3][5][2] = {
    {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
    {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
    {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
const int kMagRefOffset[3][3][2] = {{{0, 1}, {1, 0}, {1, 1}},
                                    {{0, 1}, {1, 0}, {0, 2}},
                                    {{0, 1}, {1, 0}, {2, 0}}};
const int kEdgeKernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0},
                               {2, 4, 4, 4, 2}};
const int kCdefUvDir[2][2][8] = {
    {{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
    {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};
const int kCdefDirections[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
    {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}}};
const int kCdefPriTaps[2][2] = {{4, 2}, {3, 3}};
const int kCdefSecTaps[2][2] = {{2, 1}, {2, 1}};
// inter frames (spec 6.10.x, 7.10, 7.11.3)
enum { INTER_FRAME = 1, INTRA_ONLY_FRAME = 2, SWITCH_FRAME = 3 };
enum { NONE_FRAME = -1, INTRA_FRAME = 0, LAST_FRAME, LAST2_FRAME, LAST3_FRAME,
       GOLDEN_FRAME, BWDREF_FRAME, ALTREF2_FRAME, ALTREF_FRAME };
enum { NEARESTMV = 13, NEARMV, GLOBALMV, NEWMV, NEAREST_NEARESTMV,
       NEAR_NEARMV, NEAREST_NEWMV, NEW_NEARESTMV, NEAR_NEWMV, NEW_NEARMV,
       GLOBAL_GLOBALMV, NEW_NEWMV };
enum { SIMPLE, OBMC, LOCALWARP };
enum { EIGHTTAP, EIGHTTAP_SMOOTH, EIGHTTAP_SHARP, BILINEAR, SWITCHABLE };
enum { COMPOUND_WEDGE, COMPOUND_DIFFWTD, COMPOUND_AVERAGE, COMPOUND_INTRA,
       COMPOUND_DISTANCE };
enum { II_DC_PRED, II_V_PRED, II_H_PRED, II_SMOOTH_PRED };
enum { IDENTITY, TRANSLATION, ROTZOOM, AFFINE };
constexpr int NUM_REF_FRAMES = 8, REFS_PER_FRAME = 7, PRIMARY_REF_NONE = 7;
constexpr int WARPEDMODEL_PREC_BITS = 16, GM_ABS_TRANS_BITS = 12,
              GM_ABS_TRANS_ONLY_BITS = 9, GM_ABS_ALPHA_BITS = 12,
              GM_ALPHA_PREC_BITS = 15, GM_TRANS_PREC_BITS = 6,
              GM_TRANS_ONLY_PREC_BITS = 3, WARP_PARAM_REDUCE_BITS = 6,
              WARPEDMODEL_NONDIAGAFFINE_CLAMP = 1 << 13,
              WARPEDMODEL_TRANS_CLAMP = 1 << 23, LS_MV_MAX = 256,
              LEAST_SQUARES_SAMPLES_MAX = 8, DIV_LUT_BITS = 8,
              DIV_LUT_PREC_BITS = 14;
constexpr int REF_SCALE_SHIFT = 14, SCALE_SUBPEL_BITS = 10,
              MAX_FRAME_DISTANCE = 31, REFMVS_LIMIT = (1 << 12) - 1,
              MV_LOW = -(1 << 14), MV_UPP = 1 << 14, MFMV_STACK_SIZE = 3;
const uint8_t kSizeGroup[22] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3,
                                3, 0, 0, 1, 1, 2, 2};
const uint8_t kWedgeBits[22] = {0, 0, 0, 4, 4, 4, 4, 4, 4, 4, 0, 0, 0, 0, 0,
                                0, 0, 0, 4, 4, 0, 0};
const uint8_t kCompoundModeCtxMap[3][5] = {
    {0, 1, 1, 1, 1}, {1, 2, 3, 4, 4}, {4, 4, 5, 6, 7}};
// the loop filter's mode delta of each y mode (inter modes but GLOBALMV
// and GLOBAL_GLOBALMV take the second)
inline int mode_lf(int y_mode) {
  return y_mode >= NEARESTMV && y_mode != GLOBALMV && y_mode != GLOBAL_GLOBALMV;
}
// distance weights of compound prediction (libaom's quant_dist tables)
const int kQuantDistWeight[4][2] = {{2, 3}, {2, 5}, {2, 7}, {1, 31}};
const int kQuantDistLookup[4][2] = {{9, 7}, {11, 5}, {12, 4}, {13, 3}};
inline int round2signed(int64_t x, int n) {
  return x >= 0 ? round2(x, n) : -round2(-x, n);
}
inline int64_t round2signed_64(int64_t x, int n) {
  if (n == 0) return x;
  return x >= 0 ? (x + (int64_t(1) << (n - 1))) >> n
                : -((-x + (int64_t(1) << (n - 1))) >> n);
}

// Wedge masks (libaom's av1_init_wedge_masks; its masters and codebooks)
enum { WEDGE_HORIZONTAL, WEDGE_VERTICAL, WEDGE_OBLIQUE27, WEDGE_OBLIQUE63,
       WEDGE_OBLIQUE117, WEDGE_OBLIQUE153 };
// each master: zeros, a ramp from index 28 (29 for the vertical one),
// then 64s
const uint8_t kWedgeRamp[3][8] = {{1, 4, 11, 27, 46, 58, 62, 63},   // even
                                  {1, 2, 6, 18, 37, 53, 60, 63},    // odd
                                  {2, 7, 21, 43, 57, 62, 64, 64}};  // vertical
// [codebook][index]: direction, x offset, y offset (in eighths); the
// codebooks of blocks taller than wide, wider than tall, square
const uint8_t kWedgeCodebook[3][16][3] = {
    {{2, 4, 4}, {3, 4, 4}, {4, 4, 4}, {5, 4, 4}, {0, 4, 2}, {0, 4, 4},
     {0, 4, 6}, {1, 4, 4}, {2, 4, 2}, {2, 4, 6}, {5, 4, 2}, {5, 4, 6},
     {3, 2, 4}, {3, 6, 4}, {4, 2, 4}, {4, 6, 4}},
    {{2, 4, 4}, {3, 4, 4}, {4, 4, 4}, {5, 4, 4}, {1, 2, 4}, {1, 4, 4},
     {1, 6, 4}, {0, 4, 4}, {2, 4, 2}, {2, 4, 6}, {5, 4, 2}, {5, 4, 6},
     {3, 2, 4}, {3, 6, 4}, {4, 2, 4}, {4, 6, 4}},
    {{2, 4, 4}, {3, 4, 4}, {4, 4, 4}, {5, 4, 4}, {0, 4, 2}, {0, 4, 6},
     {1, 2, 4}, {1, 6, 4}, {2, 4, 2}, {2, 4, 6}, {5, 4, 2}, {5, 4, 6},
     {3, 2, 4}, {3, 6, 4}, {4, 2, 4}, {4, 6, 4}}};

inline int log2i(int x) { return floor_log2(static_cast<uint32_t>(x)); }
inline int sq_tx(int side) { return log2i(side) - 2; }     // 4 -> TX_4X4
inline int tx_sqr(int t) { return sq_tx(std::min(kTxW[t], kTxH[t])); }
inline int tx_sqr_up(int t) { return sq_tx(std::max(kTxW[t], kTxH[t])); }

int block_of(int w4, int h4) {
  for (int b = 0; b < 22; ++b)
    if (kWide4[b] == w4 && kHigh4[b] == h4) return b;
  return BLOCK_INVALID;
}

int partition_subsize(int p, int b) {
  const int n = kWide4[b];
  switch (p) {
    case PARTITION_NONE: return b;
    case PARTITION_HORZ: case PARTITION_HORZ_A: case PARTITION_HORZ_B:
      return block_of(n, n / 2);
    case PARTITION_VERT: case PARTITION_VERT_A: case PARTITION_VERT_B:
      return block_of(n / 2, n);
    case PARTITION_SPLIT: return block_of(n / 2, n / 2);
    case PARTITION_HORZ_4: return block_of(n, n / 4);
    default: return block_of(n / 4, n);
  }
}

// ---------------------------------------------------------------------------
// Bits

struct BitReader {
  const uint8_t* p = nullptr;
  size_t size = 0, pos = 0;      // pos in bits
  BitReader() = default;
  BitReader(const uint8_t* d, size_t n) : p(d), size(n) {}
  uint32_t f(int n) {
    uint32_t x = 0;
    for (int i = 0; i < n; ++i) {
      if (pos >= size * 8) fail("the AV1 stream ends inside a header");
      x = (x << 1) | ((p[pos >> 3] >> (7 - (pos & 7))) & 1);
      ++pos;
    }
    return x;
  }
  int su(int n) {
    int v = static_cast<int>(f(n));
    const int sign = 1 << (n - 1);
    return (v & sign) ? v - 2 * sign : v;
  }
  uint32_t ns(uint32_t n) {
    int w = floor_log2(n) + 1;
    uint32_t m = (1u << w) - n;
    uint32_t v = f(w - 1);
    if (v < m) return v;
    return (v << 1) - m + f(1);
  }
  uint32_t uvlc() {
    int lz = 0;
    while (!f(1)) {
      if (++lz >= 32) fail("the AV1 stream has a malformed uvlc value");
    }
    return lz ? f(lz) + (1u << lz) - 1 : 0;
  }
  // libaom's check_trailing_bits, then its test that the OBU's bytes
  // after them are zeros
  void trailing_bits() {
    const int n = 8 - int(pos % 8);
    bool ok = f(n) == (1u << (n - 1));
    for (size_t i = pos / 8; i < size; ++i) ok &= p[i] == 0;
    if (!ok)
      fail("the AV1 stream has a header whose trailing bits are wrong "
           "(cv2 refuses it)");
  }
  // libaom's byte_alignment: zero bits up to the next byte
  void zero_align() {
    while (pos % 8)
      if (f(1))
        fail("the AV1 stream has a header not aligned by zero bits (cv2 "
             "refuses it)");
  }
};

uint64_t leb128(const uint8_t* d, size_t n, size_t* at) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) {
    if (*at >= n) fail("the AV1 stream ends inside an OBU size");
    const uint8_t b = d[(*at)++];
    v |= uint64_t(b & 0x7f) << (7 * i);
    if (!(b & 0x80)) return v;
  }
  return v;
}

// ---------------------------------------------------------------------------
// The symbol decoder (spec 8.2)

struct Symbols {
  const uint8_t* buf = nullptr;
  size_t size = 0, pos = 0;     // bits
  uint32_t value = 0, range = 0;
  int64_t max_bits = 0;
  bool adapt = true;
  uint32_t bits(int n) {       // n <= 15; zeros past the end
    if (n == 0) return 0;
    const size_t byte = pos >> 3;
    uint32_t win = 0;
    for (int i = 0; i < 3; ++i)
      win = (win << 8) | (byte + i < size ? buf[byte + i] : 0);
    const uint32_t x = (win >> (24 - int(pos & 7) - n)) & ((1u << n) - 1);
    pos += n;
    return x;
  }
  void init(const uint8_t* b, size_t sz, bool disable_update) {
    if (sz == 0) fail("the AV1 stream has an empty tile");
    buf = b; size = sz; pos = 0;
    const int nb = static_cast<int>(std::min<size_t>(sz * 8, 15));
    const uint32_t padded = bits(nb) << (15 - nb);
    value = ((1u << 15) - 1) ^ padded;
    range = 1u << 15;
    max_bits = int64_t(8) * sz - 15;
    adapt = !disable_update;
  }
  int read(uint16_t* cdf, int n) {
    uint32_t cur = range, prev;
    int symbol = -1;
    do {
      ++symbol;
      prev = cur;
      const uint32_t f = (1u << 15) - cdf[symbol];
      cur = ((range >> 8) * (f >> 6) >> 1) + 4 * (n - symbol - 1);
    } while (value < cur);
    range = prev - cur;
    value -= cur;
    const int b = 15 - floor_log2(range);
    range <<= b;
    const int nb = static_cast<int>(
        std::min<int64_t>(b, std::max<int64_t>(0, max_bits)));
    const uint32_t data = bits(nb) << (b - nb);
    value = data ^ (((value + 1) << b) - 1);
    max_bits -= b;
    if (adapt) {
      const int rate =
          3 + (cdf[n] > 15) + (cdf[n] > 31) + std::min(floor_log2(n), 2);
      uint32_t tmp = 0;
      for (int i = 0; i < n - 1; ++i) {
        if (i == symbol) tmp = 1u << 15;
        if (tmp < cdf[i])
          cdf[i] -= static_cast<uint16_t>((cdf[i] - tmp) >> rate);
        else
          cdf[i] += static_cast<uint16_t>((tmp - cdf[i]) >> rate);
      }
      cdf[n] += (cdf[n] < 32);
    }
    return symbol;
  }
  int rbool() {
    uint16_t cdf[3] = {1 << 14, 1 << 15, 0};
    const bool a = adapt;
    adapt = false;
    const int b = read(cdf, 2);
    adapt = a;
    return b;
  }
  int literal(int n) {
    int x = 0;
    for (int i = 0; i < n; ++i) x = 2 * x + rbool();
    return x;
  }
  // exit_symbol's conformance (libaom fails a tile that breaks it): no
  // more than 14 bits read past the data, and the padding after the
  // last symbol a 1 bit, then zeros to the tile's end.
  bool padding_ok() const {
    if (max_bits < -14) return false;
    const int64_t end = int64_t(size) * 8;
    const int64_t trailing = end - max_bits - 15;
    auto bit = [&](int64_t p) { return (buf[p >> 3] >> (7 - (p & 7))) & 1; };
    if (trailing < 0 || !bit(trailing)) return false;
    for (int64_t p = trailing + 1; p < end; ++p)
      if (bit(p)) return false;
    return true;
  }
};

// ---------------------------------------------------------------------------
// The CDFs of a tile

struct Cdfs {
  uint16_t y_mode[5][5][14];
  uint16_t uv_mode[2][13][15];
  uint16_t angle_delta[8][8];
  uint16_t partition[20][11];
  uint16_t skip[3][3];
  uint16_t segment_id[3][9];
  uint16_t delta_q[5];
  uint16_t delta_lf[5];
  uint16_t delta_lf_multi[4][5];
  uint16_t filter_intra[22][3];
  uint16_t filter_intra_mode[6];
  uint16_t tx_size[4][3][4];
  uint16_t intra_tx[2][4][13][17];
  uint16_t palette_y[7][3][3];
  uint16_t palette_uv[2][3];
  uint16_t cfl_sign[9];
  uint16_t cfl_alpha[6][17];
  uint16_t txb_skip[5][13][3];
  uint16_t eob16[2][2][6], eob32[2][2][7], eob64[2][2][8], eob128[2][2][9],
      eob256[2][2][10], eob512[2][2][11], eob1024[2][2][12];
  uint16_t eob_extra[5][2][9][3];
  uint16_t dc_sign[2][3][3];
  uint16_t base_eob[5][2][4][4];
  uint16_t base[5][2][42][5];
  uint16_t br[5][2][21][5];
  uint16_t restoration_type[4], use_wiener[3], use_sgrproj[3];
  uint16_t palette_y_size[7][8], palette_uv_size[7][8];
  uint16_t palette_y_color[7][5][9], palette_uv_color[7][5][9];
  uint16_t intrabc[3], txfm_split[21][3], inter_tx[3][4][17];
  // the MV contexts (0 inter blocks, 1 intra block copy): joints, then
  // per component (0 row, 1 column)
  struct Mv {
    uint16_t joint[5], cls[2][12], sign[2][3], class0_bit[2][3],
        class0_fr[2][2][5], fr[2][5], class0_hp[2][3], hp[2][3],
        bits[2][10][3];
  } mv[2];
  // inter frames
  uint16_t y_mode_inter[4][14], is_inter[4][3], comp_mode[5][3],
      comp_ref_type[5][3], uni_comp_ref[3][3][3], single_ref[3][6][3],
      comp_ref[3][3][3], comp_bwd_ref[3][2][3], compound_mode[8][9],
      new_mv[6][3], zero_mv[2][3], ref_mv[6][3], drl[3][3],
      interp_filter[16][4], motion_mode[22][4], use_obmc[22][3],
      inter_intra[4][3], inter_intra_mode[4][5], wedge_inter_intra[22][3],
      wedge_index[22][17], compound_type[22][3], comp_group_idx[6][3],
      compound_idx[6][3], skip_mode[3][3], seg_pred[3][3];

  // the symbol counters of every CDF set to 0 (each follows its 32768)
  void clear_counts() {
    uint16_t* p = reinterpret_cast<uint16_t*>(this);
    const size_t n = sizeof(*this) / sizeof(uint16_t);
    for (size_t i = 0; i + 1 < n; ++i)
      if (p[i] == 32768) p[i + 1] = 0;
  }
  void init_coeff(int base_q_idx) {
#define COPY(dst, src) std::memcpy(dst, src, sizeof(dst))
    const int q = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1
                  : base_q_idx <= 120 ? 2 : 3;
    COPY(txb_skip, Default_Txb_Skip_Cdf[q]);
    COPY(eob16, Default_Eob_Pt_16_Cdf[q]);
    COPY(eob32, Default_Eob_Pt_32_Cdf[q]);
    COPY(eob64, Default_Eob_Pt_64_Cdf[q]);
    COPY(eob128, Default_Eob_Pt_128_Cdf[q]);
    COPY(eob256, Default_Eob_Pt_256_Cdf[q]);
    COPY(eob512, Default_Eob_Pt_512_Cdf[q]);
    COPY(eob1024, Default_Eob_Pt_1024_Cdf[q]);
    COPY(eob_extra, Default_Eob_Extra_Cdf[q]);
    COPY(dc_sign, Default_Dc_Sign_Cdf[q]);
    COPY(base_eob, Default_Coeff_Base_Eob_Cdf[q]);
    COPY(base, Default_Coeff_Base_Cdf[q]);
    COPY(br, Default_Coeff_Br_Cdf[q]);
  }
  void init_non_coeff() {
    COPY(y_mode, Default_Intra_Frame_Y_Mode_Cdf);
    COPY(uv_mode, Default_Uv_Mode_Cdf);
    COPY(angle_delta, Default_Angle_Delta_Cdf);
    COPY(partition, Default_Partition_Cdf);
    COPY(skip, Default_Skip_Cdf);
    COPY(segment_id, Default_Segment_Id_Cdf);
    COPY(delta_q, Default_Delta_Q_Cdf);
    COPY(delta_lf, Default_Delta_Q_Cdf);
    for (auto& c : delta_lf_multi) COPY(c, Default_Delta_Q_Cdf);
    for (int b = 0; b < 22; ++b) {    // sizes that never filter: 16384
      const uint16_t half[3] = {16384, 32768, 0};
      const uint16_t* src =
          b < 10 ? Default_Filter_Intra_Cdfs[b]
          : (b >= 16 && b < 20) ? Default_Filter_Intra_Cdfs_Wide[b - 16]
                                : half;
      std::memcpy(filter_intra[b], src, sizeof(filter_intra[b]));
    }
    COPY(filter_intra_mode, Default_Filter_Intra_Mode_Cdf);
    COPY(tx_size, Default_Tx_Size_Cdf);
    COPY(intra_tx, Default_Intra_Tx_Type_Cdf);
    COPY(palette_y, Default_Palette_Y_Mode_Cdf);
    COPY(palette_uv, Default_Palette_Uv_Mode_Cdf);
    COPY(cfl_sign, Default_Cfl_Sign_Cdf);
    COPY(cfl_alpha, Default_Cfl_Alpha_Cdf);
    COPY(restoration_type, Default_Restoration_Type_Cdf);
    COPY(use_wiener, Default_Use_Wiener_Cdf);
    COPY(use_sgrproj, Default_Use_Sgrproj_Cdf);
    COPY(palette_y_size, Default_Palette_Y_Size_Cdf);
    COPY(palette_uv_size, Default_Palette_Uv_Size_Cdf);
    COPY(palette_y_color, Default_Palette_Y_Color_Cdf);
    COPY(palette_uv_color, Default_Palette_Uv_Color_Cdf);
    COPY(intrabc, Default_Intrabc_Cdf[0]);
    COPY(txfm_split, Default_Txfm_Split_Cdf);
    COPY(inter_tx, Default_Inter_Tx_Type_Cdf);
    for (Mv& m : mv) {
      COPY(m.joint, Default_Mv_Joint_Cdf);
      for (int c = 0; c < 2; ++c) {
        COPY(m.cls[c], Default_Mv_Class_Cdf);
        COPY(m.sign[c], Default_Mv_Sign_Cdf);
        COPY(m.class0_bit[c], Default_Mv_Class0_Bit_Cdf);
        COPY(m.class0_fr[c], Default_Mv_Class0_Fr_Cdf);
        COPY(m.fr[c], Default_Mv_Fr_Cdf);
        COPY(m.class0_hp[c], Default_Mv_Class0_Hp_Cdf);
        COPY(m.hp[c], Default_Mv_Hp_Cdf);
        COPY(m.bits[c], Default_Mv_Bit_Cdf);
      }
    }
    COPY(y_mode_inter, Default_Y_Mode_Cdf);
    COPY(is_inter, Default_Is_Inter_Cdf);
    COPY(comp_mode, Default_Comp_Mode_Cdf);
    COPY(comp_ref_type, Default_Comp_Ref_Type_Cdf);
    COPY(uni_comp_ref, Default_Uni_Comp_Ref_Cdf);
    COPY(single_ref, Default_Single_Ref_Cdf);
    COPY(comp_ref, Default_Comp_Ref_Cdf);
    COPY(comp_bwd_ref, Default_Comp_Bwd_Ref_Cdf);
    COPY(compound_mode, Default_Compound_Mode_Cdf);
    COPY(new_mv, Default_New_Mv_Cdf);
    COPY(zero_mv, Default_Zero_Mv_Cdf);
    COPY(ref_mv, Default_Ref_Mv_Cdf);
    COPY(drl, Default_Drl_Mode_Cdf);
    COPY(interp_filter, Default_Interp_Filter_Cdf);
    COPY(motion_mode, Default_Motion_Mode_Cdf);
    COPY(use_obmc, Default_Use_Obmc_Cdf);
    COPY(inter_intra, Default_Inter_Intra_Cdf);
    COPY(inter_intra_mode, Default_Inter_Intra_Mode_Cdf);
    COPY(wedge_inter_intra, Default_Wedge_Inter_Intra_Cdf);
    COPY(wedge_index, Default_Wedge_Index_Cdf);
    COPY(compound_type, Default_Compound_Type_Cdf);
    COPY(comp_group_idx, Default_Comp_Group_Idx_Cdf);
    COPY(compound_idx, Default_Compound_Idx_Cdf);
    COPY(skip_mode, Default_Skip_Mode_Cdf);
    COPY(seg_pred, Default_Segment_Id_Predicted_Cdf);
#undef COPY
  }
};

// ---------------------------------------------------------------------------
// Scans (spec: the default diagonal scans, the row and column scans)

struct Scans {
  std::vector<int16_t> def[19], mrow[19], mcol[19];
  Scans() {
    for (int t = 0; t < 19; ++t) {
      const int w = std::min<int>(kTxW[t], 32), h = std::min<int>(kTxH[t], 32);
      std::vector<int16_t>& s = def[t];
      for (int d = 0; d < w + h - 1; ++d) {
        // squares zig-zag; taller blocks run each diagonal downwards,
        // wider ones upwards
        bool down = w == h ? (d & 1) : (w < h);
        for (int k = 0; k <= d; ++k) {
          const int r = down ? k : d - k, c = d - r;
          if (r < h && c < w) s.push_back(static_cast<int16_t>(r * w + c));
        }
      }
      for (int i = 0; i < w * h; ++i) {
        mrow[t].push_back(static_cast<int16_t>(i));
        mcol[t].push_back(static_cast<int16_t>((i % h) * w + i / h));
      }
    }
  }
};

const Scans& scans() {
  static const Scans s;
  return s;
}

// ---------------------------------------------------------------------------
// Inverse transforms (spec 7.13.2, as libaom computes them: every add
// clamped to the stage's range)

int g_cos[65];
struct CosInit {
  CosInit() {
    static const int16_t c[65] = {
        4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973,
        3948, 3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564,
        3513, 3461, 3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896,
        2824, 2751, 2675, 2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019,
        1931, 1842, 1751, 1660, 1567, 1474, 1380, 1285, 1189, 1092, 995,
        897,  799,  700,  601,  501,  401,  301,  201,  101,  0};
    for (int i = 0; i < 65; ++i) g_cos[i] = c[i];
  }
} g_cos_init;

inline int32_t hbtf(int w0, int32_t a, int w1, int32_t b) {
  return static_cast<int32_t>((int64_t(w0) * a + int64_t(w1) * b + 2048) >> 12);
}

struct Tx1D {
  int lo, hi;     // the stage range
  int32_t cl(int64_t x) const {
    return static_cast<int32_t>(x < lo ? lo : (x > hi ? hi : x));
  }

  // DCT of size n = 2^lg on t[0..n) in bit-reversed order, in place.
  void dct_core(int32_t* t, int n) const {
    if (n == 2) {
      const int32_t a = t[0], b = t[1];
      t[0] = hbtf(g_cos[32], a, g_cos[32], b);
      t[1] = hbtf(g_cos[32], a, -g_cos[32], b);
      return;
    }
    const int m = n / 2;
    dct_core(t, m);
    odd(t + m, m, n);
    for (int i = 0; i < m; ++i) {
      const int32_t a = t[i], b = t[n - 1 - i];
      t[i] = cl(int64_t(a) + b);
      t[n - 1 - i] = cl(int64_t(a) - b);
    }
  }
  // The odd half of a DCT of size n: m = n / 2 values, the inputs of
  // odd index in bit-reversed order.
  void odd(int32_t* o, int m, int n) const {
    const int lgn = log2i(n);
    for (int i = 0; i < m / 2; ++i) {
      int k = 0, x = m + i;
      for (int b = 0; b < lgn; ++b) k |= ((x >> b) & 1) << (lgn - 1 - b);
      const int q = k * 64 / n, p = 64 - q;
      const int32_t a = o[i], b = o[m - 1 - i];
      o[i] = hbtf(g_cos[p], a, -g_cos[q], b);
      o[m - 1 - i] = hbtf(g_cos[q], a, g_cos[p], b);
    }
    const int levels = log2i(m);
    for (int l = 1; l < levels; ++l) {
      const int s = 1 << l;       // the adds: blocks of s, forward then reverse
      for (int b = 0; b < m; b += s) {
        const bool rev = (b / s) & 1;
        for (int j = 0; j < s / 2; ++j) {
          const int32_t x = o[b + j], y = o[b + s - 1 - j];
          if (!rev) {
            o[b + j] = cl(int64_t(x) + y);
            o[b + s - 1 - j] = cl(int64_t(x) - y);
          } else {
            o[b + j] = cl(int64_t(y) - x);
            o[b + s - 1 - j] = cl(int64_t(x) + y);
          }
        }
      }
      if (l == levels - 1) {      // the last rotation: by 32, type 1
        for (int j = m / 4; j < m / 2; ++j) {
          const int32_t a = o[j], b = o[m - 1 - j];
          o[j] = hbtf(-g_cos[32], a, g_cos[32], b);
          o[m - 1 - j] = hbtf(g_cos[32], a, g_cos[32], b);
        }
        continue;
      }
      const int S = 2 << l, H = m / 2 / S;   // blocks of S in the first half
      for (int blk = 0; blk < H; ++blk) {
        int br = 0;     // blk bit-reversed
        for (int b = 0; b < log2i(H); ++b)
          br |= ((blk >> b) & 1) << (log2i(H) - 1 - b);
        const int th = (64 / (4 * H)) * (4 * br + 1);
        const int base = blk * S;
        for (int j = base + S / 4; j < base + 3 * S / 4; ++j) {
          const int mj = m - 1 - j;
          const int32_t a = o[j], b = o[mj];
          if (j < base + S / 2) {     // type 1
            o[j] = hbtf(-g_cos[th], a, g_cos[64 - th], b);
            o[mj] = hbtf(g_cos[64 - th], a, g_cos[th], b);
          } else {                    // type 2
            o[j] = hbtf(-g_cos[64 - th], a, -g_cos[th], b);
            o[mj] = hbtf(-g_cos[th], a, g_cos[64 - th], b);
          }
        }
      }
    }
  }
  void dct(int32_t* t, int n) const {
    int32_t c[64];
    const int lg = log2i(n);
    for (int i = 0; i < n; ++i) {
      int r = 0;
      for (int b = 0; b < lg; ++b) r |= ((i >> b) & 1) << (lg - 1 - b);
      c[i] = t[r];
    }
    dct_core(c, n);
    std::memcpy(t, c, n * sizeof(int32_t));
  }
  void adst4(int32_t* t) const {
    const int64_t x0 = t[0], x1 = t[1], x2 = t[2], x3 = t[3];
    int64_t s0 = 1321 * x0, s1 = 2482 * x0, s2 = 3344 * x1, s3 = 3803 * x2;
    const int64_t s4 = 1321 * x2, s5 = 2482 * x3, s6 = 3803 * x3;
    const int64_t s7 = (x0 - x2) + x3;
    s0 = s0 + s3;
    s1 = s1 - s4;
    s3 = s2;
    s2 = 3344 * s7;
    s0 = s0 + s5;
    s1 = s1 - s6;
    const int64_t y0 = s0 + s3, y1 = s1 + s3, y2 = s2, y3 = s0 + s1 - s3;
    t[0] = round2(y0, 12);
    t[1] = round2(y1, 12);
    t[2] = round2(y2, 12);
    t[3] = round2(y3, 12);
  }
  void adst8(int32_t* t) const {
    int32_t b[8], c[8];
    const int in[8] = {7, 0, 5, 2, 3, 4, 1, 6};
    for (int i = 0; i < 8; ++i) b[i] = t[in[i]];
    for (int i = 0; i < 4; ++i) {
      const int a = 4 + 16 * i;
      c[2 * i] = hbtf(g_cos[a], b[2 * i], g_cos[64 - a], b[2 * i + 1]);
      c[2 * i + 1] = hbtf(g_cos[64 - a], b[2 * i], -g_cos[a], b[2 * i + 1]);
    }
    for (int i = 0; i < 4; ++i) {
      b[i] = cl(int64_t(c[i]) + c[i + 4]);
      b[i + 4] = cl(int64_t(c[i]) - c[i + 4]);
    }
    c[0] = b[0]; c[1] = b[1]; c[2] = b[2]; c[3] = b[3];
    c[4] = hbtf(g_cos[16], b[4], g_cos[48], b[5]);
    c[5] = hbtf(g_cos[48], b[4], -g_cos[16], b[5]);
    c[6] = hbtf(-g_cos[48], b[6], g_cos[16], b[7]);
    c[7] = hbtf(g_cos[16], b[6], g_cos[48], b[7]);
    for (int g = 0; g < 8; g += 4) {
      b[g] = cl(int64_t(c[g]) + c[g + 2]);
      b[g + 1] = cl(int64_t(c[g + 1]) + c[g + 3]);
      b[g + 2] = cl(int64_t(c[g]) - c[g + 2]);
      b[g + 3] = cl(int64_t(c[g + 1]) - c[g + 3]);
    }
    for (int g = 2; g < 8; g += 4) {
      const int32_t x = b[g], y = b[g + 1];
      b[g] = hbtf(g_cos[32], x, g_cos[32], y);
      b[g + 1] = hbtf(g_cos[32], x, -g_cos[32], y);
    }
    t[0] = b[0]; t[1] = -b[4]; t[2] = b[6]; t[3] = -b[2];
    t[4] = b[3]; t[5] = -b[7]; t[6] = b[5]; t[7] = -b[1];
  }
  void adst16(int32_t* t) const {
    int32_t b[16], c[16];
    const int in[16] = {15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14};
    for (int i = 0; i < 16; ++i) b[i] = t[in[i]];
    for (int i = 0; i < 8; ++i) {
      const int a = 2 + 8 * i;
      c[2 * i] = hbtf(g_cos[a], b[2 * i], g_cos[64 - a], b[2 * i + 1]);
      c[2 * i + 1] = hbtf(g_cos[64 - a], b[2 * i], -g_cos[a], b[2 * i + 1]);
    }
    for (int i = 0; i < 8; ++i) {
      b[i] = cl(int64_t(c[i]) + c[i + 8]);
      b[i + 8] = cl(int64_t(c[i]) - c[i + 8]);
    }
    for (int i = 0; i < 8; ++i) c[i] = b[i];
    c[8] = hbtf(g_cos[8], b[8], g_cos[56], b[9]);
    c[9] = hbtf(g_cos[56], b[8], -g_cos[8], b[9]);
    c[10] = hbtf(g_cos[40], b[10], g_cos[24], b[11]);
    c[11] = hbtf(g_cos[24], b[10], -g_cos[40], b[11]);
    c[12] = hbtf(-g_cos[56], b[12], g_cos[8], b[13]);
    c[13] = hbtf(g_cos[8], b[12], g_cos[56], b[13]);
    c[14] = hbtf(-g_cos[24], b[14], g_cos[40], b[15]);
    c[15] = hbtf(g_cos[40], b[14], g_cos[24], b[15]);
    for (int g = 0; g < 16; g += 8)
      for (int i = 0; i < 4; ++i) {
        b[g + i] = cl(int64_t(c[g + i]) + c[g + i + 4]);
        b[g + i + 4] = cl(int64_t(c[g + i]) - c[g + i + 4]);
      }
    for (int i = 0; i < 16; ++i) c[i] = b[i];
    for (int g = 4; g < 16; g += 8) {
      c[g] = hbtf(g_cos[16], b[g], g_cos[48], b[g + 1]);
      c[g + 1] = hbtf(g_cos[48], b[g], -g_cos[16], b[g + 1]);
      c[g + 2] = hbtf(-g_cos[48], b[g + 2], g_cos[16], b[g + 3]);
      c[g + 3] = hbtf(g_cos[16], b[g + 2], g_cos[48], b[g + 3]);
    }
    for (int g = 0; g < 16; g += 4) {
      b[g] = cl(int64_t(c[g]) + c[g + 2]);
      b[g + 1] = cl(int64_t(c[g + 1]) + c[g + 3]);
      b[g + 2] = cl(int64_t(c[g]) - c[g + 2]);
      b[g + 3] = cl(int64_t(c[g + 1]) - c[g + 3]);
    }
    for (int g = 2; g < 16; g += 4) {
      const int32_t x = b[g], y = b[g + 1];
      b[g] = hbtf(g_cos[32], x, g_cos[32], y);
      b[g + 1] = hbtf(g_cos[32], x, -g_cos[32], y);
    }
    const int out[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
    for (int i = 0; i < 16; ++i) t[i] = (i & 1) ? -b[out[i]] : b[out[i]];
  }
  void identity(int32_t* t, int n) const {
    for (int i = 0; i < n; ++i) {
      if (n == 4) t[i] = round2(int64_t(t[i]) * 5793, 12);
      else if (n == 8) t[i] = t[i] * 2;
      else if (n == 16) t[i] = round2(int64_t(t[i]) * 11586, 12);
      else t[i] = t[i] * 4;
    }
  }
  // kind: 0 DCT, 1 ADST, 2 identity
  void run(int kind, int32_t* t, int n) const {
    if (kind == 2) identity(t, n);
    else if (kind == 0) dct(t, n);
    else if (n == 4) adst4(t);
    else if (n == 8) adst8(t);
    else adst16(t);
  }
};

void iwht4(int32_t* t, int shift) {
  int32_t a = t[0] >> shift, c = t[1] >> shift, d = t[2] >> shift,
          b = t[3] >> shift;
  a += c;
  d -= b;
  const int32_t e = (a - d) >> 1;
  b = e - b;
  c = e - c;
  a -= b;
  d += c;
  t[0] = a; t[1] = b; t[2] = c; t[3] = d;
}

// ---------------------------------------------------------------------------
// The decoder

struct Plane {
  std::vector<uint16_t> px;
  int stride = 0, rows = 0;
  uint16_t* at(int y, int x) { return &px[size_t(y) * stride + x]; }
  uint16_t get(int y, int x) const { return px[size_t(y) * stride + x]; }
};

// A restoration unit (spec 5.11.58): its type, the Wiener taps of each
// pass (0 vertical, 1 horizontal) or the self-guided set and weights.
struct LrUnit {
  int type = RESTORE_NONE;
  int wiener[2][3] = {{0}};
  int sgr_set = 0, sgr_xqd[2] = {0};
};

// film_grain_params (spec 5.9.30)
struct FilmGrain {
  int apply = 0, seed = 0;
  int num_y = 0, num_cb = 0, num_cr = 0;
  int y_pts[14][2] = {{0}}, cb_pts[10][2] = {{0}}, cr_pts[10][2] = {{0}};
  int chroma_from_luma = 0, scaling_shift = 8, ar_lag = 0;
  int ar_y[24] = {0}, ar_cb[25] = {0}, ar_cr[25] = {0};
  int ar_shift = 6, grain_scale_shift = 0;
  int cb_mult = 0, cb_luma_mult = 0, cb_offset = 0;
  int cr_mult = 0, cr_luma_mult = 0, cr_offset = 0;
  int overlap = 0, clip_restricted = 0;
};

// The 64x64 wedge masks of each sign and direction, and each block
// size's sign flips (libaom's init_wedge_master_masks, init_wedge_signs)
struct WedgeMasks {
  uint8_t obl[2][6][64 * 64];
  uint8_t flip[22][16];
  static int codebook(int bsize) {
    const int w = kWide4[bsize], h = kHigh4[bsize];
    return h > w ? 0 : h < w ? 1 : 2;
  }
  // get_wedge_mask_inplace: the mask's top left, 64 a row
  const uint8_t* mask(int bsize, int neg, int index) const {
    const uint8_t* a = kWedgeCodebook[codebook(bsize)][index];
    const int bw = kWide4[bsize] * 4, bh = kHigh4[bsize] * 4;
    const int woff = (a[1] * bw) >> 3, hoff = (a[2] * bh) >> 3;
    return obl[neg ^ flip[bsize][index]][a[0]] + 64 * (32 - hoff) + 32 - woff;
  }
  WedgeMasks() {
    uint8_t master[3][64];
    for (int m = 0; m < 3; ++m) {
      const int start = m == 2 ? 29 : 28;
      for (int i = 0; i < 64; ++i)
        master[m][i] = i < start ? 0 : i < start + 8 ? kWedgeRamp[m][i - start] : 64;
    }
    auto shift_copy = [](const uint8_t* src, uint8_t* dst, int shift) {
      if (shift >= 0) {
        std::memcpy(dst + shift, src, 64 - shift);
        std::memset(dst, src[0], shift);
      } else {
        shift = -shift;
        std::memcpy(dst, src + shift, 64 - shift);
        std::memset(dst + 64 - shift, src[63], shift);
      }
    };
    int shift = 16;
    for (int i = 0; i < 64; i += 2) {
      shift_copy(master[0], &obl[0][WEDGE_OBLIQUE63][i * 64], shift);
      --shift;
      shift_copy(master[1], &obl[0][WEDGE_OBLIQUE63][(i + 1) * 64], shift);
      std::memcpy(&obl[0][WEDGE_VERTICAL][i * 64], master[2], 64);
      std::memcpy(&obl[0][WEDGE_VERTICAL][(i + 1) * 64], master[2], 64);
    }
    for (int i = 0; i < 64; ++i)
      for (int j = 0; j < 64; ++j) {
        const int m = obl[0][WEDGE_OBLIQUE63][i * 64 + j];
        obl[0][WEDGE_OBLIQUE27][j * 64 + i] = m;
        obl[0][WEDGE_OBLIQUE117][i * 64 + 63 - j] =
            obl[0][WEDGE_OBLIQUE153][(63 - j) * 64 + i] = uint8_t(64 - m);
        obl[1][WEDGE_OBLIQUE63][i * 64 + j] =
            obl[1][WEDGE_OBLIQUE27][j * 64 + i] = uint8_t(64 - m);
        obl[1][WEDGE_OBLIQUE117][i * 64 + 63 - j] =
            obl[1][WEDGE_OBLIQUE153][(63 - j) * 64 + i] = uint8_t(m);
        const int mx = obl[0][WEDGE_VERTICAL][i * 64 + j];
        obl[0][WEDGE_HORIZONTAL][j * 64 + i] = uint8_t(mx);
        obl[1][WEDGE_VERTICAL][i * 64 + j] =
            obl[1][WEDGE_HORIZONTAL][j * 64 + i] = uint8_t(64 - mx);
      }
    std::memset(flip, 0, sizeof(flip));
    for (int b = 0; b < 22; ++b) {
      if (!kWedgeBits[b]) continue;
      const int bw = kWide4[b] * 4, bh = kHigh4[b] * 4;
      for (int w = 0; w < 16; ++w) {
        const uint8_t* m = mask(b, 0, w);
        int avg = 0;
        for (int i = 0; i < bw; ++i) avg += m[i];
        for (int i = 1; i < bh; ++i) avg += m[i * 64];
        avg = (avg + (bw + bh - 1) / 2) / (bw + bh - 1);
        flip[b][w] = avg < 32;
      }
    }
  }
};

const WedgeMasks& wedges() {
  static const WedgeMasks w;
  return w;
}

// A frame's planes, shared by the reference slots and the output
struct FrameBuf {
  Plane planes[3];
};

// A reference slot (spec 7.20): what later frames read of a frame
struct RefSlot {
  // valid for referencing (libaom's valid_for_referencing), holding a
  // frame (its ref_frame_map entry), grey for a lost frame; blank: the
  // state of a libaom buffer no frame has used (zeros: no entropy
  // context, no film grain)
  bool valid = false, held = false, grey = false, blank = false;
  int fb = -1;     // its libaom frame buffer (Decoder::pool)
  int frame_id = 0, frame_type = 0, order_hint = 0, showable = 0;
  int spatial_id = 0;
  int upscaled_w = 0, frame_w = 0, frame_h = 0, render_w = 0, render_h = 0;
  int mi_cols = 0, mi_rows = 0, bit_depth = 8, ssx = 1, ssy = 1;
  int saved_order_hints[8] = {0};
  std::shared_ptr<FrameBuf> buf;
  std::shared_ptr<Cdfs> cdf;
  int lf_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1}, lf_mode_deltas[2] = {0};
  int feature_enabled[8][8] = {{0}}, feature_data[8][8] = {{0}};
  int gm_params[8][6] = {{0}};
  FilmGrain grain;
  // the motion field (a reference frame and a vector per mi) and the
  // segment ids
  std::shared_ptr<std::vector<int8_t>> mf_refs;
  std::shared_ptr<std::vector<int16_t>> mf_mvs;
  std::shared_ptr<std::vector<uint8_t>> seg_ids;
};

struct Decoder {
  // the operating point asked for (a1op's index), its idc; the layer
  // whose first shown frame is the output (lsel's), or -1 for the last
  // shown frame
  int operating_point = 0, op_idc_cur = 0, select_layer = -1;
  int frame_spatial_id = 0;
  bool layer_found = false;
  // sequence header
  int seq_profile = 0, reduced = 0;
  int timing_info = 0, decoder_model_info = 0, equal_picture_interval = 0;
  int buffer_delay_length = 0, buffer_removal_time_length = 0,
      frame_presentation_time_length = 0;
  int op_cnt = 1, op_idc[32] = {0}, decoder_model_present[32] = {0};
  int frame_width_bits = 0, frame_height_bits = 0;
  int max_w = 0, max_h = 0;
  int frame_id_numbers_present = 0, delta_frame_id_length = 0,
      additional_frame_id_length = 0;
  int use_128 = 0, enable_filter_intra = 0, enable_intra_edge_filter = 0;
  int enable_order_hint = 0, order_hint_bits = 0;
  int seq_force_screen_content_tools = 2, seq_force_integer_mv = 2;
  int enable_superres = 0, enable_cdef = 0, enable_restoration = 0;
  int bit_depth = 8, mono = 0, num_planes = 3;
  int color_primaries = 2, transfer = 2, matrix = 2, color_range = 0;
  int ssx = 1, ssy = 1, separate_uv_delta_q = 0;
  int film_grain_params_present = 0;
  int enable_interintra_compound = 0, enable_masked_compound = 0,
      enable_warped_motion = 0, enable_dual_filter = 0, enable_jnt_comp = 0,
      enable_ref_frame_mvs = 0;
  bool have_seq = false;

  // the reference slots, the frame to show and its film grain
  RefSlot refs[NUM_REF_FRAMES];
  std::shared_ptr<FrameBuf> shown;
  FilmGrain shown_grain;
  int shown_w = 0, shown_h = 0;
  // inter frame header
  int frame_type = KEY_FRAME, show_frame = 1, showable_frame = 0,
      show_existing_frame = 0, error_resilient_mode = 1, frame_is_intra = 1;
  int refresh_frame_flags = 0xFF, primary_ref_frame = PRIMARY_REF_NONE;
  int order_hint = 0, current_frame_id = 0;
  int ref_frame_idx[REFS_PER_FRAME] = {0};
  int order_hints[8] = {0}, sign_bias[8] = {0};
  int allow_high_precision_mv = 0, force_integer_mv = 0;
  int interpolation_filter = EIGHTTAP, is_motion_mode_switchable = 0;
  int use_ref_frame_mvs = 0, reference_select = 0, skip_mode_present = 0;
  int skip_mode_frame[2] = {0, 0}, allow_warped_motion = 0;
  int disable_frame_end_update_cdf = 1, context_update_tile_id = 0;
  int render_w = 0, render_h = 0, existing_slot = 0;
  int seg_update_map = 0, seg_temporal_update = 0;
  int lf_mode_deltas[2] = {0, 0};
  int gm_type[8] = {0}, gm_params[8][6], prev_gm_params[8][6];
  int x_scale[8] = {0}, y_scale[8] = {0};    // per reference frame
  Cdfs frame_cdf, saved_cdf;
  // what the stream used (native._av1's counts past the palette ones)
  int inter_frames = 0, shown_existing = 0, inter_blocks = 0,
      compound_blocks = 0, obmc_blocks = 0, warp_blocks = 0,
      interintra_blocks = 0, scaled_blocks = 0,
      temporal_mvs = 0, dual_filter_blocks = 0,
      wedge_blocks = 0, diffwtd_blocks = 0, distance_blocks = 0,
      wedge_interintra_blocks = 0, frames = 0, scaled_compound_blocks = 0,
      global_warp_blocks = 0, global_shift_blocks = 0, grey_slots = 0,
      grey_blocks = 0;

  // frame header
  int frame_w = 0, frame_h = 0, mi_cols = 0, mi_rows = 0;
  int disable_cdf_update = 0, allow_screen_content_tools = 0,
      allow_intrabc = 0;
  int base_q_idx = 0, dq_y_dc = 0, dq_u_dc = 0, dq_u_ac = 0, dq_v_dc = 0,
      dq_v_ac = 0;
  int seg_enabled = 0, feature_enabled[8][8] = {{0}},
      feature_data[8][8] = {{0}};
  int seg_id_pre_skip = 0, last_active_seg_id = 0;
  int delta_q_present = 0, delta_q_res = 0, delta_lf_present = 0,
      delta_lf_res = 0, delta_lf_multi = 0;
  int coded_lossless = 0, lossless_array[8] = {0};
  int using_qmatrix = 0, qm_y = 15, qm_u = 15, qm_v = 15;
  int lf_level[4] = {0}, lf_sharpness = 0, lf_delta_enabled = 0;
  int lf_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1};
  int cdef_damping = 3, cdef_bits = 0;
  int cdef_y_pri[8] = {0}, cdef_y_sec[8] = {0}, cdef_uv_pri[8] = {0},
      cdef_uv_sec[8] = {0};
  int tx_mode = 0, reduced_tx_set = 0;
  int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0;
  int mi_col_starts[65] = {0}, mi_row_starts[65] = {0};
  int tile_size_bytes = 4;
  bool have_frame = false, frame_done = false;
  int next_tile = 0;
  // superres: frame_w is the coded (downscaled) width
  int upscaled_w = 0, superres_denom = SUPERRES_NUM;
  // loop restoration: per plane the frame's type, the unit size and the
  // units' types and coefficients
  int lr_frame_type[3] = {RESTORE_NONE, RESTORE_NONE, RESTORE_NONE};
  int lr_size[3] = {0}, lr_rows[3] = {0}, lr_cols[3] = {0};
  std::vector<LrUnit> lr_units[3];
  FilmGrain grain;

  // the frame
  Plane cur[3];
  int mi_stride = 0;
  // tx_sizes holds the specification's InterTxSizes: an intra block's
  // TxSize, an inter block's transform at each mi
  std::vector<uint8_t> y_modes, uv_modes, mi_sizes, skips, tx_sizes,
      seg_ids;
  // palettes: per mi an index into palettes (-1 for none); a palette is
  // its Y and U sizes, then 8 Y and 8 U colours (what later blocks'
  // caches read)
  struct Palette {
    int size[2];
    uint16_t colors[2][PALETTE_MAX_SIZE];
  };
  std::vector<int32_t> palette_at;
  std::vector<Palette> palettes;
  // per mi: whether the block is inter (or intra block copy), its two
  // reference frames, vectors ([list][row, column] in 1/8 samples) and
  // interpolation filters ([0] vertical, [1] horizontal), skip_mode,
  // comp_group_idx and compound_idx
  std::vector<uint8_t> is_inters, interps, skip_modes, comp_group_idxs,
      compound_idxs;
  std::vector<int8_t> ref_frames;
  std::vector<int16_t> mvs;
  // the segment ids of the primary reference frame (empty: all 0)
  std::vector<uint8_t> prev_seg_ids;
  // the projected motion field (libaom's tpl_mvs) per 8x8: a vector of
  // its source frame (-32768 where none) and that frame's distance to
  // its reference
  std::vector<int16_t> mf_mv;
  std::vector<int8_t> mf_offset;
  // what the stream used: blocks with a Y and a UV palette, the palette
  // sizes (bit n for n colours), intra block copy blocks, those whose
  // reference vector was the default one
  int palette_y_blocks = 0, palette_uv_blocks = 0, palette_sizes = 0,
      intrabc_blocks = 0, intrabc_default_dv = 0;
  std::vector<int8_t> delta_lfs;          // 4 per mi
  std::vector<int8_t> cdef_idx;           // per 64x64
  int cdef_stride = 0;
  std::vector<uint8_t> lf_tx[3];          // per 4x4 of each plane
  int lf_stride[3] = {0};

  // tile state
  Cdfs cdf;
  Symbols sym;
  int mi_row_start = 0, mi_row_end = 0, mi_col_start = 0, mi_col_end = 0;
  int current_q = 0;
  int delta_lf[4] = {0};
  bool read_deltas = false;
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
  uint8_t block_decoded[3][34][34];   // [-1..32] offset by 1
  int ref_lr_wiener[3][2][3] = {{{0}}}, ref_sgr_xqd[3][2] = {{0}};

  // block state
  int mi_row = 0, mi_col = 0, mi_size = 0, has_chroma = 0;
  bool avail_u = false, avail_l = false, avail_u_chroma = false,
       avail_l_chroma = false;
  int skip = 0, segment_id = 0, lossless = 0, y_mode = 0, uv_mode = 0;
  int angle_delta_y = 0, angle_delta_uv = 0, use_filter_intra = 0,
      filter_intra_mode = 0, cfl_alpha_u = 0, cfl_alpha_v = 0, tx_size = 0;
  int max_luma_w = 0, max_luma_h = 0;
  int is_inter = 0, partition = 0, use_intrabc = 0;
  int ref_frame[2] = {INTRA_FRAME, NONE_FRAME}, mvb[2][2] = {{0}};
  int skip_mode = 0, interp[2] = {0, 0}, motion_mode = SIMPLE;
  int interintra = 0, interintra_mode = 0, wedge_interintra = 0;
  int wedge_index = 0, wedge_sign = 0, mask_type = 0;
  int compound_type = COMPOUND_AVERAGE, comp_group_idx = 0, compound_idx = 1;
  int ref_mv_idx = 0;
  Palette pal{};                          // this block's
  uint16_t v_colors[PALETTE_MAX_SIZE] = {0};
  uint8_t color_map[2][64 * 64];          // Y, UV: 64 wide

  std::vector<uint8_t> tx_types;          // per mi (luma 4x4)
  int plane_tx_type = 0;
  int32_t quant[1024];

  // -------------------------------------------------------------------------
  // headers

  void color_config(BitReader& r) {
    const int high = r.f(1);
    if (seq_profile == 2 && high) bit_depth = r.f(1) ? 12 : 10;
    else bit_depth = high ? 10 : 8;
    mono = seq_profile == 1 ? 0 : r.f(1);
    num_planes = mono ? 1 : 3;
    if (r.f(1)) {
      color_primaries = r.f(8);
      transfer = r.f(8);
      matrix = r.f(8);
    } else {
      color_primaries = transfer = matrix = 2;
    }
    if (mono) {
      color_range = r.f(1);
      ssx = ssy = 1;
      separate_uv_delta_q = 0;
      return;
    }
    if (color_primaries == 1 && transfer == 13 && matrix == 0) {
      color_range = 1;
      ssx = ssy = 0;
    } else {
      color_range = r.f(1);
      if (seq_profile == 0) ssx = ssy = 1;
      else if (seq_profile == 1) ssx = ssy = 0;
      else if (bit_depth == 12) {
        ssx = r.f(1);
        ssy = ssx ? r.f(1) : 0;
      } else {
        ssx = 1;
        ssy = 0;
      }
      if (ssx && ssy) r.f(2);     // chroma_sample_position
    }
    separate_uv_delta_q = r.f(1);
  }

  // libaom refuses the levels the specification leaves undefined (2.2,
  // 2.3, 3.2, 3.3, 4.2, 4.3, 7.x and 24..30)
  static int check_level(int level) {
    const bool ok = level == 31 || (level < 20 && level != 2 && level != 3 &&
                                    level != 6 && level != 7 && level != 10 &&
                                    level != 11);
    if (!ok)
      fail("the AV1 stream names the undefined level " +
           std::to_string(level) + " (cv2 refuses it)");
    return level;
  }

  void sequence_header(BitReader& r) {
    seq_profile = r.f(3);
    if (seq_profile > 2) fail("the AV1 stream has a reserved profile");
    const int still_picture = r.f(1);
    reduced = r.f(1);
    if (reduced && !still_picture)
      fail("the AV1 stream has a reduced header for a video (cv2 refuses "
           "it)");
    if (reduced) {
      timing_info = decoder_model_info = 0;
      op_cnt = 1;
      op_idc[0] = 0;
      check_level(r.f(5));
    } else {
      timing_info = r.f(1);
      if (timing_info) {
        r.f(32);
        r.f(32);
        equal_picture_interval = r.f(1);
        if (equal_picture_interval) r.uvlc();
        decoder_model_info = r.f(1);
        if (decoder_model_info) {
          buffer_delay_length = r.f(5) + 1;
          r.f(32);
          buffer_removal_time_length = r.f(5) + 1;
          frame_presentation_time_length = r.f(5) + 1;
        }
      } else {
        decoder_model_info = 0;
      }
      const int initial_display_delay = r.f(1);
      op_cnt = r.f(5) + 1;
      for (int i = 0; i < op_cnt; ++i) {
        op_idc[i] = r.f(12);
        const int level = check_level(r.f(5));
        if (level > 7) r.f(1);
        decoder_model_present[i] = 0;
        if (decoder_model_info) {
          decoder_model_present[i] = r.f(1);
          if (decoder_model_present[i]) {
            r.f(buffer_delay_length);
            r.f(buffer_delay_length);
            r.f(1);
          }
        }
        if (initial_display_delay && r.f(1)) r.f(4);
      }
    }
    // libaom decodes operating point 0 where the one asked for is absent
    op_idc_cur = op_idc[operating_point >= 0 && operating_point < op_cnt
                            ? operating_point : 0];
    frame_width_bits = r.f(4) + 1;
    frame_height_bits = r.f(4) + 1;
    max_w = r.f(frame_width_bits) + 1;
    max_h = r.f(frame_height_bits) + 1;
    frame_id_numbers_present = reduced ? 0 : r.f(1);
    if (frame_id_numbers_present) {
      delta_frame_id_length = r.f(4) + 2;
      additional_frame_id_length = r.f(3) + 1;
    }
    use_128 = r.f(1);
    enable_filter_intra = r.f(1);
    enable_intra_edge_filter = r.f(1);
    if (reduced) {
      enable_order_hint = 0;
      seq_force_screen_content_tools = 2;
      seq_force_integer_mv = 2;
      order_hint_bits = 0;
    } else {
      enable_interintra_compound = r.f(1);
      enable_masked_compound = r.f(1);
      enable_warped_motion = r.f(1);
      enable_dual_filter = r.f(1);
      enable_order_hint = r.f(1);
      if (enable_order_hint) {
        enable_jnt_comp = r.f(1);
        enable_ref_frame_mvs = r.f(1);
      }
      seq_force_screen_content_tools = r.f(1) ? 2 : r.f(1);
      if (seq_force_screen_content_tools > 0)
        seq_force_integer_mv = r.f(1) ? 2 : r.f(1);
      else
        seq_force_integer_mv = 2;
      order_hint_bits = enable_order_hint ? r.f(3) + 1 : 0;
    }
    enable_superres = r.f(1);
    enable_cdef = r.f(1);
    enable_restoration = r.f(1);
    color_config(r);
    film_grain_params_present = r.f(1);
    r.trailing_bits();
    have_seq = true;
  }

  int get_relative_dist(int a, int b) const {
    if (!enable_order_hint) return 0;
    const int diff = a - b, m = 1 << (order_hint_bits - 1);
    return (diff & (m - 1)) - (diff & m);
  }

  // uncompressed_header (spec 5.9.2), every frame type; a frame shown
  // from a reference slot returns after its index
  void frame_header(BitReader& r, int temporal_id, int spatial_id) {
    if (!have_seq)
      fail("the AV1 stream has a frame before its sequence header");
    frame_spatial_id = spatial_id;
    const int id_len = frame_id_numbers_present
                           ? additional_frame_id_length + delta_frame_id_length
                           : 0;
    show_existing_frame = 0;
    if (reduced) {
      frame_type = KEY_FRAME;
      frame_is_intra = show_frame = error_resilient_mode = 1;
      showable_frame = 0;
    } else {
      show_existing_frame = r.f(1);
      if (show_existing_frame) {
        const int idx = r.f(3);
        if (decoder_model_info && !equal_picture_interval)
          r.f(frame_presentation_time_length);
        const int display_frame_id = frame_id_numbers_present ? r.f(id_len) : 0;
        const RefSlot& slot = refs[idx];
        refuse_grey(slot, "shows again");
        // assign_frame_buffer_p: the frame's own buffer back, the slot's
        // taken
        release_fb(cur_fb);
        cur_fb = slot.fb;
        if (cur_fb >= 0) ++pool[cur_fb].ref;
        if (!slot.valid || !slot.showable)
          fail("the AV1 stream shows a reference slot that holds no "
               "showable frame (cv2 refuses it)");
        if (frame_id_numbers_present && display_frame_id != slot.frame_id)
          fail("the AV1 stream's frame ids do not match its reference "
               "slots (cv2 refuses it)");
        frame_type = slot.frame_type;
        refresh_frame_flags = frame_type == KEY_FRAME ? 0xFF : 0;
        existing_slot = idx;
        return;
      }
      frame_type = r.f(2);
      show_frame = r.f(1);
      if (show_frame && decoder_model_info && !equal_picture_interval)
        r.f(frame_presentation_time_length);
      showable_frame = show_frame ? frame_type != KEY_FRAME : r.f(1);
      error_resilient_mode =
          frame_type == SWITCH_FRAME || (frame_type == KEY_FRAME && show_frame)
              ? 1 : r.f(1);
    }
    frame_is_intra = frame_type == INTRA_ONLY_FRAME || frame_type == KEY_FRAME;
    if (frame_type == KEY_FRAME && show_frame) {
      for (RefSlot& slot : refs) {
        slot.valid = false;
        slot.order_hint = 0;
      }
      for (int i = LAST_FRAME; i <= ALTREF_FRAME; ++i) order_hints[i] = 0;
    }
    disable_cdf_update = r.f(1);
    allow_screen_content_tools = seq_force_screen_content_tools == 2
                                     ? r.f(1) : seq_force_screen_content_tools;
    force_integer_mv = 0;
    if (allow_screen_content_tools)
      force_integer_mv = seq_force_integer_mv == 2 ? r.f(1)
                                                   : seq_force_integer_mv;
    if (frame_is_intra) force_integer_mv = 1;
    if (frame_id_numbers_present) frame_ids(r, id_len);
    const int frame_size_override = frame_type == SWITCH_FRAME ? 1
                                    : reduced                 ? 0
                                                              : r.f(1);
    order_hint = r.f(order_hint_bits);
    primary_ref_frame = frame_is_intra || error_resilient_mode
                            ? PRIMARY_REF_NONE : r.f(3);
    if (decoder_model_info) {
      if (r.f(1)) {                   // buffer_removal_time_present_flag
        for (int op = 0; op < op_cnt; ++op) {
          if (!decoder_model_present[op]) continue;
          const int idc = op_idc[op];
          const int in_t = (idc >> temporal_id) & 1;
          const int in_s = (idc >> (spatial_id + 8)) & 1;
          if (idc == 0 || (in_t && in_s)) r.f(buffer_removal_time_length);
        }
      }
    }
    allow_high_precision_mv = use_ref_frame_mvs = allow_intrabc = 0;
    refresh_frame_flags =
        frame_type == SWITCH_FRAME || (frame_type == KEY_FRAME && show_frame)
            ? 0xFF : r.f(8);
    if (frame_type == INTRA_ONLY_FRAME && refresh_frame_flags == 0xFF)
      fail("the AV1 stream has an intra-only frame that refreshes every "
           "reference slot (cv2 refuses it)");
    if ((!frame_is_intra || refresh_frame_flags != 0xFF) &&
        error_resilient_mode && enable_order_hint)
      for (int i = 0; i < NUM_REF_FRAMES; ++i) {
        const int hint = int(r.f(order_hint_bits));
        if (hint != refs[i].order_hint || !refs[i].held) fill_grey(i, hint);
      }
    if (frame_is_intra) {
      frame_size(r, frame_size_override);
      render_size(r);
      allow_intrabc = allow_screen_content_tools && upscaled_w == frame_w
                          ? r.f(1) : 0;
    } else {
      const int short_signaling = enable_order_hint ? r.f(1) : 0;
      if (short_signaling) {
        const int last = r.f(3), gold = r.f(3);
        set_frame_refs(last, gold);
      }
      for (int i = 0; i < REFS_PER_FRAME; ++i) {
        if (!short_signaling) ref_frame_idx[i] = r.f(3);
        if (frame_id_numbers_present) {
          const int delta = r.f(delta_frame_id_length) + 1;
          const int expected = (current_frame_id - delta + (1 << id_len)) %
                               (1 << id_len);
          if (expected != refs[ref_frame_idx[i]].frame_id)
            fail("the AV1 stream's frame ids do not match its reference "
                 "slots (cv2 refuses it)");
        }
        if (!refs[ref_frame_idx[i]].valid)
          fail("the AV1 stream's inter frame refers to an empty reference "
               "slot (cv2 refuses it)");
      }
      if (frame_size_override && !error_resilient_mode) {
        frame_size_with_refs(r);
      } else {
        frame_size(r, frame_size_override);
        render_size(r);
      }
      allow_high_precision_mv = force_integer_mv ? 0 : r.f(1);
      interpolation_filter = r.f(1) ? SWITCHABLE : int(r.f(2));
      is_motion_mode_switchable = r.f(1);
      use_ref_frame_mvs = error_resilient_mode || !enable_ref_frame_mvs
                              ? 0 : r.f(1);
      for (int i = 0; i < REFS_PER_FRAME; ++i) {
        const int ref = LAST_FRAME + i;
        const RefSlot& slot = refs[ref_frame_idx[i]];
        order_hints[ref] = slot.order_hint;
        sign_bias[ref] = enable_order_hint &&
                         get_relative_dist(slot.order_hint, order_hint) > 0;
        if (slot.bit_depth != bit_depth || slot.ssx != ssx || slot.ssy != ssy)
          fail("the AV1 stream's inter frame refers to a frame of another "
               "format (cv2 refuses it)");
        // libaom's valid_ref_frame_size and scale factors
        if (2 * frame_w < slot.upscaled_w || 2 * frame_h < slot.frame_h ||
            frame_w > 16 * slot.upscaled_w || frame_h > 16 * slot.frame_h)
          fail("the AV1 stream's inter frame refers to a frame of an "
               "invalid size (cv2 refuses it)");
        x_scale[ref] = ((slot.upscaled_w << REF_SCALE_SHIFT) + frame_w / 2) /
                       frame_w;
        y_scale[ref] = ((slot.frame_h << REF_SCALE_SHIFT) + frame_h / 2) /
                       frame_h;
      }
    }
    if (int64_t(upscaled_w) * frame_h > (int64_t(1) << 30))   // cv2's limit
      fail("a " + std::to_string(upscaled_w) + "x" + std::to_string(frame_h) +
           " frame, larger than cv2 reads");
    disable_frame_end_update_cdf = reduced || disable_cdf_update ? 1 : r.f(1);
    if (primary_ref_frame == PRIMARY_REF_NONE) {
      frame_cdf.init_non_coeff();
      setup_past_independence();
    } else {
      const RefSlot& prev = refs[ref_frame_idx[primary_ref_frame]];
      refuse_grey(prev, "takes its primary reference frame from");
      if (prev.blank)
        fail("the AV1 stream's primary reference frame has no entropy "
             "context (cv2 refuses it)");
      if (prev.cdf) frame_cdf = *prev.cdf;
      std::memcpy(prev_gm_params, prev.gm_params, sizeof(prev_gm_params));
      std::memcpy(lf_ref_deltas, prev.lf_ref_deltas, sizeof(lf_ref_deltas));
      std::memcpy(lf_mode_deltas, prev.lf_mode_deltas, sizeof(lf_mode_deltas));
      std::memcpy(feature_enabled, prev.feature_enabled,
                  sizeof(feature_enabled));
      std::memcpy(feature_data, prev.feature_data, sizeof(feature_data));
    }
    tile_info(r);
    quantization_params(r);
    segmentation_params(r);
    delta_q_present = 0;
    delta_q_res = 0;
    if (base_q_idx > 0) delta_q_present = r.f(1);
    if (delta_q_present) delta_q_res = r.f(2);
    delta_lf_present = delta_lf_res = delta_lf_multi = 0;
    if (delta_q_present) {
      if (!allow_intrabc) delta_lf_present = r.f(1);
      if (delta_lf_present) {
        delta_lf_res = r.f(2);
        delta_lf_multi = r.f(1);
      }
    }
    if (primary_ref_frame == PRIMARY_REF_NONE) frame_cdf.init_coeff(base_q_idx);
    coded_lossless = 1;
    for (int s = 0; s < MAX_SEGMENTS; ++s) {
      const int q = qindex(true, s);
      lossless_array[s] = q == 0 && dq_y_dc == 0 && dq_u_ac == 0 &&
                          dq_u_dc == 0 && dq_v_ac == 0 && dq_v_dc == 0;
      if (!lossless_array[s]) coded_lossless = 0;
    }
    loop_filter_params(r);
    cdef_params(r);
    lr_params(r);
    tx_mode = coded_lossless ? ONLY_4X4
              : r.f(1)       ? TX_MODE_SELECT
                             : TX_MODE_LARGEST;
    reference_select = frame_is_intra ? 0 : r.f(1);
    skip_mode_params(r);
    allow_warped_motion = frame_is_intra || error_resilient_mode ||
                                  !enable_warped_motion
                              ? 0 : r.f(1);
    reduced_tx_set = r.f(1);
    gm_bits[0] = int(r.pos);
    global_motion_params(r);
    gm_bits[1] = int(r.pos);
    film_grain_params(r);
    have_frame = true;
  }

  // current_frame_id and libaom's checks: a frame id other than the last
  // and less than half the range ahead of it; slots whose ids fall
  // outside the delta's reach no longer valid
  bool had_frame_id = false;
  void frame_ids(BitReader& r, int id_len) {
    const bool have_prev = had_frame_id && !(frame_type == KEY_FRAME && show_frame);
    const int prev = current_frame_id;
    current_frame_id = r.f(id_len);
    had_frame_id = true;
    if (have_prev) {
      const int diff = current_frame_id > prev
                           ? current_frame_id - prev
                           : (1 << id_len) + current_frame_id - prev;
      if (prev == current_frame_id || diff >= (1 << (id_len - 1)))
        fail("the AV1 stream has an invalid frame id (cv2 refuses it)");
    }
    const int reach = 1 << delta_frame_id_length;
    for (RefSlot& slot : refs) {
      const int id = slot.frame_id;
      if (current_frame_id - reach > 0) {
        if (id > current_frame_id || id < current_frame_id - reach) slot.valid = false;
      } else if (id > current_frame_id &&
                 id < (1 << id_len) + current_frame_id - reach) {
        slot.valid = false;
      }
    }
  }

  // libaom's frame buffers (BufferPool's frame_bufs, FRAME_BUFFERS of
  // them, zeros at first): each one's reference count and the state of
  // the frame last decoded into it.  A frame takes the first free buffer
  // (get_free_fb); the slots it refreshes and the output frame (the
  // last shown, output_all_layers off) hold references, as
  // update_frame_buffers and assign_frame_buffer_p count them.  Only a
  // slot filled in for a lost frame shows which buffer a frame got.
  struct PoolBuf {
    int ref = 0;
    std::shared_ptr<RefSlot> state;     // null: never used
  };
  static constexpr int FRAME_BUFFERS = 16;
  PoolBuf pool[FRAME_BUFFERS];
  int cur_fb = -1, out_fb = -1;

  int get_free_fb() {
    for (int i = 0; i < FRAME_BUFFERS; ++i)
      if (pool[i].ref == 0) {
        pool[i].ref = 1;
        return i;
      }
    fail("the AV1 stream holds more frames than libaom's buffers (cv2 "
         "refuses it)");
  }

  void release_fb(int fb) {
    if (fb >= 0) --pool[fb].ref;
  }

  // libaom's slot for a lost frame (ref_order_hint[i] unlike the slot's,
  // or an empty slot, in an error-resilient frame): the slot's buffer
  // released, the first free one taken and filled with a frame of the
  // sequence's largest size, every plane at 1 << (BitDepth - 1), the
  // order hint given; its frame id and validity for referencing stay the
  // slot's.  The rest of its state (frame type, motion field, entropy
  // context, global motion, loop filter deltas, segmentation, film grain,
  // showable) is that of the frame the buffer held before, or blank.
  // Under an lsel (libavif asks libaom for every layer, whose output
  // frames hold buffers longer) a frame that reads that state is
  // refused by name.
  void fill_grey(int i, int hint) {
    if (refs[i].held) release_fb(refs[i].fb);
    const int fb = get_free_fb();
    RefSlot g;
    if (pool[fb].state) {
      g = *pool[fb].state;
    } else {
      g.blank = true;
      std::fill(g.lf_ref_deltas, g.lf_ref_deltas + 8, 0);
      g.grain.scaling_shift = 0;
    }
    g.valid = refs[i].valid;
    g.frame_id = refs[i].frame_id;
    g.held = g.grey = true;
    g.fb = fb;
    g.order_hint = hint;
    g.upscaled_w = g.frame_w = max_w;
    g.frame_h = max_h;
    g.bit_depth = bit_depth;
    g.ssx = ssx;
    g.ssy = ssy;
    if (int64_t(max_w) * max_h > (int64_t(1) << 30))      // cv2's limit
      fail("a lost frame's " + std::to_string(max_w) + "x" +
           std::to_string(max_h) + " slot, larger than cv2 reads");
    g.buf = std::make_shared<FrameBuf>();
    for (int p = 0; p < num_planes; ++p) {
      const int sx = p ? ssx : 0, sy = p ? ssy : 0;
      Plane& P = g.buf->planes[p];
      P.stride = (max_w + sx) >> sx;
      P.rows = (max_h + sy) >> sy;
      P.px.assign(size_t(P.stride) * P.rows, uint16_t(1 << (bit_depth - 1)));
    }
    refs[i] = g;
    pool[fb].state = std::make_shared<RefSlot>(g);
    ++grey_slots;
  }

  void refuse_grey(const RefSlot& slot, const char* use) const {
    if (slot.grey && select_layer >= 0)
      fail(std::string("the AV1 stream ") + use +
           " a reference slot filled in for a lost frame under an lsel, "
           "which the port does not read");
  }

  void frame_size(BitReader& r, int override_flag) {
    if (override_flag) {
      frame_w = r.f(frame_width_bits) + 1;
      frame_h = r.f(frame_height_bits) + 1;
      if (frame_w > max_w || frame_h > max_h)
        fail("the AV1 stream has a frame larger than its sequence header's "
             "(cv2 refuses it)");
    } else {
      frame_w = max_w;
      frame_h = max_h;
    }
    superres_params(r);
    mi_cols = 2 * ((frame_w + 7) >> 3);
    mi_rows = 2 * ((frame_h + 7) >> 3);
  }

  void render_size(BitReader& r) {
    if (r.f(1)) {
      render_w = r.f(16) + 1;
      render_h = r.f(16) + 1;
    } else {
      render_w = upscaled_w;
      render_h = frame_h;
    }
  }

  void frame_size_with_refs(BitReader& r) {
    for (int i = 0; i < REFS_PER_FRAME; ++i) {
      if (!r.f(1)) continue;
      const RefSlot& slot = refs[ref_frame_idx[i]];
      frame_w = slot.upscaled_w;
      frame_h = slot.frame_h;
      render_w = slot.render_w;
      render_h = slot.render_h;
      superres_params(r);
      mi_cols = 2 * ((frame_w + 7) >> 3);
      mi_rows = 2 * ((frame_h + 7) >> 3);
      return;
    }
    frame_size(r, 1);
    render_size(r);
  }

  // spec 7.8: the references of frame_refs_short_signaling
  void set_frame_refs(int last_idx, int gold_idx) {
    for (int& i : ref_frame_idx) i = -1;
    ref_frame_idx[0] = last_idx;
    ref_frame_idx[GOLDEN_FRAME - LAST_FRAME] = gold_idx;
    bool used[8] = {false};
    used[last_idx] = used[gold_idx] = true;
    const int cur = 1 << (order_hint_bits - 1);
    int shifted[8];
    for (int i = 0; i < 8; ++i)
      shifted[i] = cur + get_relative_dist(refs[i].order_hint, order_hint);
    if (shifted[last_idx] >= cur || shifted[gold_idx] >= cur)
      fail("the AV1 stream's short reference signalling names a later frame "
           "(cv2 refuses it)");
    auto pick = [&](bool backward, bool latest) {
      int ref = -1, best = 0;
      for (int i = 0; i < 8; ++i) {
        const int h = shifted[i];
        if (used[i] || (backward ? h < cur : h >= cur)) continue;
        if (ref < 0 || (latest ? h >= best : h < best)) {
          ref = i;
          best = h;
        }
      }
      return ref;
    };
    int ref = pick(true, true);
    if (ref >= 0) {
      ref_frame_idx[ALTREF_FRAME - LAST_FRAME] = ref;
      used[ref] = true;
    }
    ref = pick(true, false);
    if (ref >= 0) {
      ref_frame_idx[BWDREF_FRAME - LAST_FRAME] = ref;
      used[ref] = true;
    }
    ref = pick(true, false);
    if (ref >= 0) {
      ref_frame_idx[ALTREF2_FRAME - LAST_FRAME] = ref;
      used[ref] = true;
    }
    static const int kRefList[5] = {LAST2_FRAME, LAST3_FRAME, BWDREF_FRAME,
                                    ALTREF2_FRAME, ALTREF_FRAME};
    for (int f : kRefList)
      if (ref_frame_idx[f - LAST_FRAME] < 0) {
        ref = pick(false, true);
        if (ref >= 0) {
          ref_frame_idx[f - LAST_FRAME] = ref;
          used[ref] = true;
        }
      }
    ref = -1;
    int earliest = 0;
    for (int i = 0; i < 8; ++i)
      if (ref < 0 || shifted[i] < earliest) {
        ref = i;
        earliest = shifted[i];
      }
    for (int& i : ref_frame_idx)
      if (i < 0) i = ref;
  }

  void setup_past_independence() {
    std::memset(feature_enabled, 0, sizeof(feature_enabled));
    std::memset(feature_data, 0, sizeof(feature_data));
    for (int ref = LAST_FRAME; ref <= ALTREF_FRAME; ++ref)
      for (int i = 0; i < 6; ++i)
        prev_gm_params[ref][i] = i % 3 == 2 ? 1 << WARPEDMODEL_PREC_BITS : 0;
    static const int kDefaults[8] = {1, 0, 0, 0, -1, 0, -1, -1};
    std::memcpy(lf_ref_deltas, kDefaults, sizeof(lf_ref_deltas));
    lf_mode_deltas[0] = lf_mode_deltas[1] = 0;
  }

  // spec 5.9.22
  void skip_mode_params(BitReader& r) {
    skip_mode_present = 0;
    if (frame_is_intra || !reference_select || !enable_order_hint) return;
    int fwd = -1, bwd = -1, fwd_hint = 0, bwd_hint = 0;
    for (int i = 0; i < REFS_PER_FRAME; ++i) {
      const int h = refs[ref_frame_idx[i]].order_hint;
      if (get_relative_dist(h, order_hint) < 0) {
        if (fwd < 0 || get_relative_dist(h, fwd_hint) > 0) {
          fwd = i;
          fwd_hint = h;
        }
      } else if (get_relative_dist(h, order_hint) > 0) {
        if (bwd < 0 || get_relative_dist(h, bwd_hint) < 0) {
          bwd = i;
          bwd_hint = h;
        }
      }
    }
    if (fwd < 0) return;
    if (bwd >= 0) {
      skip_mode_frame[0] = LAST_FRAME + std::min(fwd, bwd);
      skip_mode_frame[1] = LAST_FRAME + std::max(fwd, bwd);
    } else {
      int fwd2 = -1, fwd2_hint = 0;
      for (int i = 0; i < REFS_PER_FRAME; ++i) {
        const int h = refs[ref_frame_idx[i]].order_hint;
        if (get_relative_dist(h, fwd_hint) < 0 &&
            (fwd2 < 0 || get_relative_dist(h, fwd2_hint) > 0)) {
          fwd2 = i;
          fwd2_hint = h;
        }
      }
      if (fwd2 < 0) return;
      skip_mode_frame[0] = LAST_FRAME + std::min(fwd, fwd2);
      skip_mode_frame[1] = LAST_FRAME + std::max(fwd, fwd2);
    }
    skip_mode_present = r.f(1);
  }

  // spec 5.9.24: each reference's global motion against the primary
  // reference frame's
  void global_motion_params(BitReader& r) {
    for (int ref = LAST_FRAME; ref <= ALTREF_FRAME; ++ref) {
      gm_type[ref] = IDENTITY;
      for (int i = 0; i < 6; ++i)
        gm_params[ref][i] = i % 3 == 2 ? 1 << WARPEDMODEL_PREC_BITS : 0;
    }
    if (frame_is_intra) return;
    for (int ref = LAST_FRAME; ref <= ALTREF_FRAME; ++ref) {
      int type = IDENTITY;
      if (r.f(1)) {
        if (r.f(1)) type = ROTZOOM;
        else type = r.f(1) ? TRANSLATION : AFFINE;
      }
      gm_type[ref] = type;
      if (type >= ROTZOOM) {
        read_global_param(r, type, ref, 2);
        read_global_param(r, type, ref, 3);
        if (type == AFFINE) {
          read_global_param(r, type, ref, 4);
          read_global_param(r, type, ref, 5);
        } else {
          gm_params[ref][4] = -gm_params[ref][3];
          gm_params[ref][5] = gm_params[ref][2];
        }
      }
      if (type >= TRANSLATION) {
        read_global_param(r, type, ref, 0);
        read_global_param(r, type, ref, 1);
      }
    }
  }

  void read_global_param(BitReader& r, int type, int ref, int idx) {
    int abs_bits = GM_ABS_ALPHA_BITS, prec_bits = GM_ALPHA_PREC_BITS;
    if (idx < 2) {
      if (type == TRANSLATION) {
        abs_bits = GM_ABS_TRANS_ONLY_BITS - !allow_high_precision_mv;
        prec_bits = GM_TRANS_ONLY_PREC_BITS - !allow_high_precision_mv;
      } else {
        abs_bits = GM_ABS_TRANS_BITS;
        prec_bits = GM_TRANS_PREC_BITS;
      }
    }
    const int prec_diff = WARPEDMODEL_PREC_BITS - prec_bits;
    const int round = idx % 3 == 2 ? 1 << WARPEDMODEL_PREC_BITS : 0;
    const int sub = idx % 3 == 2 ? 1 << prec_bits : 0;
    const int mx = 1 << abs_bits;
    const int ref_v = (prev_gm_params[ref][idx] >> prec_diff) - sub;
    // decode_signed_subexp_with_ref (spec 5.9.26..28) on the header's bits
    const int low = -mx, high = mx + 1;
    const int num = high - low, rr = ref_v - low;
    int i = 0, mk = 0, v;
    while (true) {
      const int b2 = i ? 3 + i - 1 : 3, a = 1 << b2;
      if (num <= mk + 3 * a) {
        v = static_cast<int>(r.ns(num - mk)) + mk;
        break;
      }
      if (!r.f(1)) {
        v = static_cast<int>(r.f(b2)) + mk;
        break;
      }
      ++i;
      mk += a;
    }
    const int x = (rr << 1) <= num ? inverse_recenter(rr, v)
                                   : num - 1 - inverse_recenter(num - 1 - rr, v);
    gm_params[ref][idx] = (x + low) * (1 << prec_diff) + round;
  }

  // spec 5.9.8: the coded width from the upscaled one
  void superres_params(BitReader& r) {
    superres_denom = SUPERRES_NUM;
    if (enable_superres && r.f(1)) superres_denom = r.f(3) + SUPERRES_DENOM_MIN;
    upscaled_w = frame_w;
    if (superres_denom != SUPERRES_NUM) {
      const int min_w = std::min(16, upscaled_w);
      frame_w = std::max(
          min_w, static_cast<int>((int64_t(upscaled_w) * SUPERRES_NUM +
                                   superres_denom / 2) / superres_denom));
    }
  }

  // spec 5.9.20
  void lr_params(BitReader& r) {
    for (int& t : lr_frame_type) t = RESTORE_NONE;
    const bool all_lossless = coded_lossless && frame_w == upscaled_w;
    if (all_lossless || allow_intrabc || !enable_restoration) return;
    bool uses_lr = false, uses_chroma_lr = false;
    for (int p = 0; p < num_planes; ++p) {
      lr_frame_type[p] = kRemapLrType[r.f(2)];
      if (lr_frame_type[p] != RESTORE_NONE) {
        uses_lr = true;
        uses_chroma_lr |= p > 0;
      }
    }
    if (!uses_lr) return;
    int shift = r.f(1);
    if (use_128) ++shift;
    else if (shift) shift += r.f(1);
    lr_size[0] = 256 >> (2 - shift);
    const int uv_shift = ssx && ssy && uses_chroma_lr ? r.f(1) : 0;
    lr_size[1] = lr_size[2] = lr_size[0] >> uv_shift;
    for (int p = 0; p < num_planes; ++p) {
      if (lr_frame_type[p] == RESTORE_NONE) continue;
      const int sx = p ? ssx : 0, sy = p ? ssy : 0;
      lr_rows[p] = count_units(lr_size[p], (frame_h + sy) >> sy);
      lr_cols[p] = count_units(lr_size[p], (upscaled_w + sx) >> sx);
      lr_units[p].assign(size_t(lr_rows[p]) * lr_cols[p], LrUnit());
    }
  }

  static int count_units(int unit, int size) {
    return std::max((size + (unit >> 1)) / unit, 1);
  }

  // spec 5.9.30 (an inter frame may take a reference's parameters with
  // a seed of its own), with libaom's refusals of what the specification
  // forbids
  void film_grain_params(BitReader& r) {
    FilmGrain& g = grain;
    g = FilmGrain();
    if (!film_grain_params_present || (!show_frame && !showable_frame))
      return;
    g.apply = r.f(1);
    if (!g.apply) return;
    g.seed = r.f(16);
    const int update = frame_type == INTER_FRAME ? r.f(1) : 1;
    if (!update) {
      const int idx = r.f(3);
      if (std::find(ref_frame_idx, ref_frame_idx + REFS_PER_FRAME, idx) ==
          ref_frame_idx + REFS_PER_FRAME)
        fail("the AV1 stream takes film grain from a frame it does not "
             "refer to (cv2 refuses it)");
      const int seed = g.seed;
      refuse_grey(refs[idx], "takes its film grain from");
      if (refs[idx].blank)
        fail("the AV1 stream takes film grain from a frame without it "
             "(cv2 refuses it)");
      g = refs[idx].grain;
      g.seed = seed;
      return;
    }
    auto points = [&](int (*pts)[2], int n, const char* what) {
      for (int i = 0; i < n; ++i) {
        pts[i][0] = r.f(8);
        pts[i][1] = r.f(8);
        if (i && pts[i][0] <= pts[i - 1][0])
          fail(std::string("the AV1 stream's film grain ") + what +
               " points do not increase (cv2 refuses it)");
      }
    };
    g.num_y = r.f(4);
    if (g.num_y > 14)
      fail("the AV1 stream has more than 14 film grain luma points "
           "(cv2 refuses it)");
    points(g.y_pts, g.num_y, "luma");
    g.chroma_from_luma = mono ? 0 : r.f(1);
    if (!(mono || g.chroma_from_luma || (ssx && ssy && g.num_y == 0))) {
      g.num_cb = r.f(4);
      if (g.num_cb > 10)
        fail("the AV1 stream has more than 10 film grain cb points "
             "(cv2 refuses it)");
      points(g.cb_pts, g.num_cb, "cb");
      g.num_cr = r.f(4);
      if (g.num_cr > 10)
        fail("the AV1 stream has more than 10 film grain cr points "
             "(cv2 refuses it)");
      points(g.cr_pts, g.num_cr, "cr");
      if (ssx && ssy && (g.num_cb == 0) != (g.num_cr == 0))
        fail("the AV1 stream's 4:2:0 film grain has points for one chroma "
             "plane only (cv2 refuses it)");
    }
    g.scaling_shift = r.f(2) + 8;
    g.ar_lag = r.f(2);
    const int num_pos_luma = 2 * g.ar_lag * (g.ar_lag + 1);
    const int num_pos_chroma = num_pos_luma + (g.num_y ? 1 : 0);
    if (g.num_y)
      for (int i = 0; i < num_pos_luma; ++i) g.ar_y[i] = int(r.f(8)) - 128;
    if (g.chroma_from_luma || g.num_cb)
      for (int i = 0; i < num_pos_chroma; ++i) g.ar_cb[i] = int(r.f(8)) - 128;
    if (g.chroma_from_luma || g.num_cr)
      for (int i = 0; i < num_pos_chroma; ++i) g.ar_cr[i] = int(r.f(8)) - 128;
    g.ar_shift = r.f(2) + 6;
    g.grain_scale_shift = r.f(2);
    if (g.num_cb) {
      g.cb_mult = r.f(8);
      g.cb_luma_mult = r.f(8);
      g.cb_offset = r.f(9);
    }
    if (g.num_cr) {
      g.cr_mult = r.f(8);
      g.cr_luma_mult = r.f(8);
      g.cr_offset = r.f(9);
    }
    g.overlap = r.f(1);
    g.clip_restricted = r.f(1);
  }

  static int tile_log2(int blk, int target) {
    int k = 0;
    while ((blk << k) < target) ++k;
    return k;
  }

  void tile_info(BitReader& r) {
    const int sb_cols = use_128 ? (mi_cols + 31) >> 5 : (mi_cols + 15) >> 4;
    const int sb_rows = use_128 ? (mi_rows + 31) >> 5 : (mi_rows + 15) >> 4;
    const int sb_shift = use_128 ? 5 : 4, sb_size = sb_shift + 2;
    const int max_tile_width_sb = 4096 >> sb_size;
    int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
    const int min_log2_tile_cols = tile_log2(max_tile_width_sb, sb_cols);
    const int max_log2_tile_cols = tile_log2(1, std::min(sb_cols, 64));
    const int max_log2_tile_rows = tile_log2(1, std::min(sb_rows, 64));
    const int min_log2_tiles = std::max(
        min_log2_tile_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
    if (r.f(1)) {                 // uniform
      tile_cols_log2 = min_log2_tile_cols;
      while (tile_cols_log2 < max_log2_tile_cols && r.f(1)) ++tile_cols_log2;
      const int w = (sb_cols + (1 << tile_cols_log2) - 1) >> tile_cols_log2;
      int i = 0;
      for (int s = 0; s < sb_cols; s += w) mi_col_starts[i++] = s << sb_shift;
      mi_col_starts[i] = mi_cols;
      tile_cols = i;
      const int min_log2_tile_rows = std::max(min_log2_tiles - tile_cols_log2, 0);
      tile_rows_log2 = min_log2_tile_rows;
      while (tile_rows_log2 < max_log2_tile_rows && r.f(1)) ++tile_rows_log2;
      const int h = (sb_rows + (1 << tile_rows_log2) - 1) >> tile_rows_log2;
      i = 0;
      for (int s = 0; s < sb_rows; s += h) mi_row_starts[i++] = s << sb_shift;
      mi_row_starts[i] = mi_rows;
      tile_rows = i;
    } else {
      int widest = 0, s = 0, i = 0;
      for (; s < sb_cols; ++i) {
        if (i >= 64) fail("the AV1 stream has too many tile columns");
        mi_col_starts[i] = s << sb_shift;
        const int size = r.ns(std::min(sb_cols - s, max_tile_width_sb)) + 1;
        widest = std::max(widest, size);
        s += size;
      }
      mi_col_starts[i] = mi_cols;
      tile_cols = i;
      tile_cols_log2 = tile_log2(1, tile_cols);
      max_tile_area_sb = min_log2_tiles > 0
                             ? (sb_rows * sb_cols) >> (min_log2_tiles + 1)
                             : sb_rows * sb_cols;
      const int max_h = std::max(max_tile_area_sb / widest, 1);
      s = 0;
      i = 0;
      for (; s < sb_rows; ++i) {
        if (i >= 64) fail("the AV1 stream has too many tile rows");
        mi_row_starts[i] = s << sb_shift;
        s += r.ns(std::min(sb_rows - s, max_h)) + 1;
      }
      mi_row_starts[i] = mi_rows;
      tile_rows = i;
      tile_rows_log2 = tile_log2(1, tile_rows);
    }
    context_update_tile_id = 0;
    if (tile_cols_log2 > 0 || tile_rows_log2 > 0) {
      context_update_tile_id = r.f(tile_rows_log2 + tile_cols_log2);
      tile_size_bytes = r.f(2) + 1;
      if (context_update_tile_id >= tile_cols * tile_rows)
        fail("the AV1 stream's context_update_tile_id names no tile (cv2 "
             "refuses it)");
    }
  }

  static int read_delta_q(BitReader& r) { return r.f(1) ? r.su(7) : 0; }

  void quantization_params(BitReader& r) {
    base_q_idx = r.f(8);
    dq_y_dc = read_delta_q(r);
    if (num_planes > 1) {
      const int diff = separate_uv_delta_q ? r.f(1) : 0;
      dq_u_dc = read_delta_q(r);
      dq_u_ac = read_delta_q(r);
      if (diff) {
        dq_v_dc = read_delta_q(r);
        dq_v_ac = read_delta_q(r);
      } else {
        dq_v_dc = dq_u_dc;
        dq_v_ac = dq_u_ac;
      }
    }
    using_qmatrix = r.f(1);
    if (using_qmatrix) {
      qm_y = r.f(4);
      qm_u = r.f(4);
      qm_v = separate_uv_delta_q ? r.f(4) : qm_u;
    }
  }

  // spec 5.9.14: without update_data the features stay those of the
  // primary reference frame
  void segmentation_params(BitReader& r) {
    seg_enabled = r.f(1);
    seg_update_map = seg_temporal_update = 0;
    int update_data = 0;
    if (seg_enabled) {
      if (primary_ref_frame == PRIMARY_REF_NONE) {
        seg_update_map = update_data = 1;
      } else {
        seg_update_map = r.f(1);
        if (seg_update_map) seg_temporal_update = r.f(1);
        update_data = r.f(1);
      }
    }
    if (!seg_enabled || update_data) {
      std::memset(feature_enabled, 0, sizeof(feature_enabled));
      std::memset(feature_data, 0, sizeof(feature_data));
    }
    if (update_data) {
      for (int i = 0; i < MAX_SEGMENTS; ++i)
        for (int j = 0; j < SEG_LVL_MAX; ++j) {
          if (!r.f(1)) continue;
          feature_enabled[i][j] = 1;
          const int bits = kSegFeatureBits[j], lim = kSegFeatureMax[j];
          if (kSegFeatureSigned[j])
            feature_data[i][j] = clip3(-lim, lim, r.su(1 + bits));
          else
            feature_data[i][j] = clip3(0, lim, static_cast<int>(r.f(bits)));
        }
    }
    seg_id_pre_skip = 0;
    last_active_seg_id = 0;
    for (int i = 0; i < MAX_SEGMENTS; ++i)
      for (int j = 0; j < SEG_LVL_MAX; ++j)
        if (feature_enabled[i][j]) {
          last_active_seg_id = i;
          if (j >= SEG_LVL_REF_FRAME) seg_id_pre_skip = 1;
        }
  }

  void loop_filter_params(BitReader& r) {
    lf_level[0] = lf_level[1] = lf_level[2] = lf_level[3] = 0;
    if (coded_lossless || allow_intrabc) {
      static const int kDefaults[8] = {1, 0, 0, 0, -1, 0, -1, -1};
      std::memcpy(lf_ref_deltas, kDefaults, sizeof(lf_ref_deltas));
      lf_mode_deltas[0] = lf_mode_deltas[1] = 0;
      return;
    }
    lf_level[0] = r.f(6);
    lf_level[1] = r.f(6);
    if (num_planes > 1 && (lf_level[0] || lf_level[1])) {
      lf_level[2] = r.f(6);
      lf_level[3] = r.f(6);
    }
    lf_sharpness = r.f(3);
    lf_delta_enabled = r.f(1);
    if (lf_delta_enabled && r.f(1)) {
      for (int i = 0; i < 8; ++i)
        if (r.f(1)) lf_ref_deltas[i] = r.su(7);
      for (int i = 0; i < 2; ++i)
        if (r.f(1)) lf_mode_deltas[i] = r.su(7);
    }
  }

  void cdef_params(BitReader& r) {
    cdef_bits = 0;
    cdef_y_pri[0] = cdef_y_sec[0] = cdef_uv_pri[0] = cdef_uv_sec[0] = 0;
    cdef_damping = 3;
    if (coded_lossless || allow_intrabc || !enable_cdef) return;
    cdef_damping = r.f(2) + 3;
    cdef_bits = r.f(2);
    for (int i = 0; i < (1 << cdef_bits); ++i) {
      cdef_y_pri[i] = r.f(4);
      cdef_y_sec[i] = r.f(2);
      if (cdef_y_sec[i] == 3) cdef_y_sec[i] = 4;
      if (num_planes > 1) {
        cdef_uv_pri[i] = r.f(4);
        cdef_uv_sec[i] = r.f(2);
        if (cdef_uv_sec[i] == 3) cdef_uv_sec[i] = 4;
      }
    }
  }

  bool seg_active(int seg, int feature) const {
    return seg_enabled && feature_enabled[seg][feature];
  }

  int qindex(bool ignore_delta, int seg) const {
    if (seg_active(seg, SEG_LVL_ALT_Q)) {
      const int data = feature_data[seg][SEG_LVL_ALT_Q];
      int q = base_q_idx + data;
      if (!ignore_delta && delta_q_present) q = current_q + data;
      return clip3(0, 255, q);
    }
    if (!ignore_delta && delta_q_present) return current_q;
    return base_q_idx;
  }

  void allocate() {
    const int sb = use_128 ? 128 : 64;
    const int w = (mi_cols * 4 + sb - 1) / sb * sb;
    const int h = (mi_rows * 4 + sb - 1) / sb * sb;
    for (int p = 0; p < num_planes; ++p) {
      const int sx = p ? ssx : 0, sy = p ? ssy : 0;
      cur[p].stride = w >> sx;
      cur[p].rows = h >> sy;
      cur[p].px.assign(size_t(cur[p].stride) * cur[p].rows, 0);
      lf_stride[p] = (w >> sx) / 4 + 1;
      lf_tx[p].assign(size_t(lf_stride[p]) * ((h >> sy) / 4 + 1), 0);
      above_level[p].assign((w >> sx) / 4 + 32, 0);
      above_dc[p].assign((w >> sx) / 4 + 32, 0);
      left_level[p].assign((h >> sy) / 4 + 32, 0);
      left_dc[p].assign((h >> sy) / 4 + 32, 0);
    }
    mi_stride = w / 4;
    const size_t n = size_t(mi_stride) * (h / 4);
    y_modes.assign(n, 0);
    uv_modes.assign(n, 0);
    mi_sizes.assign(n, 0);
    skips.assign(n, 0);
    tx_sizes.assign(n, 0);
    seg_ids.assign(n, 0);
    tx_types.assign(n, 0);
    delta_lfs.assign(n * 4, 0);
    palette_at.assign(allow_screen_content_tools ? n : 0, -1);
    palettes.clear();
    is_inters.assign(n, 0);
    mvs.assign(4 * n, 0);
    ref_frames.assign(2 * n, 0);
    interps.assign(2 * n, 0);
    skip_modes.assign(n, 0);
    comp_group_idxs.assign(n, 0);
    compound_idxs.assign(n, 0);
    seg_preds.assign(n, 0);
    cdef_stride = w / 64;
    cdef_idx.assign(size_t(cdef_stride) * (h / 64), -1);
  }

  // -------------------------------------------------------------------------
  // tiles

  void tile_group(BitReader& r, const uint8_t* data, size_t size,
                  bool in_frame_obu) {
    if (!have_frame) fail("the AV1 stream has tile data before a frame header");
    if (frame_done) fail("the AV1 stream has tiles past the frame's last");
    const int num_tiles = tile_cols * tile_rows;
    const size_t start = r.pos;
    int tg_start = 0, tg_end = num_tiles - 1;
    if (num_tiles > 1 && r.f(1)) {
      if (in_frame_obu)
        fail("the AV1 stream's frame OBU names its tiles (cv2 refuses it)");
      const int bits = tile_cols_log2 + tile_rows_log2;
      tg_start = r.f(bits);
      tg_end = r.f(bits);
    }
    r.zero_align();
    if (tg_start != next_tile || tg_end < tg_start || tg_end >= num_tiles)
      fail("the AV1 stream's tile groups are out of order");
    size_t at = (r.pos - start) / 8;
    const uint8_t* d = data + (start / 8);
    size_t sz = size - (start / 8);
    for (int t = tg_start; t <= tg_end; ++t) {
      size_t tile;
      if (t == tg_end) {
        if (at > sz) fail("the AV1 stream ends inside a tile");
        tile = sz - at;
      } else {
        if (at + tile_size_bytes > sz)
          fail("the AV1 stream ends inside a tile size");
        uint64_t v = 0;
        for (int i = 0; i < tile_size_bytes; ++i)
          v |= uint64_t(d[at + i]) << (8 * i);
        at += tile_size_bytes;
        tile = v + 1;
        if (at + tile > sz) fail("the AV1 stream ends inside a tile");
      }
      decode_tile(t, d + at, tile);
      at += tile;
    }
    next_tile = tg_end + 1;
    if (next_tile == num_tiles) frame_done = true;
  }

  void decode_tile(int t, const uint8_t* data, size_t size) {
    const int tr = t / tile_cols, tc = t % tile_cols;
    mi_row_start = mi_row_starts[tr];
    mi_row_end = mi_row_starts[tr + 1];
    mi_col_start = mi_col_starts[tc];
    mi_col_end = mi_col_starts[tc + 1];
    current_q = base_q_idx;
    cdf = frame_cdf;
    sym.init(data, size, disable_cdf_update);
    for (int p = 0; p < num_planes; ++p) {
      std::fill(above_level[p].begin(), above_level[p].end(), 0);
      std::fill(above_dc[p].begin(), above_dc[p].end(), 0);
    }
    for (int& d : delta_lf) d = 0;
    for (int p = 0; p < num_planes; ++p)
      for (int pass = 0; pass < 2; ++pass) {
        ref_sgr_xqd[p][pass] = Sgrproj_Xqd_Mid[pass];
        for (int i = 0; i < 3; ++i) ref_lr_wiener[p][pass][i] = Wiener_Taps_Mid[i];
      }
    const int sb4 = use_128 ? 32 : 16;
    for (int r = mi_row_start; r < mi_row_end; r += sb4) {
      for (int p = 0; p < num_planes; ++p) {
        std::fill(left_level[p].begin(), left_level[p].end(), 0);
        std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
      }
      for (int c = mi_col_start; c < mi_col_end; c += sb4) {
        read_deltas = delta_q_present;
        cdef_at(r, c) = -1;
        if (use_128) {
          if (c + 16 < mi_cols) cdef_at(r, c + 16) = -1;
          if (r + 16 < mi_rows) cdef_at(r + 16, c) = -1;
          if (c + 16 < mi_cols && r + 16 < mi_rows)
            cdef_at(r + 16, c + 16) = -1;
        }
        clear_block_decoded(r, c, sb4);
        read_lr(r, c, sb4);
        decode_partition(r, c, use_128 ? BLOCK_128X128 : BLOCK_64X64);
      }
    }
    if (!sym.padding_ok())
      fail("the AV1 stream's tile data do not end where its symbols do "
           "(cv2 refuses it)");
    if (t == context_update_tile_id) saved_cdf = cdf;
  }

  // spec 5.11.57: the restoration units whose top left corner lies in
  // the superblock (in upscaled units under superres)
  void read_lr(int r, int c, int sb4) {
    for (int p = 0; p < num_planes; ++p) {
      if (lr_frame_type[p] == RESTORE_NONE) continue;
      const int sx = p ? ssx : 0, sy = p ? ssy : 0;
      const int unit = lr_size[p];
      const int row0 = (r * (4 >> sy) + unit - 1) / unit;
      const int row1 = std::min(lr_rows[p], ((r + sb4) * (4 >> sy) + unit - 1) / unit);
      const bool scaled = upscaled_w != frame_w;   // libaom's test
      const int num = (4 >> sx) * (scaled ? superres_denom : SUPERRES_NUM);
      const int den = unit * SUPERRES_NUM;
      const int col0 = (c * num + den - 1) / den;
      const int col1 = std::min(lr_cols[p], ((c + sb4) * num + den - 1) / den);
      for (int y = row0; y < row1; ++y)
        for (int x = col0; x < col1; ++x)
          read_lr_unit(p, lr_units[p][size_t(y) * lr_cols[p] + x]);
    }
  }

  void read_lr_unit(int p, LrUnit& u) {
    const int ft = lr_frame_type[p];
    if (ft == RESTORE_WIENER)
      u.type = sym.read(cdf.use_wiener, 2) ? RESTORE_WIENER : RESTORE_NONE;
    else if (ft == RESTORE_SGRPROJ)
      u.type = sym.read(cdf.use_sgrproj, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
    else
      u.type = sym.read(cdf.restoration_type, 3);
    if (u.type == RESTORE_WIENER) {
      for (int pass = 0; pass < 2; ++pass) {
        u.wiener[pass][0] = 0;
        for (int j = p ? 1 : 0; j < 3; ++j) {
          const int v = signed_subexp(Wiener_Taps_Min[j], Wiener_Taps_Max[j] + 1,
                                      Wiener_Taps_K[j], ref_lr_wiener[p][pass][j]);
          u.wiener[pass][j] = ref_lr_wiener[p][pass][j] = v;
        }
      }
    } else if (u.type == RESTORE_SGRPROJ) {
      u.sgr_set = sym.literal(4);
      for (int i = 0; i < 2; ++i) {
        const int radius = Sgr_Params[u.sgr_set][i];
        const int lo = Sgrproj_Xqd_Min[i], hi = Sgrproj_Xqd_Max[i];
        int v = 0;
        if (radius)
          v = signed_subexp(lo, hi + 1, SGRPROJ_PRJ_SUBEXP_K, ref_sgr_xqd[p][i]);
        else if (i == 1)
          v = clip3(lo, hi, (1 << SGRPROJ_PRJ_BITS) - ref_sgr_xqd[p][0]);
        u.sgr_xqd[i] = ref_sgr_xqd[p][i] = v;
      }
    }
  }

  // decode_signed_subexp_with_ref_bool and what it calls (spec 5.11.58)
  int signed_subexp(int low, int high, int k, int ref) {
    const int mx = high - low, r = ref - low;
    const int v = subexp(mx, k);
    const int x = (r << 1) <= mx ? inverse_recenter(r, v)
                                 : mx - 1 - inverse_recenter(mx - 1 - r, v);
    return x + low;
  }
  int subexp(int num_syms, int k) {
    int i = 0, mk = 0;
    while (true) {
      const int b2 = i ? k + i - 1 : k, a = 1 << b2;
      if (num_syms <= mk + 3 * a) return ns(num_syms - mk) + mk;
      if (!sym.literal(1)) return sym.literal(b2) + mk;
      ++i;
      mk += a;
    }
  }
  int ns(int n) {
    const int w = floor_log2(n) + 1, m = (1 << w) - n;
    const int v = sym.literal(w - 1);
    return v < m ? v : (v << 1) - m + sym.literal(1);
  }
  static int inverse_recenter(int r, int v) {
    if (v > 2 * r) return v;
    return (v & 1) ? r - ((v + 1) >> 1) : r + (v >> 1);
  }

  int8_t& cdef_at(int r, int c) {
    return cdef_idx[size_t(r >> 4) * cdef_stride + (c >> 4)];
  }

  uint8_t& bd(int p, int y, int x) { return block_decoded[p][y + 1][x + 1]; }

  void clear_block_decoded(int r, int c, int sb4) {
    for (int p = 0; p < num_planes; ++p) {
      const int sx = p ? ssx : 0, sy = p ? ssy : 0;
      const int w4 = (mi_col_end - c) >> sx, h4 = (mi_row_end - r) >> sy;
      for (int y = -1; y <= (sb4 >> sy); ++y)
        for (int x = -1; x <= (sb4 >> sx); ++x) {
          if (y < 0 && x < w4) bd(p, y, x) = 1;
          else if (x < 0 && y < h4) bd(p, y, x) = 1;
          else bd(p, y, x) = 0;
        }
      bd(p, sb4 >> sy, -1) = 0;
    }
  }

  bool inside(int r, int c) const {
    return c >= mi_col_start && c < mi_col_end && r >= mi_row_start &&
           r < mi_row_end;
  }
  size_t mi(int r, int c) const { return size_t(r) * mi_stride + c; }

  // -------------------------------------------------------------------------
  // partitions and modes

  void decode_partition(int r, int c, int bsize) {
    if (r >= mi_rows || c >= mi_cols) return;
    const bool au = inside(r - 1, c), al = inside(r, c - 1);
    const int n4 = kWide4[bsize], half = n4 >> 1, quarter = half >> 1;
    const bool has_rows = (r + half) < mi_rows, has_cols = (c + half) < mi_cols;
    int p;
    if (bsize < BLOCK_8X8) {
      p = PARTITION_NONE;
    } else {
      const int bsl = log2i(n4);      // 1 for 8x8 .. 5 for 128x128
      const int above = au && log2i(kWide4[mi_sizes[mi(r - 1, c)]]) < bsl;
      const int left = al && log2i(kHigh4[mi_sizes[mi(r, c - 1)]]) < bsl;
      uint16_t* pc = cdf.partition[(bsl - 1) * 4 + left * 2 + above];
      const int nsym = bsl == 1 ? 4 : bsl == 5 ? 8 : 10;
      auto prob = [&](int e) {
        return e < nsym ? pc[e] - (e ? pc[e - 1] : 0) : 0;
      };
      if (has_rows && has_cols) {
        p = sym.read(pc, nsym);
      } else if (has_cols) {
        int psum = prob(PARTITION_VERT) + prob(PARTITION_SPLIT) +
                   prob(PARTITION_HORZ_A) + prob(PARTITION_VERT_A) +
                   prob(PARTITION_VERT_B);
        if (bsize != BLOCK_128X128) psum += prob(PARTITION_VERT_4);
        uint16_t b[3] = {static_cast<uint16_t>(32768 - psum), 32768, 0};
        const bool a = sym.adapt;
        sym.adapt = false;
        p = sym.read(b, 2) ? PARTITION_SPLIT : PARTITION_HORZ;
        sym.adapt = a;
      } else if (has_rows) {
        int psum = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT) +
                   prob(PARTITION_HORZ_A) + prob(PARTITION_HORZ_B) +
                   prob(PARTITION_VERT_A);
        if (bsize != BLOCK_128X128) psum += prob(PARTITION_HORZ_4);
        uint16_t b[3] = {static_cast<uint16_t>(32768 - psum), 32768, 0};
        const bool a = sym.adapt;
        sym.adapt = false;
        p = sym.read(b, 2) ? PARTITION_SPLIT : PARTITION_VERT;
        sym.adapt = a;
      } else {
        p = PARTITION_SPLIT;
      }
    }
    const int sub = partition_subsize(p, bsize);
    const int split = partition_subsize(PARTITION_SPLIT, bsize);
    partition = p;      // libaom's mbmi->partition: has_top_right reads it
    switch (p) {
      case PARTITION_NONE: decode_block(r, c, sub); break;
      case PARTITION_HORZ:
        decode_block(r, c, sub);
        if (has_rows) decode_block(r + half, c, sub);
        break;
      case PARTITION_VERT:
        decode_block(r, c, sub);
        if (has_cols) decode_block(r, c + half, sub);
        break;
      case PARTITION_SPLIT:
        decode_partition(r, c, sub);
        decode_partition(r, c + half, sub);
        decode_partition(r + half, c, sub);
        decode_partition(r + half, c + half, sub);
        break;
      case PARTITION_HORZ_A:
        decode_block(r, c, split);
        decode_block(r, c + half, split);
        decode_block(r + half, c, sub);
        break;
      case PARTITION_HORZ_B:
        decode_block(r, c, sub);
        decode_block(r + half, c, split);
        decode_block(r + half, c + half, split);
        break;
      case PARTITION_VERT_A:
        decode_block(r, c, split);
        decode_block(r + half, c, split);
        decode_block(r, c + half, sub);
        break;
      case PARTITION_VERT_B:
        decode_block(r, c, sub);
        decode_block(r, c + half, split);
        decode_block(r + half, c + half, split);
        break;
      case PARTITION_HORZ_4:
        for (int i = 0; i < 4; ++i)
          if (i < 3 || r + quarter * 3 < mi_rows)
            decode_block(r + quarter * i, c, sub);
        break;
      default:
        for (int i = 0; i < 4; ++i)
          if (i < 3 || c + quarter * 3 < mi_cols)
            decode_block(r, c + quarter * i, sub);
        break;
    }
  }

  void decode_block(int r, int c, int bsize) {
    if (bsize == BLOCK_INVALID) fail("the AV1 stream has an invalid partition");
    mi_row = r;
    mi_col = c;
    mi_size = bsize;
    const int bw4 = kWide4[bsize], bh4 = kHigh4[bsize];
    if (bh4 == 1 && ssy && (r & 1) == 0) has_chroma = 0;
    else if (bw4 == 1 && ssx && (c & 1) == 0) has_chroma = 0;
    else has_chroma = num_planes > 1;
    if (has_chroma && kSubSize[bsize][ssx][ssy] == BLOCK_INVALID)
      fail("the AV1 stream has a block its subsampling forbids");
    avail_u = inside(r - 1, c);
    avail_l = inside(r, c - 1);
    avail_u_chroma = avail_u;
    avail_l_chroma = avail_l;
    if (has_chroma) {
      if (ssy && bh4 == 1) avail_u_chroma = inside(r - 2, c);
      if (ssx && bw4 == 1) avail_l_chroma = inside(r, c - 2);
    } else {
      avail_u_chroma = avail_l_chroma = false;
    }
    if (frame_is_intra) intra_frame_mode_info();
    else inter_frame_mode_info();
    palette_tokens();
    read_block_tx_size();
    if (skip) reset_block_context(bw4, bh4);
    int32_t pal_index = -1;
    if (pal.size[0] || pal.size[1]) {
      pal_index = static_cast<int32_t>(palettes.size());
      palettes.push_back(pal);
      palette_y_blocks += pal.size[0] > 0;
      palette_uv_blocks += pal.size[1] > 0;
      palette_sizes |= (1 << pal.size[0]) | (1 << pal.size[1]);
    }
    for (int y = 0; y < bh4; ++y) {
      if (r + y >= mi_rows) break;
      for (int x = 0; x < bw4; ++x) {
        if (c + x >= mi_cols) break;
        const size_t k = mi(r + y, c + x);
        y_modes[k] = static_cast<uint8_t>(y_mode);
        uv_modes[k] = static_cast<uint8_t>(uv_mode);
        mi_sizes[k] = static_cast<uint8_t>(bsize);
        skips[k] = static_cast<uint8_t>(skip);
        seg_ids[k] = static_cast<uint8_t>(segment_id);
        for (int i = 0; i < 4; ++i)
          delta_lfs[k * 4 + i] = static_cast<int8_t>(delta_lf[i]);
        if (!palette_at.empty()) palette_at[k] = pal_index;
        is_inters[k] = static_cast<uint8_t>(is_inter);
        for (int l = 0; l < 2; ++l) {
          ref_frames[2 * k + l] = static_cast<int8_t>(ref_frame[l]);
          interps[2 * k + l] = static_cast<uint8_t>(interp[l]);
          for (int d = 0; d < 2; ++d)
            mvs[4 * k + 2 * l + d] = static_cast<int16_t>(mvb[l][d]);
        }
        skip_modes[k] = static_cast<uint8_t>(skip_mode);
        comp_group_idxs[k] = static_cast<uint8_t>(comp_group_idx);
        compound_idxs[k] = static_cast<uint8_t>(compound_idx);
      }
    }
    if (use_intrabc) predict_intrabc();
    else if (is_inter) predict_inter();
    residual();
  }

  const Palette* palette_of(size_t k) const {
    if (palette_at.empty() || palette_at[k] < 0) return nullptr;
    return &palettes[palette_at[k]];
  }

  // the block's inter state before its mode info: an intra block
  void reset_inter_state() {
    pal = Palette{};
    use_filter_intra = 0;
    angle_delta_y = angle_delta_uv = 0;
    cfl_alpha_u = cfl_alpha_v = 0;
    std::memset(mvb, 0, sizeof(mvb));
    ref_frame[0] = INTRA_FRAME;
    ref_frame[1] = NONE_FRAME;
    use_intrabc = is_inter = skip_mode = 0;
    interp[0] = interp[1] = EIGHTTAP;
    motion_mode = SIMPLE;
    interintra = 0;
    compound_type = COMPOUND_AVERAGE;
    comp_group_idx = 0;
    compound_idx = 1;
  }

  void intra_frame_mode_info() {
    skip = 0;
    if (seg_id_pre_skip) intra_segment_id();
    read_skip();
    if (!seg_id_pre_skip) intra_segment_id();
    read_cdef();
    read_delta_qindex();
    read_delta_lf();
    read_deltas = false;
    reset_inter_state();
    use_intrabc = is_inter = allow_intrabc ? sym.read(cdf.intrabc, 2) : 0;
    if (use_intrabc) {       // DC_PRED both, bilinear
      y_mode = uv_mode = DC_PRED;
      ++intrabc_blocks;
      assign_dv();
      return;
    }
    const int above = kIntraModeContext[
        avail_u ? y_modes[mi(mi_row - 1, mi_col)] : int(DC_PRED)];
    const int left = kIntraModeContext[
        avail_l ? y_modes[mi(mi_row, mi_col - 1)] : int(DC_PRED)];
    intra_modes(cdf.y_mode[above][left]);
  }

  // intra_frame_y_mode or y_mode, then the angles, the UV mode, CFL,
  // palettes and filter intra
  void intra_modes(uint16_t* y_cdf) {
    y_mode = sym.read(y_cdf, 13);
    if (mi_size >= BLOCK_8X8 && y_mode >= V_PRED && y_mode <= D67_PRED)
      angle_delta_y = sym.read(cdf.angle_delta[y_mode - V_PRED], 7) - 3;
    uv_mode = DC_PRED;
    if (has_chroma) {
      const int bw = kWide4[mi_size] * 4, bh = kHigh4[mi_size] * 4;
      bool cfl_allowed;
      if (lossless && kSubSize[mi_size][ssx][ssy] == BLOCK_4X4)
        cfl_allowed = true;
      else
        cfl_allowed = !lossless && std::max(bw, bh) <= 32;
      uv_mode = cfl_allowed ? sym.read(cdf.uv_mode[1][y_mode], 14)
                            : sym.read(cdf.uv_mode[0][y_mode], 13);
      if (uv_mode == UV_CFL_PRED) read_cfl_alphas();
      if (mi_size >= BLOCK_8X8 && uv_mode >= V_PRED && uv_mode <= D67_PRED)
        angle_delta_uv = sym.read(cdf.angle_delta[uv_mode - V_PRED], 7) - 3;
    }
    if (mi_size >= BLOCK_8X8 && kWide4[mi_size] <= 16 &&
        kHigh4[mi_size] <= 16 && allow_screen_content_tools)
      palette_mode_info();
    if (enable_filter_intra && y_mode == DC_PRED && pal.size[0] == 0 &&
        std::max(kWide4[mi_size], kHigh4[mi_size]) <= 8) {
      use_filter_intra = sym.read(cdf.filter_intra[mi_size], 2);
      if (use_filter_intra)
        filter_intra_mode = sym.read(cdf.filter_intra_mode, 5);
    }
  }

  void read_cfl_alphas() {
    const int signs = sym.read(cdf.cfl_sign, 8);
    const int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
    if (sign_u) {
      cfl_alpha_u = 1 + sym.read(cdf.cfl_alpha[(sign_u - 1) * 3 + sign_v], 16);
      if (sign_u == 1) cfl_alpha_u = -cfl_alpha_u;
    }
    if (sign_v) {
      cfl_alpha_v = 1 + sym.read(cdf.cfl_alpha[(sign_v - 1) * 3 + sign_u], 16);
      if (sign_v == 1) cfl_alpha_v = -cfl_alpha_v;
    }
  }

  // -------------------------------------------------------------------------
  // palettes (spec 5.11.46, 5.11.49, 7.11.4)

  // get_palette_cache: the above (not across a 64-row line) and left
  // blocks' colours of the plane's palette (U for chroma), merged in
  // order without repeats
  int palette_cache(int p, uint16_t* cache) const {
    const Palette* a = avail_u && (mi_row * 4) % 64
                           ? palette_of(mi(mi_row - 1, mi_col)) : nullptr;
    const Palette* l = avail_l ? palette_of(mi(mi_row, mi_col - 1)) : nullptr;
    int an = a ? a->size[p] : 0, ln = l ? l->size[p] : 0;
    int ai = 0, li = 0, n = 0;
    auto put = [&](uint16_t v) {
      if (n == 0 || v != cache[n - 1]) cache[n++] = v;
    };
    while (ai < an && li < ln) {
      const uint16_t va = a->colors[p][ai], vl = l->colors[p][li];
      if (vl < va) {
        put(vl);
        ++li;
      } else {
        put(va);
        ++ai;
        if (vl == va) ++li;
      }
    }
    while (ai < an) put(a->colors[p][ai++]);
    while (li < ln) put(l->colors[p][li++]);
    return n;
  }

  static int ceil_log2(int x) {
    if (x < 2) return 0;
    int i = 1, q = 2;
    while (q < x) {
      ++i;
      q <<= 1;
    }
    return i;
  }

  // Y's and U's colours: taken from the cache, then literals rising by
  // deltas (Y's at least 1 apart), all sorted
  void palette_colors(int p) {
    const int n = pal.size[p];
    uint16_t cache[2 * PALETTE_MAX_SIZE];
    const int ncache = palette_cache(p, cache);
    uint16_t* col = pal.colors[p];
    int idx = 0;
    for (int i = 0; i < ncache && idx < n; ++i)
      if (sym.literal(1)) col[idx++] = cache[i];
    if (idx < n) {
      col[idx++] = static_cast<uint16_t>(sym.literal(bit_depth));
      int bits = 0;
      if (idx < n) bits = bit_depth - 3 + sym.literal(2);
      const int maxv = (1 << bit_depth) - 1;
      for (; idx < n; ++idx) {
        const int delta = sym.literal(bits) + (p == 0);
        col[idx] = static_cast<uint16_t>(std::min(maxv, col[idx - 1] + delta));
        bits = std::min(bits, ceil_log2((1 << bit_depth) - col[idx] - (p == 0)));
      }
    }
    std::sort(col, col + n);
  }

  void palette_mode_info() {
    const int bctx = log2i(kWide4[mi_size]) + log2i(kHigh4[mi_size]) - 2;
    if (y_mode == DC_PRED) {
      int ctx = 0;
      if (avail_u) {
        const Palette* a = palette_of(mi(mi_row - 1, mi_col));
        ctx += a && a->size[0] > 0;
      }
      if (avail_l) {
        const Palette* l = palette_of(mi(mi_row, mi_col - 1));
        ctx += l && l->size[0] > 0;
      }
      if (sym.read(cdf.palette_y[bctx][ctx], 2)) {
        pal.size[0] = sym.read(cdf.palette_y_size[bctx], 7) + 2;
        palette_colors(0);
      }
    }
    if (has_chroma && uv_mode == DC_PRED &&
        sym.read(cdf.palette_uv[pal.size[0] > 0], 2)) {
      pal.size[1] = sym.read(cdf.palette_uv_size[bctx], 7) + 2;
      palette_colors(1);
      // V: delta coded with signs, wrapping, or literals
      const int n = pal.size[1];
      if (sym.literal(1)) {
        const int maxv = 1 << bit_depth;
        const int bits = bit_depth - 4 + sym.literal(2);
        v_colors[0] = static_cast<uint16_t>(sym.literal(bit_depth));
        for (int i = 1; i < n; ++i) {
          int delta = sym.literal(bits);
          if (delta && sym.literal(1)) delta = -delta;
          int val = v_colors[i - 1] + delta;
          if (val < 0) val += maxv;
          if (val >= maxv) val -= maxv;
          v_colors[i] = static_cast<uint16_t>(clip3(0, maxv - 1, val));
        }
      } else {
        for (int i = 0; i < n; ++i)
          v_colors[i] = static_cast<uint16_t>(sym.literal(bit_depth));
      }
    }
  }

  // palette_tokens: each plane's colour index map in anti-diagonal order
  // over its visible part, then its last column and row repeated
  void palette_tokens() {
    const int bw = kWide4[mi_size] * 4, bh = kHigh4[mi_size] * 4;
    const int on_w = std::min(bw, (mi_cols - mi_col) * 4);
    const int on_h = std::min(bh, (mi_rows - mi_row) * 4);
    if (pal.size[0]) color_map_tokens(0, bw, bh, on_w, on_h);
    if (pal.size[1]) {
      int w = bw >> ssx, h = bh >> ssy, ow = on_w >> ssx, oh = on_h >> ssy;
      if (w < 4) {
        w += 2;
        ow += 2;
      }
      if (h < 4) {
        h += 2;
        oh += 2;
      }
      color_map_tokens(1, w, h, ow, oh);
    }
  }

  void color_map_tokens(int p, int w, int h, int on_w, int on_h) {
    uint8_t* map = color_map[p];
    const int n = pal.size[p];
    auto at = [&](int r, int c) -> uint8_t& { return map[r * 64 + c]; };
    at(0, 0) = static_cast<uint8_t>(ns(n));
    for (int i = 1; i < on_h + on_w - 1; ++i)
      for (int j = std::min(i, on_w - 1); j >= std::max(0, i - on_h + 1); --j) {
        const int r = i - j;
        // get_palette_color_context: the left, above-left and above
        // indices scored 2, 1, 2; the first three orders by score
        int scores[PALETTE_MAX_SIZE] = {0};
        uint8_t order[PALETTE_MAX_SIZE];
        for (int k = 0; k < PALETTE_MAX_SIZE; ++k) order[k] = static_cast<uint8_t>(k);
        if (j > 0) scores[at(r, j - 1)] += Palette_Color_Weights[0];
        if (r > 0 && j > 0) scores[at(r - 1, j - 1)] += Palette_Color_Weights[1];
        if (r > 0) scores[at(r - 1, j)] += Palette_Color_Weights[2];
        for (int k = 0; k < 3; ++k) {
          int best = scores[k], bi = k;
          for (int m = k + 1; m < n; ++m)
            if (scores[m] > best) {
              best = scores[m];
              bi = m;
            }
          if (bi != k) {
            const uint8_t o = order[bi];
            for (int m = bi; m > k; --m) {
              scores[m] = scores[m - 1];
              order[m] = order[m - 1];
            }
            scores[k] = best;
            order[k] = o;
          }
        }
        int hash = 0;
        for (int k = 0; k < 3; ++k)
          hash += scores[k] * Palette_Color_Hash_Multipliers[k];
        const int ctx = Palette_Color_Context[hash];
        uint16_t* c = p == 0 ? cdf.palette_y_color[n - 2][ctx]
                             : cdf.palette_uv_color[n - 2][ctx];
        at(r, j) = order[sym.read(c, n)];
      }
    for (int r = 0; r < on_h; ++r)
      for (int c = on_w; c < w; ++c) at(r, c) = at(r, on_w - 1);
    for (int r = on_h; r < h; ++r)
      for (int c = 0; c < w; ++c) at(r, c) = at(on_h - 1, c);
  }

  // predict_palette: a transform block's colours from the map
  void predict_palette(int p, int start_x, int start_y, int x, int y,
                       int txs) {
    const uint16_t* colors = p == 0 ? pal.colors[0]
                             : p == 1 ? pal.colors[1] : v_colors;
    const uint8_t* map = color_map[p > 0];
    Plane& P = cur[p];
    for (int i = 0; i < kTxH[txs]; ++i) {
      if (start_y + i >= P.rows) break;
      for (int j = 0; j < kTxW[txs]; ++j)
        if (start_x + j < P.stride)
          *P.at(start_y + i, start_x + j) =
              colors[map[(y * 4 + i) * 64 + x * 4 + j]];
    }
  }

  // -------------------------------------------------------------------------
  // The motion vector stack of the block's reference frame(s), as libaom
  // builds it (setup_ref_mv_list; the specification's find_mv_stack): the
  // nearest row, column and top right, then the projected motion field,
  // the top left and the outer rows and columns, each half sorted by
  // weight; a short stack completed from the neighbours' other vectors
  // (or, compound, pairs of them and the global vectors); every vector
  // clamped to the block's reach.  INTRA_FRAME for intra block copy.

  struct MvCand {
    int mv[2][2];     // [list][row, column]
    int weight;
  };
  MvCand stack[MAX_REF_MV_STACK_SIZE];
  int stack_n = 0, new_mv_count = 0, mode_ctx = 0;
  int global_mvs[2][2] = {{0}};

  static void lower_precision(int* v, int allow_hp, int integer) {
    for (int i = 0; i < 2; ++i) {
      int& x = v[i];
      if (integer) {
        const int mod = x % 8;
        if (mod) {
          x -= mod;
          if (std::abs(mod) > 4) x += mod > 0 ? 8 : -8;
        }
      } else if (!allow_hp && (x & 1)) {
        x += x > 0 ? -1 : 1;
      }
    }
  }

  // gm_get_motion_vector: the global motion of the block's centre
  void global_mv(int ref, int* out) const {
    out[0] = out[1] = 0;
    if (ref <= INTRA_FRAME || gm_type[ref] == IDENTITY) return;
    const int* m = gm_params[ref];
    if (gm_type[ref] == TRANSLATION) {
      // row from [0], column from [1], as libaom and the specification
      out[0] = m[0] >> (WARPEDMODEL_PREC_BITS - 3);
      out[1] = m[1] >> (WARPEDMODEL_PREC_BITS - 3);
    } else {
      const int x = mi_col * 4 + kWide4[mi_size] * 2 - 1;
      const int y = mi_row * 4 + kHigh4[mi_size] * 2 - 1;
      const int xc = (m[2] - (1 << WARPEDMODEL_PREC_BITS)) * x + m[3] * y + m[0];
      const int yc = m[4] * x + (m[5] - (1 << WARPEDMODEL_PREC_BITS)) * y + m[1];
      auto conv = [&](int v) {
        return allow_high_precision_mv
                   ? round2signed(v, WARPEDMODEL_PREC_BITS - 3)
                   : round2signed(v, WARPEDMODEL_PREC_BITS - 2) * 2;
      };
      out[0] = conv(yc);
      out[1] = conv(xc);
    }
    if (force_integer_mv) lower_precision(out, 0, 1);
  }

  static bool has_newmv(int mode) {
    return mode == NEWMV || mode == NEW_NEWMV || mode == NEAREST_NEWMV ||
           mode == NEW_NEARESTMV || mode == NEAR_NEWMV || mode == NEW_NEARMV;
  }
  bool is_global_block(int mode, int bsize, int ref) const {
    return (mode == GLOBALMV || mode == GLOBAL_GLOBALMV) && ref > INTRA_FRAME &&
           gm_type[ref] > TRANSLATION &&
           std::min(kWide4[bsize], kHigh4[bsize]) >= 2;
  }

  void push_candidate(const int (*v)[2], int weight, bool compound) {
    for (int i = 0; i < stack_n; ++i)
      if (stack[i].mv[0][0] == v[0][0] && stack[i].mv[0][1] == v[0][1] &&
          (!compound || (stack[i].mv[1][0] == v[1][0] &&
                         stack[i].mv[1][1] == v[1][1]))) {
        stack[i].weight += weight;
        return;
      }
    if (stack_n < MAX_REF_MV_STACK_SIZE) {
      MvCand& c = stack[stack_n++];
      std::memcpy(c.mv, v, sizeof(c.mv));
      if (!compound) c.mv[1][0] = c.mv[1][1] = 0;
      c.weight = weight;
    }
  }

  // add_ref_mv_candidate
  void add_candidate(int r, int c, int weight, int* match) {
    const size_t k = mi(r, c);
    if (!is_inters[k]) return;
    const int8_t* cref = &ref_frames[2 * k];
    const int cmode = y_modes[k], csize = mi_sizes[k];
    if (ref_frame[1] <= INTRA_FRAME) {
      for (int l = 0; l < 2; ++l) {
        if (cref[l] != ref_frame[0]) continue;
        int v[2][2] = {{0}};
        if (is_global_block(cmode, csize, ref_frame[0])) {
          v[0][0] = global_mvs[0][0];
          v[0][1] = global_mvs[0][1];
        } else {
          v[0][0] = mvs[4 * k + 2 * l];
          v[0][1] = mvs[4 * k + 2 * l + 1];
        }
        push_candidate(v, weight, false);
        new_mv_count += has_newmv(cmode);
        ++*match;
      }
    } else {
      if (cref[0] != ref_frame[0] || cref[1] != ref_frame[1]) return;
      int v[2][2];
      for (int l = 0; l < 2; ++l) {
        if (is_global_block(cmode, csize, ref_frame[l])) {
          v[l][0] = global_mvs[l][0];
          v[l][1] = global_mvs[l][1];
        } else {
          v[l][0] = mvs[4 * k + 2 * l];
          v[l][1] = mvs[4 * k + 2 * l + 1];
        }
      }
      push_candidate(v, weight, true);
      new_mv_count += has_newmv(cmode);
      ++*match;
    }
  }

  void scan_row(int row_offset, int max_row_offset, int* processed,
                int* match) {
    const int bw4 = kWide4[mi_size];
    const int end = std::min({bw4, mi_cols - mi_col, 16});
    int col_offset = 0;
    if (std::abs(row_offset) > 1) {
      col_offset = 1;
      if ((mi_col & 1) && bw4 < 2) --col_offset;
    }
    for (int i = 0; i < end;) {
      const int r = mi_row + row_offset, c = mi_col + col_offset + i;
      const int cand = mi_sizes[mi(r, c)];
      int len = std::min<int>(bw4, kWide4[cand]);
      if (bw4 >= 16) len = std::max(4, len);      // 64 samples wide
      else if (std::abs(row_offset) > 1) len = std::max(len, 2);
      int weight = 2;
      if (bw4 >= 2 && bw4 <= kWide4[cand]) {
        const int inc = std::min<int>(-max_row_offset + row_offset + 1,
                                      kHigh4[cand]);
        weight = std::max(weight, inc);
        *processed = inc - row_offset - 1;
      }
      add_candidate(r, c, len * weight, match);
      i += len;
    }
  }

  void scan_col(int col_offset, int max_col_offset, int* processed,
                int* match) {
    const int bh4 = kHigh4[mi_size];
    const int end = std::min({bh4, mi_rows - mi_row, 16});
    int row_offset = 0;
    if (std::abs(col_offset) > 1) {
      row_offset = 1;
      if ((mi_row & 1) && bh4 < 2) --row_offset;
    }
    for (int i = 0; i < end;) {
      const int r = mi_row + row_offset + i, c = mi_col + col_offset;
      const int cand = mi_sizes[mi(r, c)];
      int len = std::min<int>(bh4, kHigh4[cand]);
      if (bh4 >= 16) len = std::max(4, len);
      else if (std::abs(col_offset) > 1) len = std::max(len, 2);
      int weight = 2;
      if (bh4 >= 2 && bh4 <= kHigh4[cand]) {
        const int inc = std::min<int>(-max_col_offset + col_offset + 1,
                                      kWide4[cand]);
        weight = std::max(weight, inc);
        *processed = inc - col_offset - 1;
      }
      add_candidate(r, c, len * weight, match);
      i += len;
    }
  }

  void scan_point(int row_offset, int col_offset, int* match) {
    const int r = mi_row + row_offset, c = mi_col + col_offset;
    if (inside(r, c)) add_candidate(r, c, 4, match);
  }

  // libaom's has_top_right (its is_sec_rect rules for rectangles)
  bool has_top_right() const {
    const int bw4 = kWide4[mi_size], bh4 = kHigh4[mi_size];
    int bs = std::max(bw4, bh4);
    const int sb = use_128 ? 32 : 16;
    const int mask_row = mi_row & (sb - 1), mask_col = mi_col & (sb - 1);
    if (bs > 16) return false;
    bool has_tr = !((mask_row & bs) && (mask_col & bs));
    while (bs < sb) {
      if (!(mask_col & bs)) break;
      if ((mask_col & 2 * bs) && (mask_row & 2 * bs)) {
        has_tr = false;
        break;
      }
      bs <<= 1;
    }
    if (bw4 < bh4 && ((mi_col + bw4) & (bh4 - 1))) has_tr = true;
    if (bw4 > bh4 && (mi_row & (bw4 - 1))) has_tr = false;
    if (partition == PARTITION_VERT_A && bw4 == bh4 && (mask_row & bs))
      has_tr = false;
    return has_tr;
  }

  // get_mv_projection
  static void project(const int* v, int num, int den, int* out) {
    static const int kDivMult[32] = {
        0,    16384, 8192, 5461, 4096, 3276, 2730, 2340, 2048, 1820, 1638,
        1489, 1365,  1260, 1170, 1092, 1024, 963,  910,  862,  819,  780,
        744,  712,   682,  655,  630,  606,  585,  564,  546,  528};
    den = std::min(den, MAX_FRAME_DISTANCE);
    num = num > 0 ? std::min(num, MAX_FRAME_DISTANCE)
                  : std::max(num, -MAX_FRAME_DISTANCE);
    for (int i = 0; i < 2; ++i)
      out[i] = clip3(MV_LOW + 1, MV_UPP - 1,
                     round2signed(int64_t(v[i]) * num * kDivMult[den], 14));
  }

  // add_tpl_ref_mv: a vector of the projected motion field
  bool add_temporal(int blk_row, int blk_col) {
    const int r = mi_row + ((mi_row & 1) ? blk_row : blk_row + 1);
    const int c = mi_col + ((mi_col & 1) ? blk_col : blk_col + 1);
    if (!inside(r, c)) return false;
    const size_t at = size_t(r >> 1) * (mi_stride >> 1) + (c >> 1);
    if (mf_mv[2 * at] == -32768) return false;
    const int src[2] = {mf_mv[2 * at], mf_mv[2 * at + 1]};
    int v[2][2] = {{0}};
    const int n = ref_frame[1] > INTRA_FRAME ? 2 : 1;
    for (int l = 0; l < n; ++l) {
      const int offset = get_relative_dist(order_hint, order_hints[ref_frame[l]]);
      project(src, offset, mf_offset[at], v[l]);
      lower_precision(v[l], allow_high_precision_mv, force_integer_mv);
    }
    if (blk_row == 0 && blk_col == 0) {
      bool far = false;
      for (int l = 0; l < n; ++l)
        far |= std::abs(v[l][0] - global_mvs[l][0]) >= 16 ||
               std::abs(v[l][1] - global_mvs[l][1]) >= 16;
      if (far) mode_ctx |= 1 << 3;
    }
    push_candidate(v, 2, n == 2);
    ++temporal_mvs;
    return true;
  }

  void find_mv_stack() {
    const int bw4 = kWide4[mi_size], bh4 = kHigh4[mi_size];
    const bool compound = ref_frame[1] > INTRA_FRAME;
    stack_n = new_mv_count = mode_ctx = 0;
    global_mv(ref_frame[0], global_mvs[0]);
    if (compound) global_mv(ref_frame[1], global_mvs[1]);
    else global_mvs[1][0] = global_mvs[1][1] = 0;
    const int row_adj = bh4 < 2 && (mi_row & 1);
    const int col_adj = bw4 < 2 && (mi_col & 1);
    int max_row = 0, max_col = 0, rows_done = 0, cols_done = 0;
    if (avail_u) {
      max_row = (bh4 < 2 ? -4 : -2 * MVREF_ROW_COLS) + row_adj;
      max_row = clip3(mi_row_start - mi_row, mi_row_end - mi_row - 1, max_row);
    }
    if (avail_l) {
      max_col = (bw4 < 2 ? -4 : -2 * MVREF_ROW_COLS) + col_adj;
      max_col = clip3(mi_col_start - mi_col, mi_col_end - mi_col - 1, max_col);
    }
    int row_match = 0, col_match = 0;
    if (std::abs(max_row) >= 1) scan_row(-1, max_row, &rows_done, &row_match);
    if (std::abs(max_col) >= 1) scan_col(-1, max_col, &cols_done, &col_match);
    if (has_top_right()) scan_point(-1, bw4, &row_match);
    const int nearest_match = (row_match > 0) + (col_match > 0);
    const int nearest = stack_n;
    for (int i = 0; i < nearest; ++i) stack[i].weight += REF_CAT_LEVEL;
    if (use_ref_frame_mvs) {
      const int voffset = std::max(2, bh4), hoffset = std::max(2, bw4);
      const int row_end = std::min(bh4, 16), col_end = std::min(bw4, 16);
      const int step_h = bh4 >= 16 ? 4 : 2, step_w = bw4 >= 16 ? 4 : 2;
      bool available = false;
      for (int r = 0; r < row_end; r += step_h)
        for (int c = 0; c < col_end; c += step_w) {
          const bool ok = add_temporal(r, c);
          if (r == 0 && c == 0) available = ok;
        }
      if (!available) mode_ctx |= 1 << 3;
      const int pos[3][2] = {{voffset, -2}, {voffset, hoffset},
                             {voffset - 2, hoffset}};
      const bool extension = bh4 >= 2 && bh4 < 16 && bw4 >= 2 && bw4 < 16;
      for (int i = 0; i < 3 && extension; ++i) {
        const int rr = (mi_row & 15) + pos[i][0], cc = (mi_col & 15) + pos[i][1];
        if (rr < 0 || rr >= 16 || cc < 0 || cc >= 16) continue;
        add_temporal(pos[i][0], pos[i][1]);
      }
    }
    const int newmv_nearest = new_mv_count;   // the outer scans' are not kept
    scan_point(-1, -1, &row_match);
    for (int idx = 2; idx <= MVREF_ROW_COLS; ++idx) {
      const int ro = -(idx << 1) + 1 + row_adj, co = -(idx << 1) + 1 + col_adj;
      if (std::abs(ro) <= std::abs(max_row) && std::abs(ro) > rows_done)
        scan_row(ro, max_row, &rows_done, &row_match);
      if (std::abs(co) <= std::abs(max_col) && std::abs(co) > cols_done)
        scan_col(co, max_col, &cols_done, &col_match);
    }
    new_mv_count = newmv_nearest;
    const int ref_match = (row_match > 0) + (col_match > 0);
    switch (nearest_match) {
      case 0:
        if (ref_match >= 1) mode_ctx |= 1;
        if (ref_match == 1) mode_ctx |= 1 << 4;
        else if (ref_match >= 2) mode_ctx |= 2 << 4;
        break;
      case 1:
        mode_ctx |= new_mv_count > 0 ? 2 : 3;
        if (ref_match == 1) mode_ctx |= 3 << 4;
        else if (ref_match >= 2) mode_ctx |= 4 << 4;
        break;
      default:
        mode_ctx |= new_mv_count >= 1 ? 4 : 5;
        mode_ctx |= 5 << 4;
        break;
    }
    auto sort = [&](int lo, int len) {    // libaom's bubble passes
      while (len > lo) {
        int last = lo;
        for (int i = lo + 1; i < len; ++i)
          if (stack[i - 1].weight < stack[i].weight) {
            std::swap(stack[i - 1], stack[i]);
            last = i;
          }
        len = last;
      }
    };
    sort(0, nearest);
    sort(nearest, stack_n);
    const int mw = std::min({bw4, 16, mi_cols - mi_col});
    const int mh = std::min({bh4, 16, mi_rows - mi_row});
    if (compound) {
      if (stack_n < 2) extra_compound(mw, mh);
    } else if (stack_n < 2) {
      const int msz = std::min(mw, mh);
      // the neighbours' vectors of any reference, sign-flipped to ours
      auto add = [&](size_t k) {
        for (int l = 0; l < 2; ++l) {
          const int rf = ref_frames[2 * k + l];
          if (rf <= INTRA_FRAME) continue;
          int v[2][2] = {{mvs[4 * k + 2 * l], mvs[4 * k + 2 * l + 1]}, {0, 0}};
          if (sign_bias[rf] != sign_bias[ref_frame[0]]) {
            v[0][0] = -v[0][0];
            v[0][1] = -v[0][1];
          }
          int i = 0;
          while (i < stack_n && !(stack[i].mv[0][0] == v[0][0] &&
                                  stack[i].mv[0][1] == v[0][1]))
            ++i;
          if (i == stack_n) {
            std::memcpy(stack[i].mv, v, sizeof(v));
            stack[i].weight = 2;
            ++stack_n;
          }
        }
      };
      if (avail_u)
        for (int i = 0; std::abs(max_row) >= 1 && i < msz && stack_n < 2;) {
          const size_t k = mi(mi_row - 1, mi_col + i);
          add(k);
          i += kWide4[mi_sizes[k]];
        }
      if (avail_l)
        for (int i = 0; std::abs(max_col) >= 1 && i < msz && stack_n < 2;) {
          const size_t k = mi(mi_row + i, mi_col - 1);
          add(k);
          i += kHigh4[mi_sizes[k]];
        }
    }
    // clamp_mv_ref: within the frame and the block's size plus 16 samples;
    // over the whole array (a single reference's second vectors are 0,
    // which stay, and entries past the stack are rewritten before they
    // are read): GCC 12 at -O3 -march=native built a loop over the first
    // stack_n entries into code that left a stale stack behind
    const int bw = bw4 * 4, bh = bh4 * 4;
    const int col_lo = -mi_col * 32 - bw * 8 - MV_BORDER;
    const int col_hi = (mi_cols - bw4 - mi_col) * 32 + bw * 8 + MV_BORDER;
    const int row_lo = -mi_row * 32 - bh * 8 - MV_BORDER;
    const int row_hi = (mi_rows - bh4 - mi_row) * 32 + bh * 8 + MV_BORDER;
    for (MvCand& c : stack)
      for (int* v : c.mv) {
        v[0] = clip3(row_lo, row_hi, v[0]);
        v[1] = clip3(col_lo, col_hi, v[1]);
      }
  }

  // a compound stack of fewer than two pairs: pairs of the neighbours'
  // vectors of the same references, then of others (sign-flipped), then
  // the global vectors
  void extra_compound(int mw, int mh) {
    int id[2][2][2], diff[2][2][2], id_n[2] = {0, 0}, diff_n[2] = {0, 0};
    auto process = [&](size_t k) {
      for (int l = 0; l < 2; ++l) {
        const int rf = ref_frames[2 * k + l];
        if (rf <= INTRA_FRAME) continue;
        const int v[2] = {mvs[4 * k + 2 * l], mvs[4 * k + 2 * l + 1]};
        for (int cmp = 0; cmp < 2; ++cmp) {
          if (rf == ref_frame[cmp] && id_n[cmp] < 2) {
            id[cmp][id_n[cmp]][0] = v[0];
            id[cmp][id_n[cmp]++][1] = v[1];
          } else if (diff_n[cmp] < 2) {
            int w[2] = {v[0], v[1]};
            if (sign_bias[rf] != sign_bias[ref_frame[cmp]]) {
              w[0] = -w[0];
              w[1] = -w[1];
            }
            diff[cmp][diff_n[cmp]][0] = w[0];
            diff[cmp][diff_n[cmp]++][1] = w[1];
          }
        }
      }
    };
    // both scans as far as the block's shorter side (libaom's mi_size)
    const int msz = std::min(mw, mh);
    if (avail_u)
      for (int i = 0; i < msz;) {
        const size_t k = mi(mi_row - 1, mi_col + i);
        process(k);
        i += kWide4[mi_sizes[k]];
      }
    if (avail_l)
      for (int i = 0; i < msz;) {
        const size_t k = mi(mi_row + i, mi_col - 1);
        process(k);
        i += kHigh4[mi_sizes[k]];
      }
    int comp[2][2][2];     // [candidate][list][row, column]
    for (int cmp = 0; cmp < 2; ++cmp) {
      int n = 0;
      for (int i = 0; i < id_n[cmp] && n < 2; ++i, ++n)
        std::memcpy(comp[n][cmp], id[cmp][i], sizeof(int) * 2);
      for (int i = 0; i < diff_n[cmp] && n < 2; ++i, ++n)
        std::memcpy(comp[n][cmp], diff[cmp][i], sizeof(int) * 2);
      for (; n < 2; ++n) std::memcpy(comp[n][cmp], global_mvs[cmp], sizeof(int) * 2);
    }
    if (stack_n == 1) {
      const MvCand& s0 = stack[0];
      const bool same = comp[0][0][0] == s0.mv[0][0] &&
                        comp[0][0][1] == s0.mv[0][1] &&
                        comp[0][1][0] == s0.mv[1][0] &&
                        comp[0][1][1] == s0.mv[1][1];
      std::memcpy(stack[1].mv, comp[same ? 1 : 0], sizeof(stack[1].mv));
      stack[1].weight = 2;
      stack_n = 2;
    } else {
      for (int i = 0; i < 2; ++i) {
        std::memcpy(stack[i].mv, comp[i], sizeof(stack[i].mv));
        stack[i].weight = 2;
      }
      stack_n = 2;
    }
  }

  // read_mv_component (1/8 samples; integer, quarter or eighth precision)
  int read_mv_component(int ctx, int c, bool subpel, bool hp) {
    Cdfs::Mv& m = cdf.mv[ctx];
    const int sign = sym.read(m.sign[c], 2);
    const int cls = sym.read(m.cls[c], 11);
    int mag, d = 0, fr = 3, h = 1;
    if (cls == 0) {
      d = sym.read(m.class0_bit[c], 2);
      mag = 0;
      if (subpel) {
        fr = sym.read(m.class0_fr[c][d], 4);
        if (hp) h = sym.read(m.class0_hp[c], 2);
      }
    } else {
      for (int i = 0; i < cls; ++i) d |= sym.read(m.bits[c][i], 2) << i;
      mag = 2 << (cls + 2);
      if (subpel) {
        fr = sym.read(m.fr[c], 4);
        if (hp) h = sym.read(m.hp[c], 2);
      }
    }
    mag += ((d << 3) | (fr << 1) | h) + 1;
    return sign ? -mag : mag;
  }

  void read_mv(int ctx, const int* pred, int* out) {
    const bool subpel = ctx == 0 && !force_integer_mv;
    const bool hp = subpel && allow_high_precision_mv;
    const int joint = sym.read(cdf.mv[ctx].joint, 4);
    out[0] = pred[0] + (joint == 2 || joint == 3 ? read_mv_component(ctx, 0, subpel, hp) : 0);
    out[1] = pred[1] + (joint == 1 || joint == 3 ? read_mv_component(ctx, 1, subpel, hp) : 0);
  }

  // -------------------------------------------------------------------------
  // inter frames' mode info (spec 5.11.18 .. 5.11.28, with libaom's
  // contexts)

  int above_ref[2] = {INTRA_FRAME, NONE_FRAME},
      left_ref[2] = {INTRA_FRAME, NONE_FRAME};
  std::vector<uint8_t> seg_preds;       // per mi: seg_id_predicted

  void inter_frame_mode_info() {
    reset_inter_state();
    for (int l = 0; l < 2; ++l) {
      above_ref[l] = avail_u ? ref_frames[2 * mi(mi_row - 1, mi_col) + l]
                             : (l ? int(NONE_FRAME) : int(INTRA_FRAME));
      left_ref[l] = avail_l ? ref_frames[2 * mi(mi_row, mi_col - 1) + l]
                            : (l ? int(NONE_FRAME) : int(INTRA_FRAME));
    }
    skip = 0;
    seg_id_predicted = 0;
    inter_segment_id(true);
    read_skip_mode();
    if (skip_mode) skip = 1;
    else read_skip();
    if (!seg_id_pre_skip) inter_segment_id(false);
    lossless = lossless_array[segment_id];
    for (int y = 0; y < kHigh4[mi_size] && mi_row + y < mi_rows; ++y)
      for (int x = 0; x < kWide4[mi_size] && mi_col + x < mi_cols; ++x)
        seg_preds[mi(mi_row + y, mi_col + x)] =
            static_cast<uint8_t>(seg_id_predicted);
    read_cdef();
    read_delta_qindex();
    read_delta_lf();
    read_deltas = false;
    if (skip_mode) {
      is_inter = 1;
    } else if (seg_active(segment_id, SEG_LVL_REF_FRAME)) {
      is_inter = feature_data[segment_id][SEG_LVL_REF_FRAME] != INTRA_FRAME;
    } else if (seg_active(segment_id, SEG_LVL_GLOBALMV)) {
      is_inter = 1;
    } else {
      const bool ai = above_ref[0] <= INTRA_FRAME, li = left_ref[0] <= INTRA_FRAME;
      int ctx;
      if (avail_u && avail_l) ctx = ai && li ? 3 : ai || li;
      else if (avail_u || avail_l) ctx = 2 * (avail_u ? ai : li);
      else ctx = 0;
      is_inter = sym.read(cdf.is_inter[ctx], 2);
    }
    if (is_inter) inter_block_mode_info();
    else intra_modes(cdf.y_mode_inter[kSizeGroup[mi_size]]);
  }

  int seg_id_predicted = 0;

  int predicted_segment_id() const {
    if (prev_seg_ids.empty()) return 0;
    int seg = 7;
    for (int y = 0; y < kHigh4[mi_size] && mi_row + y < mi_rows; ++y)
      for (int x = 0; x < kWide4[mi_size] && mi_col + x < mi_cols; ++x)
        seg = std::min<int>(seg, prev_seg_ids[mi(mi_row + y, mi_col + x)]);
    return seg;
  }

  // read_inter_segment_id (libaom's, the specification's inter_segment_id)
  void inter_segment_id(bool pre_skip) {
    if (!seg_enabled) {
      segment_id = 0;
      return;
    }
    if (!seg_update_map) {
      segment_id = predicted_segment_id();
      return;
    }
    if (pre_skip && !seg_id_pre_skip) {
      segment_id = 0;
      return;
    }
    if (!pre_skip && skip) {
      seg_id_predicted = 0;
      intra_segment_id();          // the spatial prediction, unread
      return;
    }
    if (seg_temporal_update) {
      const int ctx = (avail_u ? seg_preds[mi(mi_row - 1, mi_col)] : 0) +
                      (avail_l ? seg_preds[mi(mi_row, mi_col - 1)] : 0);
      seg_id_predicted = sym.read(cdf.seg_pred[ctx], 2);
      if (seg_id_predicted) segment_id = predicted_segment_id();
      else intra_segment_id();
    } else {
      intra_segment_id();
    }
  }

  void read_skip_mode() {
    skip_mode = 0;
    if (seg_active(segment_id, SEG_LVL_SKIP) ||
        seg_active(segment_id, SEG_LVL_REF_FRAME) ||
        seg_active(segment_id, SEG_LVL_GLOBALMV) || !skip_mode_present ||
        kWide4[mi_size] < 2 || kHigh4[mi_size] < 2)
      return;
    const int ctx = (avail_u ? skip_modes[mi(mi_row - 1, mi_col)] : 0) +
                    (avail_l ? skip_modes[mi(mi_row, mi_col - 1)] : 0);
    skip_mode = sym.read(cdf.skip_mode[ctx], 2);
  }

  int count_refs(int f) const {
    int c = 0;
    if (avail_u) c += (above_ref[0] == f) + (above_ref[1] == f);
    if (avail_l) c += (left_ref[0] == f) + (left_ref[1] == f);
    return c;
  }
  static int ref_count_ctx(int a, int b) { return a < b ? 0 : a == b ? 1 : 2; }
  static bool backward(int f) { return f >= BWDREF_FRAME; }
  static bool uni_comp(const int* r) {
    return r[1] > INTRA_FRAME && backward(r[0]) == backward(r[1]);
  }

  int comp_mode_ctx() const {
    const bool as = above_ref[1] <= INTRA_FRAME, ls = left_ref[1] <= INTRA_FRAME;
    const bool ai = above_ref[0] <= INTRA_FRAME, li = left_ref[0] <= INTRA_FRAME;
    if (avail_u && avail_l) {
      if (as && ls) return backward(above_ref[0]) ^ backward(left_ref[0]);
      if (as) return 2 + (backward(above_ref[0]) || ai);
      if (ls) return 2 + (backward(left_ref[0]) || li);
      return 4;
    }
    if (avail_u) return as ? backward(above_ref[0]) : 3;
    if (avail_l) return ls ? backward(left_ref[0]) : 3;
    return 1;
  }

  // libaom's av1_get_comp_reference_type_context
  int comp_ref_type_ctx() const {
    const bool ai = above_ref[0] <= INTRA_FRAME, li = left_ref[0] <= INTRA_FRAME;
    if (avail_u && avail_l) {
      if (ai && li) return 2;
      if (ai || li) {
        const int* r = ai ? left_ref : above_ref;
        return r[1] <= INTRA_FRAME ? 2 : 1 + 2 * uni_comp(r);
      }
      const bool asg = above_ref[1] <= INTRA_FRAME, lsg = left_ref[1] <= INTRA_FRAME;
      const int fa = above_ref[0], fl = left_ref[0];
      if (asg && lsg) return 1 + 2 * !(backward(fa) ^ backward(fl));
      if (asg || lsg) {
        const bool u = asg ? uni_comp(left_ref) : uni_comp(above_ref);
        return u ? 3 + !(backward(fa) ^ backward(fl)) : 1;
      }
      const bool ua = uni_comp(above_ref), ul = uni_comp(left_ref);
      if (!ua && !ul) return 0;
      if (!ua || !ul) return 2;
      return 3 + !((fa == BWDREF_FRAME) ^ (fl == BWDREF_FRAME));
    }
    if (avail_u || avail_l) {
      const int* r = avail_u ? above_ref : left_ref;
      if (r[0] <= INTRA_FRAME || r[1] <= INTRA_FRAME) return 2;
      return 4 * uni_comp(r);
    }
    return 2;
  }

  void read_ref_frames() {
    ref_frame[1] = NONE_FRAME;
    if (skip_mode) {
      ref_frame[0] = skip_mode_frame[0];
      ref_frame[1] = skip_mode_frame[1];
      return;
    }
    if (seg_active(segment_id, SEG_LVL_REF_FRAME)) {
      ref_frame[0] = feature_data[segment_id][SEG_LVL_REF_FRAME];
      return;
    }
    if (seg_active(segment_id, SEG_LVL_SKIP) ||
        seg_active(segment_id, SEG_LVL_GLOBALMV)) {
      ref_frame[0] = LAST_FRAME;
      return;
    }
    const int last = count_refs(LAST_FRAME), last2 = count_refs(LAST2_FRAME),
              last3 = count_refs(LAST3_FRAME), gold = count_refs(GOLDEN_FRAME),
              bwd = count_refs(BWDREF_FRAME), alt2 = count_refs(ALTREF2_FRAME),
              alt = count_refs(ALTREF_FRAME);
    const int fwd_ctx = ref_count_ctx(last + last2 + last3 + gold, bwd + alt2 + alt);
    const int p3 = ref_count_ctx(last + last2, last3 + gold);
    const int p4 = ref_count_ctx(last, last2), p5 = ref_count_ctx(last3, gold);
    const int bwd_ctx = ref_count_ctx(bwd + alt2, alt);
    const int p6 = ref_count_ctx(bwd, alt2);
    const bool compound = reference_select &&
                          std::min(kWide4[mi_size], kHigh4[mi_size]) >= 2 &&
                          sym.read(cdf.comp_mode[comp_mode_ctx()], 2);
    if (compound) {
      if (!sym.read(cdf.comp_ref_type[comp_ref_type_ctx()], 2)) {   // unidir
        if (sym.read(cdf.uni_comp_ref[fwd_ctx][0], 2)) {
          ref_frame[0] = BWDREF_FRAME;
          ref_frame[1] = ALTREF_FRAME;
        } else if (sym.read(cdf.uni_comp_ref[ref_count_ctx(last2, last3 + gold)][1], 2)) {
          ref_frame[0] = LAST_FRAME;
          ref_frame[1] = sym.read(cdf.uni_comp_ref[p5][2], 2) ? GOLDEN_FRAME
                                                              : LAST3_FRAME;
        } else {
          ref_frame[0] = LAST_FRAME;
          ref_frame[1] = LAST2_FRAME;
        }
        return;
      }
      if (!sym.read(cdf.comp_ref[p3][0], 2))
        ref_frame[0] = sym.read(cdf.comp_ref[p4][1], 2) ? LAST2_FRAME : LAST_FRAME;
      else
        ref_frame[0] = sym.read(cdf.comp_ref[p5][2], 2) ? GOLDEN_FRAME : LAST3_FRAME;
      if (!sym.read(cdf.comp_bwd_ref[bwd_ctx][0], 2))
        ref_frame[1] = sym.read(cdf.comp_bwd_ref[p6][1], 2) ? ALTREF2_FRAME
                                                            : BWDREF_FRAME;
      else
        ref_frame[1] = ALTREF_FRAME;
      return;
    }
    if (sym.read(cdf.single_ref[fwd_ctx][0], 2)) {
      if (!sym.read(cdf.single_ref[bwd_ctx][1], 2))
        ref_frame[0] = sym.read(cdf.single_ref[p6][5], 2) ? ALTREF2_FRAME
                                                          : BWDREF_FRAME;
      else
        ref_frame[0] = ALTREF_FRAME;
    } else if (sym.read(cdf.single_ref[p3][2], 2)) {
      ref_frame[0] = sym.read(cdf.single_ref[p5][4], 2) ? GOLDEN_FRAME
                                                        : LAST3_FRAME;
    } else {
      ref_frame[0] = sym.read(cdf.single_ref[p4][3], 2) ? LAST2_FRAME
                                                        : LAST_FRAME;
    }
  }

  int drl_ctx(int idx) const {
    const bool a = stack[idx].weight >= REF_CAT_LEVEL;
    const bool b = stack[idx + 1].weight >= REF_CAT_LEVEL;
    return a && b ? 0 : a ? 1 : !b ? 2 : 0;
  }

  static int comp_mode_of(int y_mode, int list) {
    static const uint8_t k0[12] = {NEARESTMV, NEARMV, GLOBALMV, NEWMV,
                                   NEARESTMV, NEARMV, NEARESTMV, NEWMV,
                                   NEARMV, NEWMV, GLOBALMV, NEWMV};
    static const uint8_t k1[12] = {NEARESTMV, NEARMV, GLOBALMV, NEWMV,
                                   NEARESTMV, NEARMV, NEWMV, NEARESTMV,
                                   NEWMV, NEARMV, GLOBALMV, NEWMV};
    return (list ? k1 : k0)[y_mode - NEARESTMV];
  }

  void inter_block_mode_info() {
    ++inter_blocks;
    read_ref_frames();
    const bool compound = ref_frame[1] > INTRA_FRAME;
    compound_blocks += compound;
    find_mv_stack();
    const int new_ctx = mode_ctx & 7, zero_ctx = (mode_ctx >> 3) & 1;
    const int ref_ctx = (mode_ctx >> 4) & 15;
    if (skip_mode) {
      y_mode = NEAREST_NEARESTMV;
    } else if (seg_active(segment_id, SEG_LVL_SKIP) ||
               seg_active(segment_id, SEG_LVL_GLOBALMV)) {
      y_mode = GLOBALMV;
    } else if (compound) {
      const int ctx = kCompoundModeCtxMap[ref_ctx >> 1][std::min(new_ctx, 4)];
      y_mode = NEAREST_NEARESTMV + sym.read(cdf.compound_mode[ctx], 8);
    } else if (!sym.read(cdf.new_mv[new_ctx], 2)) {
      y_mode = NEWMV;
    } else if (!sym.read(cdf.zero_mv[zero_ctx], 2)) {
      y_mode = GLOBALMV;
    } else {
      y_mode = sym.read(cdf.ref_mv[ref_ctx], 2) ? NEARMV : NEARESTMV;
    }
    uv_mode = DC_PRED;
    ref_mv_idx = 0;
    if (y_mode == NEWMV || y_mode == NEW_NEWMV) {
      for (int idx = 0; idx < 2; ++idx)
        if (stack_n > idx + 1) {
          const int drl = sym.read(cdf.drl[drl_ctx(idx)], 2);
          ref_mv_idx = idx + drl;
          if (!drl) break;
        }
    } else if (y_mode == NEARMV || y_mode == NEAR_NEARMV ||
               y_mode == NEAR_NEWMV || y_mode == NEW_NEARMV) {
      for (int idx = 1; idx < 3; ++idx)
        if (stack_n > idx + 1) {
          const int drl = sym.read(cdf.drl[drl_ctx(idx)], 2);
          ref_mv_idx = idx + drl - 1;
          if (!drl) break;
        }
    }
    assign_mv(compound);
    // inter-intra
    if (enable_interintra_compound && !skip_mode && !compound &&
        mi_size >= BLOCK_8X8 && mi_size <= BLOCK_32X32) {
      const int g = kSizeGroup[mi_size];
      interintra = sym.read(cdf.inter_intra[g], 2);
      if (interintra) {
        ++interintra_blocks;
        interintra_mode = sym.read(cdf.inter_intra_mode[g], 4);
        ref_frame[1] = INTRA_FRAME;
        wedge_interintra = sym.read(cdf.wedge_inter_intra[mi_size], 2);
        if (wedge_interintra) {
          wedge_index = sym.read(cdf.wedge_index[mi_size], 16);
          wedge_sign = 0;
        }
      }
    }
    read_motion_mode(compound);
    // the compound type
    if (compound && !skip_mode) {
      if (enable_masked_compound) {
        int ctx = 0;
        for (int side = 0; side < 2; ++side) {
          if (!(side ? avail_l : avail_u)) continue;
          const int* r = side ? left_ref : above_ref;
          const size_t k = side ? mi(mi_row, mi_col - 1) : mi(mi_row - 1, mi_col);
          if (r[1] > INTRA_FRAME) ctx += comp_group_idxs[k];
          else if (r[0] == ALTREF_FRAME) ctx += 3;
        }
        comp_group_idx = sym.read(cdf.comp_group_idx[std::min(5, ctx)], 2);
      }
      if (comp_group_idx == 0) {
        if (enable_jnt_comp) {
          const int fwd = std::abs(get_relative_dist(order_hints[ref_frame[0]], order_hint));
          const int bck = std::abs(get_relative_dist(order_hints[ref_frame[1]], order_hint));
          int ctx = fwd == bck ? 3 : 0;
          for (int side = 0; side < 2; ++side) {
            if (!(side ? avail_l : avail_u)) continue;
            const int* r = side ? left_ref : above_ref;
            const size_t k = side ? mi(mi_row, mi_col - 1) : mi(mi_row - 1, mi_col);
            if (r[1] > INTRA_FRAME) ctx += compound_idxs[k];
            else if (r[0] == ALTREF_FRAME) ++ctx;
          }
          compound_idx = sym.read(cdf.compound_idx[ctx], 2);
          compound_type = compound_idx ? COMPOUND_AVERAGE : COMPOUND_DISTANCE;
        }
      } else {
        compound_type = kWedgeBits[mi_size]
                            ? sym.read(cdf.compound_type[mi_size], 2)
                            : int(COMPOUND_DIFFWTD);
        if (compound_type == COMPOUND_WEDGE) {
          wedge_index = sym.read(cdf.wedge_index[mi_size], 16);
          wedge_sign = sym.literal(1);
        } else {
          mask_type = sym.literal(1);
        }
      }
    } else if (interintra) {
      compound_type = wedge_interintra ? COMPOUND_WEDGE : COMPOUND_INTRA;
    }
    if (compound) {
      wedge_blocks += compound_type == COMPOUND_WEDGE;
      diffwtd_blocks += compound_type == COMPOUND_DIFFWTD;
      distance_blocks += compound_type == COMPOUND_DISTANCE;
    }
    wedge_interintra_blocks += interintra && wedge_interintra;
    // the interpolation filters
    const bool nontrans_global =
        (y_mode == GLOBALMV || y_mode == GLOBAL_GLOBALMV) &&
        std::min(kWide4[mi_size], kHigh4[mi_size]) >= 2 &&
        gm_type[ref_frame[0]] != TRANSLATION &&
        (!compound || gm_type[ref_frame[1]] != TRANSLATION);
    const int frame_filter = interpolation_filter == SWITCHABLE ? int(EIGHTTAP)
                                                                : interpolation_filter;
    interp[0] = interp[1] = frame_filter;
    if (!skip_mode && motion_mode != LOCALWARP && !nontrans_global &&
        interpolation_filter == SWITCHABLE) {
      for (int dir = 0; dir < 2; ++dir) {
        int ctx = (compound ? 4 : 0) + dir * 8;
        int lt = 3, at = 3;
        if (avail_l) {
          const size_t k = mi(mi_row, mi_col - 1);
          if (ref_frames[2 * k] == ref_frame[0] || ref_frames[2 * k + 1] == ref_frame[0])
            lt = interps[2 * k + dir];
        }
        if (avail_u) {
          const size_t k = mi(mi_row - 1, mi_col);
          if (ref_frames[2 * k] == ref_frame[0] || ref_frames[2 * k + 1] == ref_frame[0])
            at = interps[2 * k + dir];
        }
        ctx += lt == at ? lt : lt == 3 ? at : at == 3 ? lt : 3;
        interp[dir] = sym.read(cdf.interp_filter[ctx], 3);
        if (!enable_dual_filter) {
          interp[1] = interp[0];
          break;
        }
      }
      dual_filter_blocks += interp[0] != interp[1];
    }
    if (motion_mode == LOCALWARP) local_warp_params();
  }

  // assign_mv as libaom: NEAREST and NEAR from the stack (or the global
  // vector) at the frame's precision, a NEWMV read against its stack
  // entry; each vector within libaom's range
  void assign_mv(bool compound) {
    int nearest[2][2], nearv[2][2];
    if (compound) {
      for (int l = 0; l < 2; ++l) {
        std::memcpy(nearest[l], stack[0].mv[l], sizeof(nearest[l]));
        std::memcpy(nearv[l], stack[ref_mv_idx + 1].mv[l], sizeof(nearv[l]));
        lower_precision(nearest[l], allow_high_precision_mv, force_integer_mv);
        lower_precision(nearv[l], allow_high_precision_mv, force_integer_mv);
      }
    } else {
      for (int i = 0; i < 2; ++i) {
        int* v = i ? nearv[0] : nearest[0];
        std::memcpy(v, i < stack_n ? stack[i].mv[0] : global_mvs[0], 2 * sizeof(int));
        lower_precision(v, allow_high_precision_mv, force_integer_mv);
      }
      if (ref_mv_idx > 0 && y_mode == NEARMV)
        std::memcpy(nearv[0], stack[1 + ref_mv_idx].mv[0], sizeof(nearv[0]));
      nearest[1][0] = nearest[1][1] = nearv[1][0] = nearv[1][1] = 0;
    }
    int ref_mv[2][2];
    std::memcpy(ref_mv, nearest, sizeof(ref_mv));
    if (compound) {
      const int idx = ref_mv_idx + (y_mode == NEAR_NEWMV || y_mode == NEW_NEARMV);
      for (int l = 0; l < 2; ++l)
        if (comp_mode_of(y_mode, l) == NEWMV)
          std::memcpy(ref_mv[l], stack[idx].mv[l], sizeof(ref_mv[l]));
    } else if (y_mode == NEWMV && stack_n > 1) {
      std::memcpy(ref_mv[0], stack[ref_mv_idx].mv[0], sizeof(ref_mv[0]));
    }
    for (int l = 0; l < 1 + compound; ++l) {
      const int m = comp_mode_of(y_mode, l);
      if (m == NEWMV) read_mv(0, ref_mv[l], mvb[l]);
      else if (m == NEARESTMV) std::memcpy(mvb[l], nearest[l], sizeof(mvb[l]));
      else if (m == NEARMV) std::memcpy(mvb[l], nearv[l], sizeof(mvb[l]));
      else std::memcpy(mvb[l], global_mvs[l], sizeof(mvb[l]));
      if (mvb[l][0] <= MV_LOW || mvb[l][0] >= MV_UPP || mvb[l][1] <= MV_LOW ||
          mvb[l][1] >= MV_UPP)
        fail("the AV1 stream has a motion vector out of range (cv2 refuses "
             "it)");
    }
  }

  // -------------------------------------------------------------------------
  // motion modes (libaom's read_motion_mode, av1_findSamples,
  // av1_find_projection)

  int num_samples = 0, samples[LEAST_SQUARES_SAMPLES_MAX][4];
  int local_warp[6] = {0};
  bool local_valid = false;

  // the neighbours OBMC blends, above (dir 0) or left: (mi offset along
  // the edge, its width in mi, the neighbour's mi)
  template <typename F>
  void for_each_overlappable(int dir, int nb_max, F f) {
    if (!(dir ? avail_l : avail_u)) return;
    const int n4 = dir ? kHigh4[mi_size] : kWide4[mi_size];
    const int end = dir ? std::min(mi_row + n4, mi_rows)
                        : std::min(mi_col + n4, mi_cols);
    int count = 0;
    for (int pos = dir ? mi_row : mi_col; pos < end && count < nb_max;) {
      size_t k = dir ? mi(pos, mi_col - 1) : mi(mi_row - 1, pos);
      int step = std::min<int>(dir ? kHigh4[mi_sizes[k]] : kWide4[mi_sizes[k]], 16);
      if (step == 1) {      // a 4-sample pair: the one with chroma
        pos &= ~1;
        k = dir ? mi(pos + 1, mi_col - 1) : mi(mi_row - 1, pos + 1);
        step = 2;
      }
      if (is_inters[k]) {
        ++count;
        f(pos - (dir ? mi_row : mi_col), std::min(n4, step), k);
      }
      pos += step;
    }
  }

  void record_sample(size_t k, int row_offset, int sign_r, int col_offset,
                     int sign_c) {
    const int bw = kWide4[mi_sizes[k]] * 4, bh = kHigh4[mi_sizes[k]] * 4;
    int* smp = samples[num_samples++];
    smp[0] = (col_offset * 4 + sign_c * bw / 2 - 1) * 8;
    smp[1] = (row_offset * 4 + sign_r * bh / 2 - 1) * 8;
    smp[2] = smp[0] + mvs[4 * k + 1];
    smp[3] = smp[1] + mvs[4 * k];
  }

  // av1_findSamples: the neighbours of the same single reference
  int find_samples() {
    num_samples = 0;
    const int bw4 = kWide4[mi_size], bh4 = kHigh4[mi_size];
    bool do_tl = true, do_tr = true;
    auto same = [&](size_t k) {
      return ref_frames[2 * k] == ref_frame[0] && ref_frames[2 * k + 1] == NONE_FRAME;
    };
    if (avail_u) {
      size_t k = mi(mi_row - 1, mi_col);
      int sbw = kWide4[mi_sizes[k]];
      if (bw4 <= sbw) {
        const int col_offset = -(mi_col % sbw);
        if (col_offset < 0) do_tl = false;
        if (col_offset + sbw > bw4) do_tr = false;
        if (same(k)) {
          record_sample(k, 0, -1, col_offset, 1);
          if (num_samples >= LEAST_SQUARES_SAMPLES_MAX) return num_samples;
        }
      } else {
        for (int i = 0; i < std::min(bw4, mi_cols - mi_col); i += sbw) {
          k = mi(mi_row - 1, mi_col + i);
          sbw = kWide4[mi_sizes[k]];
          if (same(k)) {
            record_sample(k, 0, -1, i, 1);
            if (num_samples >= LEAST_SQUARES_SAMPLES_MAX) return num_samples;
          }
        }
      }
    }
    if (avail_l) {
      size_t k = mi(mi_row, mi_col - 1);
      int sbh = kHigh4[mi_sizes[k]];
      if (bh4 <= sbh) {
        const int row_offset = -(mi_row % sbh);
        if (row_offset < 0) do_tl = false;
        if (same(k)) {
          record_sample(k, row_offset, 1, 0, -1);
          if (num_samples >= LEAST_SQUARES_SAMPLES_MAX) return num_samples;
        }
      } else {
        for (int i = 0; i < std::min(bh4, mi_rows - mi_row); i += sbh) {
          k = mi(mi_row + i, mi_col - 1);
          sbh = kHigh4[mi_sizes[k]];
          if (same(k)) {
            record_sample(k, i, 1, 0, -1);
            if (num_samples >= LEAST_SQUARES_SAMPLES_MAX) return num_samples;
          }
        }
      }
    }
    if (do_tl && avail_l && avail_u) {
      const size_t k = mi(mi_row - 1, mi_col - 1);
      if (same(k)) {
        record_sample(k, 0, -1, 0, -1);
        if (num_samples >= LEAST_SQUARES_SAMPLES_MAX) return num_samples;
      }
    }
    if (do_tr && has_top_right() && inside(mi_row - 1, mi_col + bw4)) {
      const size_t k = mi(mi_row - 1, mi_col + bw4);
      if (same(k)) record_sample(k, 0, -1, bw4, 1);
    }
    return num_samples;
  }

  void read_motion_mode(bool compound) {
    motion_mode = SIMPLE;
    if (skip_mode || !is_motion_mode_switchable) return;
    if (std::min(kWide4[mi_size], kHigh4[mi_size]) < 2) return;
    if (!force_integer_mv && is_global_block(y_mode, mi_size, ref_frame[0])) return;
    if (compound || ref_frame[1] == INTRA_FRAME) return;
    bool overlappable = false;
    for (int dir = 0; dir < 2 && !overlappable; ++dir)
      for_each_overlappable(dir, 1 << 30, [&](int, int, size_t) { overlappable = true; });
    if (!overlappable) return;
    find_samples();
    if (force_integer_mv || num_samples == 0 || !allow_warped_motion ||
        scaled(ref_frame[0]))
      motion_mode = sym.read(cdf.use_obmc[mi_size], 2) ? OBMC : SIMPLE;
    else
      motion_mode = sym.read(cdf.motion_mode[mi_size], 3);
    obmc_blocks += motion_mode == OBMC;
    warp_blocks += motion_mode == LOCALWARP;
  }

  // resolve_divisor_32 / _64: a multiplier and a shift for 1 / d
  static int resolve_divisor(uint64_t d, int* shift) {
    const int n = 63 - __builtin_clzll(d);
    const uint64_t e = d - (uint64_t(1) << n);
    const int64_t f = n > DIV_LUT_BITS
                          ? int64_t((e + (uint64_t(1) << (n - DIV_LUT_BITS - 1))) >> (n - DIV_LUT_BITS))
                          : int64_t(e << (DIV_LUT_BITS - n));
    *shift = n + DIV_LUT_PREC_BITS;
    return Div_Lut[f];
  }

  // av1_get_shear_params: false where the model is not one the warp
  // filter takes
  static bool setup_shear(const int* m, int* shear) {
    if (m[2] <= 0) return false;
    int alpha = clip3(-32768, 32767, m[2] - (1 << WARPEDMODEL_PREC_BITS));
    int beta = clip3(-32768, 32767, m[3]);
    int shift;
    const int y = resolve_divisor(uint64_t(std::abs(m[2])), &shift) * (m[2] < 0 ? -1 : 1);
    int64_t v = (int64_t(m[4]) * (1 << WARPEDMODEL_PREC_BITS)) * y;
    int gamma = static_cast<int>(std::min<int64_t>(
        std::max<int64_t>(round2signed_64(v, shift), -32768), 32767));
    v = int64_t(m[3]) * m[4] * y;
    int delta = static_cast<int>(std::min<int64_t>(
        std::max<int64_t>(m[5] - round2signed_64(v, shift) -
                              (1 << WARPEDMODEL_PREC_BITS), -32768), 32767));
    auto reduce = [](int x) {
      return round2signed(x, WARP_PARAM_REDUCE_BITS) * (1 << WARP_PARAM_REDUCE_BITS);
    };
    alpha = reduce(alpha);
    beta = reduce(beta);
    gamma = reduce(gamma);
    delta = reduce(delta);
    if (4 * std::abs(alpha) + 7 * std::abs(beta) >= (1 << WARPEDMODEL_PREC_BITS))
      return false;
    if (4 * std::abs(gamma) + 4 * std::abs(delta) >= (1 << WARPEDMODEL_PREC_BITS))
      return false;
    shear[0] = alpha;
    shear[1] = beta;
    shear[2] = gamma;
    shear[3] = delta;
    return true;
  }


  // av1_selectSamples and av1_find_projection (find_affine_int)
  void local_warp_params() {
    const int bw = kWide4[mi_size] * 4, bh = kHigh4[mi_size] * 4;
    if (num_samples > 1) {
      const int thresh = clip3(16, 112, std::max(bw, bh));
      int n = 0;
      for (int i = 0; i < num_samples; ++i) {
        const int diff = std::abs(samples[i][2] - samples[i][0] - mvb[0][1]) +
                         std::abs(samples[i][3] - samples[i][1] - mvb[0][0]);
        if (diff > thresh) continue;
        if (n != i) std::memcpy(samples[n], samples[i], sizeof(samples[n]));
        ++n;
      }
      num_samples = std::max(n, 1);
    }
    local_valid = false;
    const int rsuy = bh / 2 - 1, rsux = bw / 2 - 1;
    const int suy = rsuy * 8, sux = rsux * 8;
    const int duy = suy + mvb[0][0], dux = sux + mvb[0][1];
    int32_t a[2][2] = {{0, 0}, {0, 0}}, bx[2] = {0, 0}, by[2] = {0, 0};
    auto sq = [](int v) { return (v * v * 4 + v * 4 * 8 + 8 * 8 * 2) >> 4; };
    auto p1 = [](int u, int v) { return (u * v * 4 + (u + v) * 2 * 8 + 8 * 8) >> 4; };
    auto p2 = [](int u, int v) { return (u * v * 4 + (u + v) * 2 * 8 + 8 * 8 * 2) >> 4; };
    for (int i = 0; i < num_samples; ++i) {
      const int dx = samples[i][2] - dux, dy = samples[i][3] - duy;
      const int sx = samples[i][0] - sux, sy = samples[i][1] - suy;
      if (std::abs(sx - dx) < LS_MV_MAX && std::abs(sy - dy) < LS_MV_MAX) {
        a[0][0] += sq(sx);
        a[0][1] += p1(sx, sy);
        a[1][1] += sq(sy);
        bx[0] += p2(sx, dx);
        bx[1] += p1(sy, dx);
        by[0] += p1(sx, dy);
        by[1] += p2(sy, dy);
      }
    }
    const int64_t det = int64_t(a[0][0]) * a[1][1] - int64_t(a[0][1]) * a[0][1];
    if (det == 0) return;
    int shift;
    int64_t idet = resolve_divisor(uint64_t(det < 0 ? -det : det), &shift) * (det < 0 ? -1 : 1);
    shift -= WARPEDMODEL_PREC_BITS;
    if (shift < 0) {       // libaom shifts an int16_t
      idet = static_cast<int16_t>(idet << -shift);
      shift = 0;
    }
    const int64_t px[2] = {int64_t(a[1][1]) * bx[0] - int64_t(a[0][1]) * bx[1],
                           -int64_t(a[0][1]) * bx[0] + int64_t(a[0][0]) * bx[1]};
    const int64_t py[2] = {int64_t(a[1][1]) * by[0] - int64_t(a[0][1]) * by[1],
                           -int64_t(a[0][1]) * by[0] + int64_t(a[0][0]) * by[1]};
    auto ndiag = [&](int64_t v) {
      const int64_t r = round2signed_64(v * idet, shift);
      return int(std::min<int64_t>(std::max<int64_t>(r, -WARPEDMODEL_NONDIAGAFFINE_CLAMP + 1),
                                   WARPEDMODEL_NONDIAGAFFINE_CLAMP - 1));
    };
    auto diag = [&](int64_t v) {
      const int64_t r = round2signed_64(v * idet, shift);
      return int(std::min<int64_t>(
          std::max<int64_t>(r, (1 << WARPEDMODEL_PREC_BITS) - WARPEDMODEL_NONDIAGAFFINE_CLAMP + 1),
          (1 << WARPEDMODEL_PREC_BITS) + WARPEDMODEL_NONDIAGAFFINE_CLAMP - 1));
    };
    int* m = local_warp;
    m[2] = diag(px[0]);
    m[3] = ndiag(px[1]);
    m[4] = ndiag(py[0]);
    m[5] = diag(py[1]);
    const int isuy = mi_row * 4 + rsuy, isux = mi_col * 4 + rsux;
    const int32_t vx = mvb[0][1] * (1 << (WARPEDMODEL_PREC_BITS - 3)) -
                       (isux * (m[2] - (1 << WARPEDMODEL_PREC_BITS)) + isuy * m[3]);
    const int32_t vy = mvb[0][0] * (1 << (WARPEDMODEL_PREC_BITS - 3)) -
                       (isux * m[4] + isuy * (m[5] - (1 << WARPEDMODEL_PREC_BITS)));
    m[0] = clip3(-WARPEDMODEL_TRANS_CLAMP, WARPEDMODEL_TRANS_CLAMP - 1, vx);
    m[1] = clip3(-WARPEDMODEL_TRANS_CLAMP, WARPEDMODEL_TRANS_CLAMP - 1, vy);
    int shear[4];
    local_valid = setup_shear(m, shear);
  }


  // -------------------------------------------------------------------------
  // Inter prediction (spec 7.11.3, as libaom rounds): each reference's
  // prediction by the 8-tap filters through the scaled position (the
  // unscaled one is its case), or by the warp filter; one reference's
  // rounded to samples, two averaged, distance-weighted or blended by a
  // mask; inter-intra blended with an intra prediction; OBMC blended
  // with the neighbours' predictions.  A 4-sample-wide luma block's
  // chroma takes each covered block's vector.

  int round0() const { return bit_depth == 12 ? 5 : 3; }
  int round1(bool compound) const {
    return compound ? 7 : bit_depth == 12 ? 9 : 11;
  }

  static int filter_index(int f, int size) {
    if (size <= 4) {
      if (f == EIGHTTAP || f == EIGHTTAP_SHARP) return 4;
      if (f == EIGHTTAP_SMOOTH) return 5;
    }
    return f;
  }

  // a w x h prediction of plane p at (x, y) from reference frame ref by
  // vector mv ([row, column], 1/8 luma samples), filters [vertical,
  // horizontal]: samples, or the compound precision
  void block_pred(int p, int ref, const int* mv, int x, int y, int w, int h,
                  const int* filt, bool compound, int* out) {
    const RefSlot& slot = refs[ref_frame_idx[ref - LAST_FRAME]];
    const Plane& P = slot.buf->planes[p];
    const int sx = p ? ssx : 0, sy = p ? ssy : 0;
    const int last_x = ((slot.upscaled_w + sx) >> sx) - 1;
    const int last_y = ((slot.frame_h + sy) >> sy) - 1;
    const int xs = x_scale[ref], ys = y_scale[ref];
    const int64_t ox = (int64_t(x) << 4) + ((2 * mv[1]) >> sx) + 8;
    const int64_t oy = (int64_t(y) << 4) + ((2 * mv[0]) >> sy) + 8;
    const int start_x = int(round2signed_64(ox * xs - (int64_t(8) << 14), 8)) + 32;
    const int start_y = int(round2signed_64(oy * ys - (int64_t(8) << 14), 8)) + 32;
    const int step_x = round2(xs, 4), step_y = round2(ys, 4);
    const int16_t(*fx)[8] = Subpel_Filters[filter_index(filt[1], w)];
    const int16_t(*fy)[8] = Subpel_Filters[filter_index(filt[0], h)];
    const int r0 = round0(), r1 = round1(compound);
    const int ih = (((h - 1) * step_y + (1 << SCALE_SUBPEL_BITS) - 1) >>
                    SCALE_SUBPEL_BITS) + 8;
    static thread_local std::vector<int32_t> tmp;
    tmp.resize(size_t(ih) * w);
    for (int r = 0; r < ih; ++r) {
      const uint16_t* row = &P.px[size_t(clip3(0, last_y, (start_y >> 10) + r - 3)) * P.stride];
      for (int c = 0; c < w; ++c) {
        const int pos = start_x + step_x * c;
        const int16_t* f = fx[(pos >> 6) & 15];
        const int base = (pos >> 10) - 3;
        int sum = 0;
        for (int t = 0; t < 8; ++t) sum += f[t] * row[clip3(0, last_x, base + t)];
        tmp[size_t(r) * w + c] = round2(sum, r0);
      }
    }
    const int maxv = (1 << bit_depth) - 1;
    for (int r = 0; r < h; ++r) {
      const int pos = (start_y & 1023) + step_y * r;
      const int16_t* f = fy[(pos >> 6) & 15];
      const int32_t* col = &tmp[size_t(pos >> 10) * w];
      for (int c = 0; c < w; ++c) {
        int sum = 0;
        for (int t = 0; t < 8; ++t) sum += f[t] * col[size_t(t) * w + c];
        const int v = round2(sum, r1);
        out[r * w + c] = compound ? v : clip3(0, maxv, v);
      }
    }
  }

  // the warp filter over 8x8 blocks (av1_highbd_warp_affine_c)
  void warp_pred(int p, int ref, const int* m, int x, int y, int w, int h,
                 bool compound, int* out) {
    const RefSlot& slot = refs[ref_frame_idx[ref - LAST_FRAME]];
    const Plane& P = slot.buf->planes[p];
    const int sx = p ? ssx : 0, sy = p ? ssy : 0;
    const int width = (slot.upscaled_w + sx) >> sx, height = (slot.frame_h + sy) >> sy;
    int shear[4];
    setup_shear(m, shear);
    const int alpha = shear[0], beta = shear[1], gamma = shear[2], delta = shear[3];
    const int r0 = round0(), r1 = round1(compound);
    const int maxv = (1 << bit_depth) - 1;
    for (int i = 0; i < h; i += 8)
      for (int j = 0; j < w; j += 8) {
        const int32_t src_x = (x + j + 4) << sx, src_y = (y + i + 4) << sy;
        const int64_t dst_x = int64_t(m[2]) * src_x + int64_t(m[3]) * src_y + m[0];
        const int64_t dst_y = int64_t(m[4]) * src_x + int64_t(m[5]) * src_y + m[1];
        const int64_t x4 = dst_x >> sx, y4 = dst_y >> sy;
        const int ix4 = int(x4 >> WARPEDMODEL_PREC_BITS);
        int sx4 = int(x4 & ((1 << WARPEDMODEL_PREC_BITS) - 1));
        const int iy4 = int(y4 >> WARPEDMODEL_PREC_BITS);
        int sy4 = int(y4 & ((1 << WARPEDMODEL_PREC_BITS) - 1));
        sx4 += alpha * -4 + beta * -4;
        sy4 += gamma * -4 + delta * -4;
        sx4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1);
        sy4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1);
        int tmp[15][8];
        for (int k = -7; k < 8; ++k) {
          const uint16_t* row = &P.px[size_t(clip3(0, height - 1, iy4 + k)) * P.stride];
          int sxk = sx4 + beta * (k + 4);
          for (int l = -4; l < 4; ++l, sxk += alpha) {
            const int16_t* f = Warped_Filters[round2(sxk, 10) + 64];
            int sum = 0;
            for (int t = 0; t < 8; ++t)
              sum += row[clip3(0, width - 1, ix4 + l - 3 + t)] * f[t];
            tmp[k + 7][l + 4] = round2(sum, r0);
          }
        }
        for (int k = -4; k < std::min(4, h - i - 4); ++k) {
          int syk = sy4 + delta * (k + 4);
          for (int l = -4; l < std::min(4, w - j - 4); ++l, syk += gamma) {
            const int16_t* f = Warped_Filters[round2(syk, 10) + 64];
            int sum = 0;
            for (int t = 0; t < 8; ++t) sum += tmp[k + t + 4][l + 4] * f[t];
            const int v = round2(sum, r1);
            out[(i + k + 4) * w + (j + l + 4)] = compound ? v : clip3(0, maxv, v);
          }
        }
      }
  }

  // the shear of each reference's global motion (valid where the warp
  // filter takes it)
  bool gm_valid[8] = {false};

  // one reference's prediction of the block's plane
  void ref_pred(int p, int l, int x, int y, int w, int h, bool compound,
                int* out) {
    const int ref = ref_frame[l];
    if (w >= 8 && h >= 8 && !force_integer_mv && !scaled(ref)) {
      if (motion_mode == LOCALWARP && local_valid) {
        warp_pred(p, ref, local_warp, x, y, w, h, compound, out);
        return;
      }
      // global motion (av1_allow_warp): the model's own warp where its
      // shear is valid, else the block's vector from it
      if (is_global_block(y_mode, mi_size, ref) && gm_valid[ref]) {
        global_warped = true;
        warp_pred(p, ref, gm_params[ref], x, y, w, h, compound, out);
        return;
      }
    }
    block_pred(p, ref, mvb[l], x, y, w, h, interp, compound, out);
  }

  std::vector<int> p0, p1;      // the references' predictions

  bool scaled(int ref) const {
    return x_scale[ref] != 1 << REF_SCALE_SHIFT || y_scale[ref] != 1 << REF_SCALE_SHIFT;
  }

  bool global_warped = false;    // the block warped by global motion

  void predict_inter() {
    const bool compound = ref_frame[1] > INTRA_FRAME;
    global_warped = false;
    scaled_blocks += scaled(ref_frame[0]) || (compound && scaled(ref_frame[1]));
    scaled_compound_blocks += compound && (scaled(ref_frame[0]) || scaled(ref_frame[1]));
    grey_blocks += refs[ref_frame_idx[ref_frame[0] - LAST_FRAME]].grey ||
                   (compound && refs[ref_frame_idx[ref_frame[1] - LAST_FRAME]].grey);
    const int maxv = (1 << bit_depth) - 1;
    for (int p = 0; p < 1 + 2 * has_chroma; ++p) {
      const int sx = p ? ssx : 0, sy = p ? ssy : 0;
      const int psz = p ? kSubSize[mi_size][ssx][ssy] : mi_size;
      const int w = kWide4[psz] * 4, h = kHigh4[psz] * 4;
      const int x0 = (mi_col >> sx) * 4, y0 = (mi_row >> sy) * 4;
      Plane& D = cur[p];
      p0.resize(size_t(w) * h);
      // a 4-sample-wide or -high luma block's chroma: each covered
      // block's own prediction where all are inter
      const int r_start = p && kHigh4[mi_size] == 1 && sy ? -1 : 0;
      const int c_start = p && kWide4[mi_size] == 1 && sx ? -1 : 0;
      bool sub8 = r_start || c_start;
      for (int r = r_start; r <= 0 && sub8; ++r)
        for (int c = c_start; c <= 0; ++c)
          sub8 &= is_inters[mi(mi_row + r, mi_col + c)] != 0;
      if (sub8) {
        const int b4w = (kWide4[mi_size] * 4) >> sx, b4h = (kHigh4[mi_size] * 4) >> sy;
        int r = r_start;
        for (int yy = 0; yy < h; yy += b4h, ++r) {
          int c = c_start;
          for (int xx = 0; xx < w; xx += b4w, ++c) {
            const size_t k = mi(mi_row + r, mi_col + c);
            const int v[2] = {mvs[4 * k], mvs[4 * k + 1]};
            const int f[2] = {interps[2 * k], interps[2 * k + 1]};
            block_pred(p, ref_frames[2 * k], v, x0 + xx, y0 + yy, b4w, b4h, f,
                       false, p0.data());
            for (int i = 0; i < b4h; ++i)
              for (int j = 0; j < b4w; ++j)
                if (y0 + yy + i < D.rows && x0 + xx + j < D.stride)
                  *D.at(y0 + yy + i, x0 + xx + j) = uint16_t(p0[i * b4w + j]);
          }
        }
        continue;
      }
      ref_pred(p, 0, x0, y0, w, h, compound, p0.data());
      if (compound) {
        p1.resize(size_t(w) * h);
        ref_pred(p, 1, x0, y0, w, h, true, p1.data());
        const int rb = 14 - round0() - 7;
        if (compound_type == COMPOUND_AVERAGE) {
          for (size_t i = 0; i < p0.size(); ++i)
            p0[i] = clip3(0, maxv, round2(p0[i] + p1[i], 1 + rb));
        } else if (compound_type == COMPOUND_DISTANCE) {
          int fwd, bck;
          distance_weights(&fwd, &bck);
          for (size_t i = 0; i < p0.size(); ++i)
            p0[i] = clip3(0, maxv, round2(int64_t(p0[i]) * fwd + int64_t(p1[i]) * bck, 4 + rb));
        } else {
          if (p == 0) build_compound_mask(w, h, rb);
          for (int i = 0; i < h; ++i)
            for (int j = 0; j < w; ++j) {
              const int mm = mask_at(i, j, sx, sy);
              const size_t k = size_t(i) * w + j;
              p0[k] = clip3(0, maxv, round2(int64_t(p0[k]) * mm + int64_t(p1[k]) * (64 - mm), 6 + rb));
            }
        }
      }
      for (int i = 0; i < h && y0 + i < D.rows; ++i)
        for (int j = 0; j < w && x0 + j < D.stride; ++j)
          *D.at(y0 + i, x0 + j) = uint16_t(p0[i * w + j]);
      if (interintra) blend_interintra(p, x0, y0, w, h, psz);
    }
    if (motion_mode == OBMC) obmc();
    global_warp_blocks += global_warped;
    global_shift_blocks += !global_warped &&
                           (y_mode == GLOBALMV || y_mode == GLOBAL_GLOBALMV) &&
                           gm_type[ref_frame[0]] > IDENTITY;
  }

  // av1_dist_wtd_comp_weight_assign
  void distance_weights(int* fwd, int* bck) const {
    const int d0 = clip3(0, MAX_FRAME_DISTANCE,
                         std::abs(get_relative_dist(order_hints[ref_frame[1]], order_hint)));
    const int d1 = clip3(0, MAX_FRAME_DISTANCE,
                         std::abs(get_relative_dist(order_hint, order_hints[ref_frame[0]])));
    const int order = d0 <= d1;
    int i = 3;
    if (d0 && d1)
      for (i = 0; i < 3; ++i) {
        const int c0 = kQuantDistWeight[i][order], c1 = kQuantDistWeight[i][!order];
        if ((d0 > d1 && d0 * c0 < d1 * c1) || (d0 <= d1 && d0 * c0 > d1 * c1)) break;
      }
    *fwd = kQuantDistLookup[i][order];
    *bck = kQuantDistLookup[i][1 - order];
  }

  // the block's blend mask at luma size (a wedge, or the difference
  // weights of the two luma predictions), and its value at a sample of
  // a subsampled plane (the mean of the luma ones it covers)
  uint8_t blend_mask[128 * 128];
  int blend_stride = 0;

  void wedge_blend_mask(int sign) {
    const int bw = kWide4[mi_size] * 4, bh = kHigh4[mi_size] * 4;
    const uint8_t* m = wedges().mask(mi_size, sign, wedge_index);
    blend_stride = bw;
    for (int i = 0; i < bh; ++i) std::memcpy(blend_mask + i * bw, m + i * 64, bw);
  }

  void build_compound_mask(int w, int h, int rb) {
    if (compound_type == COMPOUND_WEDGE) {
      wedge_blend_mask(wedge_sign);
      return;
    }
    // diffwtd_mask_d16: DIFFWTD_38, inverted by mask_type
    blend_stride = w;
    const int round = rb + bit_depth - 8;
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) {
        const int d = round2(std::abs(p0[i * w + j] - p1[i * w + j]), round);
        const int m = clip3(0, 64, 38 + d / 16);
        blend_mask[i * w + j] = uint8_t(mask_type ? 64 - m : m);
      }
  }

  int mask_at(int i, int j, int sx, int sy) const {
    const uint8_t* m = blend_mask;
    const int s = blend_stride;
    if (sx && sy)
      return round2(m[(2 * i) * s + 2 * j] + m[(2 * i) * s + 2 * j + 1] +
                    m[(2 * i + 1) * s + 2 * j] + m[(2 * i + 1) * s + 2 * j + 1], 2);
    if (sx) return round2(m[i * s + 2 * j] + m[i * s + 2 * j + 1], 1);
    return m[i * s + j];
  }

  // the inter prediction blended with an intra one by the inter-intra
  // mode's smooth weights (libaom's combine_interintra)
  void blend_interintra(int p, int x0, int y0, int w, int h, int psz) {
    if (wedge_interintra && p == 0) wedge_blend_mask(0);
    Plane& D = cur[p];
    static thread_local std::vector<int> inter;
    inter.assign(size_t(w) * h, 0);
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j)
        inter[i * w + j] = (y0 + i < D.rows && x0 + j < D.stride) ? D.get(y0 + i, x0 + j) : 0;
    static const uint8_t kMode[4] = {DC_PRED, V_PRED, H_PRED, SMOOTH_PRED};
    const int saved_ad[2] = {angle_delta_y, angle_delta_uv};
    angle_delta_y = angle_delta_uv = 0;
    const int fi = use_filter_intra;
    use_filter_intra = 0;
    predict_intra(p, x0, y0, p == 0 ? avail_l : avail_l_chroma,
                  p == 0 ? avail_u : avail_u_chroma, false, false,
                  kMode[interintra_mode], log2i(w), log2i(h));
    angle_delta_y = saved_ad[0];
    angle_delta_uv = saved_ad[1];
    use_filter_intra = fi;
    static const uint8_t kScale[22] = {32, 16, 16, 16, 8, 8, 8, 4, 4, 4, 2,
                                       2,  2,  1,  1,  1, 8, 8, 4, 4, 2, 2};
    const int scale = kScale[psz];
    for (int i = 0; i < h && y0 + i < D.rows; ++i)
      for (int j = 0; j < w && x0 + j < D.stride; ++j) {
        int m = 32;
        if (wedge_interintra) m = mask_at(i, j, p ? ssx : 0, p ? ssy : 0);
        else if (interintra_mode == II_V_PRED) m = Ii_Weights_1d[i * scale];
        else if (interintra_mode == II_H_PRED) m = Ii_Weights_1d[j * scale];
        else if (interintra_mode == II_SMOOTH_PRED) m = Ii_Weights_1d[std::min(i, j) * scale];
        uint16_t& px = *D.at(y0 + i, x0 + j);
        px = uint16_t(round2(m * px + (64 - m) * inter[i * w + j], 6));
      }
  }

  // OBMC (libaom's av1_build_obmc_inter_prediction): the above
  // neighbours' predictions blended into the block's top rows, then the
  // left ones' into its left columns
  void obmc() {
    static const int kMaxNeighbours[6] = {0, 1, 2, 3, 4, 4};
    const int bw4 = kWide4[mi_size], bh4 = kHigh4[mi_size];
    static thread_local std::vector<int> pred;
    for (int dir = 0; dir < 2; ++dir) {
      const int n4 = dir ? bh4 : bw4;
      for_each_overlappable(dir, kMaxNeighbours[log2i(n4)], [&](int rel, int op, size_t k) {
        const int v[2] = {mvs[4 * k], mvs[4 * k + 1]};
        const int f[2] = {interps[2 * k], interps[2 * k + 1]};
        const int nref = ref_frames[2 * k];
        for (int p = 0; p < 1 + 2 * has_chroma; ++p) {
          const int sx = p ? ssx : 0, sy = p ? ssy : 0;
          const int psz = p ? kSubSize[mi_size][ssx][ssy] : mi_size;
          if (dir == 0 && (psz == BLOCK_4X4 || psz == BLOCK_8X4 || psz == BLOCK_4X8))
            continue;
          int x, y, w, h, bw, bh;       // the prediction and the blend
          if (dir == 0) {
            x = ((mi_col + rel) * 4) >> sx;
            y = (mi_row * 4) >> sy;
            w = bw = (op * 4) >> sx;
            h = clip3(4, 64 >> (sy + 1), (bh4 * 4) >> (sy + 1));
            bh = (std::min(bh4 * 4, 64) >> 1) >> sy;
          } else {
            x = (mi_col * 4) >> sx;
            y = ((mi_row + rel) * 4) >> sy;
            h = bh = (op * 4) >> sy;
            w = clip3(4, 64 >> (sx + 1), (bw4 * 4) >> (sx + 1));
            bw = (std::min(bw4 * 4, 64) >> 1) >> sx;
          }
          pred.resize(size_t(w) * h);
          block_pred(p, nref, v, x, y, w, h, f, false, pred.data());
          const uint8_t* mask = Obmc_Masks[log2i(dir ? bw : bh) - 1];
          Plane& D = cur[p];
          for (int i = 0; i < bh && y + i < D.rows; ++i)
            for (int j = 0; j < bw && x + j < D.stride; ++j) {
              const int m = mask[dir ? j : i];
              uint16_t& px = *D.at(y + i, x + j);
              px = uint16_t(round2(m * px + (64 - m) * pred[i * w + j], 6));
            }
        }
      });
    }
  }

  void assign_dv() {
    find_mv_stack();
    int pred[2] = {0, 0};
    for (int i = 0; i < std::min(stack_n, 2); ++i)
      if (stack[i].mv[0][0] || stack[i].mv[0][1]) {
        pred[0] = stack[i].mv[0][0];
        pred[1] = stack[i].mv[0][1];
        break;
      }
    if (!pred[0] && !pred[1]) {      // av1_find_ref_dv
      ++intrabc_default_dv;
      const int sb4 = use_128 ? 32 : 16;
      if (mi_row - sb4 < mi_row_start) {
        pred[1] = -(sb4 * 4 + INTRABC_DELAY_PIXELS) * 8;
      } else {
        pred[0] = -(sb4 * 4 * 8);
      }
    }
    read_mv(1, pred, mvb[0]);
    if (!dv_valid())
      fail("the AV1 stream has an invalid intra block copy vector "
           "(cv2 refuses it)");
  }

  bool dv_valid() const {
    const int row = mvb[0][0], col = mvb[0][1];
    if ((row & 7) || (col & 7)) return false;
    const int lim = 1 << 14;
    if (row <= -lim || row >= lim || col <= -lim || col >= lim) return false;
    const int bw = kWide4[mi_size] * 4, bh = kHigh4[mi_size] * 4;
    const int top = mi_row * 32 + row, left = mi_col * 32 + col;
    const int bottom = (mi_row * 4 + bh) * 8 + row;
    const int right = (mi_col * 4 + bw) * 8 + col;
    const int tile_top = mi_row_start * 32, tile_left = mi_col_start * 32;
    if (top < tile_top || left < tile_left || bottom > mi_row_end * 32 ||
        right > mi_col_end * 32)
      return false;
    if (has_chroma) {     // sub-8x8 chroma reaches a column or row back
      if (bw < 8 && ssx && left < tile_left + 32) return false;
      if (bh < 8 && ssy && top < tile_top + 32) return false;
    }
    const int sb_log2 = use_128 ? 5 : 4, sb_size = 4 << sb_log2;
    const int active_sb_row = mi_row >> sb_log2;
    const int active_sb64_col = (mi_col * 4) >> 6;
    const int src_sb_row = ((bottom >> 3) - 1) / sb_size;
    const int src_sb64_col = ((right >> 3) - 1) >> 6;
    const int sb64_per_row = ((mi_col_end - mi_col_start - 1) >> 4) + 1;
    const int active_sb64 = active_sb_row * sb64_per_row + active_sb64_col;
    const int src_sb64 = src_sb_row * sb64_per_row + src_sb64_col;
    if (src_sb64 >= active_sb64 - INTRABC_DELAY_SB64) return false;
    const int gradient = 1 + INTRABC_DELAY_SB64 + (sb_size > 64);
    const int wf_offset = gradient * (active_sb_row - src_sb_row);
    if (src_sb_row > active_sb_row ||
        src_sb64_col >= active_sb64_col - INTRABC_DELAY_SB64 + wf_offset)
      return false;
    return true;
  }

  // The prediction of each plane (spec 7.11.3 for one reference, the
  // block's own vector even for sub-8x8 chroma: every neighbour's
  // RefFrame[0] is INTRA_FRAME): the frame's samples before any filter,
  // through the bilinear filter at half-sample chroma positions,
  // rounded by InterRound0 then InterRound1 bits (3 and 11; 5 and 9 at
  // 12 bits).
  void predict_intrabc() {
    const int round0 = bit_depth == 12 ? 5 : 3, round1 = 14 - round0;
    static thread_local int tmp[(128 + 8) * 128];
    static thread_local uint16_t out[128 * 128];
    for (int p = 0; p < 1 + 2 * has_chroma; ++p) {
      const int sx = p ? ssx : 0, sy = p ? ssy : 0;
      const int psz = p ? kSubSize[mi_size][ssx][ssy] : mi_size;
      const int w = kWide4[psz] * 4, h = kHigh4[psz] * 4;
      const int x0 = (mi_col >> sx) * 4, y0 = (mi_row >> sy) * 4;
      const int last_x = ((mi_cols * 4 + sx) >> sx) - 1;
      const int last_y = ((mi_rows * 4 + sy) >> sy) - 1;
      const int px = (x0 << 4) + ((2 * mvb[0][1]) >> sx);    // 1/16 samples
      const int py = (y0 << 4) + ((2 * mvb[0][0]) >> sy);
      const int fx = px & 15, fy = py & 15;
      const Plane& P = cur[p];
      for (int r = 0; r < h + 7; ++r) {
        const int yy = clip3(0, last_y, (py >> 4) + r - 3);
        for (int c = 0; c < w; ++c) {
          const int xx = (px >> 4) + c;
          const int a = P.get(yy, clip3(0, last_x, xx));
          const int b = P.get(yy, clip3(0, last_x, xx + 1));
          tmp[r * w + c] = round2((128 - 8 * fx) * a + 8 * fx * b, round0);
        }
      }
      for (int r = 0; r < h; ++r)
        for (int c = 0; c < w; ++c) {
          const int s = (128 - 8 * fy) * tmp[(r + 3) * w + c] +
                        8 * fy * tmp[(r + 4) * w + c];
          out[r * w + c] = static_cast<uint16_t>(
              clip3(0, (1 << bit_depth) - 1, round2(s, round1)));
        }
      Plane& D = cur[p];
      for (int r = 0; r < h && y0 + r < D.rows; ++r)
        for (int c = 0; c < w && x0 + c < D.stride; ++c)
          *D.at(y0 + r, x0 + c) = out[r * w + c];
    }
  }

  static int neg_deinterleave(int diff, int ref, int max) {
    if (!ref) return diff;
    if (ref >= max - 1) return max - diff - 1;
    if (2 * ref < max) {
      if (diff <= 2 * ref)
        return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
      return diff;
    }
    if (diff <= 2 * (max - ref - 1))
      return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
    return max - (diff + 1);
  }

  void intra_segment_id() {
    if (seg_enabled) {
      const int ul =
          (avail_u && avail_l) ? seg_ids[mi(mi_row - 1, mi_col - 1)] : -1;
      const int u = avail_u ? seg_ids[mi(mi_row - 1, mi_col)] : -1;
      const int l = avail_l ? seg_ids[mi(mi_row, mi_col - 1)] : -1;
      int pred;
      if (u == -1) pred = l == -1 ? 0 : l;
      else if (l == -1) pred = u;
      else pred = ul == u ? u : l;
      if (skip) {
        segment_id = pred;
      } else {
        int ctx;
        if (ul < 0) ctx = 0;
        else if (ul == u && ul == l) ctx = 2;
        else if (ul == u || ul == l || u == l) ctx = 1;
        else ctx = 0;
        const int s = sym.read(cdf.segment_id[ctx], MAX_SEGMENTS);
        segment_id = clip3(0, last_active_seg_id,
                           neg_deinterleave(s, pred, last_active_seg_id + 1));
      }
    } else {
      segment_id = 0;
    }
    lossless = lossless_array[segment_id];
  }

  void read_skip() {
    if (seg_id_pre_skip && seg_active(segment_id, SEG_LVL_SKIP)) {
      skip = 1;
      return;
    }
    const int ctx = (avail_u ? skips[mi(mi_row - 1, mi_col)] : 0) +
                    (avail_l ? skips[mi(mi_row, mi_col - 1)] : 0);
    skip = sym.read(cdf.skip[ctx], 2);
  }

  void read_cdef() {
    if (skip || coded_lossless || !enable_cdef || allow_intrabc) return;
    const int r = mi_row & ~15, c = mi_col & ~15;
    if (cdef_at(r, c) == -1) {
      const int v = sym.literal(cdef_bits);
      const int w4 = kWide4[mi_size], h4 = kHigh4[mi_size];
      for (int y = r; y < r + h4; y += 16)
        for (int x = c; x < c + w4; x += 16)
          if (y < mi_rows && x < mi_cols)
            cdef_at(y, x) = static_cast<int8_t>(v);
    }
  }

  void read_delta_qindex() {
    const int sb = use_128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_size == sb && skip) return;
    if (!read_deltas) return;
    int abs = sym.read(cdf.delta_q, 4);
    if (abs == 3) {
      const int rem = sym.literal(3) + 1;
      abs = sym.literal(rem) + (1 << rem) + 1;
    }
    if (abs) {
      const int sign = sym.literal(1);
      const int reduced_q = sign ? -abs : abs;
      current_q = clip3(1, 255, current_q + reduced_q * (1 << delta_q_res));
    }
  }

  void read_delta_lf() {
    const int sb = use_128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_size == sb && skip) return;
    if (!read_deltas || !delta_lf_present) return;
    const int count = delta_lf_multi ? (num_planes > 1 ? 4 : 2) : 1;
    for (int i = 0; i < count; ++i) {
      int abs = sym.read(
          delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf, 4);
      if (abs == 3) {
        const int n = sym.literal(3) + 1;
        abs = sym.literal(n) + (1 << n) + 1;
      }
      if (abs) {
        const int sign = sym.literal(1);
        const int red = sign ? -abs : abs;
        delta_lf[i] = clip3(-MAX_LOOP_FILTER, MAX_LOOP_FILTER,
                            delta_lf[i] + red * (1 << delta_lf_res));
      }
    }
  }

  // read_block_tx_size: a coded inter (intra block copy) block under
  // TX_MODE_SELECT splits each largest transform as its flags say;
  // every other block has one size, kept per mi as InterTxSizes
  void read_block_tx_size() {
    const int bw4 = kWide4[mi_size], bh4 = kHigh4[mi_size];
    if (tx_mode == TX_MODE_SELECT && mi_size > BLOCK_4X4 && is_inter &&
        !skip && !lossless) {
      const int mx = kMaxTxRect[mi_size];
      for (int r = 0; r < bh4; r += kTxH[mx] >> 2)
        for (int c = 0; c < bw4; c += kTxW[mx] >> 2)
          read_var_tx_size(mi_row + r, mi_col + c, mx, 0);
      return;
    }
    read_tx_size(!skip || !is_inter);
    for (int r = 0; r < bh4; ++r)
      for (int c = 0; c < bw4; ++c)
        tx_sizes[mi(mi_row + r, mi_col + c)] = static_cast<uint8_t>(tx_size);
  }

  void read_var_tx_size(int row, int col, int txs, int depth) {
    if (row >= mi_rows || col >= mi_cols) return;
    int split = 0;
    if (txs != TX_4X4 && depth < 2) {
      // the neighbours' transform widths and heights against this one's
      const int above = above_tx_width(row, col) < kTxW[txs];
      const int left = left_tx_height(row, col) < kTxH[txs];
      const int size = std::min(64, 4 * std::max(kWide4[mi_size],
                                                  kHigh4[mi_size]));
      const int max_sq = sq_tx(size);
      const int ctx = (tx_sqr_up(txs) != max_sq) * 3 + (4 - max_sq) * 6 +
                      above + left;
      split = sym.read(cdf.txfm_split[ctx], 2);
    }
    const int w4 = kTxW[txs] >> 2, h4 = kTxH[txs] >> 2;
    if (split) {
      const int sub = kSplitTx[txs];
      for (int i = 0; i < h4; i += kTxH[sub] >> 2)
        for (int j = 0; j < w4; j += kTxW[sub] >> 2)
          read_var_tx_size(row + i, col + j, sub, depth + 1);
      return;
    }
    for (int i = 0; i < h4; ++i)
      for (int j = 0; j < w4; ++j)
        tx_sizes[mi(row + i, col + j)] = static_cast<uint8_t>(txs);
    tx_size = txs;
  }

  int above_tx_width(int row, int col) const {
    if (row == mi_row) {
      if (!avail_u) return 64;
      const size_t k = mi(row - 1, col);
      if (skips[k] && is_inters[k]) return kWide4[mi_sizes[k]] * 4;
    }
    return kTxW[tx_sizes[mi(row - 1, col)]];
  }

  int left_tx_height(int row, int col) const {
    if (col == mi_col) {
      if (!avail_l) return 64;
      const size_t k = mi(row, col - 1);
      if (skips[k] && is_inters[k]) return kHigh4[mi_sizes[k]] * 4;
    }
    return kTxH[tx_sizes[mi(row, col - 1)]];
  }

  void read_tx_size(bool allow_select) {
    if (lossless) {
      tx_size = TX_4X4;
      return;
    }
    tx_size = kMaxTxRect[mi_size];
    if (mi_size > BLOCK_4X4 && allow_select && tx_mode == TX_MODE_SELECT) {
      int depth_to_4 = 0;
      for (int t = tx_size; t != TX_4X4; t = kSplitTx[t]) ++depth_to_4;
      const int cat = depth_to_4 - 1;
      const int max_depth = std::min(depth_to_4, 2);
      const int mw = kTxW[tx_size], mh = kTxH[tx_size];
      // an inter neighbour by its block's width or height
      int above = 0, left = 0;
      if (avail_u) {
        const size_t k = mi(mi_row - 1, mi_col);
        above = (is_inters[k] ? kWide4[mi_sizes[k]] * 4
                             : kTxW[tx_sizes[k]]) >= mw;
      }
      if (avail_l) {
        const size_t k = mi(mi_row, mi_col - 1);
        left = (is_inters[k] ? kHigh4[mi_sizes[k]] * 4
                            : kTxH[tx_sizes[k]]) >= mh;
      }
      const int ctx = above + left;
      const int depth = sym.read(cdf.tx_size[cat][ctx], max_depth + 1);
      for (int i = 0; i < depth; ++i) tx_size = kSplitTx[tx_size];
    }
  }

  void reset_block_context(int bw4, int bh4) {
    for (int p = 0; p < 1 + 2 * has_chroma; ++p) {
      const int sx = p ? ssx : 0, sy = p ? ssy : 0;
      for (int i = mi_col >> sx; i < ((mi_col + bw4) >> sx); ++i)
        above_level[p][i] = above_dc[p][i] = 0;
      const int r0 = mi_row - mi_row_start;
      for (int i = r0 >> sy; i < ((r0 + bh4) >> sy); ++i)
        left_level[p][i] = left_dc[p][i] = 0;
    }
  }

  // -------------------------------------------------------------------------
  // residual

  int plane_tx_size(int p) const {
    if (p == 0) return tx_size;
    const int uv = kMaxTxRect[kSubSize[mi_size][ssx][ssy]];
    if (kTxW[uv] == 64 || kTxH[uv] == 64) {
      if (kTxW[uv] == 16) return TX_16X32;
      if (kTxH[uv] == 16) return TX_32X16;
      return TX_32X32;
    }
    return uv;
  }

  void residual() {
    const int bw4 = kWide4[mi_size], bh4 = kHigh4[mi_size];
    const int wchunks = std::max(1, bw4 >> 4), hchunks = std::max(1, bh4 >> 4);
    for (int cy = 0; cy < hchunks; ++cy)
      for (int cx = 0; cx < wchunks; ++cx) {
        for (int p = 0; p < 1 + has_chroma * 2; ++p) {
          const int txs = lossless ? TX_4X4 : plane_tx_size(p);
          const int step_x = kTxW[txs] >> 2, step_y = kTxH[txs] >> 2;
          const int sx = p ? ssx : 0, sy = p ? ssy : 0;
          const int psz = p ? kSubSize[mi_size][ssx][ssy] : mi_size;
          const int n4w = kWide4[psz], n4h = kHigh4[psz];
          const int base_x = (mi_col >> sx) * 4, base_y = (mi_row >> sy) * 4;
          if (is_inter && !lossless && p == 0) {
            transform_tree(base_x + cx * 64, base_y + cy * 64,
                           std::min(n4w, 16) * 4, std::min(n4h, 16) * 4);
            continue;
          }
          for (int y = 0; y < std::min(n4h, 16 >> sy); y += step_y)
            for (int x = 0; x < std::min(n4w, 16 >> sx); x += step_x)
              transform_block(p, base_x, base_y, txs, x + ((cx << 4) >> sx),
                              y + ((cy << 4) >> sy));
        }
      }
  }

  // an inter block's luma: its transforms as read_var_tx_size split it
  void transform_tree(int x, int y, int w, int h) {
    if (x >= mi_cols * 4 || y >= mi_rows * 4) return;
    const int t = tx_sizes[mi(y >> 2, x >> 2)];
    if (w <= kTxW[t] && h <= kTxH[t]) {
      transform_block(0, x, y, kMaxTxRect[block_of(w >> 2, h >> 2)], 0, 0);
    } else if (w > h) {
      transform_tree(x, y, w / 2, h);
      transform_tree(x + w / 2, y, w / 2, h);
    } else if (w < h) {
      transform_tree(x, y, w, h / 2);
      transform_tree(x, y + h / 2, w, h / 2);
    } else {
      transform_tree(x, y, w / 2, h / 2);
      transform_tree(x + w / 2, y, w / 2, h / 2);
      transform_tree(x, y + h / 2, w / 2, h / 2);
      transform_tree(x + w / 2, y + h / 2, w / 2, h / 2);
    }
  }

  void transform_block(int p, int base_x, int base_y, int txs, int x, int y) {
    const int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
    const int sx = p ? ssx : 0, sy = p ? ssy : 0;
    const int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
    const int sb_mask = use_128 ? 31 : 15;
    const int sub_r = row & sb_mask, sub_c = col & sb_mask;
    const int step_x = kTxW[txs] >> 2, step_y = kTxH[txs] >> 2;
    const int max_x = (mi_cols * 4) >> sx, max_y = (mi_rows * 4) >> sy;
    if (start_x >= max_x || start_y >= max_y) return;
    if (!is_inter) {
      if (pal.size[p > 0]) {
        predict_palette(p, start_x, start_y, x, y, txs);
      } else {
        const bool is_cfl = p > 0 && uv_mode == UV_CFL_PRED;
        const int mode = p == 0 ? y_mode : (is_cfl ? DC_PRED : uv_mode);
        predict_intra(p, start_x, start_y,
                      (p == 0 ? avail_l : avail_l_chroma) || x > 0,
                      (p == 0 ? avail_u : avail_u_chroma) || y > 0,
                      bd(p, (sub_r >> sy) - 1, (sub_c >> sx) + step_x),
                      bd(p, (sub_r >> sy) + step_y, (sub_c >> sx) - 1),
                      mode, log2i(kTxW[txs]), log2i(kTxH[txs]));
        if (is_cfl) predict_cfl(p, start_x, start_y, txs);
      }
      if (p == 0) {
        max_luma_w = start_x + step_x * 4;
        max_luma_h = start_y + step_y * 4;
      }
    }
    if (!skip) {
      const int eob = coeffs(p, start_x, start_y, txs);
      if (eob > 0) reconstruct(p, start_x, start_y, txs);
    }
    for (int i = 0; i < step_y; ++i)
      for (int j = 0; j < step_x; ++j) {
        const int ry = (row >> sy) + i, cx = (col >> sx) + j;
        if (ry < (int)(lf_tx[p].size() / lf_stride[p]) && cx < lf_stride[p])
          lf_tx[p][size_t(ry) * lf_stride[p] + cx] = static_cast<uint8_t>(txs);
        bd(p, (sub_r >> sy) + i, (sub_c >> sx) + j) = 1;
      }
  }

  int tx_set(int txs) const {
    if (tx_sqr_up(txs) > TX_32X32) return TX_SET_DCTONLY;
    if (is_inter) {
      if (reduced_tx_set || tx_sqr_up(txs) == TX_32X32) return TX_SET_INTER_3;
      if (tx_sqr(txs) == TX_16X16) return TX_SET_INTER_2;
      return TX_SET_INTER_1;
    }
    if (tx_sqr_up(txs) == TX_32X32) return TX_SET_DCTONLY;
    if (reduced_tx_set) return TX_SET_INTRA_2;
    if (tx_sqr(txs) == TX_16X16) return TX_SET_INTRA_2;
    return TX_SET_INTRA_1;
  }

  bool in_set(int set, int type) const {
    if (set == TX_SET_DCTONLY) return type == DCT_DCT;
    if (is_inter) {
      if (set == TX_SET_INTER_1) return true;
      if (set == TX_SET_INTER_2)
        return type != V_ADST && type != H_ADST && type != V_FLIPADST &&
               type != H_FLIPADST;
      return type == IDTX || type == DCT_DCT;
    }
    if (set == TX_SET_INTRA_1)
      return type == IDTX || type == DCT_DCT || type == V_DCT ||
             type == H_DCT || type == ADST_ADST || type == ADST_DCT ||
             type == DCT_ADST;
    return type == IDTX || type == DCT_DCT || type == ADST_ADST ||
           type == ADST_DCT || type == DCT_ADST;
  }

  int compute_tx_type(int p, int txs, int x4, int y4) {
    if (lossless || tx_sqr_up(txs) > TX_32X32) return DCT_DCT;
    if (p == 0) return tx_types[mi(y4, x4)];
    if (is_inter) {     // the co-located luma type, where the set has it
      const int t = tx_types[mi(std::max(mi_row, y4 << ssy),
                                std::max(mi_col, x4 << ssx))];
      return in_set(tx_set(txs), t) ? t : DCT_DCT;
    }
    const int t = kModeToTxfm[uv_mode];
    return in_set(tx_set(txs), t) ? t : DCT_DCT;
  }

  static int tx_class(int t) {
    if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return TX_CLASS_VERT;
    if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return TX_CLASS_HORIZ;
    return TX_CLASS_2D;
  }

  const std::vector<int16_t>& get_scan(int txs) const {
    const Scans& s = scans();
    if (txs == TX_16X64) return s.def[TX_16X32];
    if (txs == TX_64X16) return s.def[TX_32X16];
    if (tx_sqr_up(txs) == TX_64X64) return s.def[TX_32X32];
    if (plane_tx_type == IDTX) return s.def[txs];
    const int t = plane_tx_type;
    if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return s.mrow[txs];
    if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return s.mcol[txs];
    return s.def[txs];
  }

  // where each (adjusted) transform size's weights start in a level
  static int qm_offset(int txs) {
    int off = 0;
    for (int t = 0; t < txs; ++t)
      if (adjusted(t) == t) off += kTxW[t] * kTxH[t];
    return off;
  }

  static int adjusted(int txs) {
    switch (txs) {
      case TX_64X64: case TX_32X64: case TX_64X32: return TX_32X32;
      case TX_16X64: return TX_16X32;
      case TX_64X16: return TX_32X16;
      default: return txs;
    }
  }

  int coeffs(int p, int start_x, int start_y, int txs) {
    const int sx = p ? ssx : 0, sy = p ? ssy : 0;
    const int x4 = start_x >> 2, y4 = start_y >> 2;
    const int w4 = kTxW[txs] >> 2, h4 = kTxH[txs] >> 2;
    const int tx_ctx = (tx_sqr(txs) + tx_sqr_up(txs) + 1) >> 1;
    const int ptype = p > 0;
    const int seg_eob = (txs == TX_16X64 || txs == TX_64X16)
                            ? 512 : std::min(1024, kTxW[txs] * kTxH[txs]);
    std::memset(quant, 0, sizeof(int32_t) * seg_eob);
    int eob = 0, cul = 0, dc_cat = 0;
    const int max_x4 = mi_cols >> sx, max_y4 = mi_rows >> sy;
    const int ly = y4 - (mi_row_start >> sy);   // the tile's left context
    // all_zero
    int ctx;
    const int psz = p ? kSubSize[mi_size][ssx][ssy] : mi_size;
    const int bw = kWide4[psz] * 4, bh = kHigh4[psz] * 4;
    const int w = kTxW[txs], h = kTxH[txs];
    if (p == 0) {
      int top = 0, left = 0;
      for (int k = 0; k < w4; ++k)
        if (x4 + k < max_x4) top = std::max<int>(top, above_level[p][x4 + k]);
      for (int k = 0; k < h4; ++k)
        if (y4 + k < max_y4) left = std::max<int>(left, left_level[p][ly + k]);
      if (bw == w && bh == h) ctx = 0;
      else if (top == 0 && left == 0) ctx = 1;
      else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
      else if (std::max(top, left) <= 3) ctx = 4;
      else if (std::min(top, left) <= 3) ctx = 5;
      else ctx = 6;
    } else {
      int above = 0, left = 0;
      for (int k = 0; k < w4; ++k)
        if (x4 + k < max_x4)
          above |= above_level[p][x4 + k] | above_dc[p][x4 + k];
      for (int k = 0; k < h4; ++k)
        if (y4 + k < max_y4) left |= left_level[p][ly + k] | left_dc[p][ly + k];
      ctx = (above != 0) + (left != 0) + 7;
      if (bw * bh > w * h) ctx += 3;
    }
    const int all_zero = sym.read(cdf.txb_skip[tx_ctx][ctx], 2);
    if (all_zero) {
      if (p == 0)
        for (int i = 0; i < w4; ++i)
          for (int j = 0; j < h4; ++j)
            if (x4 + i < mi_cols && y4 + j < mi_rows)
              tx_types[mi(y4 + j, x4 + i)] = DCT_DCT;
    } else {
      if (p == 0) transform_type(x4, y4, txs);
      plane_tx_type = compute_tx_type(p, txs, x4, y4);
      const std::vector<int16_t>& scan = get_scan(txs);
      const int cls = tx_class(plane_tx_type);
      const int eob_ms = std::min(log2i(w), 5) + std::min(log2i(h), 5) - 4;
      const int ectx = cls == TX_CLASS_2D ? 0 : 1;
      int eob_pt;
      switch (eob_ms) {
        case 0: eob_pt = sym.read(cdf.eob16[ptype][ectx], 5) + 1; break;
        case 1: eob_pt = sym.read(cdf.eob32[ptype][ectx], 6) + 1; break;
        case 2: eob_pt = sym.read(cdf.eob64[ptype][ectx], 7) + 1; break;
        case 3: eob_pt = sym.read(cdf.eob128[ptype][ectx], 8) + 1; break;
        case 4: eob_pt = sym.read(cdf.eob256[ptype][ectx], 9) + 1; break;
        case 5: eob_pt = sym.read(cdf.eob512[ptype][ectx], 10) + 1; break;
        default: eob_pt = sym.read(cdf.eob1024[ptype][ectx], 11) + 1; break;
      }
      eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
      int eob_shift = eob_pt - 3;
      if (eob_shift >= 0) {
        if (sym.read(cdf.eob_extra[tx_ctx][ptype][eob_pt - 3], 2))
          eob += 1 << eob_shift;
        for (int i = 1; i < std::max(0, eob_pt - 2); ++i) {
          eob_shift = std::max(0, eob_pt - 2) - 1 - i;
          if (sym.literal(1)) eob += 1 << eob_shift;
        }
      }
      const int adj = adjusted(txs);
      const int bwl = log2i(kTxW[adj]);
      const int txw = kTxW[adj], txh = kTxH[adj];
      for (int c = eob - 1; c >= 0; --c) {
        const int pos = scan[c];
        int level;
        if (c == eob - 1) {
          const int area = txw * txh;
          const int cctx = c == 0 ? 0 : c <= area / 8 ? 1
                           : c <= area / 4 ? 2 : 3;
          level = sym.read(cdf.base_eob[tx_ctx][ptype][cctx], 3) + 1;
        } else {
          const int bctx = base_ctx(txs, bwl, txh, pos, cls);
          level = sym.read(cdf.base[tx_ctx][ptype][bctx], 4);
        }
        if (level > 2) {
          const int bctx = br_ctx(bwl, txw, txh, pos, cls);
          for (int idx = 0; idx < 4; ++idx) {
            const int k = sym.read(cdf.br[std::min(tx_ctx, 3)][ptype][bctx], 4);
            level += k;
            if (k < 3) break;
          }
        }
        quant[pos] = level;
      }
      for (int c = 0; c < eob; ++c) {
        const int pos = scan[c];
        int sign = 0;
        if (quant[pos] != 0) {
          if (c == 0) {
            int dsign = 0;
            for (int k = 0; k < w4; ++k)
              if (x4 + k < max_x4) {
                const int s = above_dc[p][x4 + k];
                if (s == 1) --dsign;
                else if (s == 2) ++dsign;
              }
            for (int k = 0; k < h4; ++k)
              if (y4 + k < max_y4) {
                const int s = left_dc[p][ly + k];
                if (s == 1) --dsign;
                else if (s == 2) ++dsign;
              }
            const int dctx = dsign < 0 ? 1 : dsign > 0 ? 2 : 0;
            sign = sym.read(cdf.dc_sign[ptype][dctx], 2);
          } else {
            sign = sym.literal(1);
          }
        }
        if (quant[pos] > 14) {
          int length = 0;
          do {
            ++length;
            if (length > 20) fail("the AV1 stream has a malformed Golomb code");
          } while (!sym.literal(1));
          int x = 1;
          for (int i = length - 2; i >= 0; --i) x = (x << 1) | sym.literal(1);
          quant[pos] = x + 14;
        }
        if (pos == 0 && quant[pos] > 0) dc_cat = sign ? 1 : 2;
        quant[pos] &= 0xFFFFF;
        cul += quant[pos];
        if (sign) quant[pos] = -quant[pos];
      }
      cul = std::min(63, cul);
    }
    for (int i = 0; i < w4; ++i) {
      above_level[p][x4 + i] = static_cast<uint8_t>(cul);
      above_dc[p][x4 + i] = static_cast<uint8_t>(dc_cat);
    }
    for (int i = 0; i < h4; ++i) {
      left_level[p][ly + i] = static_cast<uint8_t>(cul);
      left_dc[p][ly + i] = static_cast<uint8_t>(dc_cat);
    }
    return eob;
  }

  int base_ctx(int txs, int bwl, int txh, int pos, int cls) const {
    const int row = pos >> bwl, col = pos - (row << bwl);
    int mag = 0;
    for (int i = 0; i < 5; ++i) {
      const int rr = row + kSigRefDiff[cls][i][0];
      const int cc = col + kSigRefDiff[cls][i][1];
      if (rr >= 0 && cc >= 0 && rr < txh && cc < (1 << bwl))
        mag += std::min(std::abs(quant[(rr << bwl) + cc]), 3);
    }
    const int ctx = std::min((mag + 1) >> 1, 4);
    if (cls == TX_CLASS_2D) {
      if (row == 0 && col == 0) return 0;
      const int w = kTxW[txs], h = kTxH[txs];
      int off;
      if (w < h && row < 2) off = 11;
      else if (w > h && col < 2) off = 16;
      else if (row + col < 2) off = 1;
      else if (row + col < 4) off = 6;
      else off = 21;
      return ctx + off;
    }
    const int idx = cls == TX_CLASS_VERT ? row : col;
    static const int kPos[3] = {26, 31, 36};
    return ctx + kPos[std::min(idx, 2)];
  }

  int br_ctx(int bwl, int txw, int txh, int pos, int cls) const {
    const int row = pos >> bwl, col = pos - (row << bwl);
    int mag = 0;
    for (int i = 0; i < 3; ++i) {
      const int rr = row + kMagRefOffset[cls][i][0];
      const int cc = col + kMagRefOffset[cls][i][1];
      if (rr >= 0 && cc >= 0 && rr < txh && cc < (1 << bwl))
        mag += std::min(quant[rr * txw + cc], 15);
    }
    mag = std::min((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (cls == TX_CLASS_2D) return (row < 2 && col < 2) ? mag + 7 : mag + 14;
    if (cls == TX_CLASS_HORIZ) return col == 0 ? mag + 7 : mag + 14;
    return row == 0 ? mag + 7 : mag + 14;
  }

  void transform_type(int x4, int y4, int txs) {
    const int set = tx_set(txs);
    int type = DCT_DCT;
    const int q = seg_enabled ? qindex(true, segment_id) : base_q_idx;
    if (set > 0 && q > 0) {
      const int dir =
          use_filter_intra ? kFilterIntraToDir[filter_intra_mode] : y_mode;
      const int sqr = tx_sqr(txs);
      if (is_inter) {
        uint16_t* c = cdf.inter_tx[set - 1][sqr];
        type = set == TX_SET_INTER_1 ? kTxTypeInterInvSet1[sym.read(c, 16)]
               : set == TX_SET_INTER_2 ? kTxTypeInterInvSet2[sym.read(c, 12)]
                                       : kTxTypeInterInvSet3[sym.read(c, 2)];
      } else if (set == TX_SET_INTRA_1)
        type = kTxTypeInvSet1[sym.read(cdf.intra_tx[0][sqr][dir], 7)];
      else
        type = kTxTypeInvSet2[sym.read(cdf.intra_tx[1][sqr][dir], 5)];
    }
    for (int i = 0; i < (kTxW[txs] >> 2); ++i)
      for (int j = 0; j < (kTxH[txs] >> 2); ++j)
        if (x4 + i < mi_cols && y4 + j < mi_rows)
          tx_types[mi(y4 + j, x4 + i)] = static_cast<uint8_t>(type);
  }

  // spec 7.12.2: the lookup of the bit depth
  int dc_q(int b) const {
    return Dc_Qlookup[(bit_depth - 8) >> 1][clip3(0, 255, b)];
  }
  int ac_q(int b) const {
    return Ac_Qlookup[(bit_depth - 8) >> 1][clip3(0, 255, b)];
  }

  void reconstruct(int p, int x, int y, int txs) {
    // dqDenom 2 for the 32-point sizes, 4 for the 64x32 ones: a shift
    const int area = kTxW[txs] * kTxH[txs];
    const int dq_denom = area > 1024 ? 2 : area >= 512 ? 1 : 0;
    const int log2w = log2i(kTxW[txs]), log2h = log2i(kTxH[txs]);
    const int w = 1 << log2w, h = 1 << log2h;
    const int tw = std::min(32, w), th = std::min(32, h);
    const int q = qindex(false, segment_id);
    const int dcq = dc_q(q + (p == 0 ? dq_y_dc : p == 1 ? dq_u_dc : dq_v_dc));
    const int acq = ac_q(q + (p == 0 ? 0 : p == 1 ? dq_u_ac : dq_v_ac));
    const int lim = 1 << (7 + bit_depth);
    // quantizer matrices weight 2D transforms only (libaom's
    // av1_get_iqmatrix: 1D and identity transforms get a flat matrix)
    const int qm_level = (!using_qmatrix || lossless) ? 15
                         : p == 0 ? qm_y : p == 1 ? qm_u : qm_v;
    const uint8_t* qm = (qm_level < 15 && plane_tx_type < IDTX)
                            ? Quantizer_Matrix[qm_level][p > 0] + qm_offset(adjusted(txs))
                            : nullptr;
    static thread_local int32_t res[64 * 64];
    int32_t* R = res;
    std::memset(R, 0, sizeof(int32_t) * w * h);
    for (int i = 0; i < th; ++i)
      for (int j = 0; j < tw; ++j) {
        const int32_t v = quant[i * tw + j];
        if (!v) continue;
        const int64_t a = std::abs(v);
        int q = i == 0 && j == 0 ? dcq : acq;
        if (qm) q = round2(int64_t(q) * qm[i * tw + j], 5);
        int64_t dq = (a * q) & 0xFFFFFF;
        dq >>= dq_denom;
        if (v < 0) dq = -dq;
        R[i * w + j] = static_cast<int32_t>(std::min<int64_t>(std::max<int64_t>(dq, -lim), lim - 1));
      }
    int32_t t[64];
    if (lossless) {
      for (int i = 0; i < 4; ++i) {
        for (int j = 0; j < 4; ++j) t[j] = R[i * 4 + j];
        iwht4(t, 2);
        for (int j = 0; j < 4; ++j) R[i * 4 + j] = t[j];
      }
      for (int j = 0; j < 4; ++j) {
        for (int i = 0; i < 4; ++i) t[i] = R[i * 4 + j];
        iwht4(t, 0);
        for (int i = 0; i < 4; ++i) R[i * 4 + j] = t[i];
      }
    } else {
      // each type's vertical (column) and horizontal (row) 1D kinds:
      // 0 DCT, 1 ADST, 2 FLIPADST (an ADST whose output is flipped),
      // 3 identity
      static const uint8_t kCol[16] = {0, 1, 0, 1, 2, 0, 2, 1, 2, 3, 0, 3,
                                       1, 3, 2, 3};
      static const uint8_t kRow[16] = {0, 0, 1, 1, 0, 2, 2, 2, 1, 3, 3, 0,
                                       3, 1, 3, 2};
      const int col_kind = kCol[plane_tx_type], row_kind = kRow[plane_tx_type];
      const bool flip_ud = col_kind == 2, flip_lr = row_kind == 2;
      const int row_shift = kRowShift[txs];
      const int rlim = 1 << (bit_depth + 7);
      const int clim = 1 << (std::max(bit_depth + 6, 16) - 1);
      Tx1D rowtx{-rlim, rlim - 1};
      Tx1D coltx{-clim, clim - 1};
      const bool rect = std::abs(log2w - log2h) == 1;
      static const int kRun[4] = {0, 1, 1, 2};    // Tx1D::run's kinds
      for (int i = 0; i < std::min(h, 32); ++i) {
        bool any = false;
        for (int j = 0; j < w; ++j) {
          int64_t v = R[i * w + j];
          if (rect) v = round2(v * 2896, 12);
          t[j] = static_cast<int32_t>(std::min<int64_t>(std::max<int64_t>(v, -rlim), rlim - 1));
          any |= t[j] != 0;
        }
        if (any) rowtx.run(kRun[row_kind], t, w);
        for (int j = 0; j < w; ++j)
          R[i * w + (flip_lr ? w - 1 - j : j)] = round2(t[j], row_shift);
      }
      for (int j = 0; j < w; ++j) {
        for (int i = 0; i < h; ++i) t[i] = clip3(-clim, clim - 1, R[i * w + j]);
        coltx.run(kRun[col_kind], t, h);
        for (int i = 0; i < h; ++i)
          R[(flip_ud ? h - 1 - i : i) * w + j] = round2(t[i], 4);
      }
    }
    Plane& P = cur[p];
    const int maxv = (1 << bit_depth) - 1;
    for (int i = 0; i < h; ++i) {
      if (y + i >= P.rows) break;
      uint16_t* row = P.at(y + i, 0);
      for (int j = 0; j < w; ++j) {
        if (x + j >= P.stride) break;
        row[x + j] = static_cast<uint16_t>(clip3(0, maxv, row[x + j] + R[i * w + j]));
      }
    }
  }

  // -------------------------------------------------------------------------
  // intra prediction (spec 7.11.2)

  bool is_smooth(int r, int c, int p) const {
    const int m = p == 0 ? y_modes[mi(r, c)] : uv_modes[mi(r, c)];
    return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
  }

  int filter_type(int p) const {
    bool a = false, l = false;
    if (p == 0 ? avail_u : avail_u_chroma) {
      int r = mi_row - 1, c = mi_col;
      if (p > 0) {
        if (ssx && !(mi_col & 1)) ++c;
        if (ssy && (mi_row & 1)) --r;
      }
      a = is_smooth(r, c, p);
    }
    if (p == 0 ? avail_l : avail_l_chroma) {
      int r = mi_row, c = mi_col - 1;
      if (p > 0) {
        if (ssx && (mi_col & 1)) --c;
        if (ssy && !(mi_row & 1)) ++r;
      }
      l = is_smooth(r, c, p);
    }
    return a || l;
  }

  static int edge_strength(int w, int h, int type, int delta) {
    const int d = std::abs(delta), wh = w + h;
    int s = 0;
    if (type == 0) {
      if (wh <= 8) { if (d >= 56) s = 1; }
      else if (wh <= 12) { if (d >= 40) s = 1; }
      else if (wh <= 16) { if (d >= 40) s = 1; }
      else if (wh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
      else if (wh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
      else { if (d >= 1) s = 3; }
    } else {
      if (wh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
      else if (wh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
      else if (wh <= 24) { if (d >= 4) s = 3; }
      else { if (d >= 1) s = 3; }
    }
    return s;
  }

  static bool use_upsample(int w, int h, int type, int delta) {
    const int d = std::abs(delta), wh = w + h;
    if (d <= 0 || d >= 40) return false;
    return type == 0 ? wh <= 16 : wh <= 8;
  }

  static void edge_filter(int* e, int sz, int strength) {   // e[-1 .. sz-2]
    if (!strength) return;
    int edge[300];
    for (int i = 0; i < sz; ++i) edge[i] = e[i - 1];
    for (int i = 1; i < sz; ++i) {
      int s = 0;
      for (int j = 0; j < 5; ++j) {
        const int k = clip3(0, sz - 1, i - 2 + j);
        s += kEdgeKernel[strength - 1][j] * edge[k];
      }
      e[i - 1] = (s + 8) >> 4;
    }
  }

  void edge_upsample(int* buf, int num_px) const {
    int dup[300];
    dup[0] = buf[-1];
    for (int i = -1; i < num_px; ++i) dup[i + 2] = buf[i];
    dup[num_px + 2] = buf[num_px - 1];
    buf[-2] = dup[0];
    const int maxv = (1 << bit_depth) - 1;
    for (int i = 0; i < num_px; ++i) {
      int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      s = clip3(0, maxv, round2(s, 4));
      buf[2 * i - 1] = s;
      buf[2 * i] = dup[i + 2];
    }
  }

  void predict_intra(int p, int x, int y, bool have_left, bool have_above,
                     bool have_above_right, bool have_below_left, int mode,
                     int log2w, int log2h) {
    Plane& P = cur[p];
    const int w = 1 << log2w, h = 1 << log2h;
    const int sx = p ? ssx : 0, sy = p ? ssy : 0;
    const int max_x = ((mi_cols * 4) >> sx) - 1, max_y = ((mi_rows * 4) >> sy) - 1;
    const int mid = 1 << (bit_depth - 1);
    int above_buf[320], left_buf[320];
    int* above = above_buf + 16;
    int* left = left_buf + 16;
    const int n = w + h;
    if (!have_above && have_left) {
      for (int i = -1; i < n; ++i) above[i] = P.get(y, x - 1);
    } else if (!have_above && !have_left) {
      for (int i = -1; i < n; ++i) above[i] = mid - 1;
    } else {
      const int lim = std::min(max_x, x + (have_above_right ? 2 * w : w) - 1);
      for (int i = 0; i < n; ++i) above[i] = P.get(y - 1, std::min(lim, x + i));
    }
    if (!have_left && have_above) {
      for (int i = -1; i < n; ++i) left[i] = P.get(y - 1, x);
    } else if (!have_left && !have_above) {
      for (int i = -1; i < n; ++i) left[i] = mid + 1;
    } else {
      const int lim = std::min(max_y, y + (have_below_left ? 2 * h : h) - 1);
      for (int i = 0; i < n; ++i) left[i] = P.get(std::min(lim, y + i), x - 1);
    }
    if (have_above && have_left) above[-1] = P.get(y - 1, x - 1);
    else if (have_above) above[-1] = P.get(y - 1, x);
    else if (have_left) above[-1] = P.get(y, x - 1);
    else above[-1] = mid;
    left[-1] = above[-1];

    static thread_local int pred[64][64];
    if (p == 0 && use_filter_intra) {
      filter_intra(above, left, w, h, pred);
    } else if (mode >= V_PRED && mode <= D67_PRED) {
      directional(p, x, y, have_left, have_above, mode, w, h, max_x, max_y,
                  above, left, pred);
    } else if (mode == SMOOTH_PRED) {
      const uint8_t* wx = Sm_Weight_Arrays + w - 4;
      const uint8_t* wy = Sm_Weight_Arrays + h - 4;
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j)
          pred[i][j] = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1] +
                                  wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 9);
    } else if (mode == SMOOTH_V_PRED) {
      const uint8_t* wy = Sm_Weight_Arrays + h - 4;
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j)
          pred[i][j] = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
    } else if (mode == SMOOTH_H_PRED) {
      const uint8_t* wx = Sm_Weight_Arrays + w - 4;
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j)
          pred[i][j] = round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
    } else if (mode == DC_PRED) {
      int avg;
      if (have_left && have_above) {
        int sum = 0;
        for (int k = 0; k < w; ++k) sum += above[k];
        for (int k = 0; k < h; ++k) sum += left[k];
        avg = (sum + ((w + h) >> 1)) / (w + h);
      } else if (have_left) {
        int sum = 0;
        for (int k = 0; k < h; ++k) sum += left[k];
        avg = (sum + (h >> 1)) >> log2h;
      } else if (have_above) {
        int sum = 0;
        for (int k = 0; k < w; ++k) sum += above[k];
        avg = (sum + (w >> 1)) >> log2w;
      } else {
        avg = mid;
      }
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) pred[i][j] = avg;
    } else {    // PAETH
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) {
          const int base = above[j] + left[i] - above[-1];
          const int pl = std::abs(base - left[i]), pt = std::abs(base - above[j]),
                    ptl = std::abs(base - above[-1]);
          pred[i][j] = (pl <= pt && pl <= ptl) ? left[i] : (pt <= ptl) ? above[j] : above[-1];
        }
    }
    for (int i = 0; i < h; ++i) {
      if (y + i >= P.rows) break;
      uint16_t* row = P.at(y + i, 0);
      for (int j = 0; j < w; ++j)
        if (x + j < P.stride) row[x + j] = static_cast<uint16_t>(pred[i][j]);
    }
  }

  void filter_intra(const int* above, const int* left, int w, int h,
                    int (*pred)[64]) const {
    const int maxv = (1 << bit_depth) - 1;
    const int w4 = w >> 2, h2 = h >> 1;
    for (int i2 = 0; i2 < h2; ++i2)
      for (int j4 = 0; j4 < w4; ++j4) {
        int pp[7];
        for (int i = 0; i < 7; ++i) {
          if (i < 5) {
            if (i2 == 0) pp[i] = above[(j4 << 2) + i - 1];
            else if (j4 == 0 && i == 0) pp[i] = left[(i2 << 1) - 1];
            else pp[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
          } else {
            if (j4 == 0) pp[i] = left[(i2 << 1) + i - 5];
            else pp[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
          }
        }
        for (int i = 0; i < 8; ++i) {
          int pr = 0;
          for (int j = 0; j < 7; ++j)
            pr += Filter_Intra_Taps[(filter_intra_mode * 8 + i) * 8 + j] * pp[j];
          const int v = pr >= 0 ? round2(pr, 4) : -round2(-pr, 4);
          pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = clip3(0, maxv, v);
        }
      }
  }

  void directional(int p, int x, int y, bool have_left, bool have_above,
                   int mode, int w, int h, int max_x, int max_y, int* above,
                   int* left, int (*pred)[64]) const {
    const int delta = p == 0 ? angle_delta_y : angle_delta_uv;
    const int angle = kModeToAngle[mode] + delta * 3;
    int up_above = 0, up_left = 0;
    if (enable_intra_edge_filter) {
      if (angle != 90 && angle != 180) {
        if (angle > 90 && angle < 180 && (w + h) >= 24) {
          const int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
          left[-1] = above[-1] = v;
        }
        const int type = filter_type(p);
        if (have_above) {
          const int s = edge_strength(w, h, type, angle - 90);
          const int num = std::min(w, max_x - x + 1) + (angle < 90 ? h : 0) + 1;
          edge_filter(above, num, s);
        }
        if (have_left) {
          const int s = edge_strength(w, h, type, angle - 180);
          const int num = std::min(h, max_y - y + 1) + (angle > 180 ? w : 0) + 1;
          edge_filter(left, num, s);
        }
      }
      const int type = filter_type(p);
      up_above = use_upsample(w, h, type, angle - 90);
      if (up_above) edge_upsample(above, w + (angle < 90 ? h : 0));
      up_left = use_upsample(w, h, type, angle - 180);
      if (up_left) edge_upsample(left, h + (angle > 180 ? w : 0));
    }
    int dx = 0, dy = 0;
    if (angle < 90) dx = Dr_Intra_Derivative[angle];
    else if (angle > 90 && angle < 180) dx = Dr_Intra_Derivative[180 - angle];
    if (angle > 90 && angle < 180) dy = Dr_Intra_Derivative[angle - 90];
    else if (angle > 180) dy = Dr_Intra_Derivative[270 - angle];
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) {
        int v;
        if (angle < 90) {
          const int idx = (i + 1) * dx;
          const int base = (idx >> (6 - up_above)) + (j << up_above);
          const int shift = ((idx << up_above) >> 1) & 0x1F;
          const int max_base = (w + h - 1) << up_above;
          if (base < max_base)
            v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
          else
            v = above[max_base];
        } else if (angle > 90 && angle < 180) {
          int idx = (j << 6) - (i + 1) * dx;
          int base = idx >> (6 - up_above);
          if (base >= -(1 << up_above)) {
            const int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
            v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
          } else {
            idx = (i << 6) - (j + 1) * dy;
            base = idx >> (6 - up_left);
            const int shift = ((idx * (1 << up_left)) >> 1) & 0x1F;
            v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
          }
        } else if (angle > 180) {
          const int idx = (j + 1) * dy;
          const int base = (idx >> (6 - up_left)) + (i << up_left);
          const int shift = ((idx << up_left) >> 1) & 0x1F;
          const int max_base = (w + h - 1) << up_left;
          if (base < max_base)
            v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
          else
            v = left[max_base];
        } else if (angle == 90) {
          v = above[j];
        } else {
          v = left[i];
        }
        pred[i][j] = v;
      }
  }

  void predict_cfl(int p, int sx0, int sy0, int txs) {
    const int w = kTxW[txs], h = kTxH[txs];
    const int alpha = p == 1 ? cfl_alpha_u : cfl_alpha_v;
    static thread_local int L[64][64];
    int64_t avg = 0;
    const Plane& Y = cur[0];
    for (int i = 0; i < h; ++i) {
      const int ly = std::min((sy0 + i) << ssy, max_luma_h - (1 << ssy));
      for (int j = 0; j < w; ++j) {
        const int lx = std::min((sx0 + j) << ssx, max_luma_w - (1 << ssx));
        int t = 0;
        for (int dy = 0; dy <= ssy; ++dy)
          for (int dx = 0; dx <= ssx; ++dx) t += Y.get(ly + dy, lx + dx);
        const int v = t << (3 - ssx - ssy);
        L[i][j] = v;
        avg += v;
      }
    }
    const int lavg = round2(avg, log2i(w) + log2i(h));
    Plane& P = cur[p];
    const int maxv = (1 << bit_depth) - 1;
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) {
        const int dc = P.get(sy0 + i, sx0 + j);
        const int s = alpha * (L[i][j] - lavg);
        const int scaled = s >= 0 ? round2(s, 6) : -round2(-s, 6);
        *P.at(sy0 + i, sx0 + j) = static_cast<uint16_t>(clip3(0, maxv, dc + scaled));
      }
  }

  // -------------------------------------------------------------------------
  // the deblocking filter (spec 7.14)

  void loop_filter() {
    if (!lf_level[0] && !lf_level[1]) return;
    for (int p = 0; p < num_planes; ++p) {
      if (p > 0 && !lf_level[p + 1]) continue;
      const int sx = p ? ssx : 0, sy = p ? ssy : 0;
      for (int pass = 0; pass < 2; ++pass)
        for (int row = 0; row < mi_rows; row += (1 << sy))
          for (int col = 0; col < mi_cols; col += (1 << sx))
            edge(p, pass, row, col, sx, sy);
    }
  }

  void strength(int r, int c, int p, int pass, int* lvl, int* limit,
                int* blimit, int* thresh) const {
    const int seg = seg_ids[mi(r, c)];
    const int i = p == 0 ? pass : p + 1;
    const int dlf = delta_lfs[mi(r, c) * 4 + (delta_lf_multi ? i : 0)];
    int l = clip3(0, MAX_LOOP_FILTER, dlf + lf_level[i]);
    if (seg_active(seg, SEG_LVL_ALT_LF_Y_V + i))
      l = clip3(0, MAX_LOOP_FILTER, l + feature_data[seg][SEG_LVL_ALT_LF_Y_V + i]);
    if (lf_delta_enabled) {       // the reference's and the mode's deltas
      const int scale = 1 << (l >> 5);
      const int ref = std::max<int>(INTRA_FRAME, ref_frames[2 * mi(r, c)]);
      l += lf_ref_deltas[ref] * scale;
      if (ref > INTRA_FRAME) l += lf_mode_deltas[mode_lf(y_modes[mi(r, c)])] * scale;
      l = clip3(0, MAX_LOOP_FILTER, l);
    }
    const int shift = lf_sharpness > 4 ? 2 : lf_sharpness > 0 ? 1 : 0;
    int lim = lf_sharpness > 0 ? clip3(1, 9 - lf_sharpness, l >> shift)
                               : std::max(1, l >> shift);
    *lvl = l;
    *limit = lim;
    *blimit = 2 * (l + 2) + lim;
    *thresh = l >> 4;
  }

  void edge(int p, int pass, int row, int col, int sx, int sy) {
    const int dx = pass == 0, dy = pass == 1;
    const int x = col * 4, y = row * 4;
    row |= sy;
    col |= sx;
    if (x >= frame_w || y >= frame_h) return;
    if (pass == 0 && x == 0) return;
    if (pass == 1 && y == 0) return;
    const int xp = x >> sx, yp = y >> sy;
    const int prev_row = row - (dy << sy), prev_col = col - (dx << sx);
    const int txs = lf_tx[p][size_t(row >> sy) * lf_stride[p] + (col >> sx)];
    const int prev_txs =
        lf_tx[p][size_t(prev_row >> sy) * lf_stride[p] + (prev_col >> sx)];
    // transform edges; between two skipped inter blocks only the blocks'
    // own edges
    const bool tx_edge =
        pass == 0 ? xp % kTxW[txs] == 0 : yp % kTxH[txs] == 0;
    if (!tx_edge) return;
    const size_t k = mi(row, col), kp = mi(prev_row, prev_col);
    if (skips[k] && is_inters[k] && skips[kp] && is_inters[kp]) {
      const int psz = p ? kSubSize[mi_sizes[k]][sx][sy] : mi_sizes[k];
      const bool block_edge = pass == 0 ? xp % (kWide4[psz] * 4) == 0
                                        : yp % (kHigh4[psz] * 4) == 0;
      if (!block_edge) return;
    }
    const int base = pass == 0 ? std::min(kTxW[prev_txs], kTxW[txs])
                               : std::min(kTxH[prev_txs], kTxH[txs]);
    const int fsize = p == 0 ? std::min(16, base) : std::min(8, base);
    int lvl, limit, blimit, thresh;
    strength(row, col, p, pass, &lvl, &limit, &blimit, &thresh);
    if (lvl == 0) strength(prev_row, prev_col, p, pass, &lvl, &limit, &blimit, &thresh);
    if (lvl == 0) return;
    for (int i = 0; i < 4; ++i)
      sample_filter(xp + dy * i, yp + dx * i, p, limit, blimit, thresh, dx, dy, fsize);
  }

  // spec 7.14.6: the 8-bit limits shifted to the bit depth, the flatness
  // threshold 1 << (BitDepth - 8)
  void sample_filter(int x, int y, int p, int limit, int blimit, int thresh,
                     int dx, int dy, int fsize) {
    Plane& P = cur[p];
    if (y >= P.rows || x >= P.stride) return;
    const int shift = bit_depth - 8, one = 1 << shift;
    limit <<= shift;
    blimit <<= shift;
    thresh <<= shift;
    auto at = [&](int k) -> uint16_t& { return *P.at(y + dy * k, x + dx * k); };
    // k >= 0: q_k at offset k; p_k at offset -k-1
    const int q0 = at(0), q1 = at(1), p0 = at(-1), p1 = at(-2);
    int hev = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
    const int flen = fsize == 4 ? 4 : p != 0 ? 6 : fsize == 8 ? 8 : 16;
    int mask = std::abs(p1 - p0) > limit || std::abs(q1 - q0) > limit ||
               std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > blimit;
    int q2 = 0, p2 = 0, q3 = 0, p3 = 0;
    if (flen >= 6) {
      q2 = at(2);
      p2 = at(-3);
      mask |= std::abs(p2 - p1) > limit || std::abs(q2 - q1) > limit;
    }
    if (flen >= 8) {
      q3 = at(3);
      p3 = at(-4);
      mask |= std::abs(p3 - p2) > limit || std::abs(q3 - q2) > limit;
    }
    if (mask) return;
    int flat = 0, flat2 = 0;
    if (fsize >= 8) {
      int m = std::abs(p1 - p0) > one || std::abs(q1 - q0) > one ||
              std::abs(p2 - p0) > one || std::abs(q2 - q0) > one;
      if (flen >= 8)
        m |= std::abs(p3 - p0) > one || std::abs(q3 - q0) > one;
      flat = !m;
    }
    if (fsize >= 16) {
      const int q4 = at(4), q5 = at(5), q6 = at(6), p4 = at(-5), p5 = at(-6), p6 = at(-7);
      flat2 = !(std::abs(p6 - p0) > one || std::abs(q6 - q0) > one ||
                std::abs(p5 - p0) > one || std::abs(q5 - q0) > one ||
                std::abs(p4 - p0) > one || std::abs(q4 - q0) > one);
    }
    if (fsize == 4 || !flat) {
      const int half = 1 << (bit_depth - 1);
      auto c4 = [half](int v) { return clip3(-half, half - 1, v); };
      const int ps1 = p1 - half, ps0 = p0 - half, qs0 = q0 - half,
                qs1 = q1 - half;
      int f = hev ? c4(ps1 - qs1) : 0;
      f = c4(f + 3 * (qs0 - ps0));
      const int f1 = c4(f + 4) >> 3, f2 = c4(f + 3) >> 3;
      at(0) = static_cast<uint16_t>(c4(qs0 - f1) + half);
      at(-1) = static_cast<uint16_t>(c4(ps0 + f2) + half);
      if (!hev) {
        const int f3 = round2(f1, 1);
        at(1) = static_cast<uint16_t>(c4(qs1 - f3) + half);
        at(-2) = static_cast<uint16_t>(c4(ps1 + f3) + half);
      }
    } else {
      const int log2size = (fsize == 8 || !flat2) ? 3 : 4;
      const int n = log2size == 4 ? 6 : p == 0 ? 3 : 2;
      const int n2 = (log2size == 3 && p == 0) ? 0 : 1;
      int s[16], F[16];
      for (int k = -(n + 1); k <= n; ++k) s[k + 8] = at(k);   // offsets
      for (int i = -n; i < n; ++i) {
        int t = 0;
        for (int j = -n; j <= n; ++j) {
          const int pp = clip3(-(n + 1), n, i + j);
          const int tap = std::abs(j) <= n2 ? 2 : 1;
          t += s[pp + 8] * tap;
        }
        F[i + 8] = round2(t, log2size);
      }
      for (int i = -n; i < n; ++i) at(i) = static_cast<uint16_t>(F[i + 8]);
    }
  }

  // -------------------------------------------------------------------------
  // CDEF (spec 7.15)

  void cdef() {
    if (!enable_cdef || coded_lossless || allow_intrabc) return;
    Plane src[3];
    for (int p = 0; p < num_planes; ++p) src[p] = cur[p];
    for (int r = 0; r < mi_rows; r += 16)
      for (int c = 0; c < mi_cols; c += 16) {
        const int idx = cdef_at(r, c);
        if (idx == -1) continue;
        for (int y = r; y < std::min(r + 16, mi_rows); y += 2)
          for (int x = c; x < std::min(c + 16, mi_cols); x += 2) {
            const bool skipped = skips[mi(y, x)] && skips[mi(y + 1, x)] &&
                                 skips[mi(y, x + 1)] && skips[mi(y + 1, x + 1)];
            if (skipped) continue;
            // strengths and damping shifted by BitDepth - 8 (spec 7.15.1)
            const int shift = bit_depth - 8;
            int var = 0;
            const int ydir = cdef_direction(src[0], y, x, &var);
            int pri = cdef_y_pri[idx] << shift, sec = cdef_y_sec[idx] << shift;
            int dir = pri == 0 ? 0 : ydir;
            const int vs = (var >> 6) ? std::min(floor_log2(var >> 6), 12) : 0;
            pri = var ? (pri * (4 + vs) + 8) >> 4 : 0;
            cdef_filter(src, 0, y, x, pri, sec, cdef_damping + shift, dir);
            if (num_planes > 1) {
              pri = cdef_uv_pri[idx] << shift;
              sec = cdef_uv_sec[idx] << shift;
              dir = pri == 0 ? 0 : kCdefUvDir[ssx][ssy][ydir];
              const int damping = cdef_damping - 1 + shift;
              cdef_filter(src, 1, y, x, pri, sec, damping, dir);
              cdef_filter(src, 2, y, x, pri, sec, damping, dir);
            }
          }
      }
  }

  int cdef_direction(const Plane& P, int r, int c, int* var) const {
    int cost[8] = {0}, partial[8][15] = {{0}};
    const int x0 = c * 4, y0 = r * 4;
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j) {
        const int x = (P.get(y0 + i, x0 + j) >> (bit_depth - 8)) - 128;
        partial[0][i + j] += x;
        partial[1][i + j / 2] += x;
        partial[2][i] += x;
        partial[3][3 + i - j / 2] += x;
        partial[4][7 + i - j] += x;
        partial[5][3 - i / 2 + j] += x;
        partial[6][j] += x;
        partial[7][i / 2 + j] += x;
      }
    for (int i = 0; i < 8; ++i) {
      cost[2] += partial[2][i] * partial[2][i];
      cost[6] += partial[6][i] * partial[6][i];
    }
    cost[2] *= Div_Table[8];
    cost[6] *= Div_Table[8];
    for (int i = 0; i < 7; ++i) {
      cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) * Div_Table[i + 1];
      cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) * Div_Table[i + 1];
    }
    cost[0] += partial[0][7] * partial[0][7] * Div_Table[8];
    cost[4] += partial[4][7] * partial[4][7] * Div_Table[8];
    for (int i = 1; i < 8; i += 2) {
      for (int j = 0; j < 5; ++j) cost[i] += partial[i][3 + j] * partial[i][3 + j];
      cost[i] *= Div_Table[8];
      for (int j = 0; j < 3; ++j)
        cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) * Div_Table[2 * j + 2];
    }
    int best = 0, dir = 0;
    for (int i = 0; i < 8; ++i)
      if (cost[i] > best) {
        best = cost[i];
        dir = i;
      }
    *var = (best - cost[(dir + 4) & 7]) >> 10;
    return dir;
  }

  // constrain() of the spec, its damping shift max(0, damping -
  // FloorLog2(threshold)) given
  static int constrain(int diff, int threshold, int adj) {
    if (!threshold) return 0;
    const int v = std::min(std::abs(diff), std::max(0, threshold - (std::abs(diff) >> adj)));
    return diff < 0 ? -v : v;
  }

  void cdef_filter(const Plane* src, int p, int r, int c, int pri, int sec,
                   int damping, int dir) {
    const int sx = p ? ssx : 0, sy = p ? ssy : 0;
    const int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy;
    const int w = 8 >> sx, h = 8 >> sy;
    const Plane& S = src[p];
    Plane& D = cur[p];
    const int pri_adj = pri ? std::max(0, damping - floor_log2(pri)) : 0;
    const int sec_adj = sec ? std::max(0, damping - floor_log2(sec)) : 0;
    // the primary taps by the strength at 8 bits
    const int taps = (pri >> (bit_depth - 8)) & 1;
    auto get = [&](int yy, int xx, bool* ok) {
      *ok = yy >= 0 && xx >= 0 && ((yy << sy) >> 2) < mi_rows &&
            ((xx << sx) >> 2) < mi_cols;
      return *ok ? S.get(yy, xx) : 0;
    };
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) {
        const int x = S.get(y0 + i, x0 + j);
        int sum = 0, mx = x, mn = x;
        for (int k = 0; k < 2; ++k)
          for (int sign = -1; sign <= 1; sign += 2) {
            bool ok;
            const int pv = get(y0 + i + sign * kCdefDirections[dir][k][0],
                               x0 + j + sign * kCdefDirections[dir][k][1], &ok);
            if (ok) {
              sum += kCdefPriTaps[taps][k] * constrain(pv - x, pri, pri_adj);
              mx = std::max(pv, mx);
              mn = std::min(pv, mn);
            }
            for (int off = -2; off <= 2; off += 4) {
              const int d2 = (dir + off) & 7;
              const int s = get(y0 + i + sign * kCdefDirections[d2][k][0],
                                x0 + j + sign * kCdefDirections[d2][k][1], &ok);
              if (ok) {
                sum += kCdefSecTaps[taps][k] * constrain(s - x, sec, sec_adj);
                mx = std::max(s, mx);
                mn = std::min(s, mn);
              }
            }
          }
        *D.at(y0 + i, x0 + j) =
            static_cast<uint16_t>(clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4)));
      }
  }

  // The stages after the tiles: deblocking, CDEF, superres, loop
  // restoration, film grain.
  void post_filters() {
    loop_filter();
    bool lr = false;
    for (int p = 0; p < num_planes; ++p) lr |= lr_frame_type[p] != RESTORE_NONE;
    Plane deb[3];
    if (lr)
      for (int p = 0; p < num_planes; ++p) deb[p] = cur[p];
    cdef();
    if (upscaled_w != frame_w)
      for (int p = 0; p < num_planes; ++p) {
        cur[p] = upscale(cur[p], p);
        if (lr) deb[p] = upscale(deb[p], p);
      }
    if (lr) restore(deb);
  }

  // -------------------------------------------------------------------------
  // Superres (spec 7.16), as libaom upscales: each tile column on its own
  // (av1_upscale_normative_rows), its start position carried from the
  // column before, the frame's left and right edges extended; a column
  // reads its neighbours' pixels across its inner edges.  The coded plane
  // is read up to its 8-aligned width.

  Plane upscale(const Plane& src, int p) const {
    const int sx = p ? ssx : 0, sy = p ? ssy : 0;
    const int down_w = (frame_w + sx) >> sx, up_w = (upscaled_w + sx) >> sx;
    const int rows = (frame_h + sy) >> sy;
    Plane dst;
    dst.stride = up_w;
    dst.rows = rows;
    dst.px.assign(size_t(up_w) * rows, 0);
    const int maxv = (1 << bit_depth) - 1;
    const int32_t step = ((down_w << 14) + up_w / 2) / up_w;
    const int err = up_w * step - (down_w << 14);
    int32_t x0 = static_cast<int32_t>(
        static_cast<uint32_t>((-((up_w - down_w) << 13) + up_w / 2) / up_w +
                              (1 << 7) - err / 2) & ((1u << 14) - 1));
    for (int t = 0; t < tile_cols; ++t) {
      const int dx0 = mi_col_starts[t] << (2 - sx);
      const int dx1 = mi_col_starts[t + 1] << (2 - sx);
      const int ux0 = dx0 * superres_denom / SUPERRES_NUM;
      const int ux1 = t == tile_cols - 1 ? up_w
                                         : dx1 * superres_denom / SUPERRES_NUM;
      const int lo = t == 0 ? 0 : -(1 << 30);
      const int hi = t == tile_cols - 1 ? dx1 - 1 : (1 << 30);
      for (int y = 0; y < rows; ++y) {
        const uint16_t* row = &src.px[size_t(y) * src.stride];
        uint16_t* out = &dst.px[size_t(y) * dst.stride];
        int32_t pos = x0;
        for (int x = ux0; x < ux1; ++x, pos += step) {
          const int base = dx0 + (pos >> 14) - 4;
          const int16_t* f = Upscale_Filter[(pos & ((1 << 14) - 1)) >> 8];
          int sum = 0;
          for (int k = 0; k < 8; ++k)
            sum += row[clip3(lo, hi, base + k)] * f[k];
          out[x] = static_cast<uint16_t>(clip3(0, maxv, round2(sum, 7)));
        }
      }
      x0 += (ux1 - ux0) * step - ((dx1 - dx0) << 14);
    }
    return dst;
  }

  // -------------------------------------------------------------------------
  // Loop restoration (spec 7.17): cur holds the CDEF output, deb the
  // deblocked frame before CDEF (both upscaled).  Each stripe of 64 luma
  // rows, 8 rows up, reads its own rows from cur and up to 2 rows above
  // and below it from deb; rows and columns clamp to the plane.  Filtered
  // one stripe of one unit at a time.

  void restore(const Plane* deb) {
    for (int p = 0; p < num_planes; ++p) {
      if (lr_frame_type[p] == RESTORE_NONE) continue;
      const int sx = p ? ssx : 0, sy = p ? ssy : 0;
      const int pw = (upscaled_w + sx) >> sx, ph = (frame_h + sy) >> sy;
      const int unit = lr_size[p], sh = 64 >> sy, off = 8 >> sy;
      const Plane cdef_out = cur[p];
      for (int s = 0; s * sh - off < ph; ++s) {
        const int start = s * sh - off, end = start + sh - 1;
        const int y0 = std::max(0, start), y1 = std::min(ph, end + 1);
        const int ur = std::min(lr_rows[p] - 1, (y0 + off) / unit);
        for (int uc = 0; uc < lr_cols[p]; ++uc) {
          const LrUnit& u = lr_units[p][size_t(ur) * lr_cols[p] + uc];
          if (u.type == RESTORE_NONE) continue;
          const int x0 = uc * unit;
          const int x1 = uc == lr_cols[p] - 1 ? pw : x0 + unit;
          // the source window: 3 pixels around the block
          const int w = x1 - x0, h = y1 - y0, ww = w + 6;
          std::vector<int> win(size_t(ww) * (h + 6));
          for (int i = 0; i < h + 6; ++i) {
            int y = clip3(0, ph - 1, y0 + i - 3);
            const Plane* from = &cdef_out;
            if (y < start) {
              y = std::max(start - 2, y);
              from = &deb[p];
            } else if (y > end) {
              y = std::min(end + 2, y);
              from = &deb[p];
            }
            for (int j = 0; j < ww; ++j)
              win[size_t(i) * ww + j] = from->get(y, clip3(0, pw - 1, x0 + j - 3));
          }
          if (u.type == RESTORE_WIENER)
            wiener(u, win.data(), ww, w, h, p, x0, y0);
          else
            self_guided(u, win.data(), ww, w, h, p, x0, y0);
        }
      }
    }
  }

  // spec 7.17.4: InterRound0 3 and InterRound1 11, 5 and 9 at 12 bits
  void wiener(const LrUnit& u, const int* win, int ww, int w, int h, int p,
              int x0, int y0) {
    int f[2][7];
    for (int pass = 0; pass < 2; ++pass) {
      f[pass][3] = 128;
      for (int i = 0; i < 3; ++i) {
        f[pass][i] = f[pass][6 - i] = u.wiener[pass][i];
        f[pass][3] -= 2 * u.wiener[pass][i];
      }
    }
    const int round0 = bit_depth == 12 ? 5 : 3, round1 = 14 - round0;
    const int offset = 1 << (bit_depth + 7 - round0 - 1);
    const int limit = (1 << (bit_depth + 1 + 7 - round0)) - 1;
    const int maxv = (1 << bit_depth) - 1;
    std::vector<int> mid(size_t(h + 6) * w);
    for (int r = 0; r < h + 6; ++r)
      for (int c = 0; c < w; ++c) {
        int sum = 0;
        for (int t = 0; t < 7; ++t) sum += f[1][t] * win[size_t(r) * ww + c + t];
        mid[size_t(r) * w + c] =
            clip3(-offset, limit - offset, round2(sum, round0));
      }
    for (int r = 0; r < h; ++r)
      for (int c = 0; c < w; ++c) {
        int sum = 0;
        for (int t = 0; t < 7; ++t) sum += f[0][t] * mid[size_t(r + t) * w + c];
        *cur[p].at(y0 + r, x0 + c) =
            static_cast<uint16_t>(clip3(0, maxv, round2(sum, round1)));
      }
  }

  // spec 7.17.3: box filters of radius 2 (A and B on every other row) and
  // 1, then the projection
  void self_guided(const LrUnit& u, const int* win, int ww, int w, int h,
                   int p, int x0, int y0) {
    std::vector<int> flt[2];
    for (int pass = 0; pass < 2; ++pass) {
      const int r = Sgr_Params[u.sgr_set][pass];
      if (r) flt[pass] = box_filter(win, ww, w, h, y0, r, Sgr_Params[u.sgr_set][2 + pass]);
    }
    const int w0 = u.sgr_xqd[0], w1 = u.sgr_xqd[1];
    const int w2 = (1 << SGRPROJ_PRJ_BITS) - w0 - w1;
    const int maxv = (1 << bit_depth) - 1;
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) {
        const int px = win[size_t(i + 3) * ww + j + 3] << SGRPROJ_RST_BITS;
        int64_t v = int64_t(w1) * px;
        v += int64_t(w0) * (flt[0].empty() ? px : flt[0][size_t(i) * w + j]);
        v += int64_t(w2) * (flt[1].empty() ? px : flt[1][size_t(i) * w + j]);
        const int o = round2(v, SGRPROJ_RST_BITS + SGRPROJ_PRJ_BITS);
        *cur[p].at(y0 + i, x0 + j) = static_cast<uint16_t>(clip3(0, maxv, o));
      }
  }

  std::vector<int> box_filter(const int* win, int ww, int w, int h, int y0,
                              int r, int s) const {
    const int n = (2 * r + 1) * (2 * r + 1);
    const int one_over_n = ((1 << SGRPROJ_RECIP_BITS) + n / 2) / n;
    const int aw = w + 2;
    std::vector<int> A(size_t(aw) * (h + 2)), B(A.size());
    for (int i = -1; i <= h; ++i) {
      if (r == 2 && !((y0 + i) & 1)) continue;     // only odd rows
      for (int j = -1; j <= w; ++j) {
        int a = 0, b = 0;
        for (int dy = -r; dy <= r; ++dy)
          for (int dx = -r; dx <= r; ++dx) {
            const int c = win[size_t(i + 3 + dy) * ww + j + 3 + dx];
            a += c * c;
            b += c;
          }
        // a and b at 8 bits for the variance (spec 7.17.3)
        const int64_t a8 = round2(a, 2 * (bit_depth - 8)),
                      b8 = round2(b, bit_depth - 8);
        const int64_t pv = std::max<int64_t>(0, a8 * n - b8 * b8);
        const int z = static_cast<int>((pv * s + (1 << (SGRPROJ_MTABLE_BITS - 1))) >>
                                       SGRPROJ_MTABLE_BITS);
        int a2;
        if (z >= 255) a2 = 256;
        else if (z == 0) a2 = 1;
        else a2 = ((z << SGRPROJ_SGR_BITS) + z / 2) / (z + 1);
        const int64_t b2 = int64_t((1 << SGRPROJ_SGR_BITS) - a2) * b * one_over_n;
        A[size_t(i + 1) * aw + j + 1] = a2;
        B[size_t(i + 1) * aw + j + 1] = round2(b2, SGRPROJ_RECIP_BITS);
      }
    }
    std::vector<int> F(size_t(w) * h);
    for (int i = 0; i < h; ++i) {
      const bool odd = (y0 + i) & 1;
      const int shift = r == 2 && odd ? 4 : 5;
      for (int j = 0; j < w; ++j) {
        int a = 0, b = 0;
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx) {
            int weight;
            if (r == 2) weight = ((y0 + i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
            else weight = (dx == 0 || dy == 0) ? 4 : 3;
            if (!weight) continue;
            const size_t k = size_t(i + 1 + dy) * aw + j + 1 + dx;
            a += weight * A[k];
            b += weight * B[k];
          }
        const int v = a * win[size_t(i + 3) * ww + j + 3] + b;
        F[size_t(i) * w + j] = round2(v, SGRPROJ_SGR_BITS + shift - SGRPROJ_RST_BITS);
      }
    }
    return F;
  }

  // -------------------------------------------------------------------------
  // Film grain synthesis (spec 7.18.3) at the bit depth, as libaom's
  // av1_add_film_grain_run computes it

  uint16_t random_register = 0;
  int random_number(int bits) {
    const uint16_t r = random_register;
    const int bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    random_register = static_cast<uint16_t>((r >> 1) | (bit << 15));
    return (random_register >> (16 - bits)) & ((1 << bits) - 1);
  }

  void add_grain() {
    const FilmGrain& g = grain;
    const int depth_shift = bit_depth - 8;
    const int center = 128 << depth_shift;
    const int gmin = -center, gmax = (256 << depth_shift) - 1 - center;
    // the templates: luma 73x82, chroma at the subsampled size
    std::vector<std::array<int, 82>> luma(73), chroma[2] = {
        std::vector<std::array<int, 82>>(73), std::vector<std::array<int, 82>>(73)};
    const int shift = 12 - bit_depth + g.grain_scale_shift;
    random_register = static_cast<uint16_t>(g.seed);
    for (auto& row : luma)
      for (int& v : row)
        v = g.num_y ? round2(Gaussian_Sequence[random_number(11)], shift) : 0;
    const int ar_shift = g.ar_shift, lag = g.ar_lag;
    if (g.num_y)
      for (int y = 3; y < 73; ++y)
        for (int x = 3; x < 82 - 3; ++x) {
          int sum = 0, pos = 0;
          for (int dr = -lag; dr <= 0; ++dr)
            for (int dc = -lag; dc <= lag; ++dc) {
              if (dr == 0 && dc == 0) break;
              sum += luma[y + dr][x + dc] * g.ar_y[pos++];
            }
          luma[y][x] = clip3(gmin, gmax, luma[y][x] + round2(sum, ar_shift));
        }
    const int cw = ssx ? 44 : 82, ch = ssy ? 38 : 73;
    const bool use[2] = {g.num_cb > 0 || g.chroma_from_luma,
                         g.num_cr > 0 || g.chroma_from_luma};
    const int* ar[2] = {g.ar_cb, g.ar_cr};
    if (num_planes > 1) {
      for (int c = 0; c < 2; ++c) {
        random_register = static_cast<uint16_t>(g.seed ^ (c ? 0x49d8 : 0xb524));
        for (int y = 0; y < ch; ++y)
          for (int x = 0; x < cw; ++x)
            chroma[c][y][x] =
                use[c] ? round2(Gaussian_Sequence[random_number(11)], shift) : 0;
      }
      for (int y = 3; y < ch; ++y)
        for (int x = 3; x < cw - 3; ++x)
          for (int c = 0; c < 2; ++c) {
            if (!use[c]) continue;
            int sum = 0, pos = 0;
            for (int dr = -lag; dr <= 0; ++dr)
              for (int dc = -lag; dc <= lag; ++dc) {
                if (dr == 0 && dc == 0) {
                  if (g.num_y) {
                    int l = 0;
                    const int ly = ((y - 3) << ssy) + 3, lx = ((x - 3) << ssx) + 3;
                    for (int i = 0; i <= ssy; ++i)
                      for (int j = 0; j <= ssx; ++j) l += luma[ly + i][lx + j];
                    sum += round2(l, ssx + ssy) * ar[c][pos];
                  }
                  break;
                }
                sum += ar[c][pos++] * chroma[c][y + dr][x + dc];
              }
            chroma[c][y][x] = clip3(gmin, gmax, chroma[c][y][x] + round2(sum, ar_shift));
          }
    }
    // the scaling look-ups
    int lut[3][256];
    for (int p = 0; p < num_planes; ++p) {
      const int (*pts)[2] = p == 0 || g.chroma_from_luma ? g.y_pts
                            : p == 1 ? g.cb_pts : g.cr_pts;
      const int n = p == 0 || g.chroma_from_luma ? g.num_y
                    : p == 1 ? g.num_cb : g.num_cr;
      if (!n) {
        std::fill(lut[p], lut[p] + 256, 0);
        continue;
      }
      for (int i = 0; i < pts[0][0]; ++i) lut[p][i] = pts[0][1];
      for (int i = 0; i < n - 1; ++i) {
        const int dy = pts[i + 1][1] - pts[i][1], dx = pts[i + 1][0] - pts[i][0];
        const int64_t delta = int64_t(dy) * ((65536 + (dx >> 1)) / dx);
        for (int x = 0; x < dx; ++x)
          lut[p][pts[i][0] + x] = pts[i][1] + static_cast<int>((x * delta + 32768) >> 16);
      }
      for (int i = pts[n - 1][0]; i < 256; ++i) lut[p][i] = pts[n - 1][1];
    }
    // above 8 bits, interpolated between the look-up's entries (the
    // specification's scale_lut)
    auto scale = [&](int p, int index) {
      const int x = index >> depth_shift;
      if (!depth_shift || x == 255) return lut[p][x];
      const int frac = index & ((1 << depth_shift) - 1);
      return lut[p][x] + (((lut[p][x + 1] - lut[p][x]) * frac +
                           (1 << (depth_shift - 1))) >> depth_shift);
    };
    // the noise stripes: 34 rows of 32x32 blocks at random offsets, their
    // overlaps blended
    const int w = upscaled_w, h = frame_h;
    const int stripes = (h + 1) / 2 / 16 + 1, sw = ((w + 1) / 2 + 16) * 2 + 34;
    std::vector<int> noise[3];
    for (int p = 0; p < num_planes; ++p) noise[p].assign(size_t(stripes) * 34 * sw, 0);
    auto ns = [&](int p, int stripe, int i, int x) -> int& {
      return noise[p][(size_t(stripe) * 34 + i) * sw + x];
    };
    int luma_num = 0;
    for (int y = 0; y < (h + 1) / 2; y += 16, ++luma_num) {
      random_register = static_cast<uint16_t>(g.seed);
      random_register ^= static_cast<uint16_t>(((luma_num * 37 + 178) & 255) << 8);
      random_register ^= static_cast<uint16_t>((luma_num * 173 + 105) & 255);
      for (int x = 0; x < (w + 1) / 2; x += 16) {
        const int rnd = random_number(8);
        const int ox = rnd >> 4, oy = rnd & 15;
        for (int p = 0; p < num_planes; ++p) {
          const int psx = p ? ssx : 0, psy = p ? ssy : 0;
          const int pox = psx ? 6 + ox : 9 + ox * 2, poy = psy ? 6 + oy : 9 + oy * 2;
          for (int i = 0; i < (34 >> psy); ++i)
            for (int j = 0; j < (34 >> psx); ++j) {
              int v = p == 0 ? luma[poy + i][pox + j] : chroma[p - 1][poy + i][pox + j];
              const int at = psx ? x + j : x * 2 + j;
              if (!psx) {
                if (j < 2 && g.overlap && x > 0) {
                  const int old = ns(p, luma_num, i, at);
                  v = j == 0 ? old * 27 + v * 17 : old * 17 + v * 27;
                  v = clip3(gmin, gmax, round2(v, 5));
                }
              } else if (j == 0 && g.overlap && x > 0) {
                const int old = ns(p, luma_num, i, at);
                v = clip3(gmin, gmax, round2(old * 23 + v * 22, 5));
              }
              ns(p, luma_num, i, at) = v;
            }
        }
      }
    }
    // the noise image, the stripes' vertical overlaps blended
    std::vector<int> img[3];
    for (int p = 0; p < num_planes; ++p) {
      const int psx = p ? ssx : 0, psy = p ? ssy : 0;
      const int pw = (w + psx) >> psx, ph = (h + psy) >> psy;
      img[p].assign(size_t(pw) * ph, 0);
      for (int y = 0; y < ph; ++y) {
        const int n = y >> (5 - psy), i = y - (n << (5 - psy));
        for (int x = 0; x < pw; ++x) {
          int v = ns(p, n, i, x);
          if (!psy) {
            if (i < 2 && n > 0 && g.overlap) {
              const int old = ns(p, n - 1, i + 32, x);
              v = i == 0 ? old * 27 + v * 17 : old * 17 + v * 27;
              v = clip3(gmin, gmax, round2(v, 5));
            }
          } else if (i < 1 && n > 0 && g.overlap) {
            const int old = ns(p, n - 1, i + 16, x);
            v = clip3(gmin, gmax, round2(old * 23 + v * 22, 5));
          }
          img[p][size_t(y) * pw + x] = v;
        }
      }
    }
    // blend: chroma first, from the luma without its noise
    const int maxv = (256 << depth_shift) - 1;
    const int min_v = g.clip_restricted ? 16 << depth_shift : 0;
    const int max_luma = g.clip_restricted ? 235 << depth_shift : maxv;
    const int max_chroma =
        g.clip_restricted ? (matrix == 0 ? 235 : 240) << depth_shift : maxv;
    if (num_planes > 1) {
      const int pw = (w + ssx) >> ssx, ph = (h + ssy) >> ssy;
      const int mult[2] = {g.cb_mult, g.cr_mult},
                luma_mult[2] = {g.cb_luma_mult, g.cr_luma_mult},
                offset[2] = {g.cb_offset, g.cr_offset};
      for (int y = 0; y < ph; ++y)
        for (int x = 0; x < pw; ++x) {
          const int lx = x << ssx, ly = y << ssy;
          const int lnx = std::min(lx + 1, w - 1);
          const int avg = ssx ? round2(cur[0].get(ly, lx) + cur[0].get(ly, lnx), 1)
                              : cur[0].get(ly, lx);
          for (int c = 0; c < 2; ++c) {
            if (!use[c]) continue;
            uint16_t& px = *cur[c + 1].at(y, x);
            const int orig = px;
            int merged;
            if (g.chroma_from_luma) {
              merged = avg;
            } else {
              const int combined = avg * (luma_mult[c] - 128) + orig * (mult[c] - 128);
              merged = clip3(0, maxv, (combined >> 6) + (offset[c] << depth_shift) -
                                          (1 << bit_depth));
            }
            const int n = round2(scale(c + 1, merged) * img[c + 1][size_t(y) * pw + x],
                                 g.scaling_shift);
            px = static_cast<uint16_t>(clip3(min_v, max_chroma, orig + n));
          }
        }
    }
    if (g.num_y)
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          uint16_t& px = *cur[0].at(y, x);
          const int n = round2(scale(0, px) * img[0][size_t(y) * w + x], g.scaling_shift);
          px = static_cast<uint16_t>(clip3(min_v, max_luma, px + n));
        }
  }

  // -------------------------------------------------------------------------
  // OBUs

  // The OBUs of the item, as libaom takes them (libavif hands it the
  // item's data; the av1C's config OBUs are not read): every OBU with its
  // size field, zero bytes right after the frame's last OBU skipped (as
  // libaom skips them after each frame it decodes); a temporal delimiter
  // empty, no tile list; padding, metadata and reserved OBUs skipped but
  // for a last byte of 0 (libaom's trailing-bits test); a redundant frame
  // header ignored.
  // -------------------------------------------------------------------------
  // frames

  // what a frame needs before its tiles: the shears of global motion,
  // the segment ids of the primary reference frame, the projected
  // motion field
  void setup_frame() {
    for (int ref = LAST_FRAME; ref <= ALTREF_FRAME; ++ref) {
      int shear[4];
      gm_valid[ref] = setup_shear(gm_params[ref], shear);
    }
    prev_seg_ids.clear();
    if (primary_ref_frame != PRIMARY_REF_NONE && seg_enabled) {
      const RefSlot& prev = refs[ref_frame_idx[primary_ref_frame]];
      if (prev.seg_ids && prev.mi_cols == mi_cols && prev.mi_rows == mi_rows)
        prev_seg_ids = *prev.seg_ids;
    }
    if (use_ref_frame_mvs) motion_field_estimation();
  }

  // libaom's av1_setup_motion_field: vectors of the references' motion
  // fields projected onto this frame's 8x8 blocks
  void motion_field_estimation() {
    const size_t cells = size_t(mi_stride >> 1) * ((mi_rows >> 1) + 1);
    mf_mv.assign(2 * cells, -32768);
    mf_offset.assign(cells, 0);
    int stamp = MFMV_STACK_SIZE - 1;
    const RefSlot& last = refs[ref_frame_idx[0]];
    refuse_grey(last, "projects its motion field from");
    if (last.saved_order_hints[ALTREF_FRAME] != order_hints[GOLDEN_FRAME])
      project_field(LAST_FRAME, 2);
    --stamp;
    if (get_relative_dist(order_hints[BWDREF_FRAME], order_hint) > 0 &&
        project_field(BWDREF_FRAME, 0))
      --stamp;
    if (get_relative_dist(order_hints[ALTREF2_FRAME], order_hint) > 0 &&
        project_field(ALTREF2_FRAME, 0))
      --stamp;
    if (get_relative_dist(order_hints[ALTREF_FRAME], order_hint) > 0 &&
        stamp >= 0 && project_field(ALTREF_FRAME, 0))
      --stamp;
    if (stamp >= 0) project_field(LAST2_FRAME, 2);
  }

  bool project_field(int src, int dir) {
    const RefSlot& slot = refs[ref_frame_idx[src - LAST_FRAME]];
    refuse_grey(slot, "projects its motion field from");
    if (slot.frame_type == KEY_FRAME || slot.frame_type == INTRA_ONLY_FRAME)
      return false;
    if (slot.mi_rows != mi_rows || slot.mi_cols != mi_cols || !slot.mf_refs)
      return false;
    int ref_offset[8] = {0};
    for (int rf = LAST_FRAME; rf <= ALTREF_FRAME; ++rf)
      ref_offset[rf] = get_relative_dist(slot.order_hint, slot.saved_order_hints[rf]);
    int s2c = get_relative_dist(slot.order_hint, order_hint);
    if (dir == 2) s2c = -s2c;
    const int rows8 = (mi_rows + 1) >> 1, cols8 = (mi_cols + 1) >> 1;
    const int stride8 = mi_stride >> 1;
    for (int r = 0; r < rows8; ++r)
      for (int c = 0; c < cols8; ++c) {
        const size_t cell = size_t(r) * cols8 + c;
        const int ref = (*slot.mf_refs)[cell];
        if (ref <= INTRA_FRAME) continue;
        const int off = ref_offset[ref];
        if (std::abs(off) > MAX_FRAME_DISTANCE || off <= 0 ||
            std::abs(s2c) > MAX_FRAME_DISTANCE)
          continue;
        const int fwd[2] = {(*slot.mf_mvs)[2 * cell], (*slot.mf_mvs)[2 * cell + 1]};
        int v[2];
        project(fwd, s2c, off, v);
        // get_block_position
        const int ro = v[0] >= 0 ? v[0] >> 6 : -((-v[0]) >> 6);
        const int co = v[1] >= 0 ? v[1] >> 6 : -((-v[1]) >> 6);
        const int rr = dir == 2 ? r - ro : r + ro;
        const int cc = dir == 2 ? c - co : c + co;
        if (rr < 0 || rr >= (mi_rows >> 1) || cc < 0 || cc >= (mi_cols >> 1))
          continue;
        const int br = (r >> 3) << 3, bc = (c >> 3) << 3;
        if (rr < br || rr >= br + 8 || cc < bc - 8 || cc >= bc + 16) continue;
        const size_t at = size_t(rr) * stride8 + cc;
        mf_mv[2 * at] = static_cast<int16_t>(fwd[0]);
        mf_mv[2 * at + 1] = static_cast<int16_t>(fwd[1]);
        mf_offset[at] = static_cast<int8_t>(off);
      }
    return true;
  }

  // the end of a frame (spec 7.20, 7.21): the filters, the frame CDFs,
  // the motion field and the segment ids saved, the reference slots
  // refreshed, a shown frame kept for output; a frame shown from a slot
  // (a key frame refreshing every slot from it)
  void finish_frame(bool headers_only) {
    ++frames;
    if (show_existing_frame) {
      const RefSlot slot = refs[existing_slot];
      show(slot.buf, slot.grain, slot.upscaled_w, slot.frame_h, slot.spatial_id);
      ++shown_existing;
      if (frame_type == KEY_FRAME) refresh(slot, 0xFF);
      output_fb();
      return;
    }
    RefSlot slot;
    slot.valid = slot.held = true;
    slot.fb = cur_fb;
    slot.frame_id = current_frame_id;
    slot.frame_type = frame_type;
    slot.order_hint = order_hint;
    slot.showable = showable_frame;
    slot.spatial_id = frame_spatial_id;
    slot.upscaled_w = upscaled_w;
    slot.frame_w = frame_w;
    slot.frame_h = frame_h;
    slot.render_w = render_w;
    slot.render_h = render_h;
    slot.mi_cols = mi_cols;
    slot.mi_rows = mi_rows;
    slot.bit_depth = bit_depth;
    slot.ssx = ssx;
    slot.ssy = ssy;
    std::memcpy(slot.saved_order_hints, order_hints, sizeof(order_hints));
    std::memcpy(slot.lf_ref_deltas, lf_ref_deltas, sizeof(lf_ref_deltas));
    std::memcpy(slot.lf_mode_deltas, lf_mode_deltas, sizeof(lf_mode_deltas));
    std::memcpy(slot.feature_enabled, feature_enabled, sizeof(feature_enabled));
    std::memcpy(slot.feature_data, feature_data, sizeof(feature_data));
    std::memcpy(slot.gm_params, gm_params, sizeof(gm_params));
    slot.grain = grain;
    if (!headers_only) {
      post_filters();
      slot.buf = std::make_shared<FrameBuf>();
      for (int p = 0; p < num_planes; ++p)
        slot.buf->planes[p] = std::move(cur[p]);
      if (!disable_frame_end_update_cdf) frame_cdf = saved_cdf;
      frame_cdf.clear_counts();
      slot.cdf = std::make_shared<Cdfs>(frame_cdf);
      slot.seg_ids = std::make_shared<std::vector<uint8_t>>(seg_ids);
      // the motion field (libaom's av1_copy_frame_mvs): per 8x8 the
      // vector of a past reference of its odd mi
      const int rows8 = (mi_rows + 1) >> 1, cols8 = (mi_cols + 1) >> 1;
      auto refs8 = std::make_shared<std::vector<int8_t>>(size_t(rows8) * cols8, NONE_FRAME);
      auto mvs8 = std::make_shared<std::vector<int16_t>>(size_t(rows8) * cols8 * 2, 0);
      if (!frame_is_intra)
        for (int r = 0; r < rows8; ++r)
          for (int c = 0; c < cols8; ++c) {
            const size_t k = mi(std::min(2 * r + 1, mi_rows - 1),
                                std::min(2 * c + 1, mi_cols - 1));
            const size_t cell = size_t(r) * cols8 + c;
            for (int l = 0; l < 2; ++l) {
              const int rf = ref_frames[2 * k + l];
              if (rf <= INTRA_FRAME) continue;
              if (get_relative_dist(order_hints[rf], order_hint) >= 0) continue;
              const int mr = mvs[4 * k + 2 * l], mc = mvs[4 * k + 2 * l + 1];
              if (std::abs(mr) > REFMVS_LIMIT || std::abs(mc) > REFMVS_LIMIT) continue;
              (*refs8)[cell] = static_cast<int8_t>(rf);
              (*mvs8)[2 * cell] = static_cast<int16_t>(mr);
              (*mvs8)[2 * cell + 1] = static_cast<int16_t>(mc);
            }
          }
      slot.mf_refs = refs8;
      slot.mf_mvs = mvs8;
    }
    pool[cur_fb].state = std::make_shared<RefSlot>(slot);
    refresh(slot, refresh_frame_flags);
    if (show_frame) {
      show(slot.buf, grain, upscaled_w, frame_h, frame_spatial_id);
      output_fb();
    } else {
      release_fb(cur_fb);
      cur_fb = -1;
    }
    inter_frames += !frame_is_intra;
  }

  // update_frame_buffers: the refreshed slots hold the frame's buffer
  void refresh(const RefSlot& slot, int flags) {
    for (int i = 0; i < NUM_REF_FRAMES; ++i)
      if ((flags >> i) & 1) {
        if (refs[i].held) release_fb(refs[i].fb);
        refs[i] = slot;
        if (slot.fb >= 0) ++pool[slot.fb].ref;
      }
  }

  // ... and the output frame holds it in place of the one before
  void output_fb() {
    release_fb(out_fb);
    out_fb = cur_fb;
    cur_fb = -1;
  }

  // a shown frame: the output if it is the last (libaom with
  // output_all_layers off), or the first of the selected layer (libavif
  // picks it among all the layers' frames)
  void show(const std::shared_ptr<FrameBuf>& buf, const FilmGrain& g, int w,
            int h, int spatial_id) {
    if (select_layer >= 0 && (layer_found || spatial_id != select_layer))
      return;
    layer_found = true;
    shown = buf;
    shown_grain = g;
    shown_w = w;
    shown_h = h;
  }

  // where each frame header lies (av1_frame_marks), when asked
  std::vector<int32_t>* marks = nullptr;
  int gm_bits[2] = {0, 0};

  // The OBUs of the item, as libaom takes them (libavif hands it the
  // item's data; the av1C's config OBUs are not read): every OBU with its
  // size field, zero bytes right after a frame's last OBU skipped (as
  // libaom skips them after each frame it decodes); OBUs with an
  // extension outside the operating point dropped; a temporal delimiter
  // empty, no tile list; padding, metadata and reserved OBUs skipped but
  // for a last byte of 0 (libaom's trailing-bits test); a redundant frame
  // header ignored.  Every frame is decoded, its references kept; the
  // last one shown is the output, as libaom hands libavif (which does
  // not ask for every layer).  headers_only parses the frame headers
  // alone, the tiles skipped.
  void run(const uint8_t* d, size_t n, bool headers_only) {
    size_t at = 0;
    bool after_frame = false;
    while (at < n) {
      if (after_frame && d[at] == 0) {
        ++at;
        continue;
      }
      after_frame = false;
      const int frames_before = frames;
      const size_t obu_at = at;
      const uint8_t h = d[at++];
      if (h & 0x80)
        fail("the AV1 stream has an OBU with its forbidden bit set");
      const int type = (h >> 3) & 15, ext = (h >> 2) & 1;
      if (!((h >> 1) & 1))
        fail("the AV1 stream has an OBU without its size (cv2 refuses it)");
      int temporal_id = 0, spatial_id = 0;
      if (ext) {
        if (at >= n) fail("the AV1 stream ends inside an OBU header");
        temporal_id = d[at] >> 5;
        spatial_id = (d[at] >> 3) & 3;
        ++at;
      }
      const size_t size = static_cast<size_t>(leb128(d, n, &at));
      if (size > n - at) fail("the AV1 stream ends inside an OBU");
      const uint8_t* body = d + at;
      at += size;
      if (type != 1 && type != 2 && ext && op_idc_cur &&
          !(((op_idc_cur >> temporal_id) & 1) &&
            ((op_idc_cur >> (spatial_id + 8)) & 1)))
        continue;       // not in the operating point
      BitReader r(body, size);
      switch (type) {
        case 1:
          if (!have_seq) sequence_header(r);
          break;
        case 2:
          if (size) fail("the AV1 stream has a temporal delimiter with a "
                         "payload (cv2 refuses it)");
          break;
        case 3: case 6:
          if (have_frame && !frame_done)
            fail("the AV1 stream has a frame header inside a frame (cv2 "
                 "refuses it)");
          have_frame = frame_done = false;
          next_tile = 0;
          gm_bits[0] = gm_bits[1] = -1;
          cur_fb = get_free_fb();     // assign_cur_frame_new_fb
          frame_header(r, temporal_id, spatial_id);
          have_frame = true;
          if (marks)
            marks->insert(marks->end(),
                          {int32_t(obu_at), int32_t(body - d), int32_t(size),
                           gm_bits[0], gm_bits[1], int32_t(r.pos), type,
                           frame_type | allow_high_precision_mv << 2});
          if (show_existing_frame) {
            if (type == 6)
              fail("the AV1 stream's frame OBU shows an existing frame (cv2 "
                   "refuses it)");
            r.trailing_bits();
            frame_done = true;
            finish_frame(headers_only);
            break;
          }
          if (type == 3) r.trailing_bits();
          else r.zero_align();
          if (headers_only) {
            frame_done = true;
            finish_frame(true);
            break;
          }
          allocate();
          setup_frame();
          if (type == 6) tile_group(r, body, size, true);
          if (frame_done) finish_frame(false);
          break;
        case 4:
          if (headers_only) break;
          tile_group(r, body, size, false);
          if (frame_done) finish_frame(false);
          break;
        case 7:
          break;
        case 8:
          fail("the AV1 stream has a tile list OBU (cv2 refuses it)");
        default:        // metadata, padding, reserved
          if (size && body[size - 1] == 0)
            fail("the AV1 stream has an OBU whose trailing bits are "
                 "missing (cv2 refuses it)");
      }
      after_frame = frames != frames_before;
    }
    if (!have_seq) fail("the AV1 stream has no sequence header");
    if (!have_frame) fail("the AV1 stream has no frame");
    if (!frame_done) fail("the AV1 stream ends before its last tile");
    if (select_layer >= 0 && !layer_found)
      fail("the AV1 stream shows no frame of the layer its lsel selects "
           "(cv2 refuses it)");
    if (!shown_w) fail("the AV1 stream shows no frame (cv2 refuses it)");
  }

  // the shown frame, its film grain added, in cur
  void output() {
    upscaled_w = shown_w;
    frame_h = shown_h;
    for (int p = 0; p < num_planes; ++p) cur[p] = shown->planes[p];
    grain = shown_grain;
    if (grain.apply) add_grain();
  }

};

}  // namespace

extern "C" {

// the frame headers of the stream (the operating point's), up to max:
// eight int32 each (the OBU's offset, its payload's offset and size, the
// bits of global_motion_params in the payload [start, end) or -1, the
// header's end bit, the OBU type, frame_type | allow_high_precision_mv
// << 2); the number of headers, or -1 with the reason
int av1_frame_marks(const uint8_t* data, int64_t len, int operating_point,
                    int32_t* out, int max, char* msg, int msg_len) {
  try {
    std::vector<int32_t> marks;
    Decoder dec;
    dec.operating_point = operating_point;
    dec.marks = &marks;
    dec.run(data, static_cast<size_t>(len), true);
    const int n = int(marks.size() / 8);
    std::memcpy(out, marks.data(), sizeof(int32_t) * 8 * std::min(n, max));
    return n;
  } catch (const Fail& f) {
    set_msg(msg, msg_len, f.msg);
  } catch (const std::bad_alloc&) {
    set_msg(msg, msg_len, "out of memory");
  }
  return -1;
}

int av1_probe(const uint8_t* data, int64_t len, int operating_point,
              int layer, int32_t* info, char* msg, int msg_len) {
  try {
    Decoder dec;
    dec.operating_point = operating_point;
    dec.select_layer = layer;
    dec.run(data, static_cast<size_t>(len), true);
    info[0] = dec.shown_w;
    info[1] = dec.shown_h;
    info[2] = dec.ssx;
    info[3] = dec.ssy;
    info[4] = dec.mono;
    info[5] = dec.bit_depth;
    info[6] = dec.color_range;
    info[7] = dec.matrix;
    info[8] = dec.color_primaries;
    info[9] = dec.transfer;
    for (int p = 0; p < 3; ++p) info[10 + p] = dec.lr_frame_type[p];
    info[13] = dec.superres_denom;
    info[14] = dec.shown_grain.apply;
    info[15] = dec.use_128 ? 128 : 64;
    info[16] = dec.tile_cols;
    info[17] = dec.frame_w;
    info[18] = dec.allow_screen_content_tools;
    info[19] = dec.allow_intrabc;
    info[20] = dec.op_cnt;
    info[21] = dec.frames;
    return 0;
  } catch (const Fail& f) {
    set_msg(msg, msg_len, f.msg);
  } catch (const std::bad_alloc&) {
    set_msg(msg, msg_len, "out of memory");
  }
  return 1;
}

int av1_decode(const uint8_t* data, int64_t len, int operating_point,
               int layer, uint16_t* y, uint16_t* u, uint16_t* v,
               int32_t* counts, char* msg, int msg_len) {
  try {
    Decoder dec;
    dec.operating_point = operating_point;
    dec.select_layer = layer;
    dec.run(data, static_cast<size_t>(len), false);
    dec.output();
    uint16_t* out[3] = {y, u, v};
    for (int p = 0; p < dec.num_planes; ++p) {
      const int sx = p ? dec.ssx : 0, sy = p ? dec.ssy : 0;
      const int w = (dec.upscaled_w + sx) >> sx, h = (dec.frame_h + sy) >> sy;
      for (int i = 0; i < h; ++i)
        std::memcpy(out[p] + size_t(i) * w, dec.cur[p].at(i, 0), w * sizeof(uint16_t));
    }
    if (counts) {
      const int c[AV1_COUNTS] = {
          dec.palette_y_blocks, dec.palette_uv_blocks, dec.palette_sizes & ~1,
          dec.intrabc_blocks, dec.intrabc_default_dv, dec.frames,
          dec.inter_frames, dec.shown_existing, dec.inter_blocks,
          dec.compound_blocks, dec.obmc_blocks, dec.warp_blocks,
          dec.interintra_blocks, dec.scaled_blocks,
          dec.temporal_mvs, dec.dual_filter_blocks,
          dec.wedge_blocks, dec.diffwtd_blocks, dec.distance_blocks,
          dec.wedge_interintra_blocks, dec.scaled_compound_blocks,
          dec.global_warp_blocks, dec.global_shift_blocks, dec.grey_slots,
          dec.grey_blocks};
      std::memcpy(counts, c, sizeof(c));
    }
    return 0;
  } catch (const Fail& f) {
    set_msg(msg, msg_len, f.msg);
  } catch (const std::bad_alloc&) {
    set_msg(msg, msg_len, "out of memory");
  }
  return 1;
}

}  // extern "C"
