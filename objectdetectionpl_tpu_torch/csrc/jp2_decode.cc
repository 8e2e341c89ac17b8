// The JPEG 2000 codestream decoder of the port's image reader (host C++17;
// data/formats.py parses the JP2 boxes around it): ITU-T T.800 Annexes A-G
// as OpenJPEG 2.5 decodes them, so that a file's samples equal those that
// cv2.imread gets from its bundled OpenJPEG, bit for bit.
//
// - main and tile-part headers: SIZ, COD/COC, QCD/QCC (no quantisation,
//   scalar derived, scalar expounded; guard bits), RGN (max-shift), POC,
//   PPM, PPT, SOT/SOD over any number of tile-parts; Part 2's CBD (bit
//   depths) and MCT, MCC and MCO as OpenJPEG takes them (the DC level
//   shifts from an offset array); TLM, PLM, PLT, CRG, COM and Part 15's
//   CAP and CPF checked by their lengths and skipped; each marker held to
//   OpenJPEG's lengths and places, unknown ones skipped as it skips them;
//   HT code-blocks (HTJ2K) refused;
// - tier 2: the five progression orders and POC as OpenJPEG's packet
//   iterator walks them (pi.c), precincts, the inclusion and zero
//   bit-plane tag trees, pass counts, Lblock, segments of every code-block
//   style, SOP and EPH markers, bit stuffing after 0xFF;
// - tier 1: the MQ decoder (T.800 Table C.2) over the 19 contexts, the
//   significance, refinement and cleanup passes, every code-block style
//   bit (bypass, reset, termall, vertically causal, predictable
//   termination, segmentation symbols), and OpenJPEG's reconstruction: the
//   coefficients carry one more bit, set to a half-step below the last
//   decoded bit-plane;
// - each component rebuilt up to the highest resolution its packets
//   reached (OpenJPEG's resno_decoded);
// - ROI max-shift, dequantisation (the reversible path halves the
//   coefficients, the irreversible one scales them by half the step size
//   in float), the inverse 5/3 DWT in integers and the 9/7 in float in
//   OpenJPEG's order and constants (rows, then columns; its 2/K high-pass
//   gain), the inverse RCT or ICT, the DC level shift (SIZ's, or an MCO's)
//   with lrintf and the clamp to the component's range.
//
// The float steps are plain adds and multiplies in OpenJPEG's order, kept
// from being contracted into FMAs under -march=native (cv2's OpenJPEG
// build does not contract them).
//
// C interface (0 on success, else 3 with the reason in msg):
//   j2k_decode(src, n, alloc, prec, msg, msg_len): reads the main header,
//     refuses what cv2.imread refuses by it (more than 4 components,
//     signed ones, a largest precision below 8, an origin other than 0,
//     subsampled components, more than 2^20 columns or rows or 2^30
//     pixels), sets *prec to the largest precision, takes an int32
//     [Csiz, Ysiz, Xsiz] buffer from alloc(Csiz, Ysiz, Xsiz) (null: out
//     of memory) and decodes every component's samples into it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <new>
#include <string>
#include <vector>

#pragma GCC optimize("fp-contract=off")

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& s) { throw Error{s}; }

void set_msg(char* msg, int msg_len, const std::string& s) {
  if (msg && msg_len > 0) std::snprintf(msg, msg_len, "%s", s.c_str());
}

int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t ceildivpow2(int64_t a, int b) {
  return (a + (int64_t(1) << b) - 1) >> b;
}
int64_t floordivpow2(int64_t a, int b) { return a >> b; }
int floorlog2(uint32_t a) {
  int l = 0;
  while (a > 1) { a >>= 1; ++l; }
  return l;
}

// ---------------------------------------------------------------------------
// coding parameters

constexpr int kMaxRes = 33, kMaxBands = 3 * kMaxRes - 2;
enum { LRCP, RLCP, RPCL, PCRL, CPRL };
// code-block style bits; predictable termination (16) changes no decoding
enum { kLazy = 1, kReset = 2, kTermAll = 4, kVsc = 8, kSegSym = 32 };

struct Tccp {                   // a component's coding style and quantisation
  int csty = 0, numres = 6, cbw = 6, cbh = 6, cblksty = 0, qmfbid = 1;
  int prcw[kMaxRes], prch[kMaxRes];
  int qntsty = 0, numgbits = 2, roishift = 0;
  int32_t dc_shift = 0;         // added after the inverse transforms
  int expn[kMaxBands], mant[kMaxBands];
  Tccp() {
    std::fill(prcw, prcw + kMaxRes, 15);
    std::fill(prch, prch + kMaxRes, 15);
    std::fill(expn, expn + kMaxBands, 0);
    std::fill(mant, mant + kMaxBands, 0);
  }
};

struct Poc {
  int res0, comp0, lay1, res1, comp1, prg;
};

// where OpenJPEG's marker table lets a marker stand: the main header
// before SIZ, the rest of the main header, a tile-part header; nowhere
enum { kMainSiz = 1, kMain = 2, kTilePart = 4, kNowhere = 8 };

// 0 for a marker OpenJPEG does not know (an unknown one stands in either
// header; it is skipped in the main one and refused in a tile-part one)
int marker_places(uint32_t m) {
  switch (m) {
    case 0xff51:                                // SIZ
      return kMainSiz;
    case 0xff52: case 0xff53:                   // COD, COC
    case 0xff5c: case 0xff5d:                   // QCD, QCC
    case 0xff5e: case 0xff5f: case 0xff64:      // RGN, POC, COM
    case 0xff74: case 0xff75: case 0xff77:      // MCT, MCC, MCO
      return kMain | kTilePart;
    case 0xff90: case 0xff55: case 0xff57:      // SOT, TLM, PLM
    case 0xff60: case 0xff63: case 0xff78:      // PPM, CRG, CBD
    case 0xff50: case 0xff59:                   // CAP, CPF (Part 15)
      return kMain;
    case 0xff58: case 0xff61:                   // PLT, PPT
      return kTilePart;
    case 0xff91:                                // SOP
      return kNowhere;
    default:
      return 0;
  }
}

// packed packet headers, by their PPM / PPT index (Zppm / Zppt)
using Packed = std::map<int, std::vector<uint8_t>>;

// Part 2's multiple component transformation as OpenJPEG keeps it: MCT
// arrays (Imct's index and element type: int16, int32, float32, float64;
// its bytes), MCC collections (a component count, the MCT records holding
// the decorrelation and offset arrays, -1 for none).  OpenJPEG's decoder
// never applies a decorrelation array (its COD refuses the transform
// value 2 that would ask for it), but it sizes it; an MCO stage sets every
// component's DC level shift from its collection's offset array.
struct MctRecord {
  int index = 0, elem = 0;
  std::vector<uint8_t> data;
};
struct MccRecord {
  int index = 0, ncomp = 0, deco = -1, offset = -1;
};
constexpr uint32_t kMctElemSize[4] = {2, 4, 4, 8};

struct Tcp {                    // a tile's coding parameters and data
  int csty = 0, prg = LRCP, numlayers = 1, mct = 0;
  std::vector<Tccp> tccps;
  std::vector<Poc> pocs;
  std::vector<MctRecord> mcts;
  std::vector<MccRecord> mccs;
  std::vector<uint8_t> data, ppt;
  Packed ppt_parts;
  bool seen = false, has_ppt = false;
};

void add_packed(Packed& parts, int z, const uint8_t* p, size_t n,
                const char* what) {
  if (parts.count(z)) fail(std::string(what) + " index read twice");
  parts[z].assign(p, p + n);
}

struct Siz {
  int64_t x0, y0, x1, y1, tx0, ty0, tdx, tdy;
  int ncomp, tw, th;
  std::vector<int> dx, dy, prec, sgnd;
};

class Stream {
 public:
  Stream(const uint8_t* p, size_t n) : p_(p), n_(n) {}
  size_t pos() const { return pos_; }
  size_t size() const { return n_; }
  void seek(size_t at) { pos_ = at; }
  bool more(size_t k) const { return pos_ + k <= n_; }
  // reads past ``end`` fail until unbound() (a marker segment's handler)
  void bound(size_t end) { end_ = end; }
  void unbound() { end_ = SIZE_MAX; }
  uint32_t u8() { need(1); return p_[pos_++]; }
  uint32_t u16() {
    need(2);
    pos_ += 2;
    return p_[pos_ - 2] << 8 | p_[pos_ - 1];
  }
  uint32_t u32() { uint32_t hi = u16(); return hi << 16 | u16(); }
  uint32_t un(int bytes) { return bytes == 1 ? u8() : u16(); }
  const uint8_t* at(size_t k) const { return p_ + k; }

 private:
  void need(size_t k) {
    if (pos_ + k > n_) fail("the codestream ends inside a marker segment");
    if (pos_ + k > end_) fail("a marker segment shorter than its fields");
  }
  const uint8_t* p_;
  size_t n_, pos_ = 0, end_ = SIZE_MAX;
};

// ---------------------------------------------------------------------------
// tier-2 structures

struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;
  void build(int w, int h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> lw{w}, lh{h};
    int n;
    do {
      n = lw.back() * lh.back();
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
    } while (n > 1);
    const int levels = static_cast<int>(lw.size()) - 1;
    std::vector<int> start(levels + 1, 0);
    for (int l = 0; l < levels; ++l) start[l + 1] = start[l] + lw[l] * lh[l];
    nodes.assign(start[levels], Node{-1, 999, 0});
    for (int l = 0; l + 1 < levels; ++l)
      for (int j = 0; j < lh[l]; ++j)
        for (int i = 0; i < lw[l]; ++i)
          nodes[start[l] + j * lw[l] + i].parent =
              start[l + 1] + (j / 2) * lw[l + 1] + i / 2;
  }
  void reset() {
    for (auto& nd : nodes) { nd.value = 999; nd.low = 0; }
  }
};

struct Bio {                    // packet-header bits, MSB first, stuffed
  const uint8_t *bp, *start, *end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* p, size_t n) : bp(p), start(p), end(p + n) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void inalign() {
    ct = 0;
    if ((buf & 0xff) == 0xff) { bytein(); ct = 0; }
  }
  size_t numbytes() const { return static_cast<size_t>(bp - start); }
};

int tgt_decode(Bio& bio, TagTree& t, int leaf, int threshold) {
  int stk[32], sp = 0;
  int node = leaf;
  while (t.nodes[node].parent >= 0) {
    stk[sp++] = node;
    node = t.nodes[node].parent;
  }
  int low = 0;
  for (;;) {
    auto& nd = t.nodes[node];
    if (low > nd.low) nd.low = low; else low = nd.low;
    while (low < threshold && low < nd.value) {
      if (bio.bit()) nd.value = low; else ++low;
    }
    nd.low = low;
    if (sp == 0) break;
    node = stk[--sp];
  }
  return t.nodes[node].value < threshold;
}

struct Seg {
  int len = 0, numpasses = 0, maxpasses = 0, newlen = 0, numnewpasses = 0;
};

struct Cblk {
  int64_t x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0;
  std::vector<Seg> segs;
  std::vector<uint8_t> data;
};

struct Precinct {
  int64_t x0, y0, x1, y1;
  int cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int64_t x0, y0, x1, y1;
  int bandno, numbps;
  float stepsize;
  std::vector<Precinct> precincts;
  bool empty() const { return x0 == x1 || y0 == y1; }
};

struct Res {
  int64_t x0, y0, x1, y1;
  int pw = 0, ph = 0, pdx, pdy, numbands;
  Band bands[3];
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  int numres;
  std::vector<Res> res;
  std::vector<int32_t> idata;   // reversible path
  std::vector<float> fdata;     // irreversible path
};

void init_seg(std::vector<Seg>& segs, int segno, int cblksty, bool first) {
  if (static_cast<int>(segs.size()) <= segno) segs.resize(segno + 1);
  Seg& seg = segs[segno];
  seg = Seg();
  if (cblksty & kTermAll)
    seg.maxpasses = 1;
  else if (cblksty & kLazy)
    seg.maxpasses = first ? 10
                          : (segs[segno - 1].maxpasses == 1 ||
                             segs[segno - 1].maxpasses == 10) ? 2 : 1;
  else
    seg.maxpasses = 109;
}

// ---------------------------------------------------------------------------
// tier 1: the MQ decoder and the three passes

struct State {
  uint32_t qe;
  uint8_t nmps, nlps, sw;
};
constexpr State kStates[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

constexpr int kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17,
              kCtxUni = 18, kNumCtx = 19;

class Mqc {
 public:
  void reset_states() {
    for (int i = 0; i < kNumCtx; ++i) { st_[i] = 0; mps_[i] = 0; }
    st_[kCtxUni] = 46;
    st_[kCtxAgg] = 3;
    st_[kCtxZc] = 4;
  }
  // the segment's bytes followed by the artificial 0xFF 0xFF marker
  void init(const uint8_t* p, int len, bool raw) {
    buf_.assign(p, p + len);
    buf_.push_back(0xff);
    buf_.push_back(0xff);
    bp_ = 0;
    if (raw) { c_ = 0; ct_ = 0; return; }
    c_ = len == 0 ? 0xffu << 16 : static_cast<uint32_t>(buf_[0]) << 16;
    bytein();
    c_ <<= 7;
    ct_ -= 7;
    a_ = 0x8000;
  }
  int decode(int ctx) {
    const State& s = kStates[st_[ctx]];
    int d;
    a_ -= s.qe;
    if ((c_ >> 16) < s.qe) {
      if (a_ < s.qe) {           // the LPS exchange
        a_ = s.qe;
        d = mps_[ctx];
        st_[ctx] = s.nmps;
      } else {
        a_ = s.qe;
        d = !mps_[ctx];
        if (s.sw) mps_[ctx] = !mps_[ctx];
        st_[ctx] = s.nlps;
      }
      renorm();
    } else {
      c_ -= s.qe << 16;
      if ((a_ & 0x8000) == 0) {  // the MPS exchange
        if (a_ < s.qe) {
          d = !mps_[ctx];
          if (s.sw) mps_[ctx] = !mps_[ctx];
          st_[ctx] = s.nlps;
        } else {
          d = mps_[ctx];
          st_[ctx] = s.nmps;
        }
        renorm();
      } else {
        d = mps_[ctx];
      }
    }
    return d;
  }
  int raw() {
    if (ct_ == 0) {
      if (c_ == 0xff) {
        if (buf_[bp_] > 0x8f) {
          c_ = 0xff;
          ct_ = 8;
        } else {
          c_ = buf_[bp_++];
          ct_ = 7;
        }
      } else {
        c_ = buf_[bp_++];
        ct_ = 8;
      }
    }
    --ct_;
    return (c_ >> ct_) & 1;
  }

 private:
  void bytein() {
    const uint32_t next = buf_[bp_ + 1];
    if (buf_[bp_] == 0xff) {
      if (next > 0x8f) {
        c_ += 0xff00;
        ct_ = 8;
      } else {
        ++bp_;
        c_ += next << 9;
        ct_ = 7;
      }
    } else {
      ++bp_;
      c_ += next << 8;
      ct_ = 8;
    }
  }
  void renorm() {
    do {
      if (ct_ == 0) bytein();
      a_ <<= 1;
      c_ <<= 1;
      --ct_;
    } while (a_ < 0x8000);
  }
  std::vector<uint8_t> buf_;
  size_t bp_ = 0;
  uint32_t a_ = 0, c_ = 0;
  int ct_ = 0;
  uint8_t st_[kNumCtx], mps_[kNumCtx];
};

// flags of a coefficient
constexpr uint8_t kSig = 1, kNeg = 2, kVisit = 4, kRefined = 8;

// the zero-coding context (T.800 Table D.1) from a coefficient's
// significant neighbours: h horizontal, v vertical, d diagonal; OpenJPEG's
// band 1 (horizontally high-pass) swaps h and v
int zc_context(int orient, int h, int v, int d) {
  if (orient == 3) {
    const int hv = h + v;
    if (!d) return !hv ? 0 : hv == 1 ? 1 : 2;
    if (d == 1) return !hv ? 3 : hv == 1 ? 4 : 5;
    if (d == 2) return !hv ? 6 : 7;
    return 8;
  }
  if (orient == 1) std::swap(h, v);
  if (!h) {
    if (!v) return !d ? 0 : d == 1 ? 1 : 2;
    return v == 1 ? 3 : 4;
  }
  if (h == 1) return v ? 7 : d ? 6 : 5;
  return 8;
}

class T1 {
 public:
  T1(int w, int h, int orient, int cblksty)
      : w_(w), h_(h), vsc_(cblksty & kVsc), f_((w + 2) * (h + 2), 0),
        n_((w + 2) * (h + 2), 0), data_(w * h, 0) {
    for (int c = 0; c < 128; ++c)
      zc_[c] = static_cast<uint8_t>(
          kCtxZc + zc_context(orient, c & 3, c >> 2 & 3, c >> 4));
  }
  std::vector<int32_t>& data() { return data_; }

  void decode(const Cblk& cb, int roishift, int cblksty) {
    int bpno_plus_one = roishift + cb.numbps;
    if (bpno_plus_one >= 31) fail("a code-block of 31 or more bit-planes");
    int passtype = 2;
    mqc_.reset_states();
    size_t at = 0;
    for (int segno = 0; segno < cb.numsegs; ++segno) {
      const Seg& seg = cb.segs[segno];
      const bool raw = bpno_plus_one <= cb.numbps - 4 && passtype < 2 &&
                       (cblksty & kLazy);
      mqc_.init(cb.data.data() + at, seg.len, raw);
      at += seg.len;
      for (int passno = 0; passno < seg.numpasses && bpno_plus_one >= 1;
           ++passno) {
        if (passtype == 0)
          sigpass(bpno_plus_one, raw);
        else if (passtype == 1)
          refpass(bpno_plus_one, raw);
        else
          clnpass(bpno_plus_one, cblksty & kSegSym);
        if ((cblksty & kReset) && !raw) mqc_.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          --bpno_plus_one;
        }
      }
    }
    if (roishift) {
      if (roishift >= 31) {
        std::fill(data_.begin(), data_.end(), 0);
      } else {
        const int32_t thresh = 1 << roishift;
        for (auto& v : data_) {
          int32_t mag = v < 0 ? -v : v;
          if (mag >= thresh) {
            mag >>= roishift;
            v = v < 0 ? -mag : mag;
          }
        }
      }
    }
  }

 private:
  uint8_t& f(int y, int x) { return f_[(y + 1) * (w_ + 2) + x + 1]; }
  // the counts of a coefficient's significant neighbours: horizontal in
  // bits 0-1, vertical in 2-3, diagonal in 4-6
  uint8_t& n(int y, int x) { return n_[(y + 1) * (w_ + 2) + x + 1]; }
  // a neighbour's flags as the coefficient at row y sees them: in the
  // vertically causal mode the last row of a stripe sees nothing below
  uint8_t nb(int y, int x, int dy, int dx) {
    if (dy > 0 && vsc_ && (y & 3) == 3) return 0;
    return f(y + dy, x + dx);
  }
  bool any_sig(int y, int x) { return n(y, x) != 0; }
  int ctx_zc(int y, int x) { return zc_[n(y, x)]; }
  int contrib(uint8_t fl) {
    return !(fl & kSig) ? 0 : (fl & kNeg) ? -1 : 1;
  }
  // the sign's context and the bit its decision is XORed with
  int ctx_sc(int y, int x, int* xorbit) {
    int h = contrib(nb(y, x, 0, -1)) + contrib(nb(y, x, 0, 1));
    int v = contrib(nb(y, x, -1, 0)) + contrib(nb(y, x, 1, 0));
    h = std::min(1, std::max(-1, h));
    v = std::min(1, std::max(-1, v));
    *xorbit = 0;
    if (h < 0 || (h == 0 && v < 0)) {
      h = -h;
      v = -v;
      *xorbit = 1;
    }
    if (h == 0) return kCtxSc + (v == 0 ? 0 : 1);
    return kCtxSc + 3 + v;     // h = 1: v = -1, 0, 1 -> 11, 12, 13
  }
  int ctx_mag(int y, int x) {
    if (f(y, x) & kRefined) return kCtxMag + 2;
    return kCtxMag + (any_sig(y, x) ? 1 : 0);
  }
  void significant(int y, int x, int neg, int32_t oneplushalf) {
    data_[y * w_ + x] = neg ? -oneplushalf : oneplushalf;
    f(y, x) |= kSig | (neg ? kNeg : 0);
    n(y, x - 1) += 1;
    n(y, x + 1) += 1;
    n(y + 1, x) += 4;
    n(y + 1, x - 1) += 16;
    n(y + 1, x + 1) += 16;
    if (!(vsc_ && (y & 3) == 0)) {   // the row above sees below unless it
      n(y - 1, x) += 4;              // ends a stripe in the causal mode
      n(y - 1, x - 1) += 16;
      n(y - 1, x + 1) += 16;
    }
  }
  void decode_sign(int y, int x, int32_t oneplushalf) {
    int xorbit;
    const int ctx = ctx_sc(y, x, &xorbit);
    significant(y, x, mqc_.decode(ctx) ^ xorbit, oneplushalf);
  }

  void sigpass(int bpno, bool raw) {
    const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; ++x)
        for (int y = k; y < std::min(k + 4, h_); ++y) {
          uint8_t& fl = f(y, x);
          if ((fl & (kSig | kVisit)) || !any_sig(y, x)) continue;
          if (raw) {
            if (mqc_.raw()) significant(y, x, mqc_.raw(), oneplushalf);
          } else if (mqc_.decode(ctx_zc(y, x))) {
            decode_sign(y, x, oneplushalf);
          }
          f(y, x) |= kVisit;
        }
  }

  void refpass(int bpno, bool raw) {
    const int32_t poshalf = (1 << bpno) >> 1;
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; ++x)
        for (int y = k; y < std::min(k + 4, h_); ++y) {
          if ((f(y, x) & (kSig | kVisit)) != kSig) continue;
          const int v = raw ? mqc_.raw() : mqc_.decode(ctx_mag(y, x));
          int32_t& d = data_[y * w_ + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          f(y, x) |= kRefined;
        }
  }

  void clnpass(int bpno, bool segsym) {
    const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; ++x) {
        int y = k;
        const int end = std::min(k + 4, h_);
        if (k + 4 <= h_) {
          bool run = true;
          for (int r = k; r < end && run; ++r)
            run = !(f(r, x) & (kSig | kVisit)) && !any_sig(r, x);
          if (run) {
            if (!mqc_.decode(kCtxAgg)) {
              y = end;
            } else {
              int runlen = mqc_.decode(kCtxUni);
              runlen = (runlen << 1) | mqc_.decode(kCtxUni);
              y = k + runlen;
              decode_sign(y, x, oneplushalf);
              ++y;
            }
          }
        }
        for (; y < end; ++y) {
          if (f(y, x) & (kSig | kVisit)) continue;
          if (mqc_.decode(ctx_zc(y, x))) decode_sign(y, x, oneplushalf);
        }
        for (int r = k; r < end; ++r) f(r, x) &= ~kVisit;
      }
    if (segsym) {
      for (int i = 0; i < 4; ++i) mqc_.decode(kCtxUni);
    }
  }

  int w_, h_;
  bool vsc_;
  std::vector<uint8_t> f_, n_;
  std::vector<int32_t> data_;
  uint8_t zc_[128];
  Mqc mqc_;
};

// ---------------------------------------------------------------------------
// the inverse wavelet transforms

// one row or column of the 5/3: sn low samples then dn high ones in, the
// interleaved samples out, as OpenJPEG's opj_idwt53_h/_v
void idwt53_1d(int32_t* x, int sn, int dn, int cas, std::vector<int32_t>& t) {
  const int len = sn + dn;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
  } else {
    if (sn == 0 && dn == 1) {
      x[0] /= 2;
      return;
    }
    if (!(sn > 0 || dn > 1)) return;
  }
  t.resize(len);
  for (int i = 0; i < sn; ++i) t[2 * i + cas] = x[i];
  for (int i = 0; i < dn; ++i) t[2 * i + 1 - cas] = x[sn + i];
  auto m = [len](int k) {
    if (k < 0) k = -k;
    if (k >= len) k = 2 * (len - 1) - k;
    return k;
  };
  for (int k = cas; k < len; k += 2)            // the low (even) samples
    t[k] -= (t[m(k - 1)] + t[m(k + 1)] + 2) >> 2;
  for (int k = 1 - cas; k < len; k += 2)        // the high (odd) samples
    t[k] += (t[m(k - 1)] + t[m(k + 1)]) >> 1;
  std::copy(t.begin(), t.end(), x);
}

constexpr float kAlpha = -1.586134342f, kBeta = -0.052980118f,
                kGamma = 0.882911075f, kDelta = 0.443506852f,
                kK = 1.230174105f, kTwoInvK = 1.625732422f;

// OpenJPEG's opj_v8dwt_decode_step2 on one lane: w[2i - 1] += (l_prev +
// w[2i]) * c for i < min(end, m), the last one mirrored when m < end
void step2(float* l, float* w, int end, int m, float c) {
  const int imax = std::min(end, m);
  float prev = l[0];
  int i = 0;
  for (; i < imax; ++i) {
    const float next = w[2 * i];
    w[2 * i - 1] = w[2 * i - 1] + (prev + next) * c;
    prev = next;
  }
  if (m < end) w[2 * i - 1] = w[2 * i - 1] + (c + c) * w[2 * i - 2];
}

void idwt97_1d(float* x, int sn, int dn, int cas, std::vector<float>& t) {
  int a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0; b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1; b = 0;
  }
  const int len = sn + dn;
  t.assign(len + 2, 0.f);
  float* wv = t.data();
  for (int i = 0; i < sn; ++i) wv[2 * i + a] = x[i];
  for (int i = 0; i < dn; ++i) wv[2 * i + b] = x[sn + i];
  for (int i = 0; i < sn; ++i) wv[2 * i + a] *= kK;
  for (int i = 0; i < dn; ++i) wv[2 * i + b] *= kTwoInvK;
  step2(wv + b, wv + a + 1, sn, std::min(sn, dn - a), -kDelta);
  step2(wv + a, wv + b + 1, dn, std::min(dn, sn - b), -kGamma);
  step2(wv + b, wv + a + 1, sn, std::min(sn, dn - a), -kBeta);
  step2(wv + a, wv + b + 1, dn, std::min(dn, sn - b), -kAlpha);
  std::copy(wv, wv + len, x);
}

template <typename T, typename F>
void idwt_2d(TileComp& tc, std::vector<T>& data, F one_d, int numres) {
  const int64_t stride = tc.x1 - tc.x0;
  std::vector<T> line, tmp;
  for (int r = 1; r < numres; ++r) {
    const Res& lo = tc.res[r - 1];
    const Res& re = tc.res[r];
    const int rw = static_cast<int>(re.x1 - re.x0),
              rh = static_cast<int>(re.y1 - re.y0);
    const int snh = static_cast<int>(lo.x1 - lo.x0),
              snv = static_cast<int>(lo.y1 - lo.y0);
    const int cash = static_cast<int>(re.x0 & 1),
              casv = static_cast<int>(re.y0 & 1);
    for (int j = 0; j < rh; ++j)
      one_d(&data[j * stride], snh, rw - snh, cash, tmp);
    line.resize(rh);
    for (int i = 0; i < rw; ++i) {
      for (int j = 0; j < rh; ++j) line[j] = data[j * stride + i];
      one_d(line.data(), snv, rh - snv, casv, tmp);
      for (int j = 0; j < rh; ++j) data[j * stride + i] = line[j];
    }
  }
}

// ---------------------------------------------------------------------------
// the decoder

class Decoder {
 public:
  Decoder(const uint8_t* p, size_t n) : s_(p, n) {}

  // the main header as opj_j2k_read_header_procedure reads it: up to the
  // first SOT; every segment checked by its handler's rules
  void header() {
    if (s_.u16() != 0xff4f) fail("no SOC marker");
    bool has_siz = false, has_cod = false, has_qcd = false;
    uint32_t marker = s_.u16();
    while (true) {
      if (marker < 0xff00) fail("a byte that is not a marker");
      const int place = has_siz ? kMain : kMainSiz;
      if (!marker_places(marker)) marker = skip_unknown(place);
      if (!(marker_places(marker) & place))
        fail("a marker out of its place");
      if (marker == 0xff90) break;              // the first SOT
      const size_t at = s_.pos();
      const uint32_t len = s_.u16();
      if (len < 2 || !s_.more(len - 2)) fail("a marker segment past the end");
      s_.bound(at + len);
      if (marker == 0xff51) {
        read_siz(len - 2);
        def_.tccps.assign(siz_.ncomp, Tccp());
        for (int c = 0; c < siz_.ncomp; ++c)
          if (!siz_.sgnd[c]) def_.tccps[c].dc_shift = 1 << (siz_.prec[c] - 1);
        has_siz = true;
      } else {
        segment(marker, len - 2, def_);
        has_cod |= marker == 0xff52;
        has_qcd |= marker == 0xff5c;
      }
      s_.unbound();
      s_.seek(at + len);
      marker = s_.u16();
    }
    if (!has_cod || !has_qcd) fail("no COD or no QCD in the main header");
  }
  const Siz& siz() const { return siz_; }

  // what cv2 refuses by the header; the largest precision
  int refuse_as_cv2() const {
    if (siz_.ncomp > 4)
      fail(std::to_string(siz_.ncomp) + " components (cv2 reads 1 to 4)");
    int prec = 0;
    for (int c = 0; c < siz_.ncomp; ++c) {
      if (siz_.sgnd[c]) fail("signed components (cv2 refuses them)");
      prec = std::max(prec, siz_.prec[c]);
    }
    if (prec < 8)
      fail("a precision of " + std::to_string(prec) +
           " bits (cv2 reads 8 or more)");
    if (siz_.x0 || siz_.y0)
      fail("an image whose origin is not 0 (cv2 refuses it)");
    for (int c = 0; c < siz_.ncomp; ++c)
      if (siz_.dx[c] != 1 || siz_.dy[c] != 1)
        fail("a subsampled component (cv2 refuses it)");
    if (siz_.x1 > (1 << 20) || siz_.y1 > (1 << 20) ||
        siz_.x1 * siz_.y1 > (int64_t(1) << 30))
      fail("a " + std::to_string(siz_.x1) + "x" + std::to_string(siz_.y1) +
           " image, larger than cv2 reads");
    return prec;
  }

  void decode(int32_t* out) {
    read_tiles();
    packed_headers();
    const int64_t W = siz_.x1, H = siz_.y1;
    std::fill(out, out + siz_.ncomp * W * H, 0);
    for (int t = 0; t < siz_.tw * siz_.th; ++t) {
      if (!tiles_[t].seen) continue;
      decode_tile(t, out);
    }
  }

 private:
  void read_siz(uint32_t body) {
    s_.u16();                                   // Rsiz
    siz_.x1 = s_.u32(); siz_.y1 = s_.u32();
    siz_.x0 = s_.u32(); siz_.y0 = s_.u32();
    siz_.tdx = s_.u32(); siz_.tdy = s_.u32();
    siz_.tx0 = s_.u32(); siz_.ty0 = s_.u32();
    siz_.ncomp = static_cast<int>(s_.u16());
    if (body != 36u + 3u * siz_.ncomp || siz_.ncomp == 0 || siz_.ncomp > 16384)
      fail("a bad SIZ marker");
    if (siz_.x0 >= siz_.x1 || siz_.y0 >= siz_.y1 || !siz_.tdx || !siz_.tdy ||
        siz_.tx0 > siz_.x0 || siz_.ty0 > siz_.y0 ||
        siz_.tx0 + siz_.tdx <= siz_.x0 || siz_.ty0 + siz_.tdy <= siz_.y0)
      fail("a bad image or tile size in SIZ");
    for (int c = 0; c < siz_.ncomp; ++c) {
      const uint32_t ssiz = s_.u8();
      siz_.prec.push_back((ssiz & 0x7f) + 1);
      siz_.sgnd.push_back(ssiz >> 7);
      siz_.dx.push_back(s_.u8());
      siz_.dy.push_back(s_.u8());
      if (!siz_.dx.back() || !siz_.dy.back() || siz_.prec.back() > 31)
        fail("a bad component in SIZ");
    }
    siz_.tw = static_cast<int>(ceildiv(siz_.x1 - siz_.tx0, siz_.tdx));
    siz_.th = static_cast<int>(ceildiv(siz_.y1 - siz_.ty0, siz_.tdy));
    if (int64_t(siz_.tw) * siz_.th > 65535) fail("more than 65535 tiles");
  }

  // opj_j2k_read_unk: past an unknown marker of the main header, two bytes
  // at a time up to a marker OpenJPEG knows (an unknown one met on the way
  // must stand in its place, as in the rest of the main header)
  uint32_t skip_unknown(int place) {
    while (true) {
      if (!s_.more(2)) fail("the codestream ends after an unknown marker");
      const uint32_t m = s_.u16();
      if (m < 0xff00) continue;
      const int places = marker_places(m);
      if (!((places ? places : kMain | kTilePart) & place))
        fail("a marker out of its place");
      if (places) return m;
    }
  }

  int comp_index() {
    return static_cast<int>(s_.un(siz_.ncomp <= 256 ? 1 : 2));
  }

  // SPcod / SPcoc from a body of ``left`` bytes, which it must fill
  void read_spcod(Tccp& tc, bool precincts, uint32_t left) {
    if (left < 5) fail("a COD or COC marker of the wrong length");
    tc.numres = static_cast<int>(s_.u8()) + 1;
    tc.cbw = static_cast<int>(s_.u8()) + 2;
    tc.cbh = static_cast<int>(s_.u8()) + 2;
    tc.cblksty = static_cast<int>(s_.u8());
    tc.qmfbid = static_cast<int>(s_.u8());
    if (tc.numres > kMaxRes || tc.cbw > 10 || tc.cbh > 10 ||
        tc.cbw + tc.cbh > 12 || tc.qmfbid > 1)
      fail("a bad coding style (COD/COC)");
    if (tc.cblksty & 0x80) fail("a mixed HT code-block style");
    if (tc.cblksty & 0x40)
      fail("a high-throughput (HTJ2K) code-block, which the port does not "
           "read");
    if (left != 5u + (precincts ? tc.numres : 0))
      fail("a COD or COC marker of the wrong length");
    for (int r = 0; r < tc.numres; ++r) {
      if (precincts) {
        const uint32_t v = s_.u8();
        tc.prcw[r] = v & 15;
        tc.prch[r] = v >> 4;
        if (r && (!tc.prcw[r] || !tc.prch[r]))
          fail("a precinct of size 1 above resolution 0");
      } else {
        tc.prcw[r] = tc.prch[r] = 15;
      }
    }
  }

  // SQcd / SQcc from a body of ``len`` bytes, which it must fill; a style
  // above 2 reads as expounded (OpenJPEG's)
  void read_sqcd(Tccp& tc, uint32_t len) {
    if (len < 1) fail("a QCD or QCC marker of the wrong length");
    const uint32_t sq = s_.u8();
    --len;
    tc.qntsty = sq & 0x1f;
    tc.numgbits = sq >> 5;
    const int n = tc.qntsty == 0 ? static_cast<int>(len)
                : tc.qntsty == 1 ? 1 : static_cast<int>(len / 2);
    if (len != static_cast<uint32_t>(tc.qntsty == 0 ? n : 2 * n))
      fail("a QCD or QCC marker of the wrong length");
    for (int b = 0; b < n; ++b) {
      if (b >= kMaxBands) { s_.un(tc.qntsty == 0 ? 1 : 2); continue; }
      if (tc.qntsty == 0) {
        tc.expn[b] = static_cast<int>(s_.u8() >> 3);
        tc.mant[b] = 0;
      } else {
        const uint32_t v = s_.u16();
        tc.expn[b] = static_cast<int>(v >> 11);
        tc.mant[b] = static_cast<int>(v & 0x7ff);
      }
    }
    if (tc.qntsty == 1)
      for (int b = 1; b < kMaxBands; ++b) {
        tc.expn[b] = std::max(0, tc.expn[0] - (b - 1) / 3);
        tc.mant[b] = tc.mant[0];
      }
  }

  // a progression order other than the five makes no packets (pi.c)
  void read_poc(Tcp& tcp, uint32_t body) {
    const int cb = siz_.ncomp <= 256 ? 1 : 2;
    const int n = static_cast<int>(body / (5 + 2 * cb));
    if (!n || body % (5 + 2 * cb)) fail("a POC marker of the wrong length");
    if (tcp.pocs.size() + n >= 32) fail("32 progression changes or more");
    for (int i = 0; i < n; ++i) {
      Poc p;
      p.res0 = static_cast<int>(s_.u8());
      p.comp0 = static_cast<int>(s_.un(cb));
      p.lay1 = std::min(static_cast<int>(s_.u16()), tcp.numlayers);
      p.res1 = static_cast<int>(s_.u8());
      p.comp1 = std::min(static_cast<int>(s_.un(cb)), siz_.ncomp);
      p.prg = static_cast<int>(s_.u8());
      tcp.pocs.push_back(p);
    }
  }

  // a marker segment of ``body`` bytes (the reader bound to it) of the
  // main header, or of a tile-part header into ``tcp``, with the length
  // rules of OpenJPEG's handlers
  void segment(uint32_t marker, uint32_t body, Tcp& tcp) {
    const uint32_t cb = siz_.ncomp <= 256 ? 1 : 2;
    switch (marker) {
      case 0xff52: {                            // COD
        if (body < 5) fail("a COD marker of the wrong length");
        tcp.csty = static_cast<int>(s_.u8());
        tcp.prg = static_cast<int>(s_.u8());
        tcp.numlayers = static_cast<int>(s_.u16());
        tcp.mct = static_cast<int>(s_.u8());
        if ((tcp.csty & ~7) || tcp.prg > CPRL || !tcp.numlayers ||
            tcp.mct > 1)
          fail("a bad COD marker");
        Tccp tc;
        read_spcod(tc, tcp.csty & 1, body - 5);
        for (auto& t : tcp.tccps) {
          const Tccp q = t;
          t = tc;
          t.csty = tcp.csty & 1;
          std::copy(q.expn, q.expn + kMaxBands, t.expn);
          std::copy(q.mant, q.mant + kMaxBands, t.mant);
          t.qntsty = q.qntsty;
          t.numgbits = q.numgbits;
          t.roishift = q.roishift;
          t.dc_shift = q.dc_shift;
        }
        break;
      }
      case 0xff53: {                            // COC
        if (body < cb + 1) fail("a COC marker of the wrong length");
        const int c = comp_index();
        if (c >= siz_.ncomp) fail("COC of a component that is not there");
        Tccp& t = tcp.tccps[c];
        t.csty = static_cast<int>(s_.u8());
        read_spcod(t, t.csty & 1, body - cb - 1);
        break;
      }
      case 0xff5c: {                            // QCD
        Tccp q;
        read_sqcd(q, body);
        for (auto& t : tcp.tccps) {
          std::copy(q.expn, q.expn + kMaxBands, t.expn);
          std::copy(q.mant, q.mant + kMaxBands, t.mant);
          t.qntsty = q.qntsty;
          t.numgbits = q.numgbits;
        }
        break;
      }
      case 0xff5d: {                            // QCC
        if (body < cb) fail("a QCC marker of the wrong length");
        const int c = comp_index();
        if (c >= siz_.ncomp) fail("QCC of a component that is not there");
        read_sqcd(tcp.tccps[c], body - cb);
        break;
      }
      case 0xff5e: {                            // RGN (Srgn is not read)
        if (body != cb + 2) fail("an RGN marker of the wrong length");
        const int c = comp_index();
        if (c >= siz_.ncomp) fail("RGN of a component that is not there");
        s_.u8();
        tcp.tccps[c].roishift = static_cast<int>(s_.u8());
        break;
      }
      case 0xff5f:                              // POC
        read_poc(tcp, body);
        break;
      case 0xff60: {                            // PPM
        if (body < 2) fail("a PPM marker of the wrong length");
        const int z = static_cast<int>(s_.u8());
        add_packed(ppm_parts_, z, s_.at(s_.pos()), body - 1, "Zppm");
        break;
      }
      case 0xff61: {                            // PPT
        if (body < 2) fail("a PPT marker of the wrong length");
        if (!ppm_parts_.empty()) fail("PPT in a codestream with PPM");
        const int z = static_cast<int>(s_.u8());
        add_packed(tcp.ppt_parts, z, s_.at(s_.pos()), body - 1, "Zppt");
        tcp.has_ppt = true;
        break;
      }
      case 0xff55:                              // TLM
        if (body < 2) fail("a TLM marker of the wrong length");
        break;
      case 0xff57:                              // PLM
        if (body < 1) fail("a PLM marker of the wrong length");
        break;
      case 0xff58: {                            // PLT: whole lengths only
        if (body < 1) fail("a PLT marker of the wrong length");
        s_.u8();
        uint32_t len = 0;
        for (uint32_t i = 1; i < body; ++i) {
          const uint32_t v = s_.u8();
          len |= v & 0x7f;
          len = v & 0x80 ? len << 7 : 0;
        }
        if (len) fail("a PLT marker that ends inside a packet length");
        break;
      }
      case 0xff63:                              // CRG
        if (body != 4u * siz_.ncomp) fail("a CRG marker of the wrong length");
        break;
      case 0xff74:                              // MCT
        read_mct(tcp, body);
        break;
      case 0xff75:                              // MCC
        read_mcc(tcp, body);
        break;
      case 0xff77:                              // MCO
        read_mco(tcp, body);
        break;
      case 0xff78:                              // CBD
        read_cbd(body);
        break;
      default:                                  // COM, CAP, CPF
        break;
    }
  }

  // opj_j2k_read_mct: Zmct and Ymct other than 0 are not taken (with
  // Ymct the record is made, its data dropped); a record of the same
  // index is replaced
  void read_mct(Tcp& tcp, uint32_t body) {
    if (body < 2) fail("an MCT marker of the wrong length");
    if (s_.u16() != 0) return;                  // Zmct
    if (body <= 6) fail("an MCT marker of the wrong length");
    const uint32_t imct = s_.u16();
    const int index = static_cast<int>(imct & 0xff);
    size_t k = 0;
    while (k < tcp.mcts.size() && tcp.mcts[k].index != index) ++k;
    if (k == tcp.mcts.size()) tcp.mcts.emplace_back();
    MctRecord& r = tcp.mcts[k];
    r.data.clear();
    r.index = index;
    r.elem = static_cast<int>((imct >> 10) & 3);
    if (s_.u16() != 0) return;                  // Ymct
    r.data.assign(s_.at(s_.pos()), s_.at(s_.pos()) + body - 6);
  }

  // opj_j2k_read_mcc: one collection of array-based decorrelation over
  // components 0..n-1 in order; anything else is not taken (a record
  // already there keeps what was read of it); a collection naming an MCT
  // index that is not there fails
  void read_mcc(Tcp& tcp, uint32_t body) {
    if (body < 2) fail("an MCC marker of the wrong length");
    if (s_.u16() != 0) return;                  // Zmcc
    if (body < 7) fail("an MCC marker of the wrong length");
    const int index = static_cast<int>(s_.u8());
    size_t k = 0;
    while (k < tcp.mccs.size() && tcp.mccs[k].index != index) ++k;
    const bool found = k < tcp.mccs.size();
    MccRecord fresh;
    MccRecord& r = found ? tcp.mccs[k] : fresh;
    r.index = index;
    if (s_.u16() != 0) return;                  // Ymcc
    const uint32_t ncoll = s_.u16();            // Qmcc
    if (ncoll > 1) return;
    uint32_t left = body - 7;
    for (uint32_t i = 0; i < ncoll; ++i) {
      if (left < 3) fail("an MCC marker of the wrong length");
      if (s_.u8() != 1) return;                 // Xmcc: array-based
      uint32_t n = s_.u16();
      left -= 3;
      int bytes = 1 + static_cast<int>(n >> 15);
      r.ncomp = static_cast<int>(n & 0x7fff);
      if (left < bytes * uint32_t(r.ncomp) + 2)
        fail("an MCC marker of the wrong length");
      left -= bytes * r.ncomp + 2;
      for (int j = 0; j < r.ncomp; ++j)
        if (s_.un(bytes) != uint32_t(j)) return;
      n = s_.u16();
      bytes = 1 + static_cast<int>(n >> 15);
      if (static_cast<int>(n & 0x7fff) != r.ncomp) return;
      if (left < bytes * uint32_t(r.ncomp) + 3)
        fail("an MCC marker of the wrong length");
      left -= bytes * r.ncomp + 3;
      for (int j = 0; j < r.ncomp; ++j)
        if (s_.un(bytes) != uint32_t(j)) return;
      const uint32_t t = s_.u8() << 16 | s_.u16();
      r.deco = r.offset = -1;
      for (int which : {0, 1}) {
        const int want = static_cast<int>(which ? (t >> 8) & 0xff : t & 0xff);
        if (!want) continue;
        int found_at = -1;
        for (size_t m = 0; m < tcp.mcts.size() && found_at < 0; ++m)
          if (tcp.mcts[m].index == want) found_at = static_cast<int>(m);
        if (found_at < 0) fail("an MCC naming an MCT array that is not there");
        (which ? r.offset : r.deco) = found_at;
      }
    }
    if (left) fail("an MCC marker of the wrong length");
    if (!found) tcp.mccs.push_back(r);
  }

  // opj_j2k_read_mco: more than one stage is not taken; otherwise every
  // component's DC level shift becomes 0, then each stage's collection
  // (opj_j2k_add_mct) sets them from its offset array
  void read_mco(Tcp& tcp, uint32_t body) {
    if (body < 1) fail("an MCO marker of the wrong length");
    const uint32_t nstages = s_.u8();
    if (nstages > 1) return;
    if (body != nstages + 1) fail("an MCO marker of the wrong length");
    for (auto& t : tcp.tccps) t.dc_shift = 0;
    for (uint32_t i = 0; i < nstages; ++i)
      add_mct(tcp, static_cast<int>(s_.u8()));
  }

  // opj_j2k_add_mct compares the stage's index with the first collection
  // only (its search never steps on); a collection over another number of
  // components than the image's is passed over; arrays of the wrong size
  // fail; the offsets, read as OpenJPEG's j2k_mct_read_functions_to_int32
  // read them (int16 as unsigned, floats truncated), become the shifts
  void add_mct(Tcp& tcp, int index) {
    if (tcp.mccs.empty() || tcp.mccs[0].index != index) return;
    const MccRecord& r = tcp.mccs[0];
    const uint32_t n = static_cast<uint32_t>(siz_.ncomp);
    if (r.ncomp != siz_.ncomp) return;
    if (r.deco >= 0) {
      const MctRecord& d = tcp.mcts[r.deco];
      if (d.data.size() != kMctElemSize[d.elem] * n * n)
        fail("an MCT decorrelation array of the wrong size");
    }
    if (r.offset < 0) return;
    const MctRecord& o = tcp.mcts[r.offset];
    const uint32_t size = kMctElemSize[o.elem];
    if (o.data.size() != size * n)
      fail("an MCT offset array of the wrong size");
    for (uint32_t c = 0; c < n; ++c) {
      uint64_t v = 0;
      for (uint32_t b = 0; b < size; ++b) v = v << 8 | o.data[c * size + b];
      int32_t shift;
      if (o.elem < 2) {
        shift = static_cast<int32_t>(static_cast<uint32_t>(v));
      } else {
        double f;
        if (o.elem == 2) {
          float g;
          const uint32_t u = static_cast<uint32_t>(v);
          std::memcpy(&g, &u, 4);
          f = g;
        } else {
          std::memcpy(&f, &v, 8);
        }
        // a conversion out of range gives x86's "integer indefinite"
        shift = f >= -2147483648.0 && f < 2147483648.0
                    ? static_cast<int32_t>(f) : INT32_MIN;
      }
      tcp.tccps[c].dc_shift = shift;
    }
  }

  // opj_j2k_read_cbd: a bit depth and sign for every component, which
  // replace SIZ's
  void read_cbd(uint32_t body) {
    const uint32_t n = static_cast<uint32_t>(siz_.ncomp);
    if (body != n + 2 || s_.u16() != n) fail("a bad CBD marker");
    for (uint32_t c = 0; c < n; ++c) {
      const uint32_t v = s_.u8();
      siz_.sgnd[c] = static_cast<int>(v >> 7);
      siz_.prec[c] = static_cast<int>(v & 0x7f) + 1;
      if (siz_.prec[c] > 31) fail("a bad CBD marker");
    }
  }

  // the tile-parts as opj_j2k_read_tile_header and opj_j2k_read_sot take
  // them: each tile's parts numbered on from 0, within its TNsot once one
  // gives it; OpenJPEG decodes a tile when its last part (by TNsot) has
  // come and reads no further once every tile has; a Psot of 0 runs to
  // the last two bytes of the file, after which it reads nothing more
  void read_tiles() {
    const int ntiles = siz_.tw * siz_.th;
    tiles_.resize(ntiles);
    std::vector<int> last_part(ntiles, -1), nparts(ntiles, 0);
    int complete = 0;
    // positioned after the first SOT marker
    while (true) {
      const size_t sot = s_.pos() - 2;
      if (s_.u16() != 10) fail("a bad SOT marker");
      const int isot = static_cast<int>(s_.u16());
      const uint32_t psot = s_.u32();
      const int tpsot = static_cast<int>(s_.u8());
      const int tnsot = static_cast<int>(s_.u8());
      if (isot >= ntiles) fail("a tile index past the last tile");
      if (tpsot != last_part[isot] + 1)
        fail("tile-part " + std::to_string(tpsot) + " of tile " +
             std::to_string(isot) + " out of order");
      last_part[isot] = tpsot;
      if (psot && psot < 14) fail("a Psot of " + std::to_string(psot));
      if ((nparts[isot] && tpsot >= nparts[isot]) || (tnsot && tpsot >= tnsot))
        fail("a TPsot past the tile's TNsot");
      if (tnsot) nparts[isot] = tnsot;
      Tcp& tcp = tiles_[isot];
      if (!tcp.seen) {
        tcp = def_;
        tcp.data.clear();
        tcp.ppt.clear();
        tcp.has_ppt = false;
        tcp.seen = true;
      }
      tile_part_order_.push_back(isot);
      while (true) {                            // opj_j2k_read_tile_header
        const uint32_t marker = s_.u16();
        if (marker == 0xff93) break;            // SOD
        const size_t at = s_.pos();
        const uint32_t len = s_.u16();
        if (len < 2) fail("a marker segment shorter than its length");
        const int places = marker_places(marker);
        if (!((places ? places : kMain | kTilePart) & kTilePart))
          fail("a marker out of its place");
        if (!s_.more(len - 2)) fail("a marker segment past the end");
        if (!places) fail("an unknown marker in a tile-part header");
        s_.bound(at + len);
        segment(marker, len - 2, tcp);
        s_.unbound();
        s_.seek(at + len);
      }
      const size_t end = psot ? sot + psot : s_.size() - 2;
      if (s_.size() < 2 || end > s_.size())
        fail("a tile-part longer than the file");
      if (end < s_.pos()) fail("a tile-part shorter than its header");
      tcp.data.insert(tcp.data.end(), s_.at(s_.pos()), s_.at(end));
      s_.seek(end);
      if (!s_.more(2)) fail("the codestream ends without an EOC marker");
      const uint32_t marker = s_.u16();
      const bool all = nparts[isot] == tpsot + 1 && ++complete == ntiles;
      if (marker == 0xffd9 || (!psot && marker != 0xff90)) break;
      if (marker != 0xff90) {
        if (all && !s_.more(1)) break;          // the file's last 2 bytes
        fail("neither SOT nor EOC after a tile-part");
      }
      if (all) break;
    }
  }

  // each tile's PPT segments in Zppt order, then PPM's packet headers:
  // Nppm bytes for each tile-part in order
  void packed_headers() {
    for (auto& tcp : tiles_)
      for (const auto& part : tcp.ppt_parts)
        tcp.ppt.insert(tcp.ppt.end(), part.second.begin(), part.second.end());
    if (ppm_parts_.empty()) return;
    std::vector<uint8_t> ppm;
    for (const auto& part : ppm_parts_)
      ppm.insert(ppm.end(), part.second.begin(), part.second.end());
    size_t at = 0;
    for (int t : tile_part_order_) {
      if (at + 4 > ppm.size())
        fail("PPM holds fewer tile-parts than there are");
      const uint32_t n = uint32_t(ppm[at]) << 24 | ppm[at + 1] << 16 |
                         ppm[at + 2] << 8 | ppm[at + 3];
      at += 4;
      if (at + n > ppm.size()) fail("a PPM tile-part past its end");
      tiles_[t].ppt.insert(tiles_[t].ppt.end(), ppm.begin() + at,
                           ppm.begin() + at + n);
      tiles_[t].has_ppt = true;
      at += n;
    }
  }

  void init_tile(int t, const Tcp& tcp, std::vector<TileComp>& comps,
                 int64_t* tx0, int64_t* ty0, int64_t* tx1, int64_t* ty1) {
    const int p = t % siz_.tw, q = t / siz_.tw;
    *tx0 = std::max(siz_.tx0 + p * siz_.tdx, siz_.x0);
    *ty0 = std::max(siz_.ty0 + q * siz_.tdy, siz_.y0);
    *tx1 = std::min(siz_.tx0 + (p + 1) * siz_.tdx, siz_.x1);
    *ty1 = std::min(siz_.ty0 + (q + 1) * siz_.tdy, siz_.y1);
    comps.resize(siz_.ncomp);
    for (int c = 0; c < siz_.ncomp; ++c) {
      const Tccp& tc = tcp.tccps[c];
      TileComp& tcm = comps[c];
      tcm.x0 = ceildiv(*tx0, siz_.dx[c]);
      tcm.y0 = ceildiv(*ty0, siz_.dy[c]);
      tcm.x1 = ceildiv(*tx1, siz_.dx[c]);
      tcm.y1 = ceildiv(*ty1, siz_.dy[c]);
      tcm.numres = tc.numres;
      tcm.res.assign(tc.numres, Res());
      const int64_t area = (tcm.x1 - tcm.x0) * (tcm.y1 - tcm.y0);
      if (tc.qmfbid == 1) tcm.idata.assign(area, 0);
      else tcm.fdata.assign(area, 0.f);
      for (int r = 0; r < tc.numres; ++r) {
        Res& re = tcm.res[r];
        const int level = tc.numres - 1 - r;
        re.x0 = ceildivpow2(tcm.x0, level);
        re.y0 = ceildivpow2(tcm.y0, level);
        re.x1 = ceildivpow2(tcm.x1, level);
        re.y1 = ceildivpow2(tcm.y1, level);
        re.pdx = tc.prcw[r];
        re.pdy = tc.prch[r];
        const int64_t prx0 = floordivpow2(re.x0, re.pdx) << re.pdx;
        const int64_t pry0 = floordivpow2(re.y0, re.pdy) << re.pdy;
        const int64_t prx1 = ceildivpow2(re.x1, re.pdx) << re.pdx;
        const int64_t pry1 = ceildivpow2(re.y1, re.pdy) << re.pdy;
        re.pw = re.x0 == re.x1 ? 0 : static_cast<int>((prx1 - prx0) >> re.pdx);
        re.ph = re.y0 == re.y1 ? 0 : static_cast<int>((pry1 - pry0) >> re.pdy);
        int64_t cbgx0, cbgy0;
        int cbgw, cbgh;
        if (r == 0) {
          cbgx0 = prx0; cbgy0 = pry0; cbgw = re.pdx; cbgh = re.pdy;
          re.numbands = 1;
        } else {
          cbgx0 = ceildivpow2(prx0, 1); cbgy0 = ceildivpow2(pry0, 1);
          cbgw = re.pdx - 1; cbgh = re.pdy - 1;
          re.numbands = 3;
        }
        const int cbw = std::min(tc.cbw, cbgw), cbh = std::min(tc.cbh, cbgh);
        for (int b = 0; b < re.numbands; ++b) {
          Band& band = re.bands[b];
          int stepno;
          if (r == 0) {
            band.bandno = 0;
            band.x0 = re.x0; band.y0 = re.y0; band.x1 = re.x1; band.y1 = re.y1;
            stepno = 0;
          } else {
            band.bandno = b + 1;
            const int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
            band.x0 = ceildivpow2(tcm.x0 - (xob << level), level + 1);
            band.y0 = ceildivpow2(tcm.y0 - (yob << level), level + 1);
            band.x1 = ceildivpow2(tcm.x1 - (xob << level), level + 1);
            band.y1 = ceildivpow2(tcm.y1 - (yob << level), level + 1);
            stepno = 3 * (r - 1) + 1 + b;
          }
          const int gain = tc.qmfbid == 0 ? 0
                         : band.bandno == 0 ? 0
                         : band.bandno == 3 ? 2 : 1;
          const int numbps = siz_.prec[c] + gain;
          band.stepsize = static_cast<float>(
              (1.0 + tc.mant[stepno] / 2048.0) *
              std::pow(2.0, numbps - tc.expn[stepno]));
          band.numbps = tc.expn[stepno] + tc.numgbits - 1;
          band.precincts.assign(int64_t(re.pw) * re.ph, Precinct());
          for (int pn = 0; pn < re.pw * re.ph; ++pn) {
            Precinct& pr = band.precincts[pn];
            const int64_t sx = cbgx0 + (int64_t(pn % re.pw) << cbgw);
            const int64_t sy = cbgy0 + (int64_t(pn / re.pw) << cbgh);
            pr.x0 = std::max(sx, band.x0);
            pr.y0 = std::max(sy, band.y0);
            pr.x1 = std::min(sx + (int64_t(1) << cbgw), band.x1);
            pr.y1 = std::min(sy + (int64_t(1) << cbgh), band.y1);
            if (pr.x0 >= pr.x1 || pr.y0 >= pr.y1) continue;   // no blocks
            const int64_t bx0 = floordivpow2(pr.x0, cbw) << cbw;
            const int64_t by0 = floordivpow2(pr.y0, cbh) << cbh;
            const int64_t bx1 = ceildivpow2(pr.x1, cbw) << cbw;
            const int64_t by1 = ceildivpow2(pr.y1, cbh) << cbh;
            pr.cw = static_cast<int>((bx1 - bx0) >> cbw);
            pr.ch = static_cast<int>((by1 - by0) >> cbh);
            pr.cblks.resize(int64_t(pr.cw) * pr.ch);
            for (int k = 0; k < pr.cw * pr.ch; ++k) {
              Cblk& cb = pr.cblks[k];
              const int64_t cx = bx0 + (int64_t(k % pr.cw) << cbw);
              const int64_t cy = by0 + (int64_t(k / pr.cw) << cbh);
              cb.x0 = std::max(cx, pr.x0);
              cb.y0 = std::max(cy, pr.y0);
              cb.x1 = std::min(cx + (int64_t(1) << cbw), pr.x1);
              cb.y1 = std::min(cy + (int64_t(1) << cbh), pr.y1);
            }
            pr.incl.build(pr.cw, pr.ch);
            pr.imsb.build(pr.cw, pr.ch);
          }
        }
      }
    }
  }

  struct Packet {
    int layno, resno, compno, precno;
  };

  // the packets of a tile in the order OpenJPEG's iterator yields them
  std::vector<Packet> packets(const Tcp& tcp,
                              const std::vector<TileComp>& comps,
                              int64_t tx0, int64_t ty0, int64_t tx1,
                              int64_t ty1) {
    int maxres = 0, maxprec = 0;
    for (const auto& tc : comps) {
      maxres = std::max(maxres, tc.numres);
      for (const auto& re : tc.res) maxprec = std::max(maxprec, re.pw * re.ph);
    }
    const int64_t nl = tcp.numlayers;
    std::vector<uint8_t> include(nl * maxres * siz_.ncomp * int64_t(maxprec),
                                 0);
    auto index = [&](int l, int r, int c, int p) {
      return ((int64_t(l) * maxres + r) * siz_.ncomp + c) * maxprec + p;
    };
    std::vector<Poc> progs = tcp.pocs;
    if (progs.empty())
      progs.push_back(Poc{0, 0, tcp.numlayers, maxres, siz_.ncomp, tcp.prg});
    std::vector<Packet> out;
    auto emit = [&](int l, int r, int c, int p) {
      int64_t i = index(l, r, c, p);
      if (!include[i]) {
        include[i] = 1;
        out.push_back(Packet{l, r, c, p});
      }
    };
    for (const Poc& poc : progs) {
      const int l1 = std::min(poc.lay1, tcp.numlayers);
      const int c1 = std::min(poc.comp1, siz_.ncomp);
      const int r1 = std::min(poc.res1, maxres);
      auto precs = [&](int r, int c) {
        return r < comps[c].numres ? comps[c].res[r].pw * comps[c].res[r].ph
                                   : 0;
      };
      if (poc.prg == LRCP) {
        for (int l = 0; l < l1; ++l)
          for (int r = poc.res0; r < r1; ++r)
            for (int c = poc.comp0; c < c1; ++c)
              for (int p = 0; p < precs(r, c); ++p) emit(l, r, c, p);
      } else if (poc.prg == RLCP) {
        for (int r = poc.res0; r < r1; ++r)
          for (int l = 0; l < l1; ++l)
            for (int c = poc.comp0; c < c1; ++c)
              for (int p = 0; p < precs(r, c); ++p) emit(l, r, c, p);
      } else {
        // the position-driven orders: B.12.1.3-5 as pi.c steps them
        auto step = [&](int c0, int c1_, int64_t* dx, int64_t* dy) {
          *dx = *dy = 0;
          for (int c = c0; c < c1_; ++c)
            for (int r = 0; r < comps[c].numres; ++r) {
              const Res& re = comps[c].res[r];
              const int lv = comps[c].numres - 1 - r;
              const int64_t ddx = int64_t(siz_.dx[c]) << (re.pdx + lv);
              const int64_t ddy = int64_t(siz_.dy[c]) << (re.pdy + lv);
              *dx = *dx ? std::min(*dx, ddx) : ddx;
              *dy = *dy ? std::min(*dy, ddy) : ddy;
            }
        };
        // the precinct of (r, c) at position (x, y), or -1 when none starts
        auto prec_at = [&](int r, int c, int64_t x, int64_t y) -> int {
          if (r >= comps[c].numres) return -1;
          const Res& re = comps[c].res[r];
          const int lv = comps[c].numres - 1 - r;
          const int64_t cdx = int64_t(siz_.dx[c]) << lv,
                        cdy = int64_t(siz_.dy[c]) << lv;
          const int64_t trx0 = ceildiv(tx0, cdx), try0 = ceildiv(ty0, cdy);
          const int64_t trx1 = ceildiv(tx1, cdx), try1 = ceildiv(ty1, cdy);
          const int rpx = re.pdx + lv, rpy = re.pdy + lv;
          if (!(y % (int64_t(siz_.dy[c]) << rpy) == 0 ||
                (y == ty0 && ((try0 << lv) % (int64_t(1) << rpy)))))
            return -1;
          if (!(x % (int64_t(siz_.dx[c]) << rpx) == 0 ||
                (x == tx0 && ((trx0 << lv) % (int64_t(1) << rpx)))))
            return -1;
          if (re.pw == 0 || re.ph == 0) return -1;
          if (trx0 == trx1 || try0 == try1) return -1;
          const int64_t prci = floordivpow2(ceildiv(x, cdx), re.pdx) -
                               floordivpow2(trx0, re.pdx);
          const int64_t prcj = floordivpow2(ceildiv(y, cdy), re.pdy) -
                               floordivpow2(try0, re.pdy);
          return static_cast<int>(prci + prcj * re.pw);
        };
        auto layers = [&](int r, int c, int p) {
          if (p < 0) return;
          for (int l = 0; l < l1; ++l) emit(l, r, c, p);
        };
        int64_t dx, dy;
        if (poc.prg == RPCL) {
          step(0, siz_.ncomp, &dx, &dy);
          if (!dx || !dy) continue;
          for (int r = poc.res0; r < r1; ++r)
            for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
              for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
                for (int c = poc.comp0; c < c1; ++c)
                  layers(r, c, prec_at(r, c, x, y));
        } else if (poc.prg == PCRL) {
          step(0, siz_.ncomp, &dx, &dy);
          if (!dx || !dy) continue;
          for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
              for (int c = poc.comp0; c < c1; ++c)
                for (int r = poc.res0; r < std::min(r1, comps[c].numres); ++r)
                  layers(r, c, prec_at(r, c, x, y));
        } else if (poc.prg == CPRL) {
          for (int c = poc.comp0; c < c1; ++c) {
            step(c, c + 1, &dx, &dy);
            if (!dx || !dy) continue;
            for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
              for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
                for (int r = poc.res0; r < std::min(r1, comps[c].numres); ++r)
                  layers(r, c, prec_at(r, c, x, y));
          }
        }
      }
    }
    return out;
  }

  // one packet: its header (from the data or the packed headers) and body
  void read_packet(const Tcp& tcp, std::vector<TileComp>& comps,
                   const Packet& pk, size_t* pos, size_t* hpos) {
    const std::vector<uint8_t>& d = tcp.data;
    const Tccp& tc = tcp.tccps[pk.compno];
    Res& re = comps[pk.compno].res[pk.resno];
    if (pk.layno == 0)
      for (int b = 0; b < re.numbands; ++b) {
        Band& band = re.bands[b];
        if (band.empty()) continue;
        Precinct& pr = band.precincts[pk.precno];
        pr.incl.reset();
        pr.imsb.reset();
        for (auto& cb : pr.cblks) cb.numsegs = 0;
      }
    if (tcp.csty & 2) {                         // SOP
      if (*pos + 6 <= d.size() && d[*pos] == 0xff && d[*pos + 1] == 0x91)
        *pos += 6;
    }
    const bool packed = tcp.has_ppt;
    const std::vector<uint8_t>& hd = packed ? tcp.ppt : d;
    size_t& hp = packed ? *hpos : *pos;
    Bio bio(hd.data() + std::min(hp, hd.size()),
            hp < hd.size() ? hd.size() - hp : 0);
    auto eph = [&]() {                         // a missing one fails
      if (tcp.csty & 4) {
        if (hp + 2 > hd.size() || hd[hp] != 0xff || hd[hp + 1] != 0x92)
          fail("no EPH marker after a packet header");
        hp += 2;
      }
    };
    if (!bio.bit()) {                           // an empty packet
      bio.inalign();
      hp += bio.numbytes();
      eph();
      return;
    }
    for (int b = 0; b < re.numbands; ++b) {
      Band& band = re.bands[b];
      if (band.empty()) continue;
      Precinct& pr = band.precincts[pk.precno];
      for (int k = 0; k < pr.cw * pr.ch; ++k) {
        Cblk& cb = pr.cblks[k];
        const int included = cb.numsegs ? static_cast<int>(bio.bit())
                                         : tgt_decode(bio, pr.incl, k,
                                                      pk.layno + 1);
        if (!included) { cb.numnewpasses = 0; continue; }
        if (!cb.numsegs) {
          int i = 0;
          while (!tgt_decode(bio, pr.imsb, k, i)) ++i;
          cb.numbps = band.numbps + 1 - i;
          cb.numlenbits = 3;
          cb.data.clear();
        }
        int n;
        if (!bio.bit()) n = 1;
        else if (!bio.bit()) n = 2;
        else if ((n = static_cast<int>(bio.read(2))) != 3) n += 3;
        else if ((n = static_cast<int>(bio.read(5))) != 31) n += 6;
        else n = 37 + static_cast<int>(bio.read(7));
        cb.numnewpasses = n;
        int incr = 0;
        while (bio.bit()) ++incr;
        cb.numlenbits += incr;
        int segno = 0;
        if (!cb.numsegs) {
          init_seg(cb.segs, 0, tc.cblksty, true);
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
            ++segno;
            init_seg(cb.segs, segno, tc.cblksty, false);
          }
        }
        do {
          Seg& seg = cb.segs[segno];
          seg.numnewpasses = std::min(seg.maxpasses - seg.numpasses, n);
          const int bits = cb.numlenbits + floorlog2(seg.numnewpasses);
          if (bits > 32) fail("a code-block length of more than 32 bits");
          seg.newlen = static_cast<int>(bio.read(bits));
          n -= seg.numnewpasses;
          if (n > 0) {
            ++segno;
            init_seg(cb.segs, segno, tc.cblksty, false);
          }
        } while (n > 0);
      }
    }
    bio.inalign();
    hp += bio.numbytes();
    eph();
    // the body
    for (int b = 0; b < re.numbands; ++b) {
      Band& band = re.bands[b];
      if (band.empty()) continue;
      Precinct& pr = band.precincts[pk.precno];
      for (auto& cb : pr.cblks) {
        if (!cb.numnewpasses) continue;
        int segno;
        if (!cb.numsegs) {
          segno = 0;
          cb.numsegs = 1;
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
            ++segno;
            ++cb.numsegs;
          }
        }
        do {
          Seg& seg = cb.segs[segno];
          if (*pos + seg.newlen > d.size())
            fail("a code-block's data past the end of its tile");
          cb.data.insert(cb.data.end(), d.begin() + *pos,
                         d.begin() + *pos + seg.newlen);
          *pos += seg.newlen;
          seg.len += seg.newlen;
          seg.numpasses += seg.numnewpasses;
          cb.numnewpasses -= seg.numnewpasses;
          if (cb.numnewpasses > 0) {
            ++segno;
            ++cb.numsegs;
          }
        } while (cb.numnewpasses > 0);
      }
    }
  }

  void decode_tile(int t, int32_t* out) {
    Tcp& tcp = tiles_[t];
    std::vector<TileComp> comps;
    int64_t tx0, ty0, tx1, ty1;
    init_tile(t, tcp, comps, &tx0, &ty0, &tx1, &ty1);
    // OpenJPEG rebuilds each component up to the highest resolution that
    // a packet of the tile reached (resno_decoded; a packet past the end of
    // the data reads as empty), at the top left of the tile's buffer, and
    // copies that much to the image at its resolution's coordinates; the
    // rest of the image stays 0
    std::vector<int> top(siz_.ncomp, 0);
    size_t pos = 0, hpos = 0;
    for (const Packet& pk : packets(tcp, comps, tx0, ty0, tx1, ty1)) {
      read_packet(tcp, comps, pk, &pos, &hpos);
      top[pk.compno] = std::max(top[pk.compno], pk.resno);
    }
    for (int c = 0; c < siz_.ncomp; ++c) {
      TileComp& tcm = comps[c];
      const Tccp& tc = tcp.tccps[c];
      const int64_t stride = tcm.x1 - tcm.x0;
      for (int r = 0; r < tcm.numres; ++r) {
        Res& re = tcm.res[r];
        for (int b = 0; b < re.numbands; ++b) {
          Band& band = re.bands[b];
          if (band.empty()) continue;
          for (auto& pr : band.precincts)
            for (auto& cb : pr.cblks) {
              if (!cb.numsegs) continue;
              const int w = static_cast<int>(cb.x1 - cb.x0),
                        h = static_cast<int>(cb.y1 - cb.y0);
              T1 t1(w, h, band.bandno, tc.cblksty);
              t1.decode(cb, tc.roishift, tc.cblksty);
              int64_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
              if (band.bandno & 1) x += tcm.res[r - 1].x1 - tcm.res[r - 1].x0;
              if (band.bandno & 2) y += tcm.res[r - 1].y1 - tcm.res[r - 1].y0;
              const std::vector<int32_t>& dv = t1.data();
              if (tc.qmfbid == 1) {
                for (int j = 0; j < h; ++j)
                  for (int i = 0; i < w; ++i)
                    tcm.idata[(y + j) * stride + x + i] = dv[j * w + i] / 2;
              } else {
                const float step = 0.5f * band.stepsize;
                for (int j = 0; j < h; ++j)
                  for (int i = 0; i < w; ++i)
                    tcm.fdata[(y + j) * stride + x + i] =
                        static_cast<float>(dv[j * w + i]) * step;
              }
            }
        }
      }
      if (tc.qmfbid == 1) {
        idwt_2d(tcm, tcm.idata, idwt53_1d, top[c] + 1);
      } else {
        idwt_2d(tcm, tcm.fdata, idwt97_1d, top[c] + 1);
      }
    }
    if (tcp.mct && siz_.ncomp >= 3) {
      for (int c = 1; c < 3; ++c)
        if (comps[c].x1 - comps[c].x0 != comps[0].x1 - comps[0].x0 ||
            comps[c].y1 - comps[c].y0 != comps[0].y1 - comps[0].y0)
          fail("the MCT over components of different sizes");
      const int64_t n =
          (comps[0].x1 - comps[0].x0) * (comps[0].y1 - comps[0].y0);
      if (tcp.tccps[0].qmfbid == 1) {
        for (int c = 1; c < 3; ++c)
          if (comps[c].idata.size() != size_t(n))
            fail("the RCT over an irreversible component");
        int32_t *c0 = comps[0].idata.data(), *c1 = comps[1].idata.data(),
                *c2 = comps[2].idata.data();
        for (int64_t i = 0; i < n; ++i) {
          const int32_t y = c0[i], u = c1[i], v = c2[i];
          const int32_t g = y - ((u + v) >> 2);
          c0[i] = v + g;
          c1[i] = g;
          c2[i] = u + g;
        }
      } else {
        for (int c = 1; c < 3; ++c)
          if (comps[c].fdata.size() != size_t(n))
            fail("the ICT over a reversible component");
        float *c0 = comps[0].fdata.data(), *c1 = comps[1].fdata.data(),
              *c2 = comps[2].fdata.data();
        for (int64_t i = 0; i < n; ++i) {
          const float y = c0[i], u = c1[i], v = c2[i];
          c0[i] = y + (v * 1.402f);
          c1[i] = y - (u * 0.34413f) - (v * 0.71414f);
          c2[i] = y + (u * 1.772f);
        }
      }
    }
    const int64_t W = siz_.x1, H = siz_.y1;
    for (int c = 0; c < siz_.ncomp; ++c) {
      TileComp& tcm = comps[c];
      const int prec = siz_.prec[c];
      const int64_t lo = siz_.sgnd[c] ? -(int64_t(1) << (prec - 1)) : 0;
      const int64_t hi = siz_.sgnd[c] ? (int64_t(1) << (prec - 1)) - 1
                                      : (int64_t(1) << prec) - 1;
      const int32_t shift = tcp.tccps[c].dc_shift;
      const int64_t stride = tcm.x1 - tcm.x0;
      const Res& re = tcm.res[top[c]];
      int32_t* plane = out + c * W * H;
      for (int64_t y = re.y0; y < std::min(re.y1, H); ++y)
        for (int64_t x = re.x0; x < std::min(re.x1, W); ++x) {
          const int64_t i = (y - re.y0) * stride + (x - re.x0);
          int64_t v;
          if (tcp.tccps[c].qmfbid == 1) {         // OpenJPEG adds in int32
            v = static_cast<int32_t>(static_cast<uint32_t>(tcm.idata[i]) +
                                     static_cast<uint32_t>(shift));
          } else {
            const float f = tcm.fdata[i];
            if (f > static_cast<float>(INT32_MAX)) v = hi;
            else if (f < static_cast<float>(INT32_MIN)) v = lo;
            else v = static_cast<int64_t>(std::lrintf(f)) + shift;
          }
          plane[y * W + x] =
              static_cast<int32_t>(std::min(hi, std::max(lo, v)));
        }
    }
  }

  Stream s_;
  Siz siz_;
  Tcp def_;
  std::vector<Tcp> tiles_;
  std::vector<int> tile_part_order_;
  Packed ppm_parts_;
};

}  // namespace

extern "C" {

int j2k_decode(const uint8_t* src, int64_t n,
               int32_t* (*alloc)(int, int, int), int32_t* prec, char* msg,
               int msg_len) {
  try {
    Decoder dec(src, static_cast<size_t>(n));
    dec.header();
    *prec = dec.refuse_as_cv2();
    const Siz& s = dec.siz();
    int32_t* out = alloc(s.ncomp, static_cast<int>(s.y1),
                         static_cast<int>(s.x1));
    if (!out) throw std::bad_alloc();
    dec.decode(out);
    return 0;
  } catch (const Error& e) {
    set_msg(msg, msg_len, e.msg);
  } catch (const std::bad_alloc&) {
    set_msg(msg, msg_len, "out of memory");
  }
  return 3;
}

}  // extern "C"
