// Greedy weighted-merge NMS over score-sorted candidates.
//
// Replaces: objectdetectionpl_tpu/ops/pallas/nms_kernel.py:120
//   pallas_greedy_nms (kernel math _nms_body :40), and the XLA formulation
//   of the same function, blocked_greedy_nms (objectdetectionpl_tpu/ops/nms.py:105).
//
// What it computes, per image b (inputs sorted by descending score):
//   valid[i]   = scores[i] > -1e9
//   over[i][j] = j > i && valid[i] && valid[j] && IoU+1(i, j) > thresh
//                && (!class_aware || labels[i] == labels[j])
//   keep       = the greedy scan: i is kept iff valid and no kept i' < i
//                has over[i'][j=i]
//   merge      : each kept i becomes sum(w*box)/max(sum(w), 1e-16) over
//                itself and the boxes whose first kept suppressor is i,
//                w = obj for valid rows, 0 otherwise.
//   Rows that are not kept return their input box unchanged.
//   drop_lone  : un-keep the image's last kept row k when no valid j > k
//                has k as its first kept suppressor, i.e. when k's merge
//                group is empty (the JAX twin's drop_lone_survivor,
//                objectdetectionpl_tpu/ops/nms.py:184-197).
//
// K <= 1024: greedy_nms_kernel, one CTA per image.  K > 1024: the image's
// valid rows split by label into segments (greedy_nms_partition_kernel),
// and persistent CTAs run each segment's chain (greedy_nms_segment_kernel);
// see "K > kMaxK" below.  Both run the same device functions:
// build_relation (its pair test over_pair, or over_pair_fast on the split
// route), scan_words and group_sum.
//
// What bounds it on an H100: not bytes nor FLOPs.  At B=256, K=300 the
// function moves ~3.5 MB (~1 us at 3.35 TB/s) and does ~45k IoUs per image
// (~0.2 GFLOP f32 in all, a few us at 67 TFLOP/s).  What remains is
// latency: one CTA per image, so B=1 and B=256 (one wave) take about the
// same time, and within it the greedy chain -- head h+1 depends on every
// suppression by heads <= h -- is serial in the number of kept boxes.
//
// What the design does about it.  The first design (one thread per (row,
// 64-column word) with a data-dependent inner loop; a one-warp scan that
// shuffled the alive word and reloaded each head's row) took 0.134 ms at
// B=1, K=300, of which the relation build was 90 us and the scan 42 us
// (clock64() stamps, H100 80GB HBM3, 700 W: PERF.md).
// - Relation build, one warp per 32-row x 64-column block that holds some
//   j > i (blocks wholly on or below the diagonal are never read and get
//   no task; the others are dealt out evenly, two per warp at K=300).  Lane = row i with its box, area and label in registers; the
//   64 columns (K padded to whole words) are read as warp-uniform
//   broadcasts, so no bank conflicts, with loads that do not depend on a
//   branch, over a trip count that is the same for every lane.  The test
//   IoU > thresh takes no division: RN(inter / denom) > t exactly when
//   inter / denom lies above the midpoint m of t and the next float (or
//   on it, where that tie rounds up), and inter > m * denom is exact in
//   double for denom > 0 (m has 25 significant bits, denom 24); the IEEE
//   division remains for a non-positive or non-finite denominator.
//   Validity and j > i are masks applied once per word.
// - Scan, blocked by 64-bit word.  The word's 64 diagonal rows are copied
//   to a dense array; lane 0 resolves the word's kept heads in order, 8
//   columns at a time: the rows of the batch's alive columns are loaded
//   together and taken in order with register operations (cand &= ~row),
//   so the chain holds one shared-memory load per 8 columns, not one per
//   head, and no cross-lane step.  Then lane l > w walks word w's kept
//   heads in order, g = over[h][l] & alive_l; over[h][l] = g; alive_l &=
//   ~over[h][l], again 8 rows loaded together.  Each head's row is
//   overwritten by the boxes it removes now, which is its merge group, as
//   in the first design.
// - Merge, one thread per kept row over its group (j ascending, then the
//   row itself), reading only the words at and after its own.
// - drop_lone: the thread of a kept row with no kept bit above it reads the
//   same group words; all zero drops the row before the merge.  It is a
//   template argument: the instance without it pays nothing for the flag.
// 512 threads per CTA, at most 64 registers each: two CTAs per SM, so
// B=256 still runs in one wave.
//
// IoU is evaluated in the JAX code's order,
//   inter / (area_i + area_j - inter + 1e-16),
// with __f*_rn intrinsics so that no FMA contraction can move a value that
// sits at the hard threshold.

#include <climits>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kMaxK = 1024;       // nw <= 16 words: one warp holds the alive set
constexpr float kNegInf = -1e9f;  // score <= kNegInf marks an invalid row
constexpr int kBatch = 8;         // scan: rows loaded ahead of their use

__device__ __forceinline__ float box_area(float4 b, float plus1) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), plus1),
                   __fadd_rn(__fsub_rn(b.w, b.y), plus1));
}

__device__ __forceinline__ u64 word_of(const unsigned* bits, int word) {
  return (static_cast<u64>(bits[2 * word + 1]) << 32) | bits[2 * word];
}

__device__ __forceinline__ bool bit_of(const unsigned* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

// The threshold test for one pair, i the earlier row.
// IoU > thresh without the division: for b > 0 and a finite,
// RN(a / b) > t  <=>  a / b > mid, or a / b == mid when a tie rounds up,
// mid = (t + next float above t) / 2; a and mid * b are exact in double.
struct Thresh {
  float t;
  bool by_mid, tie_up;
  double mid;
  float mid_f;    // mid rounded to float: over_pair_fast's pre-test
};

__device__ __forceinline__ Thresh make_thresh(float thresh) {
  const float t_next = nextafterf(thresh, __int_as_float(0x7f800000));
  Thresh th;
  th.t = thresh;
  th.by_mid = isfinite(thresh) && isfinite(t_next);
  th.mid = 0.5 * ((double)thresh + (double)t_next);
  th.tie_up = __float_as_uint(thresh) & 1u;   // t_next is even
  th.mid_f = static_cast<float>(th.mid);
  return th;
}

__device__ __forceinline__ bool over_pair(float4 bi, float ai, float4 bj,
                                          float aj, float plus1,
                                          const Thresh& th) {
  const float iw = fmaxf(
      __fadd_rn(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), plus1),
      0.0f);
  const float ih = fmaxf(
      __fadd_rn(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), plus1),
      0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(ai, aj), inter), 1e-16f);
  if (th.by_mid && denom > 0.0f && isfinite(denom) && isfinite(inter)) {
    const double a = inter, ab = th.mid * (double)denom;
    return a > ab || (th.tie_up && a == ab);
  }
  return __fdiv_rn(inter, denom) > th.t;
}

// over_pair, with the division-free test's sign, inter - mid * denom,
// first taken in float: one FMA, inter - mid_f * denom, lies within
// 2^-23 * |mid| * denom of the exact value (mid_f is mid to 24 bits, the
// FMA rounds once), so outside a band of 2^-20 * |mid_f| * denom its sign
// is the exact one.  Pairs inside the band -- an IoU within a few ulps of
// the threshold -- take the double test.  The split route runs it; the
// single-tile kernel keeps over_pair: at its 64 registers the pre-test
// spilled there (116 bytes of spill stores and loads, unrolled by 8 or 4,
// or with the double test out of line), and taken only for rows of one
// label it cost 10 % at K=300, B=1 (H100, PERF.md).
__device__ __forceinline__ bool over_pair_fast(float4 bi, float ai, float4 bj,
                                               float aj, float plus1,
                                               const Thresh& th) {
  const float iw = fmaxf(
      __fadd_rn(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), plus1),
      0.0f);
  const float ih = fmaxf(
      __fadd_rn(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), plus1),
      0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(ai, aj), inter), 1e-16f);
  if (th.by_mid && denom > 0.0f && isfinite(denom) && isfinite(inter)) {
    const float r = __fmaf_rn(-th.mid_f, denom, inter);
    const float band = __fmul_rn(fabsf(th.mid_f), denom) * 0x1p-20f;
    if (r > band) return true;
    if (r < -band) return false;
    const double a = inter, ab = th.mid * (double)denom;
    return a > ab || (th.tie_up && a == ab);
  }
  return __fdiv_rn(inter, denom) > th.t;
}

// Suppression relation of n staged rows (box, area, lab padded with zero
// rows to nw whole words): over[i][wd] = the columns j > i of word wd that
// row i suppresses, both rows set in row_bits (the valid, or live, rows).
// Warp task (row block rb, word wd) builds over[rb*32 + lane][wd]; blocks
// with no column j > row i get none.
template <int kNT, bool kFast = false>
__device__ __forceinline__ void build_relation(
    const float4* box, const float* area, const int* lab,
    const unsigned* row_bits, u64* over, int n, int nw, bool label_test,
    const Thresh& th, float plus1) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Word wd has tasks for row blocks 0 .. min(nrb, 2 wd + 2) - 1; the
  // tasks are numbered densely, word by word, and dealt out to the warps.
  const int nrb = (n + 31) >> 5;
  int tasks = 0;
  for (int wd = 0; wd < nw; ++wd) tasks += min(nrb, 2 * wd + 2);
  for (int t = warp; t < tasks; t += kNT / 32) {
    int wd = 0, rb = t;
    while (rb >= min(nrb, 2 * wd + 2)) {
      rb -= min(nrb, 2 * wd + 2);
      ++wd;
    }
    const int j0 = wd * 64;
    const int i = rb * 32 + lane;             // < kp: a padded row if >= n
    const float4 bi = box[i];
    const float ai = area[i];
    const int li = lab[i];
    u64 bits = 0ull;
#pragma unroll 8
    for (int c = 0; c < 64; ++c) {
      const float4 bj = box[j0 + c];          // warp-uniform: a broadcast
      const float aj = area[j0 + c];
      const int lj = lab[j0 + c];
      const bool hit = kFast ? over_pair_fast(bi, ai, bj, aj, plus1, th)
                             : over_pair(bi, ai, bj, aj, plus1, th);
      if ((!label_test || lj == li) && hit) bits |= 1ull << c;
    }
    if (i < n) {
      const bool vi = bit_of(row_bits, i);
      const int s = i - j0;                    // columns c > s are j > i
      const u64 later = s < 0 ? ~0ull : (s >= 63 ? 0ull : ~0ull << (s + 1));
      over[(size_t)i * nw + wd] = vi ? bits & later & word_of(row_bits, wd)
                                     : 0ull;
    }
  }
}

// Greedy scan on one warp (the caller's warp 0), one 64-bit word at a
// time.  Lane l holds word l of the alive set (row_bits, not yet
// suppressed, not yet taken).  Leaves the kept rows in keep_bits and each
// kept row's relation row reduced to its merge group.
__device__ __forceinline__ void scan_words(u64* over, const unsigned* row_bits,
                                           unsigned* keep_bits, u64* diag,
                                           unsigned char* heads, int n,
                                           int nw) {
  const int lane = threadIdx.x & 31;
  u64 alive = lane < nw ? word_of(row_bits, lane) : 0ull;
  for (int wd = 0; wd < nw; ++wd) {
    // The word's own 64 rows (columns of word wd) in a dense array.
    const int r_lo = wd * 64 + lane;
    const int r_hi = r_lo + 32;
    diag[lane] = r_lo < n ? over[(size_t)r_lo * nw + wd] : 0ull;
    diag[lane + 32] = r_hi < n ? over[(size_t)r_hi * nw + wd] : 0ull;
    __syncwarp();
    // Its kept heads, in order, on lane 0, kBatch columns at a time: the
    // rows of the batch's alive columns are loaded together, then taken
    // in order with register operations alone.  Each head's row becomes
    // its group in the word.
    u64 cand = __shfl_sync(0xffffffffu, alive, wd);
    u64 kept = 0ull;
    if (lane == 0) {
      int k = 0;
      for (int p = 0; p < 64; p += kBatch) {
        if (!((cand >> p) & ((1ull << kBatch) - 1))) continue;
        u64 row[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          row[q] = (cand >> (p + q)) & 1ull ? diag[p + q] : 0ull;
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const u64 bit = 1ull << (p + q);
          if (cand & bit) {
            diag[p + q] = row[q] & cand;
            kept |= bit;
            heads[k++] = static_cast<unsigned char>(p + q);
            cand &= ~row[q] & ~bit;
          }
        }
      }
      keep_bits[2 * wd] = static_cast<unsigned>(kept);
      keep_bits[2 * wd + 1] = static_cast<unsigned>(kept >> 32);
    }
    __syncwarp();
    kept = __shfl_sync(0xffffffffu, kept, 0);
    if (r_lo < n) over[(size_t)r_lo * nw + wd] = diag[lane];
    if (r_hi < n) over[(size_t)r_hi * nw + wd] = diag[lane + 32];
    // Each later word l on lane l: the word's heads in order, g = row &
    // alive_l (the head's group there), alive_l &= ~row; kBatch rows
    // loaded together, the chain a register AND.
    const int nk = __popcll(kept);
    if (lane > wd && lane < nw) {
      for (int r0 = 0; r0 < nk; r0 += kBatch) {
        int at[kBatch];
        u64 row[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          at[q] = r0 + q < nk ? (wd * 64 + heads[r0 + q]) * nw + lane : 0;
          row[q] = r0 + q < nk ? over[at[q]] : 0ull;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (r0 + q < nk) {
            over[at[q]] = row[q] & alive;
            alive &= ~row[q];
          }
        }
      }
    }
    __syncwarp();                            // diag, heads reused
  }
}

// Kept row i's merge group (its relation row after scan_words, words at
// and after its own), summed in ascending j into (sum, den); returns the
// group's size.
__device__ __forceinline__ int group_sum(const u64* over, int nw, int i,
                                         const float4* box, const float* w,
                                         float4& sum, float& den) {
  int size = 0;
  for (int word = i >> 6; word < nw; ++word) {
    u64 g = over[(size_t)i * nw + word];
    size += __popcll(g);
    while (g) {
      const int j = word * 64 + __ffsll(static_cast<long long>(g)) - 1;
      g &= g - 1;
      const float wj = w[j];
      const float4 bj = box[j];
      sum.x += wj * bj.x;
      sum.y += wj * bj.y;
      sum.z += wj * bj.z;
      sum.w += wj * bj.w;
      den += wj;
    }
  }
  return size;
}

// The merged box of a head from its group's sums and its own row, added
// last.
__device__ __forceinline__ float4 merged(float4 sum, float den, float4 b,
                                         float wi) {
  sum.x += wi * b.x;
  sum.y += wi * b.y;
  sum.z += wi * b.z;
  sum.w += wi * b.w;
  den = fmaxf(den + wi, 1e-16f);
  return make_float4(sum.x / den, sum.y / den, sum.z / den, sum.w / den);
}

// Kept row i has no kept row after it among nbits rows of keep_bits.
__device__ __forceinline__ bool last_kept(const unsigned* keep_bits, int i,
                                          int nwords32) {
  bool last = (keep_bits[i >> 5] >> (i & 31)) >> 1 == 0u;
  for (int b = (i >> 5) + 1; b < nwords32; ++b) last &= keep_bits[b] == 0u;
  return last;
}

template <bool kDropLone>
__global__ void __launch_bounds__(kThreads, 2)
greedy_nms_kernel(const float4* __restrict__ boxes,
                  const float* __restrict__ scores,
                  const int* __restrict__ labels,
                  const float* __restrict__ obj,
                  float4* __restrict__ out_boxes,
                  bool* __restrict__ keep_out,
                  int K, float thresh, int class_aware, int merge,
                  float plus1) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = (K + 63) >> 6;
  const int kp = nw * 64;                               // K padded to words
  float4* box = reinterpret_cast<float4*>(smem);        // [kp]
  u64* over = reinterpret_cast<u64*>(box + kp);         // [K][nw]
  u64* diag = over + (size_t)K * nw;                    // [64]
  float* area = reinterpret_cast<float*>(diag + 64);    // [kp]
  int* lab = reinterpret_cast<int*>(area + kp);         // [kp]
  float* w = reinterpret_cast<float*>(lab + kp);        // [K]
  unsigned* valid_bits = reinterpret_cast<unsigned*>(w + K);  // [2 nw]
  unsigned* keep_bits = valid_bits + 2 * nw;                   // [2 nw]
  unsigned char* heads = reinterpret_cast<unsigned char*>(keep_bits + 2 * nw);

  const size_t base = (size_t)blockIdx.x * K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. Stage the image's candidates in shared memory; validity as bits.
  //    Columns K..kp-1 hold a zero box that no valid bit lets through.
  for (int i = tid; i < kp; i += kThreads) {
    bool v = false;
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int l = 0;
    if (i < K) {
      b = boxes[base + i];
      v = scores[base + i] > kNegInf;
      w[i] = v ? obj[base + i] : 0.0f;
      l = labels[base + i];
    }
    box[i] = b;
    area[i] = box_area(b, plus1);
    lab[i] = l;
    const unsigned vb = __ballot_sync(0xffffffffu, v);
    if (lane == 0) valid_bits[i >> 5] = vb;
  }
  __syncthreads();

  // 2. Suppression relation (build_relation).
  const Thresh th = make_thresh(thresh);
  build_relation<kThreads>(box, area, lab, valid_bits, over, K, nw,
                           class_aware, th, plus1);
  __syncthreads();

  // 3. Greedy scan on warp 0 (scan_words).
  if (warp == 0) scan_words(over, valid_bits, keep_bits, diag, heads, K, nw);
  __syncthreads();

  // 4. Outputs: kept boxes merged with their group, every other row as given.
  for (int i = tid; i < K; i += kThreads) {
    float4 out = box[i];
    bool kept = bit_of(keep_bits, i);
    if (kDropLone && kept && last_kept(keep_bits, i, 2 * nw)) {
      // the last kept row with an empty group
      bool lone = true;
      for (int word = i >> 6; lone && word < nw; ++word)
        lone = over[(size_t)i * nw + word] == 0ull;
      kept = !lone;
    }
    if (kept && merge) {
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float den = 0.0f;
      group_sum(over, nw, i, box, w, sum, den);
      out = merged(sum, den, out, w[i]);
    }
    out_boxes[base + i] = out;
    keep_out[base + i] = kept;
  }
}

size_t smem_bytes(int K) {
  const size_t nw = (K + 63) / 64, kp = nw * 64;
  return kp * sizeof(float4) + (size_t)K * nw * sizeof(u64) +
         64 * sizeof(u64) + 2 * kp * sizeof(float) + K * sizeof(float) +
         4 * nw * sizeof(unsigned) + 64;
}

// ---------------------------------------------------------------------------
// K > kMaxK: the same function, split by label.
//
// greedy_nms_kernel holds the whole [K][nw] relation in shared memory, which
// caps K at 1024 (128 KB of relation).  A YOLO decode gives far more rows
// (25,200 for YOLOv5s at 640 px, 80 labels), and the Pallas kernel takes
// any K.  Class-aware NMS splits exactly by label: over[i][j] needs
// labels[i] == labels[j], so a row's first kept suppressor has its label
// and every merge group lies inside one label.  The function is the same
// function over independent (image, label) segments:
//   greedy_nms_partition_kernel, one CTA per image: the valid rows (score >
//     -1e9), the image's label range (block min/max), a stable counting
//     sort of the valid rows by label in shared memory (per-warp
//     histograms over contiguous row ranges, __match_any_sync for the rank
//     inside 32 rows), so that each segment lists its rows in ascending
//     row order, which keeps every merge group's summation order; each
//     segment's offset and size in a table, and its id appended to a work
//     list binned by floor(log2(size)); every invalid row written out as
//     given with keep false.  class_aware 0, or a label range above
//     kLabelBins (1024; the repo's models have at most 80 labels), makes
//     the image one segment of all its valid rows in row order, with the
//     label test kept in its chain (the image is counted in the
//     workspace's header).
//   greedy_nms_segment_kernel, persistent CTAs (as many as fit on the
//     card, one an SM) that take segments from the work list with an
//     atomic ticket, the largest size bin first.  A segment of n <= kSeg
//     (1024) rows is gathered into shared memory and runs the single-tile
//     chain (build_relation, scan_words, group_sum) and writes out_boxes
//     and keep at the rows' own places.  A longer segment walks its rows
//     in tiles of kSeg:
//       (a) each row of the tile is tested against the segment's heads of
//           earlier tiles; its first kept suppressor is the least ordinal
//           among those that suppress it.  For thresh >= 0 a suppressing
//           head intersects the row, so a uniform grid over the heads (at
//           most 32 x 32 cells, none smaller than the mean head; rebuilt
//           each tile in the workspace: each head listed in the cells it
//           touches, a head over more than 9 cells in a list of its own)
//           gives each row the heads it can meet, each list filled 256
//           heads a round so that a row stops at the round after its best
//           hit; thresh < 0, or a row over more than 16 cells, tests every
//           head in order and stops at its first hit.  The tile's suppressed rows, sorted by (head, row) in
//           shared memory, then add themselves to their heads' running
//           merge sums (in the workspace) in ascending row order: no
//           search for a head's first row.
//       (b) the tile's live rows, moved to the front, run the single-tile
//           chain, which leaves each head's in-tile group in its relation
//           row;
//       (c) the tile's heads take ordinals after the earlier ones and
//           start their sums with their in-tile groups.
//     So every group is summed in ascending j, then the head's own row, as
//     greedy_nms_kernel sums it.
//   drop_lone is the image's rule, not a segment's: each segment records
//     its last kept row and whether its group is empty (an atomicMax on
//     ((row + 1) << 1 | lone) for the image), and the image's last segment
//     to finish (an atomic count against the image's segment count) un-keeps
//     that row if it is lone and writes its input box back over the merge.
// What bounds it: neither bytes nor FLOPs (chip_smoke.py's nms_bound_ms
// counts the same-label pairs).  The chains are serial in their kept heads,
// but they now run side by side, one a CTA, and a row is tested only
// against heads of its own label.  At the serving decode (80 labels, ~315
// rows a segment) every segment takes the single-tile chain; one label of
// many thousand rows still takes the tiled chain on one SM.

constexpr int kSeg = 1024;                   // rows a tile: nw <= 16 words
constexpr int kSegWords = kSeg / 64;
constexpr int kSegThreads = 1024;
constexpr int kGrid = 32;                    // (a): kGrid x kGrid cells
constexpr int kCells = kGrid * kGrid;
constexpr int kHeadCells = 9;                // a head in more: the big list
constexpr int kRowCells = 16;                // a row over more: every head
constexpr int kRound = 256;                  // heads listed a round, in order
constexpr int kNone = -1;                    // no kept suppressor
constexpr int kPartThreads = 1024;
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kLabelBins = 1024;             // the label range one sort holds
constexpr int kBins = 32;                    // work list: floor(log2(size))

// The workspace's header, int32 words (greedy_nms_workspace_bytes).
enum Header {
  kTicket = kBins,        // the segment kernel's next work item
  kOneSegment,            // images whose label range exceeded kLabelBins
  kSegments,              // segments in the work list
  kHeaderInts = 64
};

static_assert(kSegThreads == kSeg, "the tiled chain takes a row a thread");

// A uniform grid: its extent (x0, y0, x1, y1) and cell sizes (grid_over).
struct Grid {
  float4 ext;
  float cw, ch;
};

struct SegSmem {
  float4 box[kSeg];
  float area[kSeg];
  int lab[kSeg];
  float w[kSeg];
  int row[kSeg];             // each staged row's place in the image
  int first[kSeg];           // tiled chain: ordinal of its first suppressor
  union {
    u64 over[kSeg * kSegWords];              // the tile's relation
    struct {
      long long key[kSeg];                   // (a): (first, row) sorted
      int off[kCells + 1];                   // (a): each cell's heads
      int cursor[kCells];
      float4 extent;                         // the heads' x0, y0, x1, y1
      int nbig;
    } a;
  } u;
  u64 diag[64];
  unsigned valid_bits[kSeg / 32];
  unsigned live_bits[kSeg / 32];
  unsigned keep_bits[kSeg / 32];
  unsigned char heads[64];
  int item;
  float red[33];
  int sums[33];
};

// Work-list bin c (segments of 2^c .. 2^(c+1) - 1 rows) holds at most
// B*K >> c items and at most all B*S segments.
__host__ __device__ inline long long bin_cap(int c, long long bk,
                                             long long bs) {
  const long long by_rows = bk >> c;
  return by_rows < bs ? by_rows : bs;
}

__host__ __device__ inline long long bin_offset(int c, long long bk,
                                                long long bs) {
  long long at = 0;
  for (int q = 0; q < c; ++q) at += bin_cap(q, bk, bs);
  return at;
}

struct Work {
  int* hdr;          // [kHeaderInts]
  int* done;         // [B] segments finished (drop_lone)
  int* drop;         // [B] max over segments of ((last kept + 1) << 1 | lone)
  int* nseg;         // [B]
  int* mixed;        // [B] one segment of several labels: test labels
  int2* seg;         // [B][S] (offset, size) into the image's perm rows
  int* work;         // the binned work list of b * S + s
  int* perm;         // [B][K] valid rows, by segment
  float4* head_sum;  // [B][K] tiled chain, by segment offset + head ordinal
  float* head_den;
  int* head_row;
  int* head_size;
  float4* head_box;  // [B][K] the heads' boxes, by ordinal
  int* big;          // [B][K] heads over more than kHeadCells cells
  int* cell;         // [B][K][kHeadCells] each cell's heads, by segment
};

#ifdef NMS_PROBE
// tools/kernel_ab.py --phases builds this file with -DNMS_PROBE: the
// partition's span per image and the segment kernel's per CTA (globaltimer
// ns), and each CTA's clock64() cycles in its phases.
constexpr int kProbeMax = 4096;
__device__ unsigned long long g_part_ns[2 * kProbeMax];
__device__ unsigned long long g_seg_ns[2 * kProbeMax];
__device__ long long g_seg_clk[8 * kProbeMax];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// phase p of this CTA's work: the cycles since its last mark (thread 0,
// after a barrier)
#define PROBE(...) __VA_ARGS__
#define SEG_MARK(p)                                                    \
  do {                                                                 \
    if (threadIdx.x == 0 && blockIdx.x < kProbeMax) {                  \
      const long long c_ = clock64();                                  \
      g_seg_clk[blockIdx.x * 8 + (p)] += c_ - probe_clk;               \
      probe_clk = c_;                                                  \
    }                                                                  \
  } while (0)
#else
#define PROBE(...)
#define SEG_MARK(p) do {} while (0)
#endif
enum ProbePhase { kPWait, kPStage, kPCross, kPChain, kPMerge, kPDrop,
                  kPItems };

// An exclusive scan of a[0..n), n <= 1024, by a CTA of 1024 threads, in
// place; returns the total.  sums: 33 ints of shared memory.
__device__ int block_exclusive_scan(int* a, int n, int* sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v = tid < n ? a[tid] : 0;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int s = sums[lane];
    int y = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y += z;
    }
    sums[lane] = y - s;
    if (lane == 31) sums[32] = y;
  }
  __syncthreads();
  if (tid < n) a[tid] = x - v + sums[warp];
  const int total = sums[32];
  __syncthreads();
  return total;
}

__device__ __forceinline__ int block_reduce(int v, int* red, int op) {
  // op 0: min, 1: max, 2: sum
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const int y = __shfl_xor_sync(0xffffffffu, v, o);
    v = op == 0 ? min(v, y) : op == 1 ? max(v, y) : v + y;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const int y = __shfl_xor_sync(0xffffffffu, v, o);
      v = op == 0 ? min(v, y) : op == 1 ? max(v, y) : v + y;
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kPartThreads, 1)
greedy_nms_partition_kernel(const float4* __restrict__ boxes,
                            const float* __restrict__ scores,
                            const int* __restrict__ labels,
                            float4* __restrict__ out_boxes,
                            bool* __restrict__ keep_out, int K, int S,
                            int class_aware, Work ws) {
  extern __shared__ __align__(16) int psm[];
  int* hist = psm;                           // [kPartWarps][L]
  int* cnt = hist + kPartWarps * kLabelBins; // [kLabelBins] rows a label
  int* off = cnt + kLabelBins;               // [kLabelBins] its first place
  int* sidx = off + kLabelBins;              // [kLabelBins] its segment
  int* red = sidx + kLabelBins;              // [33]
  const int b = blockIdx.x;
  const size_t base = (size_t)b * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PROBE(if (tid == 0 && b < kProbeMax) g_part_ns[2 * b] = global_ns();)

  // The label range of the valid rows; the invalid rows written out.
  int lmin = INT_MAX, lmax = INT_MIN, nvalid = 0;
  for (int i = tid; i < K; i += kPartThreads) {
    if (scores[base + i] > kNegInf) {
      const int l = labels[base + i];
      lmin = min(lmin, l);
      lmax = max(lmax, l);
      ++nvalid;
    } else {
      out_boxes[base + i] = boxes[base + i];
      keep_out[base + i] = false;
    }
  }
  lmin = block_reduce(lmin, red, 0);
  lmax = block_reduce(lmax, red, 1);
  nvalid = block_reduce(nvalid, red, 2);
  const bool overflow = class_aware && nvalid &&
                        (long long)lmax - lmin + 1 > kLabelBins;
  const bool one = !class_aware || overflow;
  const int L = nvalid == 0 ? 0 : (one ? 1 : lmax - lmin + 1);
  for (int x = tid; x < kPartWarps * L; x += kPartThreads) hist[x] = 0;
  __syncthreads();

  // Warp w sorts rows [r0, r1); within them 32 rows a step, in order.
  const int R = (K + kPartThreads - 1) / kPartThreads * 32;
  const int r0 = min(K, warp * R), r1 = min(K, r0 + R);
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = r0; i0 < r1; i0 += 32) {
    const int i = i0 + lane;
    const bool v = i < r1 && scores[base + i] > kNegInf;
    const int key = v ? (one ? 0 : labels[base + i] - lmin) : -1;
    const unsigned m = __match_any_sync(0xffffffffu, key);
    if (v && (m & below) == 0u) hist[warp * L + key] += __popc(m);
    __syncwarp();
  }
  __syncthreads();
  // per label: the warps' exclusive offsets and its row count
  for (int k = tid; k < L; k += kPartThreads) {
    int run = 0;
    for (int q = 0; q < kPartWarps; ++q) {
      const int c = hist[q * L + k];
      hist[q * L + k] = run;
      run += c;
    }
    cnt[k] = run;
    off[k] = run;
    sidx[k] = run > 0;
  }
  __syncthreads();
  block_exclusive_scan(off, L, red);
  const int nseg = block_exclusive_scan(sidx, L, red);
  for (int i0 = r0; i0 < r1; i0 += 32) {
    const int i = i0 + lane;
    const bool v = i < r1 && scores[base + i] > kNegInf;
    const int key = v ? (one ? 0 : labels[base + i] - lmin) : -1;
    const unsigned m = __match_any_sync(0xffffffffu, key);
    if (v)
      ws.perm[base + off[key] + hist[warp * L + key] + __popc(m & below)] = i;
    __syncwarp();
    if (v && (m & below) == 0u) hist[warp * L + key] += __popc(m);
    __syncwarp();
  }
  // The segments, in label order, into the table and the work list.
  const long long bk = (long long)gridDim.x * K, bs = (long long)gridDim.x * S;
  for (int k = tid; k < L; k += kPartThreads) {
    const int n = cnt[k];
    if (!n) continue;
    const int s = sidx[k];
    ws.seg[(size_t)b * S + s] = make_int2(off[k], n);
    const int c = 31 - __clz(n);
    const int at = atomicAdd(&ws.hdr[c], 1);
    ws.work[bin_offset(c, bk, bs) + at] = b * S + s;
  }
  if (tid == 0) {
    ws.nseg[b] = nseg;
    ws.mixed[b] = class_aware && overflow;
    if (overflow) atomicAdd(&ws.hdr[kOneSegment], 1);
    atomicAdd(&ws.hdr[kSegments], nseg);
  }
  PROBE(__syncthreads();
        if (tid == 0 && b < kProbeMax) g_part_ns[2 * b + 1] = global_ns();)
}

// A CTA-wide min, max or (sum) sum of v; red: 33 floats of shared memory.
__device__ __forceinline__ float block_reduce_f(float v, float* red, bool mx,
                                                bool sum = false) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto op = [&](float a, float b) {
    return sum ? a + b : mx ? fmaxf(a, b) : fminf(a, b);
  };
#pragma unroll
  for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];
#pragma unroll
    for (int o = 16; o; o >>= 1)
      v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();
  return v;
}

// The cells a box touches, [cx0, cx1] x [cy0, cy1]: its extent [x1, x2 +
// plus1) x [y1, y2 + plus1), where IoU+1's intersection lives, padded by
// a thousandth of a cell and 4e-6 of the coordinate (far more than the
// float rounding of the intersection or of the cell index), clamped to the
// grid.  Two boxes whose intersection is positive share a cell.  Returns
// false for a box with a non-finite coordinate.
__device__ __forceinline__ bool cells_of(float4 b, float plus1, float4 ext,
                                         float cw, float ch, int* c) {
  if (!(isfinite(b.x) && isfinite(b.y) && isfinite(b.z) && isfinite(b.w)))
    return false;
  const float px = 1e-3f * cw, py = 1e-3f * ch;
  const float lo_x = b.x - px - 4e-6f * fabsf(b.x);
  const float hi_x = b.z + plus1 + px + 4e-6f * fabsf(b.z + plus1);
  const float lo_y = b.y - py - 4e-6f * fabsf(b.y);
  const float hi_y = b.w + plus1 + py + 4e-6f * fabsf(b.w + plus1);
  auto at = [](float v, float v0, float step) {
    const float q = floorf((v - v0) / step);
    return q < 0.0f ? 0 : (q >= kGrid ? kGrid - 1 : static_cast<int>(q));
  };
  c[0] = at(lo_x, ext.x, cw);
  c[1] = at(hi_x, ext.x, cw);
  c[2] = at(lo_y, ext.y, ch);
  c[3] = at(hi_y, ext.y, ch);
  return true;
}

// A grid over n boxes (the finite ones): their extent [x1, x2 + plus1) x
// [y1, y2 + plus1), cells no smaller than the mean box (so most boxes
// touch 4), at most kGrid a side.  Every thread of the CTA calls it.
__device__ Grid grid_over(const float4* boxes, int n, float plus1,
                          float* red) {
  const float inf = __int_as_float(0x7f800000);
  float x0 = inf, y0 = inf, x1 = -inf, y1 = -inf, sw = 0.0f, sh = 0.0f,
        nf = 0.0f;
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const float4 b = boxes[o];
    if (!(isfinite(b.x) && isfinite(b.y) && isfinite(b.z) && isfinite(b.w)))
      continue;
    x0 = fminf(x0, b.x);
    y0 = fminf(y0, b.y);
    x1 = fmaxf(x1, b.z + plus1);
    y1 = fmaxf(y1, b.w + plus1);
    sw += fabsf(b.z - b.x) + plus1;
    sh += fabsf(b.w - b.y) + plus1;
    nf += 1.0f;
  }
  Grid g;
  g.ext.x = block_reduce_f(x0, red, false);
  g.ext.y = block_reduce_f(y0, red, false);
  g.ext.z = block_reduce_f(x1, red, true);
  g.ext.w = block_reduce_f(y1, red, true);
  nf = fmaxf(block_reduce_f(nf, red, true, true), 1.0f);
  sw = block_reduce_f(sw, red, true, true) / nf;
  sh = block_reduce_f(sh, red, true, true) / nf;
  g.cw = fmaxf(fmaxf((g.ext.z - g.ext.x) / kGrid, sw), 1e-6f);
  g.ch = fmaxf(fmaxf((g.ext.w - g.ext.y) / kGrid, sh), 1e-6f);
  if (!(isfinite(g.cw) && isfinite(g.ch))) {     // no finite box
    g.ext = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    g.cw = g.ch = 1.0f;
  }
  return g;
}

__device__ __forceinline__ int cell_count(const int* c) {
  return (c[1] - c[0] + 1) * (c[3] - c[2] + 1);
}

// Row i's value of one staged array moved to place at <= i, every thread
// at once (one field at a time: few registers held across the barrier).
template <typename T>
__device__ __forceinline__ void move_left(T* f, int i, bool live, int at) {
  const T v = f[i];
  __syncthreads();
  if (live) f[at] = v;
}

// Stage rows t0 .. t0 + kt - 1 of a segment (padded to whole words with
// zero rows), every one valid.
__device__ __forceinline__ void stage_rows(SegSmem& s, const Work& ws,
                                           const float4* boxes,
                                           const int* labels,
                                           const float* obj, size_t base,
                                           size_t pbase, int kt, int kp,
                                           float plus1) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kp; i += kSegThreads) {
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int l = 0, r = 0;
    float wv = 0.0f;
    if (i < kt) {
      r = ws.perm[pbase + i];
      b = boxes[base + r];
      l = labels[base + r];
      wv = obj[base + r];
    }
    s.box[i] = b;
    s.area[i] = box_area(b, plus1);
    s.lab[i] = l;
    s.w[i] = wv;
    s.row[i] = r;
    s.first[i] = kNone;
    const unsigned vb = __ballot_sync(0xffffffffu, i < kt);
    if (lane == 0) s.valid_bits[i >> 5] = vb;
  }
}

template <bool kDropLone>
__global__ void __launch_bounds__(kSegThreads, 1)
greedy_nms_segment_kernel(const float4* __restrict__ boxes,
                          const int* __restrict__ labels,
                          const float* __restrict__ obj,
                          float4* __restrict__ out_boxes,
                          bool* __restrict__ keep_out, int B, int K, int S,
                          float thresh, int merge, float plus1, Work ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  SegSmem& s = *reinterpret_cast<SegSmem*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const Thresh th = make_thresh(thresh);
  const long long bk = (long long)B * K, bs = (long long)B * S;
  PROBE(long long probe_clk = clock64();
        if (tid == 0 && blockIdx.x < kProbeMax)
            g_seg_ns[2 * blockIdx.x] = global_ns();)

  for (;;) {
    // The next work item, the largest size bin first.
    if (tid == 0) {
      int t = atomicAdd(&ws.hdr[kTicket], 1), item = -1;
      for (int c = kBins - 1; c >= 0; --c) {
        const int n = ws.hdr[c];
        if (t < n) {
          item = ws.work[bin_offset(c, bk, bs) + t];
          break;
        }
        t -= n;
      }
      s.item = item;
    }
    __syncthreads();
    const int item = s.item;
    if (item < 0) break;
    SEG_MARK(kPWait);
    const int b = item / S;
    const int2 sg = ws.seg[item];
    const int n = sg.y;
    const size_t base = (size_t)b * K;
    const size_t pbase = base + sg.x;          // the segment's perm rows
    const bool label_test = ws.mixed[b];

    if (n <= kSeg) {
      // The single-tile chain over the segment's rows.
      const int nw = (n + 63) >> 6;
      stage_rows(s, ws, boxes, labels, obj, base, pbase, n, nw * 64, plus1);
      __syncthreads();
      SEG_MARK(kPStage);
      build_relation<kSegThreads, true>(s.box, s.area, s.lab, s.valid_bits,
                                        s.u.over, n, nw, label_test, th,
                                        plus1);
      __syncthreads();
      if (warp == 0)
        scan_words(s.u.over, s.valid_bits, s.keep_bits, s.diag, s.heads, n,
                   nw);
      __syncthreads();
      SEG_MARK(kPChain);
      for (int i = tid; i < n; i += kSegThreads) {
        float4 out = s.box[i];
        const bool kept = bit_of(s.keep_bits, i);
        if (kept && merge) {
          float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          float den = 0.0f;
          group_sum(s.u.over, nw, i, s.box, s.w, sum, den);
          out = merged(sum, den, out, s.w[i]);
        }
        out_boxes[base + s.row[i]] = out;
        keep_out[base + s.row[i]] = kept;
        if (kDropLone && kept && last_kept(s.keep_bits, i, 2 * nw)) {
          bool empty = true;
          for (int word = i >> 6; empty && word < nw; ++word)
            empty = s.u.over[(size_t)i * nw + word] == 0ull;
          atomicMax(&ws.drop[b], ((s.row[i] + 1) << 1) | int(empty));
        }
      }
    } else {
      // The tiled chain; heads' sums at the segment's perm offset.
      float4* hsum = ws.head_sum + pbase;
      float* hden = ws.head_den + pbase;
      int* hrow = ws.head_row + pbase;
      int* hsize = ws.head_size + pbase;
      float4* hbox = ws.head_box + pbase;
      int nk = 0;                              // heads kept so far
      for (int t0 = 0; t0 < n; t0 += kSeg) {
        const int kt = min(kSeg, n - t0);
        const int nw = (kt + 63) >> 6;
        stage_rows(s, ws, boxes, labels, obj, base, pbase + t0, kt, nw * 64,
                   plus1);
        __syncthreads();
        SEG_MARK(kPStage);

        // (a) The rows against the earlier heads: each row's first kept
        //     suppressor is the least ordinal among the heads that suppress
        //     it.  With thresh >= 0 a head that suppresses a row intersects
        //     it, so it shares a cell of a uniform grid over the heads with
        //     it: the row tests only the heads of its cells (and the few
        //     heads too large to bin); without the grid (thresh < 0, a row
        //     over more than kRowCells cells or not finite) it tests every
        //     head in order.
        //     Then the tile's suppressed rows, sorted by (head, row), add
        //     themselves to their heads' sums in ascending row order.
        if (nk > 0) {
          const bool grid = !(th.t < 0.0f);
          int* cells = ws.cell + (size_t)pbase * kHeadCells;
          int* big = ws.big + pbase;
          float4 ext = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          float cw = 1.0f, ch = 1.0f;
          if (grid) {
            const Grid gr = grid_over(hbox, nk, plus1, s.red);
            ext = gr.ext;
            cw = gr.cw;
            ch = gr.ch;
            for (int c = tid; c < kCells; c += kSegThreads) s.u.a.off[c] = 0;
            if (tid == 0) s.u.a.nbig = 0;
            __syncthreads();
            for (int o = tid; o < nk; o += kSegThreads) {
              int c[4];
              if (!cells_of(hbox[o], plus1, ext, cw, ch, c) ||
                  cell_count(c) > kHeadCells)
                continue;
              for (int cy = c[2]; cy <= c[3]; ++cy)
                for (int cx = c[0]; cx <= c[1]; ++cx)
                  atomicAdd(&s.u.a.off[cy * kGrid + cx], 1);
            }
            __syncthreads();
            block_exclusive_scan(s.u.a.off, kCells, s.sums);
            for (int c = tid; c < kCells; c += kSegThreads)
              s.u.a.cursor[c] = s.u.a.off[c];
            if (tid == 0) s.u.a.off[kCells] = 0;
            __syncthreads();
            // kRound heads a round, the rounds in order: each list holds
            // its heads by round, so a row stops at the round after its
            // best hit
            for (int r0 = 0; r0 < nk; r0 += kRound) {
              const int o = r0 + tid;
              int c[4];
              if (tid < kRound && o < nk) {
                if (!cells_of(hbox[o], plus1, ext, cw, ch, c) ||
                    cell_count(c) > kHeadCells) {
                  big[atomicAdd(&s.u.a.nbig, 1)] = o;
                } else {
                  for (int cy = c[2]; cy <= c[3]; ++cy)
                    for (int cx = c[0]; cx <= c[1]; ++cx)
                      cells[atomicAdd(&s.u.a.cursor[cy * kGrid + cx], 1)] =
                          o;
                }
              }
              __syncthreads();
            }
            // the end of the last cell: its cursor after the fill
            if (tid == 0) s.u.a.off[kCells] = s.u.a.cursor[kCells - 1];
            __syncthreads();
          }
          const int nbig = grid ? s.u.a.nbig : 0;
          for (int i = tid; i < kt; i += kSegThreads) {
            const float4 bj = s.box[i];
            const float aj = s.area[i];
            const int lj = s.lab[i];
            auto hits = [&](int o) {
              if (label_test && labels[base + hrow[o]] != lj) return false;
              const float4 bh = hbox[o];
              return over_pair_fast(bh, box_area(bh, plus1), bj, aj, plus1,
                                    th);
            };
            int best = INT_MAX, stop = INT_MAX, c[4];
            const bool binned =
                grid && cells_of(bj, plus1, ext, cw, ch, c) &&
                cell_count(c) <= kRowCells;
            if (binned) {
              // a hit at o ends the lists at the next round: later rounds
              // hold only larger ordinals
              auto take = [&](int o) {
                if (o < best && hits(o)) {
                  best = o;
                  stop = min(stop, (o / kRound + 1) * kRound);
                }
              };
              for (int k = 0; k < nbig && big[k] < stop; ++k) take(big[k]);
              for (int cy = c[2]; cy <= c[3]; ++cy)
                for (int cx = c[0]; cx <= c[1]; ++cx) {
                  const int cc = cy * kGrid + cx;
                  for (int e = s.u.a.off[cc];
                       e < s.u.a.off[cc + 1] && cells[e] < stop; ++e)
                    take(cells[e]);
                }
            } else {
              for (int o = 0; o < nk; ++o)
                if (hits(o)) {
                  best = o;
                  break;
                }
            }
            s.first[i] = best == INT_MAX ? kNone : best;
          }
          __syncthreads();
          // (head, row) keys of the suppressed rows, sorted (bitonic)
          s.u.a.key[tid] = s.first[tid] != kNone && tid < kt
                               ? (long long)s.first[tid] << 11 | tid
                               : LLONG_MAX;
          __syncthreads();
          for (int k = 2; k <= kSeg; k <<= 1)
            for (int j = k >> 1; j > 0; j >>= 1) {
              const int q = tid ^ j;
              if (q > tid) {
                const long long a = s.u.a.key[tid], b = s.u.a.key[q];
                if ((a > b) == ((tid & k) == 0)) {
                  s.u.a.key[tid] = b;
                  s.u.a.key[q] = a;
                }
              }
              __syncthreads();
            }
          // the first of each head's rows adds them all, in row order
          const long long key = s.u.a.key[tid];
          if (key != LLONG_MAX &&
              (tid == 0 || s.u.a.key[tid - 1] >> 11 != key >> 11)) {
            const int h = static_cast<int>(key >> 11);
            float4 sum = hsum[h];
            float den = hden[h];
            int size = hsize[h];
            for (int q = tid; q < kSeg && s.u.a.key[q] >> 11 == h; ++q) {
              const int r = static_cast<int>(s.u.a.key[q] & 2047);
              const float wq = s.w[r];
              const float4 bq = s.box[r];
              sum.x += wq * bq.x;
              sum.y += wq * bq.y;
              sum.z += wq * bq.z;
              sum.w += wq * bq.w;
              den += wq;
              ++size;
            }
            hsum[h] = sum;
            hden[h] = den;
            hsize[h] = size;
          }
        }
        __syncthreads();

        SEG_MARK(kPCross);

        // (b) The tile's own chain over its live rows, moved to the front
        //     in row order (so the relation holds only them); the rows (a)
        //     suppressed go out as given.
        int nl = 0;
        {
          const int i = tid;                   // kSegThreads == kSeg
          const bool live = i < kt && s.first[i] == kNone;
          if (i < kt && !live) {
            out_boxes[base + s.row[i]] = s.box[i];
            keep_out[base + s.row[i]] = false;
          }
          const unsigned lb = __ballot_sync(0xffffffffu, live);
          if ((tid & 31) == 0) s.live_bits[warp] = lb;
          __syncthreads();
          int at = __popc(lb & ((1u << (tid & 31)) - 1u));
          for (int wd = 0; wd < kSeg / 32; ++wd) {
            const int c = __popc(s.live_bits[wd]);
            at += wd < warp ? c : 0;
            nl += c;
          }
          move_left(s.box, i, live, at);
          move_left(s.area, i, live, at);
          move_left(s.lab, i, live, at);
          move_left(s.w, i, live, at);
          move_left(s.row, i, live, at);
          const int nwl = (nl + 63) >> 6;
          if (i >= nl && i < nwl * 64) {       // zero rows to whole words
            const float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            s.box[i] = b;
            s.area[i] = box_area(b, plus1);
            s.lab[i] = 0;
            s.w[i] = 0.0f;
          }
          const unsigned vb = __ballot_sync(0xffffffffu, i < nl);
          if ((tid & 31) == 0) s.valid_bits[warp] = vb;
        }
        __syncthreads();
        const int nwl = (nl + 63) >> 6;
        build_relation<kSegThreads, true>(s.box, s.area, s.lab, s.valid_bits,
                                          s.u.over, nl, nwl, label_test, th,
                                          plus1);
        __syncthreads();
        if (warp == 0)
          scan_words(s.u.over, s.valid_bits, s.keep_bits, s.diag, s.heads, nl,
                     nwl);
        __syncthreads();

        // (c) The tile's heads: ordinals after nk, sums from their in-tile
        //     groups; the live rows written as given.
        int tile_kept = 0;
        for (int wd = 0; wd < 2 * nwl; ++wd)
          tile_kept += __popc(s.keep_bits[wd]);
        for (int i = tid; i < nl; i += kSegThreads) {
          const bool kept = bit_of(s.keep_bits, i);
          out_boxes[base + s.row[i]] = s.box[i];
          keep_out[base + s.row[i]] = kept;
          if (!kept) continue;
          int o = nk + __popc(s.keep_bits[i >> 5] & ((1u << (i & 31)) - 1u));
          for (int wd = 0; wd < (i >> 5); ++wd) o += __popc(s.keep_bits[wd]);
          float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          float den = 0.0f;
          hsize[o] = group_sum(s.u.over, nwl, i, s.box, s.w, sum, den);
          hsum[o] = sum;
          hden[o] = den;
          hrow[o] = s.row[i];
          hbox[o] = s.box[i];
        }
        nk += tile_kept;
        __syncthreads();             // the next tile restages the shared arrays
        SEG_MARK(kPChain);
      }
      // The kept rows merged with their groups, their own row last.
      if (merge) {
        for (int o = tid; o < nk; o += kSegThreads) {
          const int r = hrow[o];
          out_boxes[base + r] =
              merged(hsum[o], hden[o], boxes[base + r], obj[base + r]);
        }
      }
      if (kDropLone && tid == 0 && nk > 0)   // the segment's last kept row
        atomicMax(&ws.drop[b],
                  ((hrow[nk - 1] + 1) << 1) | int(hsize[nk - 1] == 0));
    }
    __syncthreads();
    SEG_MARK(kPMerge);

    if (kDropLone) {
      // The image's last segment to finish applies drop_lone to its last
      // kept row.
      __threadfence();
      __syncthreads();
      if (tid == 0 && atomicAdd(&ws.done[b], 1) == ws.nseg[b] - 1) {
        __threadfence();
        const int rec = atomicAdd(&ws.drop[b], 0);
        if (rec & 1) {
          const int r = (rec >> 1) - 1;
          keep_out[base + r] = false;
          out_boxes[base + r] = boxes[base + r];
        }
      }
      SEG_MARK(kPDrop);
    }
    PROBE(if (tid == 0 && blockIdx.x < kProbeMax)
              g_seg_clk[blockIdx.x * 8 + kPItems] += 1;)
    __syncthreads();                 // s.item is rewritten
  }
  PROBE(if (tid == 0 && blockIdx.x < kProbeMax)
            g_seg_ns[2 * blockIdx.x + 1] = global_ns();)
}

// The workspace of the K > kMaxK route, in bytes from its start (16-byte
// aligned): first the part the launch zeroes (header, done counts, drop
// records), then the partition's outputs and the tiled chain's head sums.
struct Layout {
  size_t hdr, done, drop, zeroed, nseg, mixed, seg, work, perm, sum, den,
      row, size, hbox, big, cell, total;
};

Layout layout(int B, int K) {
  auto up = [](size_t x) { return (x + 15) & ~size_t(15); };
  const long long bk = (long long)B * K;
  const long long bs = (long long)B * (K < kLabelBins ? K : kLabelBins);
  Layout L;
  size_t at = 0;
  L.hdr = at;
  at += kHeaderInts * sizeof(int);
  L.done = at;
  at += B * sizeof(int);
  L.drop = at;
  at = up(at + B * sizeof(int));
  L.zeroed = at;
  L.nseg = at;
  at = up(at + B * sizeof(int));
  L.mixed = at;
  at = up(at + B * sizeof(int));
  L.seg = at;
  at = up(at + bs * sizeof(int2));
  L.work = at;
  at = up(at + bin_offset(kBins, bk, bs) * sizeof(int));
  L.perm = at;
  at = up(at + bk * sizeof(int));
  L.sum = at;
  at = up(at + bk * sizeof(float4));
  L.den = at;
  at = up(at + bk * sizeof(float));
  L.row = at;
  at = up(at + bk * sizeof(int));
  L.size = at;
  at = up(at + bk * sizeof(int));
  L.hbox = at;
  at = up(at + bk * sizeof(float4));
  L.big = at;
  at = up(at + bk * sizeof(int));
  L.cell = at;
  at = up(at + bk * kHeadCells * sizeof(int));
  L.total = at;
  return L;
}

int launch_tiled(const void* boxes, const void* scores, const void* labels,
                 const void* obj, void* out_boxes, void* keep, int B, int K,
                 float thresh, int class_aware, int merge, float plus1,
                 cudaStream_t stream, int drop_lone, void* workspace) {
  if (!workspace || reinterpret_cast<size_t>(workspace) % 16)
    return (int)cudaErrorInvalidValue;
  const int S = K < kLabelBins ? K : kLabelBins;
  if ((long long)B * K >= INT_MAX / 2) return (int)cudaErrorInvalidValue;
  const Layout L = layout(B, K);
  unsigned char* w = static_cast<unsigned char*>(workspace);
  Work ws;
  ws.hdr = reinterpret_cast<int*>(w + L.hdr);
  ws.done = reinterpret_cast<int*>(w + L.done);
  ws.drop = reinterpret_cast<int*>(w + L.drop);
  ws.nseg = reinterpret_cast<int*>(w + L.nseg);
  ws.mixed = reinterpret_cast<int*>(w + L.mixed);
  ws.seg = reinterpret_cast<int2*>(w + L.seg);
  ws.work = reinterpret_cast<int*>(w + L.work);
  ws.perm = reinterpret_cast<int*>(w + L.perm);
  ws.head_sum = reinterpret_cast<float4*>(w + L.sum);
  ws.head_den = reinterpret_cast<float*>(w + L.den);
  ws.head_row = reinterpret_cast<int*>(w + L.row);
  ws.head_size = reinterpret_cast<int*>(w + L.size);
  ws.head_box = reinterpret_cast<float4*>(w + L.hbox);
  ws.big = reinterpret_cast<int*>(w + L.big);
  ws.cell = reinterpret_cast<int*>(w + L.cell);

  const size_t part_smem =
      (size_t)(kPartWarps + 3) * kLabelBins * sizeof(int) + 33 * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      greedy_nms_partition_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)part_smem);
  if (e != cudaSuccess) return (int)e;
  const auto seg_kernel = drop_lone ? greedy_nms_segment_kernel<true>
                                    : greedy_nms_segment_kernel<false>;
  const size_t seg_smem = sizeof(SegSmem);
  e = cudaFuncSetAttribute(seg_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)seg_smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seg_kernel,
                                                    kSegThreads, seg_smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long most = (long long)B * S;     // no more CTAs than segments
  const int grid = (int)(most < (long long)sms * per_sm ? most
                                                        : (long long)sms * per_sm);

  e = cudaMemsetAsync(w, 0, L.zeroed, stream);
  if (e != cudaSuccess) return (int)e;
  greedy_nms_partition_kernel<<<B, kPartThreads, part_smem, stream>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const int*>(labels), static_cast<float4*>(out_boxes),
      static_cast<bool*>(keep), K, S, class_aware, ws);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  seg_kernel<<<grid, kSegThreads, seg_smem, stream>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(labels),
      static_cast<const float*>(obj), static_cast<float4*>(out_boxes),
      static_cast<bool*>(keep), B, K, S, thresh, merge, plus1, ws);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest K of the single-tile kernel; larger K takes the split route.
extern "C" int greedy_nms_max_k() { return kMaxK; }

// The widest label range (max - min + 1 over an image's valid rows) that
// the partition splits by label; a wider one makes the image one segment.
extern "C" int greedy_nms_label_bins() { return kLabelBins; }

// Bytes of device workspace that greedy_nms_launch needs for B x K: 0 up to
// greedy_nms_max_k(), the split route's layout above it (its size grows
// with K, so that of K = greedy_nms_max_k() + 1 holds any smaller K).
// Its first 64 int32 are a header: [0, 32) segments in each size bin,
// [32] the work ticket, [33] images that took the one-segment path because
// their label range exceeded greedy_nms_label_bins(), [34] segments.
extern "C" size_t greedy_nms_workspace_bytes(int B, int K) {
  return K > kMaxK ? layout(B, K).total : 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// boxes/out_boxes [B, K, 4] f32 (16-byte aligned), scores/obj [B, K] f32,
// labels [B, K] i32, keep [B, K] bool; all contiguous on the current device.
// workspace: greedy_nms_workspace_bytes(B, K) bytes on that device, 16-byte
// aligned (null when that is 0).  drop_lone and workspace are the last
// arguments, so the others keep the positions they had before.
extern "C" int greedy_nms_launch(const void* boxes, const void* scores,
                                 const void* labels, const void* obj,
                                 void* out_boxes, void* keep, int B, int K,
                                 float thresh, int class_aware, int merge,
                                 float plus1, void* stream, int drop_lone,
                                 void* workspace) {
  if (B <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (K > kMaxK)
    return launch_tiled(boxes, scores, labels, obj, out_boxes, keep, B, K,
                        thresh, class_aware, merge, plus1,
                        static_cast<cudaStream_t>(stream), drop_lone,
                        workspace);
  const size_t smem = smem_bytes(K);
  const auto kernel =
      drop_lone ? greedy_nms_kernel<true> : greedy_nms_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const int*>(labels), static_cast<const float*>(obj),
      static_cast<float4*>(out_boxes), static_cast<bool*>(keep), K, thresh,
      class_aware, merge, plus1);
  return (int)cudaGetLastError();
}

// greedy_nms_launch's arguments, but the split route (partition and
// segment kernels) at any K, its workspace greedy_nms_workspace_bytes(B,
// max(K, kMaxK + 1)): to time the two routes side by side at K <= kMaxK.
// The serving path never calls it.
extern "C" int greedy_nms_tiled_launch(const void* boxes, const void* scores,
                                       const void* labels, const void* obj,
                                       void* out_boxes, void* keep, int B,
                                       int K, float thresh, int class_aware,
                                       int merge, float plus1, void* stream,
                                       int drop_lone, void* workspace) {
  if (B <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  return launch_tiled(boxes, scores, labels, obj, out_boxes, keep, B, K,
                      thresh, class_aware, merge, plus1,
                      static_cast<cudaStream_t>(stream), drop_lone,
                      workspace);
}

#ifdef NMS_PROBE
// tools/kernel_ab.py: the probe arrays, ns and clocks, into host memory.
extern "C" int route_probe(void* part_ns, void* seg_ns, void* seg_clk, int n) {
  cudaError_t e =
      cudaMemcpyFromSymbol(part_ns, g_part_ns, 2 * n * sizeof(long long));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(seg_ns, g_seg_ns, 2 * n * sizeof(long long));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(seg_clk, g_seg_clk, 8 * n * sizeof(long long));
  return (int)e;
}
extern "C" int route_probe_clear() {
  static long long zeros[8 * kProbeMax];
  cudaError_t e = cudaMemcpyToSymbol(g_seg_clk, zeros, sizeof(zeros));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_part_ns, zeros, sizeof(g_part_ns));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_seg_ns, zeros, sizeof(g_seg_ns));
  return (int)e;
}
#endif
