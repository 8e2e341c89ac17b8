// Greedy weighted-merge NMS over score-sorted candidates, one CTA per image.
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

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
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

  // 2. Suppression relation: warp task (row block rb, word wd) builds
  //    over[rb*32 + lane][wd]; blocks with no column j > row i get none.
  // IoU > thresh without the division: for b > 0 and a finite,
  // RN(a / b) > t  <=>  a / b > mid, or a / b == mid when a tie rounds up,
  // mid = (t + next float above t) / 2; a and mid * b are exact in double.
  const float t_next = nextafterf(thresh, __int_as_float(0x7f800000));
  const bool by_mid = isfinite(thresh) && isfinite(t_next);
  const double mid = 0.5 * ((double)thresh + (double)t_next);
  const bool tie_up = __float_as_uint(thresh) & 1u;   // t_next is even
  // Word wd has tasks for row blocks 0 .. min(nrb, 2 wd + 2) - 1; the
  // tasks are numbered densely, word by word, and dealt out to the warps.
  const int nrb = (K + 31) >> 5;
  int tasks = 0;
  for (int wd = 0; wd < nw; ++wd) tasks += min(nrb, 2 * wd + 2);
  for (int t = warp; t < tasks; t += kWarps) {
    int wd = 0, rb = t;
    while (rb >= min(nrb, 2 * wd + 2)) {
      rb -= min(nrb, 2 * wd + 2);
      ++wd;
    }
    const int j0 = wd * 64;
    const int i = rb * 32 + lane;             // < kp: a padded row if >= K
    const float4 bi = box[i];
    const float ai = area[i];
    const int li = lab[i];
    u64 bits = 0ull;
#pragma unroll 8
    for (int c = 0; c < 64; ++c) {
      const float4 bj = box[j0 + c];          // warp-uniform: a broadcast
      const float aj = area[j0 + c];
      const int lj = lab[j0 + c];
      const float iw = fmaxf(
          __fadd_rn(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), plus1),
          0.0f);
      const float ih = fmaxf(
          __fadd_rn(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), plus1),
          0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float denom =
          __fadd_rn(__fsub_rn(__fadd_rn(ai, aj), inter), 1e-16f);
      bool hit;
      if (by_mid && denom > 0.0f && isfinite(denom) && isfinite(inter)) {
        const double a = inter, ab = mid * (double)denom;
        hit = a > ab || (tie_up && a == ab);
      } else {
        hit = __fdiv_rn(inter, denom) > thresh;
      }
      if ((!class_aware || lj == li) && hit) bits |= 1ull << c;
    }
    if (i < K) {
      const bool vi = (valid_bits[i >> 5] >> (i & 31)) & 1u;
      const int s = i - j0;                    // columns c > s are j > i
      const u64 later = s < 0 ? ~0ull : (s >= 63 ? 0ull : ~0ull << (s + 1));
      over[(size_t)i * nw + wd] = vi ? bits & later & word_of(valid_bits, wd)
                                     : 0ull;
    }
  }
  __syncthreads();

  // 3. Greedy scan on warp 0, one 64-bit word at a time.  Lane l holds
  //    word l of the alive set (valid, not yet suppressed, not yet taken).
  if (warp == 0) {
    u64 alive = lane < nw ? word_of(valid_bits, lane) : 0ull;
    for (int wd = 0; wd < nw; ++wd) {
      // The word's own 64 rows (columns of word wd) in a dense array.
      const int r_lo = wd * 64 + lane;
      const int r_hi = r_lo + 32;
      diag[lane] = r_lo < K ? over[(size_t)r_lo * nw + wd] : 0ull;
      diag[lane + 32] = r_hi < K ? over[(size_t)r_hi * nw + wd] : 0ull;
      __syncwarp();
      // Its kept heads, in order, on lane 0, kBatch columns at a time: the
      // rows of the batch's alive columns are loaded together, then taken
      // in order with register operations alone.  Each head's row becomes
      // its group in the word.
      u64 cand = __shfl_sync(0xffffffffu, alive, wd);
      u64 kept = 0ull;
      if (lane == 0) {
        int n = 0;
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
              heads[n++] = static_cast<unsigned char>(p + q);
              cand &= ~row[q] & ~bit;
            }
          }
        }
        keep_bits[2 * wd] = static_cast<unsigned>(kept);
        keep_bits[2 * wd + 1] = static_cast<unsigned>(kept >> 32);
      }
      __syncwarp();
      kept = __shfl_sync(0xffffffffu, kept, 0);
      if (r_lo < K) over[(size_t)r_lo * nw + wd] = diag[lane];
      if (r_hi < K) over[(size_t)r_hi * nw + wd] = diag[lane + 32];
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
  __syncthreads();

  // 4. Outputs: kept boxes merged with their group, every other row as given.
  for (int i = tid; i < K; i += kThreads) {
    float4 out = box[i];
    bool kept = (keep_bits[i >> 5] >> (i & 31)) & 1u;
    if (kDropLone && kept) {
      // the last kept row (no kept bit above it) with an empty group
      bool last = (keep_bits[i >> 5] >> (i & 31)) >> 1 == 0u;
      for (int b = (i >> 5) + 1; b < 2 * nw; ++b) last &= keep_bits[b] == 0u;
      bool lone = last;
      for (int word = i >> 6; lone && word < nw; ++word)
        lone = over[(size_t)i * nw + word] == 0ull;
      kept = !lone;
    }
    if (kept && merge) {
      float nx1 = 0.0f, ny1 = 0.0f, nx2 = 0.0f, ny2 = 0.0f, den = 0.0f;
      for (int word = i >> 6; word < nw; ++word) {
        u64 g = over[(size_t)i * nw + word];
        while (g) {
          const int j = word * 64 + __ffsll(static_cast<long long>(g)) - 1;
          g &= g - 1;
          const float wj = w[j];
          const float4 bj = box[j];
          nx1 += wj * bj.x;
          ny1 += wj * bj.y;
          nx2 += wj * bj.z;
          ny2 += wj * bj.w;
          den += wj;
        }
      }
      const float wi = w[i];
      nx1 += wi * out.x;
      ny1 += wi * out.y;
      nx2 += wi * out.z;
      ny2 += wi * out.w;
      den = fmaxf(den + wi, 1e-16f);
      out = make_float4(nx1 / den, ny1 / den, nx2 / den, ny2 / den);
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
// K > kMaxK: the same function over tiles of the score-sorted candidates.
//
// greedy_nms_kernel holds the whole [K][nw] relation in shared memory, which
// caps K at 1024 (128 KB of relation).  A YOLO decode gives far more rows
// (25,200 for YOLOv5s at 640 px), and the Pallas kernel takes any K.  Above
// the cap one CTA per image walks its candidates in tiles of kTile rows, in
// score order:
//   (a) each live row of the tile (valid, not yet suppressed) is tested
//       against the heads kept in earlier tiles, in head order, kHeadChunk
//       heads staged in shared memory at a time; its first hit is its first
//       kept suppressor and the row is dead.  The rows test independently:
//       no serial chain here, O(tile x earlier heads) IoUs over all threads,
//       a label test first when class_aware, and an exit once no live row
//       is left.
//   (b) the tile's live rows resolve their own chain with greedy_nms_kernel's
//       relation build and word-blocked scan (its steps 2 and 3 over the
//       tile), which leave each head's in-tile group in its relation row.
//   (c) the tile's heads take ordinals after the earlier ones, their in-tile
//       groups name them as first suppressor, and each head's running merge
//       sum (in the per-image workspace) takes the tile's rows of its group
//       in ascending row order -- the first row of the tile that names a
//       head adds them all -- so over the tiles every group is summed in
//       ascending j, then the head's own row, as greedy_nms_kernel sums it.
// Chosen over one head at a time (the Pallas kernel's loop, alive set as K
// bits) because there every kept head costs a CTA-wide barrier and a pass
// over the K rows; here the serial part is only the in-tile scan, and the
// cross-tile test is parallel over rows.  Every pair is decided by
// over_pair, the relation build's division-free midpoint test, so pairs
// within ulps of the threshold decide as in greedy_nms_kernel.
//
// Workspace, [B][K] slots indexed by head ordinal, from the caller
// (greedy_nms_workspace_bytes): each head's merge sum (float4) and weight
// (float), its row and its group size (int), 28 bytes a candidate.
// What bounds it: neither bytes nor FLOPs -- the cross-tile test is
// O(K x kept heads) IoUs per image on one SM, and the in-tile chain is
// serial as in greedy_nms_kernel; B=1 uses one SM of 132.

constexpr int kTile = 1024;                  // rows a tile: nw <= 16 words
constexpr int kTileWords = kTile / 64;
constexpr int kTileThreads = 1024;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kHeadChunk = 1024;             // earlier heads staged at once
constexpr int kNone = -1;                    // no kept suppressor

struct TileSmem {
  float4 box[kTile];
  float area[kTile];
  int lab[kTile];
  int first[kTile];          // ordinal of the row's first kept suppressor
  union {
    u64 over[kTile * kTileWords];            // (b): the tile's relation
    struct {
      float4 box[kHeadChunk];
      float area[kHeadChunk];
      int lab[kHeadChunk];
    } head;                                  // (a): earlier heads
  } u;
  u64 diag[64];
  unsigned valid_bits[kTile / 32];
  unsigned live_bits[kTile / 32];
  unsigned keep_bits[kTile / 32];
  unsigned char heads[64];
};

// greedy_nms_kernel's step-2 threshold test for one pair, i the earlier row.
struct Thresh {
  float t;
  bool by_mid, tie_up;
  double mid;
};

__device__ __forceinline__ Thresh make_thresh(float thresh) {
  const float t_next = nextafterf(thresh, __int_as_float(0x7f800000));
  Thresh th;
  th.t = thresh;
  th.by_mid = isfinite(thresh) && isfinite(t_next);
  th.mid = 0.5 * ((double)thresh + (double)t_next);
  th.tie_up = __float_as_uint(thresh) & 1u;
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

__device__ __forceinline__ bool bit_of(const unsigned* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

template <bool kDropLone>
__global__ void __launch_bounds__(kTileThreads, 1)
greedy_nms_tiled_kernel(const float4* __restrict__ boxes,
                        const float* __restrict__ scores,
                        const int* __restrict__ labels,
                        const float* __restrict__ obj,
                        float4* __restrict__ out_boxes,
                        bool* __restrict__ keep_out,
                        float4* __restrict__ head_sum,
                        float* __restrict__ head_den,
                        int* __restrict__ head_row,
                        int* __restrict__ head_size,
                        int K, float thresh, int class_aware, int merge,
                        float plus1) {
  extern __shared__ __align__(16) unsigned char smem[];
  TileSmem& s = *reinterpret_cast<TileSmem*>(smem);
  const size_t base = (size_t)blockIdx.x * K;   // the image's rows and slots
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Thresh th = make_thresh(thresh);
  int nk = 0;                                   // heads kept so far

  for (int r0 = 0; r0 < K; r0 += kTile) {
    const int kt = min(kTile, K - r0);
    const int nw = (kt + 63) >> 6;
    const int kp = nw * 64;

    // Stage the tile; columns kt..kp-1 hold a zero box, never valid.
    for (int i = tid; i < kp; i += kTileThreads) {
      bool v = false;
      float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int l = 0;
      if (i < kt) {
        b = boxes[base + r0 + i];
        v = scores[base + r0 + i] > kNegInf;
        l = labels[base + r0 + i];
      }
      s.box[i] = b;
      s.area[i] = box_area(b, plus1);
      s.lab[i] = l;
      s.first[i] = kNone;
      const unsigned vb = __ballot_sync(0xffffffffu, v);
      if (lane == 0) s.valid_bits[i >> 5] = vb;
    }
    __syncthreads();

    // (a) Live rows against the heads of earlier tiles, in head order.
    for (int h0 = 0; h0 < nk; h0 += kHeadChunk) {
      int any = 0;
      for (int i = tid; i < kt; i += kTileThreads)
        any |= bit_of(s.valid_bits, i) && s.first[i] == kNone;
      // also the barrier between the last chunk's tests and the restaging
      if (!__syncthreads_or(any)) break;
      const int nh = min(kHeadChunk, nk - h0);
      for (int h = tid; h < nh; h += kTileThreads) {
        const int row = head_row[base + h0 + h];
        const float4 b = boxes[base + row];
        s.u.head.box[h] = b;
        s.u.head.area[h] = box_area(b, plus1);
        s.u.head.lab[h] = labels[base + row];
      }
      __syncthreads();
      for (int i = tid; i < kt; i += kTileThreads) {
        if (!bit_of(s.valid_bits, i) || s.first[i] != kNone) continue;
        const float4 bj = s.box[i];
        const float aj = s.area[i];
        const int lj = s.lab[i];
        for (int h = 0; h < nh; ++h) {
          if (class_aware && s.u.head.lab[h] != lj) continue;
          if (over_pair(s.u.head.box[h], s.u.head.area[h], bj, aj, plus1,
                        th)) {
            s.first[i] = h0 + h;
            break;
          }
        }
      }
    }
    __syncthreads();

    // (b) The tile's own chain over its live rows: greedy_nms_kernel's
    //     relation build and scan, the live rows taking the valid ones' place.
    for (int i = tid; i < kp; i += kTileThreads) {
      const bool live =
          i < kt && bit_of(s.valid_bits, i) && s.first[i] == kNone;
      const unsigned lb = __ballot_sync(0xffffffffu, live);
      if (lane == 0) s.live_bits[i >> 5] = lb;
    }
    __syncthreads();
    const int nrb = (kt + 31) >> 5;
    int tasks = 0;
    for (int wd = 0; wd < nw; ++wd) tasks += min(nrb, 2 * wd + 2);
    for (int t = warp; t < tasks; t += kTileWarps) {
      int wd = 0, rb = t;
      while (rb >= min(nrb, 2 * wd + 2)) {
        rb -= min(nrb, 2 * wd + 2);
        ++wd;
      }
      const int j0 = wd * 64;
      const int i = rb * 32 + lane;             // < kp: a padded row if >= kt
      const float4 bi = s.box[i];
      const float ai = s.area[i];
      const int li = s.lab[i];
      u64 bits = 0ull;
#pragma unroll 8
      for (int c = 0; c < 64; ++c) {
        const float4 bj = s.box[j0 + c];        // warp-uniform: a broadcast
        const float aj = s.area[j0 + c];
        const int lj = s.lab[j0 + c];
        const bool hit = over_pair(bi, ai, bj, aj, plus1, th);
        if ((!class_aware || lj == li) && hit) bits |= 1ull << c;
      }
      if (i < kt) {
        const bool vi = bit_of(s.live_bits, i);
        const int sh = i - j0;                   // columns c > sh are j > i
        const u64 later =
            sh < 0 ? ~0ull : (sh >= 63 ? 0ull : ~0ull << (sh + 1));
        s.u.over[(size_t)i * nw + wd] =
            vi ? bits & later & word_of(s.live_bits, wd) : 0ull;
      }
    }
    __syncthreads();

    if (warp == 0) {
      u64 alive = lane < nw ? word_of(s.live_bits, lane) : 0ull;
      for (int wd = 0; wd < nw; ++wd) {
        const int r_lo = wd * 64 + lane;
        const int r_hi = r_lo + 32;
        s.diag[lane] = r_lo < kt ? s.u.over[(size_t)r_lo * nw + wd] : 0ull;
        s.diag[lane + 32] =
            r_hi < kt ? s.u.over[(size_t)r_hi * nw + wd] : 0ull;
        __syncwarp();
        u64 cand = __shfl_sync(0xffffffffu, alive, wd);
        u64 kept = 0ull;
        if (lane == 0) {
          int n = 0;
          for (int p = 0; p < 64; p += kBatch) {
            if (!((cand >> p) & ((1ull << kBatch) - 1))) continue;
            u64 row[kBatch];
#pragma unroll
            for (int q = 0; q < kBatch; ++q)
              row[q] = (cand >> (p + q)) & 1ull ? s.diag[p + q] : 0ull;
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              const u64 bit = 1ull << (p + q);
              if (cand & bit) {
                s.diag[p + q] = row[q] & cand;
                kept |= bit;
                s.heads[n++] = static_cast<unsigned char>(p + q);
                cand &= ~row[q] & ~bit;
              }
            }
          }
          s.keep_bits[2 * wd] = static_cast<unsigned>(kept);
          s.keep_bits[2 * wd + 1] = static_cast<unsigned>(kept >> 32);
        }
        __syncwarp();
        kept = __shfl_sync(0xffffffffu, kept, 0);
        if (r_lo < kt) s.u.over[(size_t)r_lo * nw + wd] = s.diag[lane];
        if (r_hi < kt) s.u.over[(size_t)r_hi * nw + wd] = s.diag[lane + 32];
        const int nkw = __popcll(kept);
        if (lane > wd && lane < nw) {
          for (int r = 0; r < nkw; r += kBatch) {
            int at[kBatch];
            u64 row[kBatch];
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              at[q] = r + q < nkw ? (wd * 64 + s.heads[r + q]) * nw + lane
                                  : 0;
              row[q] = r + q < nkw ? s.u.over[at[q]] : 0ull;
            }
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              if (r + q < nkw) {
                s.u.over[at[q]] = row[q] & alive;
                alive &= ~row[q];
              }
            }
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // (c) The tile's heads: ordinals after nk, fresh sums, and their in-tile
    //     groups naming them.
    int tile_kept = 0;
    for (int wd = 0; wd < 2 * nw; ++wd) tile_kept += __popc(s.keep_bits[wd]);
    for (int i = tid; i < kt; i += kTileThreads) {
      if (!bit_of(s.keep_bits, i)) continue;
      int n = nk + __popc(s.keep_bits[i >> 5] & ((1u << (i & 31)) - 1u));
      for (int wd = 0; wd < (i >> 5); ++wd) n += __popc(s.keep_bits[wd]);
      head_row[base + n] = r0 + i;
      head_sum[base + n] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      head_den[base + n] = 0.0f;
      head_size[base + n] = 0;
      for (int wd = i >> 6; wd < nw; ++wd) {
        u64 g = s.u.over[(size_t)i * nw + wd];
        while (g) {
          s.first[wd * 64 + __ffsll(static_cast<long long>(g)) - 1] = n;
          g &= g - 1;
        }
      }
    }
    __syncthreads();
    // Each head's rows in this tile, in row order, added to its sum by the
    // first of them; every row of the tile is written as given.
    for (int j = tid; j < kt; j += kTileThreads) {
      out_boxes[base + r0 + j] = s.box[j];
      keep_out[base + r0 + j] = bit_of(s.keep_bits, j);
      const int n = s.first[j];
      if (n == kNone) continue;
      bool lead = true;
      for (int q = 0; q < j && lead; ++q) lead = s.first[q] != n;
      if (!lead) continue;
      float4 sum = head_sum[base + n];
      float den = head_den[base + n];
      int size = head_size[base + n];
      for (int q = j; q < kt; ++q) {
        if (s.first[q] != n) continue;
        const float wq = obj[base + r0 + q];    // group rows are valid
        const float4 bq = s.box[q];
        sum.x += wq * bq.x;
        sum.y += wq * bq.y;
        sum.z += wq * bq.z;
        sum.w += wq * bq.w;
        den += wq;
        ++size;
      }
      head_sum[base + n] = sum;
      head_den[base + n] = den;
      head_size[base + n] = size;
    }
    nk += tile_kept;
    __syncthreads();               // the next tile restages the shared arrays
  }

  // The kept rows: drop_lone, then each head merged with its group, its own
  // row last (greedy_nms_kernel's step 4).
  for (int n = tid; n < nk; n += kTileThreads) {
    const int i = head_row[base + n];
    if (kDropLone && n == nk - 1 && head_size[base + n] == 0) {
      keep_out[base + i] = false;
      continue;
    }
    if (!merge) continue;
    float4 sum = head_sum[base + n];
    const float4 b = boxes[base + i];
    const float wi = obj[base + i];
    sum.x += wi * b.x;
    sum.y += wi * b.y;
    sum.z += wi * b.z;
    sum.w += wi * b.w;
    const float den = fmaxf(head_den[base + n] + wi, 1e-16f);
    out_boxes[base + i] =
        make_float4(sum.x / den, sum.y / den, sum.z / den, sum.w / den);
  }
}

// greedy_nms_tiled_kernel's workspace: B*K each of float4, float, int, int.
size_t tiled_workspace_bytes(int B, int K) {
  return (size_t)B * K * (sizeof(float4) + sizeof(float) + 2 * sizeof(int));
}

int launch_tiled(const void* boxes, const void* scores, const void* labels,
                 const void* obj, void* out_boxes, void* keep, int B, int K,
                 float thresh, int class_aware, int merge, float plus1,
                 cudaStream_t stream, int drop_lone, void* workspace) {
  if (!workspace || reinterpret_cast<size_t>(workspace) % 16)
    return (int)cudaErrorInvalidValue;
  const auto kernel = drop_lone ? greedy_nms_tiled_kernel<true>
                                : greedy_nms_tiled_kernel<false>;
  const size_t smem = sizeof(TileSmem);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)B * K;
  float4* head_sum = static_cast<float4*>(workspace);
  float* head_den = reinterpret_cast<float*>(head_sum + n);
  int* head_row = reinterpret_cast<int*>(head_den + n);
  kernel<<<B, kTileThreads, smem, stream>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const int*>(labels), static_cast<const float*>(obj),
      static_cast<float4*>(out_boxes), static_cast<bool*>(keep), head_sum,
      head_den, head_row, head_row + n, K, thresh, class_aware, merge, plus1);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest K of the single-tile kernel; larger K takes the tiled one.
extern "C" int greedy_nms_max_k() { return kMaxK; }

// Bytes of device workspace that greedy_nms_launch needs for B x K: 0 up to
// greedy_nms_max_k(), 28 * B * K above it (greedy_nms_tiled_launch: 28 * B *
// K at any K).
extern "C" size_t greedy_nms_workspace_bytes(int B, int K) {
  return K > kMaxK ? tiled_workspace_bytes(B, K) : 0;
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

// greedy_nms_launch's arguments, but the tiled kernel at any K (its
// workspace tiled_workspace_bytes(B, K), which greedy_nms_workspace_bytes
// gives only above kMaxK): to time the two kernels side by side at
// K <= kMaxK.  The serving path never calls it.
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
