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
//
// What bounds it on an H100: not bytes nor FLOPs.  At B=256, K=300 the
// function moves ~3.5 MB (~1 us at 3.35 TB/s) and does ~45k IoUs per image
// (~0.2 GFLOP f32 in all, a few us at 67 TFLOP/s).  What remains is the
// greedy chain: head h+1 depends on every suppression by heads <= h, so each
// image is a serial scan whose length is its number of kept boxes.
//
// What the design does about it: everything that does not depend on the
// chain is taken off it and run by all 256 threads -- the K x K suppression
// relation is built once as a bitmask in shared memory (K * ceil(K/64)
// 64-bit words, 12 KB at K=300), and the merge runs after the scan.  The
// scan itself is one warp: lane l owns word l of the "alive" set, the next
// head is found with one shuffle and one find-first-set, and removing its
// row is one shared-memory load and AND per lane; so a step costs a few
// dozen cycles and steps are taken only for kept heads and empty words.
// While a head is taken, its row of the bitmask is overwritten with the
// boxes it removes now -- its merge group -- so the merge reads each group
// directly and does work in proportion to the group, with no second K x K
// pass.  Images run in parallel CTAs; making the chain itself shorter is
// later work.
//
// IoU is evaluated in the JAX code's order,
//   inter / (area_i + area_j - inter + 1e-16),
// with __f*_rn intrinsics so that no FMA contraction can move a value that
// sits at the hard threshold.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 1024;       // nw <= 16 words: one warp holds the alive set
constexpr float kNegInf = -1e9f;  // score <= kNegInf marks an invalid row

__device__ __forceinline__ float box_area(float4 b, float plus1) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), plus1),
                   __fadd_rn(__fsub_rn(b.w, b.y), plus1));
}

__device__ __forceinline__ bool iou_over(float4 a, float area_a, float4 b,
                                         float area_b, float thresh,
                                         float plus1) {
  const float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)),
                                   plus1), 0.0f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)),
                                   plus1), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float denom =
      __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-16f);
  return __fdiv_rn(inter, denom) > thresh;
}

__global__ void __launch_bounds__(kThreads)
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
  float4* box = reinterpret_cast<float4*>(smem);
  unsigned long long* over =
      reinterpret_cast<unsigned long long*>(box + K);   // [K][nw]
  float* area = reinterpret_cast<float*>(over + (size_t)K * nw);
  float* w = area + K;
  int* lab = reinterpret_cast<int*>(w + K);
  unsigned char* valid = reinterpret_cast<unsigned char*>(lab + K);
  unsigned char* keep = valid + K;

  const size_t base = (size_t)blockIdx.x * K;
  const int tid = threadIdx.x;

  // 1. Stage the image's candidates in shared memory.
  for (int i = tid; i < K; i += kThreads) {
    const float4 b = boxes[base + i];
    const bool v = scores[base + i] > kNegInf;
    box[i] = b;
    area[i] = box_area(b, plus1);
    valid[i] = v;
    w[i] = v ? obj[base + i] : 0.0f;
    lab[i] = labels[base + i];
    keep[i] = 0;
  }
  __syncthreads();

  // 2. Suppression relation, one 64-bit word (row i, columns 64*word..) per
  //    task; only j > i can be suppressed by i.
  for (int t = tid; t < K * nw; t += kThreads) {
    const int i = t / nw;
    const int word = t - i * nw;
    unsigned long long bits = 0ull;
    if (valid[i]) {
      const float4 bi = box[i];
      const float ai = area[i];
      const int li = lab[i];
      const int j0 = max(word * 64, i + 1);
      const int j1 = min(word * 64 + 64, K);
      for (int j = j0; j < j1; ++j) {
        if (valid[j] && (!class_aware || lab[j] == li) &&
            iou_over(bi, ai, box[j], area[j], thresh, plus1)) {
          bits |= 1ull << (j - word * 64);
        }
      }
    }
    over[t] = bits;
  }
  __syncthreads();

  // 3. Greedy scan on warp 0.  Lane l holds word l of the alive set (valid,
  //    not yet suppressed, not yet taken as a head); the next head is the
  //    lowest alive bit.  Row `head` of `over` becomes the head's group.
  if (tid < 32) {
    const int lane = tid;
    unsigned long long alive = 0ull;
    if (lane < nw) {
      const int j1 = min(lane * 64 + 64, K);
      for (int j = lane * 64; j < j1; ++j) {
        if (valid[j]) alive |= 1ull << (j - lane * 64);
      }
    }
    int word = 0;
    while (word < nw) {
      const unsigned long long cur = __shfl_sync(0xffffffffu, alive, word);
      if (cur == 0ull) {
        ++word;
        continue;
      }
      const int bit = __ffsll(static_cast<long long>(cur)) - 1;
      const int head = word * 64 + bit;
      if (lane < nw) {
        const unsigned long long row = over[head * nw + lane];
        over[head * nw + lane] = row & alive;
        alive &= ~row;
      }
      if (lane == word) alive &= ~(1ull << bit);
      if (lane == 0) keep[head] = 1;
    }
  }
  __syncthreads();

  // 4. Outputs: kept boxes merged with their group, every other row as given.
  for (int i = tid; i < K; i += kThreads) {
    float4 out = box[i];
    if (keep[i] && merge) {
      float nx1 = 0.0f, ny1 = 0.0f, nx2 = 0.0f, ny2 = 0.0f, den = 0.0f;
      for (int word = 0; word < nw; ++word) {
        unsigned long long g = over[i * nw + word];
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
    keep_out[base + i] = keep[i] != 0;
  }
}

size_t smem_bytes(int K) {
  const size_t nw = (K + 63) / 64;
  return K * sizeof(float4) + (size_t)K * nw * sizeof(unsigned long long) +
         3 * K * sizeof(float) + 2 * K;
}

}  // namespace

extern "C" int greedy_nms_max_k() { return kMaxK; }

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// boxes/out_boxes [B, K, 4] f32 (16-byte aligned), scores/obj [B, K] f32,
// labels [B, K] i32, keep [B, K] bool; all contiguous on the current device.
extern "C" int greedy_nms_launch(const void* boxes, const void* scores,
                                 const void* labels, const void* obj,
                                 void* out_boxes, void* keep, int B, int K,
                                 float thresh, int class_aware, int merge,
                                 float plus1, void* stream) {
  if (B <= 0 || K <= 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  greedy_nms_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const int*>(labels), static_cast<const float*>(obj),
      static_cast<float4*>(out_boxes), static_cast<bool*>(keep), K, thresh,
      class_aware, merge, plus1);
  return (int)cudaGetLastError();
}
