// 3x3 stride-1 SAME convolution, NHWC x HWIO, f32 accumulation: the forward
// (which also computes the input gradient on the flipped, transposed
// weights) and the weight gradient with its split-K reduction.
//
// Replaces: objectdetectionpl_tpu/ops/pallas/conv_kernel.py
//   :121 conv3x3_s1        (_fwd_kernel :101, pallas_call :146)
//   :185 conv3x3_s1_wgrad  (_wgrad_kernel :169, pallas_call :208)
//
// What it computes (implicit GEMM, no padded or im2col copy in memory):
//   forward  y[m, n]  = sum_k A[m, k] * w[k, n]          m < B*H*W, n < Co
//   wgrad    dw[k, n] = sum_m A[m, k] * g[m, n]          k < 9*C
// where A[m, k] is the im2col matrix of x: m = (b*H + y)*W + x, k = t*C + c
// with tap t = 3*dy + dx, A[m, k] = x[b, y+dy-1, x+dx-1, c], or 0 where that
// pixel lies outside the image.  The halo's and the border's zeros come from
// index tests while the tiles are loaded (the TPU kernel pads x in HBM first).
// w [3,3,C,Co] is the [9C, Co] matrix of the same k.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): operations for
// the 64-256-channel layers of YOLOv5s-640 (2*9*C*Co flops per pixel
// against (C + Co) * 2 bytes), bytes for the stem (C=12) and the 32->64
// layer.  Measured, the loads into shared memory come first: an implicit
// GEMM that takes A tap by tap reads each pixel of x nine times, and each
// weight once per output tile, from L2 -- several times the HBM bytes, at
// a few TB/s.  The design reads less: x once per dy where it can, the
// weights once per block where they fit.
//
// bf16 with C and Co multiples of 4 (pixels 8-byte aligned): the wgmma
// kernels.  A block is two (wgrad windows: three) consumer warpgroups, each
// issuing wgmma m64nNk16 (f32 accumulators in registers) on operands in
// shared memory.  All threads feed a 4-stage ring with cp.async (zero-fill,
// src-size 0, for the halo, the ragged ends and the padding), two stages
// ahead of the warpgroups, which keep one wgmma group in flight while they
// issue the next: loads, MMA and the next stage's address arithmetic
// overlap, with one __syncthreads per stage.  Four kernels; the wrapper's
// plan picks one by the shape:
//   window forward (C of 32, 64 or 128; the stem's dgrad, the 32->64,
//     64->64 and 128->128 layers): the weight columns of the block stay in
//     shared memory; the output positions run over rows padded to W + 2,
//     so the three dx taps of one dy are one window of x shifted by one
//     position, loaded once and read unswizzled from any 16-byte shift.
//   k-tile forward (the stem, C=12, and the 256-channel layers): a
//     128-pixel x BN tile, BN = Co rounded up to a power of two (8..256),
//     so narrow layers waste no MMA columns; k runs tap-major in
//     64-element k-tiles (channel-block major for C % 64 == 0), each
//     8-element (16-byte) or, for C % 8 != 0, 4-element (8-byte) piece of a
//     pixel lying in one tap: the tap and the halo test are computed once
//     per (piece, k-tile) and the pixel's y, x once per tile, with no
//     division per element.  The last k-tile issues only the 16-deep steps
//     that reach K (the stem's K = 108 runs as 112).
//   Both forwards take the weights as a K-major [Co, 9C] copy, zero-padded
//     to whole tiles, made by the wrapper; blocks are persistent over the
//     output tiles, so the ring runs on across tiles and one tile's
//     epilogue (bf16 through shared memory, rows stored 16 bytes at a time)
//     overlaps the next tile's first loads -- what the bytes-bound stem
//     needs.
//   window wgrad (C of 32 or a multiple of 64, Co a multiple of 8): per
//     64 channels x 64 columns of dw, all nine taps over a chunk of padded
//     positions; warpgroup dy reads its dx taps as one shifted window of x.
//     For C = 32 the m64 MMAs' other 32 rows read zeros: half their work
//     is wasted.
//   tile wgrad (the stem): a 128 (of 9C) x BN (64 or 128) tile of dw per
//     block, over its chunk of pixels in 64-pixel steps.
//   Both wgrads load x and g as they lie (pixel rows of channels) and
//     wgmma reads both MN-major through its transpose bits: no transposed
//     stores; pixels are decomposed with a multiply-shift division.
//   The stem (C=12): 8-byte pieces of 4 channels, which never straddle a
//     tap (12 % 4 == 0); one halo test per piece and row, none per element.
// f32, and bf16 with C or Co not a multiple of 4 (odd channel counts whose
// pixels are not 8-byte aligned) or a tensor not 16-byte aligned, take the
// simple kernels: 128x64 tiles, one shared-memory stage, mma.sync m16n8k16
// (bf16) or FMA (f32).
//
// The wgmma launchers take the dynamic shared memory the wrapper's plan
// sized its grid by, and refuse a value that differs from the kernel's own.
//
// wgrad reduces over the B*H*W pixels (6.5 M for the stem at B=64) while its
// output has few tiles (one for the stem), so the pixels are split into
// `splits` chunks, one block per (tile, chunk).  Each block writes its f32
// partial tile to scratch, and a second kernel sums the partials of each
// element in chunk order: the result is the same on every run (no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int BM = 128;                   // tile rows (pixels; wgrad: 9C)
constexpr int BN = 64;                    // tile columns (output channels)
constexpr int BK = 32;                    // reduction step

template <typename T>
struct Tile {
  // reduction index contiguous; the pad keeps 16-byte rows and spreads the
  // mma fragments' 32-bit loads over the banks
  static constexpr int PAD = sizeof(T) == 2 ? 8 : 4;
  static constexpr int LDS = BK + PAD;
  static constexpr int VEC = 16 / sizeof(T);   // elements in a 16-byte load
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ T zero() { return from_f<T>(0.0f); }

// ---------------------------------------------------------------- the core
// acc[mi][ni][2*h + j] holds output row wm*32 + mi*16 + (lane>>2) + 8*h,
// column wn*32 + ni*8 + 2*(lane&3) + j: mma.sync's m16n8 accumulator layout.

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void tile_product(
    __nv_bfloat16 (*As)[Tile<__nv_bfloat16>::LDS],
    __nv_bfloat16 (*Bs)[Tile<__nv_bfloat16>::LDS],
    float (&acc)[2][4][4], int wm, int wn, int lane) {
  const int g = lane >> 2, q = 2 * (lane & 3);
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + g;
      a[mi][0] = ld32(&As[r][ks + q]);
      a[mi][1] = ld32(&As[r + 8][ks + q]);
      a[mi][2] = ld32(&As[r][ks + q + 8]);
      a[mi][3] = ld32(&As[r + 8][ks + q + 8]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = wn * 32 + ni * 8 + g;
      const uint32_t b0 = ld32(&Bs[n][ks + q]);
      const uint32_t b1 = ld32(&Bs[n][ks + q + 8]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
    }
  }
}

__device__ __forceinline__ void tile_product(float (*As)[Tile<float>::LDS],
                                             float (*Bs)[Tile<float>::LDS],
                                             float (&acc)[2][4][4], int wm,
                                             int wn, int lane) {
  const int g = lane >> 2, q = 2 * (lane & 3);
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float a[2][2], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) a[mi][h] = As[wm * 32 + mi * 16 + g + 8 * h][k];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) b[ni][j] = Bs[wn * 32 + ni * 8 + q + j][k];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            acc[mi][ni][2 * h + j] =
                fmaf(a[mi][h], b[ni][j], acc[mi][ni][2 * h + j]);
  }
}

// ------------------------------------------------------------ im2col reads

struct Geom {
  int B, H, W, C, Co;
  long long M;        // B*H*W pixels
  int K;              // 9*C
};

// Pixel m of the output (or of the reduction, for wgrad).
struct Pixel {
  int b, y, x;
  bool ok;
  __device__ __forceinline__ Pixel(long long m, const Geom& g) {
    ok = m < g.M;
    const long long mm = ok ? m : 0;
    x = (int)(mm % g.W);
    const long long r = mm / g.W;
    y = (int)(r % g.H);
    b = (int)(r / g.H);
  }
};

// Index into x of A[pixel, k], or -1 where A is 0 (outside, or k >= K).
__device__ __forceinline__ long long a_index(const Pixel& p, int k,
                                             const Geom& g) {
  if (!p.ok || k >= g.K) return -1;
  const int t = k / g.C;
  const int c = k - t * g.C;
  const int yy = p.y + t / 3 - 1;
  const int xx = p.x + t % 3 - 1;
  if (yy < 0 || yy >= g.H || xx < 0 || xx >= g.W) return -1;
  return (((long long)p.b * g.H + yy) * g.W + xx) * g.C + c;
}

// n consecutive A elements from k: 16-byte loads where C is a multiple of
// the vector width (a chunk then never straddles two taps), else one by one.
template <typename T, int N>
__device__ __forceinline__ void load_a_run(T (&dst)[N], const T* __restrict__ x,
                                           const Pixel& p, int k, const Geom& g,
                                           bool vec) {
  constexpr int VEC = Tile<T>::VEC;
  if (vec) {
#pragma unroll
    for (int v = 0; v < N / VEC; ++v) {
      const long long i = a_index(p, k + v * VEC, g);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (i >= 0) val = __ldg(reinterpret_cast<const uint4*>(x + i));
      *reinterpret_cast<uint4*>(&dst[v * VEC]) = val;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const long long i = a_index(p, k + e, g);
      dst[e] = i >= 0 ? x[i] : zero<T>();
    }
  }
}

// n consecutive elements of row `row` of a [rows, cols] matrix from column
// col, 0 outside it.
template <typename T, int N>
__device__ __forceinline__ void load_row_run(T (&dst)[N], const T* __restrict__ m,
                                             long long row, long long rows,
                                             int col, int cols, bool vec) {
  constexpr int VEC = Tile<T>::VEC;
  const T* base = m + row * cols;
  if (vec && row < rows) {
#pragma unroll
    for (int v = 0; v < N / VEC; ++v) {
      uint4 val = make_uint4(0, 0, 0, 0);
      if (col + v * VEC < cols)
        val = __ldg(reinterpret_cast<const uint4*>(base + col + v * VEC));
      *reinterpret_cast<uint4*>(&dst[v * VEC]) = val;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      dst[e] = (row < rows && col + e < cols) ? base[col + e] : zero<T>();
  }
}

// ------------------------------------------------------------------ forward
// Block (bx, by): output rows bx*128.., channels by*64..  Loads per thread
// and k-step: 16 A elements of one pixel (thread pair per pixel), and 8 w
// elements of one column (w[k, n] with n across the threads: coalesced).

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, Geom g, bool vec_x) {
  using TT = Tile<T>;
  __shared__ __align__(16) T As[BM][TT::LDS];
  __shared__ __align__(16) T Bs[BN][TT::LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  const int a_row = tid >> 1, a_k = (tid & 1) * 16;
  const Pixel pix(m0 + a_row, g);
  const int b_col = tid & 63, b_k = (tid >> 6) * 8;
  const int n = n0 + b_col;

  alignas(16) T ra[16];
  alignas(16) T rb[8];
  auto load = [&](int k0) {
    load_a_run<T, 16>(ra, x, pix, k0 + a_k, g, vec_x);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = k0 + b_k + e;
      rb[e] = (k < g.K && n < g.Co) ? w[(long long)k * g.Co + n] : zero<T>();
    }
  };

  float acc[2][4][4] = {};
  load(0);
  for (int k0 = 0; k0 < g.K; k0 += BK) {
#pragma unroll
    for (int v = 0; v < 16 / TT::VEC; ++v)
      *reinterpret_cast<uint4*>(&As[a_row][a_k + v * TT::VEC]) =
          *reinterpret_cast<const uint4*>(&ra[v * TT::VEC]);
#pragma unroll
    for (int e = 0; e < 8; ++e) Bs[b_col][b_k + e] = rb[e];
    __syncthreads();
    if (k0 + BK < g.K) load(k0 + BK);
    tile_product(As, Bs, acc, wm, wn, lane);
    __syncthreads();
  }

  const int gq = lane >> 2, q = 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 32 + mi * 16 + gq + 8 * h;
      if (m >= g.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = n0 + wn * 32 + ni * 8 + q + j;
          if (c < g.Co) y[m * g.Co + c] = from_f<T>(acc[mi][ni][2 * h + j]);
        }
    }
}

// ------------------------------------------------------------------- wgrad
// Block (bx, by, s): dw rows bx*128.. (of 9C), channels by*64.., pixels of
// chunk s.  Loads per thread and step: 16 A elements (one pixel, 16 rows of
// k) and 8 g elements (one pixel, 8 channels); both are stored transposed,
// pixel-contiguous, since the pixels are the reduction here.

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                     float* __restrict__ partial, Geom g, long long chunk,
                     bool vec_x, bool vec_g) {
  using TT = Tile<T>;
  __shared__ __align__(16) T As[BM][TT::LDS];
  __shared__ __align__(16) T Bs[BN][TT::LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long p_begin = (long long)blockIdx.z * chunk;
  long long p_end = p_begin + chunk;
  if (p_end > g.M) p_end = g.M;

  const int p_local = tid & 31;
  const int a_r = (tid >> 5) * 16;
  const int b_n = (tid >> 5) * 8;

  alignas(16) T ra[16];
  alignas(16) T rb[8];
  auto load = [&](long long p0) {
    const long long m = p0 + p_local;
    Pixel pix(m, g);
    pix.ok = pix.ok && m < p_end;
    load_a_run<T, 16>(ra, x, pix, r0 + a_r, g, vec_x);
    load_row_run<T, 8>(rb, gy, m, pix.ok ? g.M : 0, n0 + b_n, g.Co, vec_g);
  };

  float acc[2][4][4] = {};
  if (p_begin < p_end) load(p_begin);
  for (long long p0 = p_begin; p0 < p_end; p0 += BK) {
#pragma unroll
    for (int e = 0; e < 16; ++e) As[a_r + e][p_local] = ra[e];
#pragma unroll
    for (int e = 0; e < 8; ++e) Bs[b_n + e][p_local] = rb[e];
    __syncthreads();
    if (p0 + BK < p_end) load(p0 + BK);
    tile_product(As, Bs, acc, wm, wn, lane);
    __syncthreads();
  }

  float* out = partial + (long long)blockIdx.z * g.K * g.Co;
  const int gq = lane >> 2, q = 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wm * 32 + mi * 16 + gq + 8 * h;
      if (r >= g.K) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = n0 + wn * 32 + ni * 8 + q + j;
          if (c < g.Co) out[(long long)r * g.Co + c] = acc[mi][ni][2 * h + j];
        }
    }
}

// dw[i] = sum over s = 0, 1, ... of partial[s][i], in that order.
__global__ void __launch_bounds__(kThreads)
conv3x3_wgrad_reduce_kernel(const float* __restrict__ partial,
                            float* __restrict__ dw, int n, int splits) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += partial[(long long)k * n + i];
  dw[i] = s;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool geom(Geom& g, int B, int H, int W, int C, int Co) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C > (1 << 26))
    return false;
  g = Geom{B, H, W, C, Co, (long long)B * H * W, 9 * C};
  return (g.M + BM - 1) / BM <= 0x7fffffffLL && (Co + BN - 1) / BN <= 65535;
}

template <typename T>
int fwd(const void* x, const void* w, void* y, const Geom& g, cudaStream_t s) {
  const bool vec_x = g.C % Tile<T>::VEC == 0 && aligned16(x);
  const dim3 grid((unsigned)((g.M + BM - 1) / BM), (g.Co + BN - 1) / BN);
  conv3x3_fwd_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      g, vec_x);
  return (int)cudaGetLastError();
}

template <typename T>
int wgrad(const void* x, const void* gy, void* partial, const Geom& g,
          int splits, long long chunk, cudaStream_t s) {
  const bool vec_x = g.C % Tile<T>::VEC == 0 && aligned16(x);
  const bool vec_g = g.Co % Tile<T>::VEC == 0 && aligned16(gy);
  const dim3 grid((g.K + BM - 1) / BM, (g.Co + BN - 1) / BN, splits);
  conv3x3_wgrad_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy),
      static_cast<float*>(partial), g, chunk, vec_x, vec_g);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ the wgmma kernels

constexpr int kStages = 4;                // ring depth
constexpr int kWThreads = 256;            // two consumer warpgroups
constexpr int kTileRows = 128;            // forward: pixels; wgrad: rows of 9C
constexpr int kStep = 64;                 // k-tile (forward) / pixel step (wgrad)
constexpr int kLine = 128;                // bytes of one swizzled smem line

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 8 bytes from global to shared memory; src_size 0 writes zeros.  L1:
// through L1 (.ca), for the im2col reads, which the nine taps repeat; else
// L2 only (.cg).
template <int BYTES, bool L1 = false>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool ok) {
  if constexpr (BYTES == 16 && L1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0) : "memory");
  else if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// makes this thread's completed cp.async writes visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads and writes across wgmma
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  The tiles are
// made of 1024-byte atoms of eight 128-byte lines; 16-byte chunk c of line l
// is stored at chunk c ^ (l & 7).  K-major (forward): a line is 64 k of one
// row, SBO the stride of 8 rows (1024), LBO unused.  MN-major (wgrad): a
// line is 64 rows (or columns) of one k (pixel), SBO the stride of 8 k
// (1024), LBO the stride to the next 64 rows (64 lines, 8192).
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The same without swizzle, K-major: the core matrices are 8 rows of 16
// bytes, 128 contiguous bytes; SBO the stride of 8 rows, LBO the stride to
// the next 8 k.  Any 16-byte-aligned start is a valid matrix.
__device__ __forceinline__ uint64_t pdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// byte offset of the 8-byte half h (or 16-byte chunk, h = 0) of element
// column `col` (a multiple of 4) of swizzled line `line`
__device__ __forceinline__ uint32_t swz(int line, int col) {
  return line * kLine + ((((col >> 3) ^ line) & 7) << 4) + ((col & 4) << 1);
}

// D[64 x N] = A . B + (scale_d ? D : 0), bf16 from shared memory, f32 in
// registers: wgmma m64nNk16; TA / TB = 1 reads A / B MN-major.
template <int N, int TA, int TB> struct Wgmma;
template <int TA, int TB> struct Wgmma<8, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, %7, %8;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<16, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<32, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<64, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<128, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<256, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

// n / d for 0 <= n < 2^31: q = umulhi(n, mul) >> shift, with mul = ceil(2^p /
// d), p = 31 + ceil(log2 d) (exact: the rounding error is below 1/d).
struct FastDiv {
  uint32_t d, mul, shift;
  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n : (int)(__umulhi((uint32_t)n, mul) >> shift);
  }
};

FastDiv fast_div(uint32_t d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    uint32_t l = 0;
    while ((1u << l) < d) ++l;
    const uint32_t p = 31 + l;
    f.mul = (uint32_t)(((1ull << p) + d - 1) / d);
    f.shift = p - 32;
  }
  return f;
}

struct WGeom {
  int H, W, C, Co, M, K;   // M = B*H*W < 2^31, K = 9C
  int k_tiles;             // forward: 64-wide k-tiles
  int last_kk;             // forward: 16-deep MMA steps of the last k-tile
  int cblock;              // forward: k-tile kt is tap kt % 9 of channels kt / 9 * 64..
  int w_cols;              // forward: row length of the weight copy (k_tiles*64)
  int tiles_n, tiles;      // forward: column tiles; output (window: position) tiles
  int Wp, BH;              // window forward: padded row length W + 2, B*H
  FastDiv div_w, div_h, div_wp;
};

// The im2col geometry of one 4- or 8-element piece of k: its tap's offset
// from the pixel in elements, and the tap's dy, dx (tap >= 9: padding).
struct Piece {
  int delta, dy, dx;
  bool ok;
  __device__ __forceinline__ Piece(int k, const WGeom& g)
      : Piece(k / g.C, k - k / g.C * g.C, g) {}
  __device__ __forceinline__ Piece(int t, int c, const WGeom& g) {
    dy = t / 3;
    dx = t - 3 * dy;
    ok = t < 9;
    delta = ((dy - 1) * g.W + (dx - 1)) * g.C + c;
  }
  __device__ __forceinline__ bool inside(int y, int x, const WGeom& g) const {
    return ok && (unsigned)(y + dy - 1) < (unsigned)g.H &&
           (unsigned)(x + dx - 1) < (unsigned)g.W;
  }
};

__device__ __forceinline__ void pixel_yx(int m, const WGeom& g, int& y, int& x) {
  const int q = g.div_w(m);
  x = m - q * g.W;
  y = q - g.div_h(q) * g.H;
}

// ------------------------------------------------------------------ forward
// y [M, Co] = A [M, 9C] . wk^T, wk the K-major weight copy [tiles_n*BN,
// w_cols], zero beyond Co and 9C.  Stage s: the A tile (128 lines, one per
// pixel) then the B tile (BN lines, one per output channel), each line 64 k.
// Each thread loads piece j of 4 or 8 rows of A (rows j/PIECES + i*ROW_STEP)
// and chunks tid, tid + 256, ... of B.  Block b computes the output tiles b,
// b + gridDim.x, ...; the loader's cursor runs two k-tiles ahead of the
// warpgroups' and on into the block's next tile.

// A warp's 16 x BN accumulators (row warp*16 + lane/4 + 8h, column 8i +
// 2*(lane%4) + {0, 1}) as bf16 rows of y [M, Co] from column n0: staged in
// the warp's 32*BN bytes of shared memory at ep (16-byte chunk c of row r at
// c ^ (r & SWZ): no bank conflicts), then stored 16 (or, for Co % 8 != 0,
// 8) bytes at a time.  pixel(r) is the row of y of tile row r, or -1 to
// drop it.
template <int BN, typename PixelOf>
__device__ __forceinline__ void store_rows(const float (&acc)[BN / 2],
                                           uint8_t* ep, int lane, bf16* y,
                                           int Co, int n0, PixelOf pixel) {
  constexpr int CPR = BN / 8;                          // 16-byte chunks a row
  constexpr int SWZ = CPR < 8 ? CPR - 1 : 7;
  const int r4 = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < CPR; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r4 + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(
          ep + r * (2 * BN) + ((i ^ (r & SWZ)) << 4) + 4 * q) =
          __floats2bfloat162_rn(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  __syncwarp();
  if (Co % 8 == 0) {
#pragma unroll
    for (int e = lane; e < 16 * CPR; e += 32) {
      const int r = e / CPR, c = e % CPR, m = pixel(r), n = n0 + 8 * c;
      if (m >= 0 && n < Co)
        *reinterpret_cast<uint4*>(y + (long long)m * Co + n) =
            *reinterpret_cast<const uint4*>(ep + r * (2 * BN) +
                                            ((c ^ (r & SWZ)) << 4));
    }
  } else {
#pragma unroll
    for (int e = lane; e < 32 * CPR; e += 32) {
      const int r = e / (2 * CPR), c = (e >> 1) % CPR, m = pixel(r),
                n = n0 + 8 * c + 4 * (e & 1);
      if (m >= 0 && n < Co)
        *reinterpret_cast<uint2*>(y + (long long)m * Co + n) =
            *reinterpret_cast<const uint2*>(
                ep + r * (2 * BN) + ((c ^ (r & SWZ)) << 4) + 8 * (e & 1));
    }
  }
}

// The first N 16-deep steps of a k-tile: A and B K-major, 32 bytes a step.
template <int BN, int N>
__device__ __forceinline__ void kt_steps(float (&acc)[BN / 2], uint32_t sa,
                                         uint32_t sb, bool accumulate) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
    Wgmma<BN, 0, 0>::run(acc, sdesc(sa + kk * 32, 16, 1024),
                         sdesc(sb + kk * 32, 16, 1024), accumulate || kk > 0);
}

template <int BN, int VEC>
__global__ void __launch_bounds__(kWThreads, 1)
conv3x3_fwd_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                  bf16* __restrict__ y, WGeom g) {
  constexpr uint32_t A_BYTES = kTileRows * kLine, STAGE = A_BYTES + BN * kLine;
  constexpr int PIECES = kStep / VEC;                  // pieces per line
  constexpr int ROW_STEP = kWThreads / PIECES;
  constexpr int ROWS = kTileRows / ROW_STEP;           // A rows per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = ((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw);
  const uint32_t base = smem_u32(smem_raw) + pad;
  uint8_t* const ring = smem_raw + pad;                // the same, generic
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int j = tid % PIECES, row0 = tid / PIECES;
  if ((int)blockIdx.x >= g.tiles) return;

  // the loader's cursor: tile, k-tile, stage; its rows' pixels
  int ld_tile = blockIdx.x, ld_kt = 0, ld_stage = 0;
  int ry[ROWS], rx[ROWS];
  const bf16* rp[ROWS];
  auto rows_of = [&](int tile) {
    const int m0 = (tile / g.tiles_n) * kTileRows + row0;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int m = m0 + i * ROW_STEP;
      if (m < g.M) {
        pixel_yx(m, g, ry[i], rx[i]);
        rp[i] = x + (long long)m * g.C;
      } else {                      // past the last pixel: every tap outside
        ry[i] = -4;
        rx[i] = 0;
        rp[i] = x;
      }
    }
  };
  auto load = [&]() {
    if (ld_tile >= g.tiles) return;                    // the block is done
    const uint32_t sa = base + ld_stage * STAGE, sb = sa + A_BYTES;
    const int cb = ld_kt / 9;
    const Piece pc = g.cblock ? Piece(ld_kt - 9 * cb, cb * kStep + j * VEC, g)
                              : Piece(ld_kt * kStep + j * VEC, g);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const bool ok = pc.inside(ry[i], rx[i], g);
      cp_async<2 * VEC, true>(sa + swz(row0 + i * ROW_STEP, j * VEC),
                              ok ? rp[i] + pc.delta : x, ok);
    }
    const bf16* wt = wk + (long long)(ld_tile % g.tiles_n) * BN * g.w_cols
                     + ld_kt * kStep;
#pragma unroll
    for (int i = tid; i < BN * 8; i += kWThreads)
      cp_async<16>(sb + swz(i >> 3, (i & 7) * 8),
                   wt + (long long)(i >> 3) * g.w_cols + (i & 7) * 8, true);
    ld_stage = ld_stage + 1 == kStages ? 0 : ld_stage + 1;
    if (++ld_kt == g.k_tiles) {
      ld_kt = 0;
      ld_tile += gridDim.x;
      if (ld_tile < g.tiles) rows_of(ld_tile);
    }
  };

  rows_of(ld_tile);
#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    load();
    cp_commit();
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  int stage = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    for (int kt = 0; kt < g.k_tiles; ++kt) {
      // this stage's loads have landed (all threads'), and both warpgroups
      // have retired the wgmma of two steps ago, whose stage is refilled now
      cp_wait<kStages - 3>();
      fence_async_smem();
      __syncthreads();
      load();
      cp_commit();

      const uint32_t sa = base + stage * STAGE + wg * (64 * kLine);
      const uint32_t sb = base + stage * STAGE + A_BYTES;
      // the last k-tile runs only the 16-deep steps that reach K (the
      // stem's 108 as 112); a tile's first step overwrites the accumulators
      reg_fence(acc);
      switch (kt + 1 < g.k_tiles ? 4 : g.last_kk) {   // straight-line MMAs
        case 1: kt_steps<BN, 1>(acc, sa, sb, kt > 0); break;
        case 2: kt_steps<BN, 2>(acc, sa, sb, kt > 0); break;
        case 3: kt_steps<BN, 3>(acc, sa, sb, kt > 0); break;
        default: kt_steps<BN, 4>(acc, sa, sb, kt > 0);
      }
      wg_commit();
      wg_wait<1>();
      reg_fence(acc);
      stage = stage + 1 == kStages ? 0 : stage + 1;
    }

    // epilogue: both warpgroups retire their wgmma; then the stages of the
    // last two k-steps are free (none is refilled before the next step's
    // barrier): warpgroup 0 stages its rows in the last, 1 in the one before
    wg_wait<0>();
    reg_fence(acc);
    __syncthreads();
    const int m0 = (tile / g.tiles_n) * kTileRows + wg * 64 + warp * 16;
    store_rows<BN>(acc, ring + ((stage + (wg ? 2 : 3)) % kStages) * STAGE
                            + warp * (32 * BN), lane, y, g.Co,
                   (tile % g.tiles_n) * BN,
                   [&](int r) { return m0 + r < g.M ? m0 + r : -1; });
  }
  cp_wait<0>();
}

// ------------------------------------------- forward, weights resident
// C of 32, 64 or 128, whose weights for a 64-column tile fit in shared
// memory (the stem's dgrad, the 32->64, 64->64 and 128->128 layers): the
// block's weight columns, 9 taps x NCB channel
// blocks of BN lines, are loaded once and stay in shared memory, and x is
// read once per dy instead of once per tap.  The output positions are
// enumerated with the padded row length Wp = W + 2 (positions x = W, W+1
// of a row are computed and dropped), so tap (dy, dx) of position P reads
// input position P + (dy - 1)*Wp + dx: for one dy, the three dx taps read
// one window of 130 positions, shifted by 0, 1, 2.  The window (one channel
// block of 64, or the 32) lies in shared memory unswizzled, the 16-byte
// chunk kc of position j at kc*kWinStride + j*16, and a wgmma descriptor
// reads its 64 rows from any 16-byte shift.  Stage s of the ring is one
// window; a tile of 128 positions x BN columns is 3 * NCB steps, one per
// (channel block, dy), of 3 taps x CH/2 MMAs.  Position j of the window
// of dy belongs to input row R + dy - 1, R being the row of position P0 +
// j, and is zero where that row leaves R's image, or its column is the
// padding.  Block b computes columns (b % tiles_n)*BN.. of the position
// tiles b / tiles_n, + gridDim.x / tiles_n, ... (the grid is a multiple of
// tiles_n).

constexpr int kWin = kTileRows + 2;       // positions a window holds
constexpr int kWinStride = 137 * 16;      // >= kWin*16, 16 mod 128: the
                                          // loads' quarter-warps hit 8 banks

template <int BN, int CH>
__device__ __forceinline__ void window_steps(float (&acc)[BN / 2], uint32_t sa,
                                             uint32_t sw, bool accumulate) {
  wg_fence();
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int kk = 0; kk < CH / 2; ++kk)
      Wgmma<BN, 0, 0>::run(
          acc, pdesc(sa + dx * 16 + kk * 2 * kWinStride, kWinStride, 128),
          sdesc(sw + dx * BN * kLine + kk * 32, 16, 1024),
          accumulate || dx > 0 || kk > 0);
}

template <int BN, int CH, int NCB>
__global__ void __launch_bounds__(kWThreads, 1)
conv3x3_fwd_window(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                   bf16* __restrict__ y, WGeom g) {
  constexpr int C = CH * 8 * NCB, C_BLK = CH * 8, STEPS = 3 * NCB;
  constexpr uint32_t W_BYTES = 9 * NCB * BN * kLine, STAGE = CH * kWinStride;
  constexpr int UNITS = (kWin * CH + kWThreads - 1) / kWThreads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = ((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw);
  const uint32_t wbase = smem_u32(smem_raw) + pad, abase = wbase + W_BYTES;
  uint8_t* const ring = smem_raw + pad + W_BYTES;      // the same, generic
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int n0 = (blockIdx.x % g.tiles_n) * BN;
  const int first = blockIdx.x / g.tiles_n, stride = gridDim.x / g.tiles_n;
  if (first >= g.tiles) return;

  // the weights: line kt*BN + n holds k-tile kt (tap kt % 9 of channel
  // block kt / 9) of output channel n0 + n
  for (int i = tid; i < 9 * NCB * BN * CH; i += kWThreads)
    cp_async<16>(wbase + swz(i / CH, (i % CH) * 8),
                 wk + (long long)(n0 + i / CH % BN) * g.w_cols +
                     i / CH / BN * C_BLK + (i % CH) * 8, true);

  // the loader's cursor: tile, channel block, dy, stage; unit i of this
  // thread is chunk e % CH of window position e / CH, e = tid + i*256: its
  // input pixel offset at dy = 1, the row's y, and whether the column is
  // inside
  int ld_tile = first, ld_step = 0, ld_stage = 0;
  long long off[UNITS];
  int yr[UNITS];
  bool inside[UNITS];
  auto window_of = [&](int tile) {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int e = tid + i * kWThreads, q = tile * kTileRows + e / CH;
      const int r = g.div_wp(q), u = q - r * g.Wp;
      yr[i] = r - g.div_h(r) * g.H;
      inside[i] = e < kWin * CH && u >= 1 && u <= g.W && r < g.BH;
      off[i] = ((long long)r * g.W + u - 1) * C + (e % CH) * 8;
    }
  };
  auto load = [&]() {
    if (ld_tile >= g.tiles) return;                    // the block is done
    const uint32_t sa = abase + ld_stage * STAGE;
    const int cb = ld_step / 3, dy = ld_step - 3 * cb;
    const long long shift = (long long)(dy - 1) * g.W * C + cb * C_BLK;
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int e = tid + i * kWThreads;
      if (i + 1 < UNITS || e < kWin * CH) {
        const bool ok = inside[i] && (unsigned)(yr[i] + dy - 1) < (unsigned)g.H;
        cp_async<16, true>(sa + (e % CH) * kWinStride + (e / CH) * 16,
                           ok ? x + off[i] + shift : x, ok);
      }
    }
    ld_stage = ld_stage + 1 == kStages ? 0 : ld_stage + 1;
    if (++ld_step == STEPS) {
      ld_step = 0;
      ld_tile += stride;
      if (ld_tile < g.tiles) window_of(ld_tile);
    }
  };

  window_of(ld_tile);
#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {              // the weights ride
    load();                                            // in the first group
    cp_commit();
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  int stage = 0;
  for (int tile = first; tile < g.tiles; tile += stride) {
    for (int step = 0; step < STEPS; ++step) {
      // as conv3x3_fwd_wgmma: this window has landed, and the one read two
      // steps ago is retired by both warpgroups, so it is refilled now
      cp_wait<kStages - 3>();
      fence_async_smem();
      __syncthreads();
      load();
      cp_commit();
      reg_fence(acc);
      window_steps<BN, CH>(acc, abase + stage * STAGE + wg * 64 * 16,
                           wbase + step * 3 * BN * kLine, step > 0);
      wg_commit();
      wg_wait<1>();
      reg_fence(acc);
      stage = stage + 1 == kStages ? 0 : stage + 1;
    }

    // epilogue, as conv3x3_fwd_wgmma's; row r of the tile is position P,
    // pixel (P / Wp) * W + P % Wp unless P % Wp >= W
    wg_wait<0>();
    reg_fence(acc);
    __syncthreads();
    const int p0 = tile * kTileRows + wg * 64 + warp * 16;
    store_rows<BN>(acc, ring + ((stage + (wg ? 2 : 3)) % kStages) * STAGE
                            + warp * (32 * BN), lane, y, g.Co, n0,
                   [&](int r) {
                     const int row = g.div_wp(p0 + r), u = p0 + r - row * g.Wp;
                     return u < g.W && row < g.BH ? row * g.W + u : -1;
                   });
  }
  cp_wait<0>();
}

// ------------------------------------------------------------------- wgrad
// Block (bx, by, bz): dw rows bx*128.. (of 9C), columns by*BN.., the pixels
// of chunk bz in steps of 64.  Stage s: A (x) then B (g), both MN-major:
// line mi*64 + p holds rows mi*64.. of pixel p; B likewise per 64 columns.
// Thread: piece ja of 4 or 8 A pixels, piece jb of 2..4 B pixels.

template <int BN, int VA, int VG>
__global__ void __launch_bounds__(kWThreads, 1)
conv3x3_wgrad_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                    float* __restrict__ partial, WGeom g, int chunk) {
  constexpr uint32_t A_BYTES = kTileRows * kLine, STAGE = A_BYTES + BN * kLine;
  constexpr int PA = kTileRows / VA, A_STEP = kWThreads / PA, A_PIX = kStep / A_STEP;
  constexpr int PB = BN / VG, B_STEP = kWThreads / PB, B_PIX = kStep / B_STEP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int r0 = blockIdx.x * kTileRows, c0 = blockIdx.y * BN;
  const int p_begin = blockIdx.z * chunk;
  const int p_end = min(p_begin + chunk, g.M);
  const int steps = (p_end - p_begin + kStep - 1) / kStep;

  const int ja = tid % PA, pa = tid / PA;
  const int jb = tid % PB, pb = tid / PB;
  const int ka = ja * VA, kb = jb * VG;                 // within the tile
  const Piece pc(r0 + ka, g);
  const bool a_ok = r0 + ka < g.K, b_ok = c0 + kb < g.Co;
  const uint32_t a_off = swz((ka >> 6) * 64 + pa, ka & 63);
  const uint32_t b_off = swz((kb >> 6) * 64 + pb, kb & 63);
  const bf16* gcol = gy + c0 + kb;

  int ld_stage = 0, ld_p = p_begin, ld_left = steps;
  auto load = [&]() {
    const uint32_t sa = base + ld_stage * STAGE, sb = sa + A_BYTES;
#pragma unroll
    for (int i = 0; i < A_PIX; ++i) {
      const int m = ld_p + pa + i * A_STEP;
      int yy, xx;
      pixel_yx(m, g, yy, xx);
      const bool ok = a_ok && m < p_end && pc.inside(yy, xx, g);
      // line pa + i*A_STEP: the same swizzle phase as pa (A_STEP % 8 == 0)
      cp_async<2 * VA, true>(sa + a_off + i * A_STEP * kLine,
                             ok ? x + (long long)m * g.C + pc.delta : x, ok);
    }
#pragma unroll
    for (int i = 0; i < B_PIX; ++i) {
      const int m = ld_p + pb + i * B_STEP;
      const bool ok = b_ok && m < p_end;
      cp_async<2 * VG>(sb + b_off + i * B_STEP * kLine,
                       ok ? gcol + (long long)m * g.Co : gy, ok);
    }
    ld_stage = ld_stage + 1 == kStages ? 0 : ld_stage + 1;
    ld_p += kStep;
    --ld_left;
  };

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (ld_left > 0) load();
    cp_commit();
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  int stage = 0;
  for (int step = 0; step < steps; ++step) {
    cp_wait<kStages - 3>();
    fence_async_smem();
    __syncthreads();
    if (ld_left > 0) load();
    cp_commit();
    const uint32_t sa = base + stage * STAGE + wg * (64 * kLine);
    const uint32_t sb = base + stage * STAGE + A_BYTES;
    reg_fence(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)      // 16 pixels = two 8-pixel atoms
      Wgmma<BN, 1, 1>::run(acc, sdesc(sa + kk * 2048, 64 * kLine, 1024),
                           sdesc(sb + kk * 2048, 64 * kLine, 1024), 1);
    wg_commit();
    wg_wait<1>();
    reg_fence(acc);
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
  wg_wait<0>();
  reg_fence(acc);
  cp_wait<0>();

  float* out = partial + (long long)blockIdx.z * g.K * g.Co;
  const int r = r0 + wg * 64 + warp * 16 + (lane >> 2);
  const int n0 = c0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h, n = n0 + 8 * i;
      if (rr < g.K && n < g.Co)
        *reinterpret_cast<float2*>(out + (long long)rr * g.Co + n) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
}

// ------------------------------------------------- wgrad, windows of x
// C of 32 or a multiple of 64, Co a multiple of 8: the pixels are the
// padded positions of the window forward (row length Wp = W + 2, g zero at
// the two extra positions of a row), so tap (dy, dx) pairs g at position P
// with x at P + (dy - 1)*Wp + dx.  A step of 64 positions loads g once
// (MN-major, 128-byte swizzle, as conv3x3_wgrad_wgmma's B) and, per dy,
// one window of 66 positions of x: channel block bx (64 channels, or the
// 32) of the three input rows, unswizzled as in the window forward, 16-byte
// chunk kc of position j at kc*kGradStride + j*16.  Warpgroup dy computes
// the dw rows of taps (dy, 0..2) from its window shifted by dx, wgmma
// reading it MN-major from any 16-byte shift (LBO 128: 8 positions; SBO
// kGradStride: 8 channels).  Block (bx, by, bz): channel block bx, columns
// by*64.., the positions of chunk bz.  x is read 3 times per position where
// conv3x3_wgrad_wgmma reads it 9 times, and g once per channel block.

constexpr int kGThreads = 384;            // three consumer warpgroups
constexpr int kGWin = kStep + 2;          // positions a window holds
constexpr int kGradStride = 73 * 16;      // >= kGWin*16, 16 mod 128
constexpr uint32_t kGWinBytes = 8 * kGradStride;   // 8 chunk rows (m64)
constexpr uint32_t kGStage = 28672 + kStep * kLine; // 3 windows, 1 KB-aligned; g

template <int CH>
__global__ void __launch_bounds__(kGThreads, 1)
conv3x3_wgrad_window(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                     float* __restrict__ partial, WGeom g, int chunk) {
  static_assert(3 * kGWinBytes <= 28672, "windows overlap g");
  constexpr int C_BLK = CH * 8;
  constexpr int X_UNITS = (kGWin * CH + kGThreads - 1) / kGThreads;
  constexpr int G_UNITS = (kStep * 8 + kGThreads - 1) / kGThreads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int c0 = blockIdx.x * C_BLK, n0 = blockIdx.y * 64;
  const int positions = g.BH * g.Wp;
  const int p_begin = blockIdx.z * chunk;
  const int p_end = min(p_begin + chunk, positions);
  const int steps = (p_end - p_begin + kStep - 1) / kStep;

  // C = 32 fills chunk rows 0..3 of a window; the m64 MMA also reads rows
  // 4..7, whose dw rows the epilogue drops: zero them once in every stage
  // so that they read no stale data (the first step's fence publishes them)
  if constexpr (CH < 8) {
    uint8_t* const ring = smem_raw + (base - smem_u32(smem_raw));
    constexpr int PAD = 8 - CH, Z = kStages * 3 * PAD * kGWin;
    for (int i = tid; i < Z; i += kGThreads) {
      const int j = i % kGWin, kc = CH + i / kGWin % PAD, win = i / kGWin / PAD;
      *reinterpret_cast<uint4*>(ring + win / 3 * kGStage + win % 3 * kGWinBytes +
                                kc * kGradStride + j * 16) = make_uint4(0, 0, 0, 0);
    }
  }

  int ld_stage = 0, ld_p = p_begin, ld_left = steps;
  auto load = [&]() {
    const uint32_t sw = base + ld_stage * kGStage, sg = sw + 28672;
    // x: position ld_p + j of the dy = 1 window, its chunk kc; then the
    // same chunk of the dy = 0 and dy = 2 windows, one row up and down
#pragma unroll
    for (int i = 0; i < X_UNITS; ++i) {
      const int e = tid + i * kGThreads;
      if (i + 1 < X_UNITS || e < kGWin * CH) {
        const int q = ld_p + e / CH, kc = e % CH;
        const int r = g.div_wp(q), u = q - r * g.Wp;
        const int yr = r - g.div_h(r) * g.H;
        const bool in = u >= 1 && u <= g.W && r < g.BH;
        const bf16* src = x + ((long long)r * g.W + u - 1) * g.C + c0 + kc * 8;
        const uint32_t dst = sw + kc * kGradStride + (e / CH) * 16;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const bool ok = in && (unsigned)(yr + dy - 1) < (unsigned)g.H;
          cp_async<16, true>(dst + dy * kGWinBytes,
                             ok ? src + (long long)(dy - 1) * g.W * g.C : x,
                             ok);
        }
      }
    }
    // g: chunk kc (8 columns) of position ld_p + p, zero off the grid
#pragma unroll
    for (int i = 0; i < G_UNITS; ++i) {
      const int e = tid + i * kGThreads;
      if (i + 1 < G_UNITS || e < kStep * 8) {
        const int q = ld_p + (e >> 3), kc = e & 7;
        const int r = g.div_wp(q), u = q - r * g.Wp;
        const bool ok = q < p_end && u < g.W && r < g.BH && n0 + kc * 8 < g.Co;
        cp_async<16>(sg + swz(e >> 3, kc * 8),
                     ok ? gy + ((long long)r * g.W + u) * g.Co + n0 + kc * 8
                        : gy, ok);
      }
    }
    ld_stage = ld_stage + 1 == kStages ? 0 : ld_stage + 1;
    ld_p += kStep;
    --ld_left;
  };

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (ld_left > 0) load();
    cp_commit();
  }
  float acc[3][32];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.0f;
  int stage = 0;
  for (int step = 0; step < steps; ++step) {
    cp_wait<kStages - 3>();
    fence_async_smem();
    __syncthreads();
    if (ld_left > 0) load();
    cp_commit();
    const uint32_t sw = base + stage * kGStage + wg * kGWinBytes;
    const uint32_t sg = base + stage * kGStage + 28672;
#pragma unroll
    for (int t = 0; t < 3; ++t) reg_fence(acc[t]);
    wg_fence();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)          // 16 positions a step
        Wgmma<64, 1, 1>::run(acc[dx],
                             pdesc(sw + (dx + 16 * kk) * 16, 128, kGradStride),
                             sdesc(sg + kk * 2048, 64 * kLine, 1024), 1);
    wg_commit();
    wg_wait<1>();
#pragma unroll
    for (int t = 0; t < 3; ++t) reg_fence(acc[t]);
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
  wg_wait<0>();
#pragma unroll
  for (int t = 0; t < 3; ++t) reg_fence(acc[t]);
  cp_wait<0>();

  // rows of dw: tap 3*wg + dx, channel c0 + warp*16 + lane/4 (+8)
  float* out = partial + (long long)blockIdx.z * g.K * g.Co;
  const int c = c0 + warp * 16 + (lane >> 2);
  const int n = n0 + 2 * (lane & 3);
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cc = c + 8 * h, nn = n + 8 * i;
        if (cc < c0 + C_BLK && cc < g.C && nn < g.Co)
          *reinterpret_cast<float2*>(
              out + ((long long)(3 * wg + dx) * g.C + cc) * g.Co + nn) =
              make_float2(acc[dx][4 * i + 2 * h], acc[dx][4 * i + 2 * h + 1]);
      }
}

// ------------------------------------------------------------ host helpers

// the ring, and 1 KB to align it to the 1024-byte swizzle atoms
constexpr int smem_bytes(int bn) { return kStages * (kTileRows + bn) * kLine + 1024; }

bool wgeom(WGeom& g, int B, int H, int W, int C, int Co) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 4 || Co % 4)
    return false;
  const long long M = (long long)B * H * W;
  if (M >= (1LL << 31) - 2 * kTileRows || 9LL * C >= (1 << 30) ||
      (long long)(W + 2) * C >= (1 << 30))
    return false;
  g = WGeom{};
  g.H = H; g.W = W; g.C = C; g.Co = Co; g.M = (int)M; g.K = 9 * C;
  g.div_w = fast_div(W);
  g.div_h = fast_div(H);
  return true;
}

template <int BN, int VEC>
int fwd_wgmma(const void* x, const void* wk, void* y, const WGeom& g, int grid,
              cudaStream_t s) {
  auto kernel = conv3x3_fwd_wgmma<BN, VEC>;
  const int smem = smem_bytes(BN);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kWThreads, smem, s>>>(static_cast<const bf16*>(x),
                                       static_cast<const bf16*>(wk),
                                       static_cast<bf16*>(y), g);
  return (int)cudaGetLastError();
}

template <int VEC>
int fwd_wgmma_bn(int bn, const void* x, const void* wk, void* y,
                 const WGeom& g, int grid, cudaStream_t s) {
  switch (bn) {
    case 8: return fwd_wgmma<8, VEC>(x, wk, y, g, grid, s);
    case 16: return fwd_wgmma<16, VEC>(x, wk, y, g, grid, s);
    case 32: return fwd_wgmma<32, VEC>(x, wk, y, g, grid, s);
    case 64: return fwd_wgmma<64, VEC>(x, wk, y, g, grid, s);
    case 128: return fwd_wgmma<128, VEC>(x, wk, y, g, grid, s);
    case 256: return fwd_wgmma<256, VEC>(x, wk, y, g, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}

constexpr int window_smem_bytes(int bn, int ch, int ncb) {
  return 9 * ncb * bn * kLine + kStages * ch * kWinStride + 1024;
}

template <int BN, int CH, int NCB>
int fwd_window(const void* x, const void* wk, void* y, const WGeom& g, int grid,
               cudaStream_t s) {
  auto kernel = conv3x3_fwd_window<BN, CH, NCB>;
  const int smem = window_smem_bytes(BN, CH, NCB);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kWThreads, smem, s>>>(static_cast<const bf16*>(x),
                                       static_cast<const bf16*>(wk),
                                       static_cast<bf16*>(y), g);
  return (int)cudaGetLastError();
}

template <int CH, int NCB>
int fwd_window_bn(int bn, const void* x, const void* wk, void* y,
                  const WGeom& g, int grid, cudaStream_t s) {
  switch (bn) {
    case 8: return fwd_window<8, CH, NCB>(x, wk, y, g, grid, s);
    case 16: return fwd_window<16, CH, NCB>(x, wk, y, g, grid, s);
    case 32: return fwd_window<32, CH, NCB>(x, wk, y, g, grid, s);
    case 64: return fwd_window<64, CH, NCB>(x, wk, y, g, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int BN, int VA, int VG>
int wgrad_wgmma(const void* x, const void* gy, void* partial, const WGeom& g,
                dim3 grid, int chunk, cudaStream_t s) {
  auto kernel = conv3x3_wgrad_wgmma<BN, VA, VG>;
  const int smem = smem_bytes(BN);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kWThreads, smem, s>>>(static_cast<const bf16*>(x),
                                       static_cast<const bf16*>(gy),
                                       static_cast<float*>(partial), g, chunk);
  return (int)cudaGetLastError();
}

template <int BN>
int wgrad_wgmma_vec(int va, int vg, const void* x, const void* gy,
                    void* partial, const WGeom& g, dim3 grid, int chunk,
                    cudaStream_t s) {
  if (va == 8 && vg == 8) return wgrad_wgmma<BN, 8, 8>(x, gy, partial, g, grid, chunk, s);
  if (va == 8 && vg == 4) return wgrad_wgmma<BN, 8, 4>(x, gy, partial, g, grid, chunk, s);
  if (va == 4 && vg == 8) return wgrad_wgmma<BN, 4, 8>(x, gy, partial, g, grid, chunk, s);
  if (va == 4 && vg == 4) return wgrad_wgmma<BN, 4, 4>(x, gy, partial, g, grid, chunk, s);
  return (int)cudaErrorInvalidValue;
}

int vec_of(int c) { return c % 8 == 0 ? 8 : 4; }

}  // namespace

// All launchers run on `stream`, take contiguous tensors on the current
// device, and return cudaGetLastError() (0 = launched).  dtype 0 is f32,
// 1 is bf16 (x, w, y, g alike); partial and dw are f32.

// y [B,H,W,Co] = conv3x3_s1(x [B,H,W,C], w [3,3,C,Co]).
extern "C" int conv3x3_fwd_launch(const void* x, const void* w, void* y, int B,
                                  int H, int W, int C, int Co, int dtype,
                                  void* stream) {
  Geom g;
  if (!geom(g, B, H, W, C, Co)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, w, y, g, s);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, w, y, g, s);
  return (int)cudaErrorInvalidValue;
}

// partial [splits, 9C, Co] f32: chunk s sums pixels [s*chunk, (s+1)*chunk).
extern "C" int conv3x3_wgrad_launch(const void* x, const void* gy,
                                    void* partial, int B, int H, int W, int C,
                                    int Co, int splits, long long chunk,
                                    int dtype, void* stream) {
  Geom g;
  if (!geom(g, B, H, W, C, Co) || splits <= 0 || splits > 65535 ||
      chunk <= 0 || chunk % BK != 0 || (splits - 1) * chunk >= g.M ||
      splits * chunk < g.M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return wgrad<float>(x, gy, partial, g, splits, chunk, s);
  if (dtype == 1)
    return wgrad<__nv_bfloat16>(x, gy, partial, g, splits, chunk, s);
  return (int)cudaErrorInvalidValue;
}

// partial [splits, 9C, Co] f32 from x [B,H,W,C] and gy [B,H,W,Co] bf16, C 32
// or a multiple of 64, Co a multiple of 8, on the window kernel: chunk s
// sums positions [s*chunk, (s+1)*chunk) of the padded [B*H, W+2] grid,
// chunk a multiple of 64.  x, gy 16-byte aligned.  smem: the block's
// dynamic shared memory as the caller's plan has it.
extern "C" int conv3x3_wgrad_window_launch(const void* x, const void* gy,
                                           void* partial, int B, int H, int W,
                                           int C, int Co, int splits,
                                           int chunk, int smem, void* stream) {
  WGeom g;
  const long long positions = (long long)B * H * (W + 2);
  if (smem != kStages * (int)kGStage + 1024 || !wgeom(g, B, H, W, C, Co) ||
      (C != 32 && C % 64) || Co % 8 ||
      positions >= (1LL << 31) - 2 * kTileRows || splits <= 0 ||
      splits > 65535 || chunk <= 0 || chunk % kStep ||
      (long long)(splits - 1) * chunk >= positions ||
      (long long)splits * chunk < positions || !aligned16(x) ||
      !aligned16(gy) || (Co + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  g.Wp = W + 2;
  g.BH = B * H;
  g.div_wp = fast_div(g.Wp);
  const dim3 grid(C == 32 ? 1 : C / 64, (Co + 63) / 64, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = C == 32 ? conv3x3_wgrad_window<4> : conv3x3_wgrad_window<8>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kGThreads, smem, s>>>(static_cast<const bf16*>(x),
                                       static_cast<const bf16*>(gy),
                                       static_cast<float*>(partial), g, chunk);
  return (int)cudaGetLastError();
}

// dw [n] f32 = sum of partial [splits, n] over its first axis, in order.
extern "C" int conv3x3_wgrad_reduce_launch(const void* partial, void* dw, int n,
                                           int splits, void* stream) {
  if (n <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  conv3x3_wgrad_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), n, splits);
  return (int)cudaGetLastError();
}

// y [B,H,W,Co] bf16 = conv3x3_s1(x [B,H,W,C] bf16, w), C and Co multiples
// of 4, on the wgmma kernel: wk is the K-major weight copy [ceil(Co/bn)*bn,
// ceil(9C/64)*64] bf16, zero beyond Co and 9C; bn a power of two in
// [8, 256]; `grid` persistent blocks, at most one per 128-pixel x bn tile.
// x, wk, y 16-byte aligned.  smem as for conv3x3_wgrad_window_launch.
extern "C" int conv3x3_fwd_wgmma_launch(const void* x, const void* wk, void* y,
                                        int B, int H, int W, int C, int Co,
                                        int bn, int grid, int smem,
                                        void* stream) {
  WGeom g;
  if (!wgeom(g, B, H, W, C, Co) || bn < 8 || bn > 256 || (bn & (bn - 1)) ||
      smem != smem_bytes(bn) || !aligned16(x) || !aligned16(wk) ||
      !aligned16(y))
    return (int)cudaErrorInvalidValue;
  g.k_tiles = (g.K + kStep - 1) / kStep;
  g.last_kk = (g.K - (g.k_tiles - 1) * kStep + 15) / 16;
  g.cblock = C % kStep == 0;
  g.w_cols = g.k_tiles * kStep;
  g.tiles_n = (Co + bn - 1) / bn;
  const long long tiles =
      ((long long)g.M + kTileRows - 1) / kTileRows * g.tiles_n;
  if (tiles >= (1LL << 31) || grid <= 0 || grid > tiles)
    return (int)cudaErrorInvalidValue;
  g.tiles = (int)tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec_of(C) == 8 ? fwd_wgmma_bn<8>(bn, x, wk, y, g, grid, s)
                        : fwd_wgmma_bn<4>(bn, x, wk, y, g, grid, s);
}

// y [B,H,W,Co] bf16 = conv3x3_s1(x [B,H,W,C] bf16, w), C 32, 64 or 128, on
// the weights-resident window kernel: wk as for conv3x3_fwd_wgmma_launch;
// bn a power of two in [8, 64]; `grid` persistent blocks, a multiple of
// the ceil(Co/bn) column tiles, at most one per tile of 128 positions of
// the padded [B*H, W+2] grid x bn columns.  x, wk, y 16-byte aligned.
// smem as for conv3x3_wgrad_window_launch.
extern "C" int conv3x3_fwd_window_launch(const void* x, const void* wk,
                                         void* y, int B, int H, int W, int C,
                                         int Co, int bn, int grid, int smem,
                                         void* stream) {
  WGeom g;
  const long long positions = (long long)B * H * (W + 2);
  if (!wgeom(g, B, H, W, C, Co) || (C != 32 && C != 64 && C != 128) ||
      bn < 8 || bn > 64 || (bn & (bn - 1)) ||
      smem != window_smem_bytes(bn, C == 32 ? 4 : 8, C == 128 ? 2 : 1) ||
      positions >= (1LL << 31) - 2 * kTileRows || !aligned16(x) ||
      !aligned16(wk) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  g.Wp = W + 2;
  g.BH = B * H;
  g.div_wp = fast_div(g.Wp);
  g.w_cols = (g.K + kStep - 1) / kStep * kStep;
  g.tiles_n = (Co + bn - 1) / bn;
  g.tiles = (int)((positions + kTileRows - 1) / kTileRows);   // positions'
  if (grid <= 0 || grid % g.tiles_n ||
      (long long)grid > (long long)g.tiles * g.tiles_n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return C == 32   ? fwd_window_bn<4, 1>(bn, x, wk, y, g, grid, s)
         : C == 64 ? fwd_window_bn<8, 1>(bn, x, wk, y, g, grid, s)
                   : fwd_window_bn<8, 2>(bn, x, wk, y, g, grid, s);
}

// partial [splits, 9C, Co] f32 from x [B,H,W,C] and gy [B,H,W,Co] bf16, C
// and Co multiples of 4, on the wgmma kernel: 128 x bn tiles (bn 64 or
// 128); chunk s sums pixels [s*chunk, (s+1)*chunk), chunk a multiple of 64.
// smem as for conv3x3_wgrad_window_launch.
extern "C" int conv3x3_wgrad_wgmma_launch(const void* x, const void* gy,
                                          void* partial, int B, int H, int W,
                                          int C, int Co, int bn, int splits,
                                          int chunk, int smem, void* stream) {
  WGeom g;
  if (!wgeom(g, B, H, W, C, Co) || (bn != 64 && bn != 128) ||
      smem != smem_bytes(bn) || splits <= 0 ||
      splits > 65535 || chunk <= 0 || chunk % kStep != 0 ||
      (long long)(splits - 1) * chunk >= g.M ||
      (long long)splits * chunk < g.M || !aligned16(x) || !aligned16(gy) ||
      (Co + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((g.K + kTileRows - 1) / kTileRows, (Co + bn - 1) / bn,
                  splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int va = vec_of(C), vg = vec_of(Co);
  return bn == 64
      ? wgrad_wgmma_vec<64>(va, vg, x, gy, partial, g, grid, chunk, s)
      : wgrad_wgmma_vec<128>(va, vg, x, gy, partial, g, grid, chunk, s);
}
