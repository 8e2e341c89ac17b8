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
// What bounds it on an H100: operations for every layer of YOLOv5s-640 but
// the stem, whose 12 input channels make it bound by bytes (2*9*C*Co flops
// per output pixel against (C + Co) * 2 bytes).  The design is the simple
// one: 128x64 output tiles, 8 warps of 32x32, k-steps of 32 staged in
// shared memory with the next step's global loads held in registers while
// the current one is multiplied; bf16 on mma.sync m16n8k16 with f32
// accumulators, f32 on FMA in the same thread layout.  wgmma, TMA and a
// multi-stage shared-memory ring are later work.
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

// dw [n] f32 = sum of partial [splits, n] over its first axis, in order.
extern "C" int conv3x3_wgrad_reduce_launch(const void* partial, void* dw, int n,
                                           int splits, void* stream) {
  if (n <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  conv3x3_wgrad_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), n, splits);
  return (int)cudaGetLastError();
}
