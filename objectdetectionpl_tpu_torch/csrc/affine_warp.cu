// Batched inverse affine bilinear warp of gathered slots (shift-scale-rotate
// augmentation): out[k] = use[k] ? warp(images[top[k]], inv[k])
//                                : images[top[k]].
//
// Replaces: objectdetectionpl_tpu/ops/pallas/warp_kernel.py:154
//   affine_warp_batch (pass kernel _pass_kernel :43, pallas_call :124), and
//   with it the slot gather and select around it in
//   objectdetectionpl_tpu/data/augment.py:205-210.
//
// What it computes, for slot k, output pixel (y, x), channel c, with
// m = inv[k] the 3x3 output->input matrix in normalized [0, 1] coordinates
// (the semantics of objectdetectionpl_tpu/data/augment.py::_affine_warp):
//   xx = (x + 0.5) / W,  yy = (y + 0.5) / H            (pixel centers)
//   sx = (m00*xx + m01*yy + m02) * W - 0.5,  sy likewise with row 1 and H
//   inside = 0 <= sx <= W-1 && 0 <= sy <= H-1
//   x0 = (int)clamp(sx, 0, W-1), x1 = min(x0+1, W-1), dx = sx - x0 (y alike)
//   out = inside ? bilinear(images[top[k]], x0, x1, y0, y1, dx, dy)[c] : 0
//
// The TPU kernel splits the warp into two 1-D shear/scale passes done as
// MXU matrix products, because gathers are slow on the TPU; the split adds
// half-texel smoothing and a ~2-texel band at the border.  On Hopper a
// 4-tap gather is cheap, so this kernel computes the exact single-pass
// warp, valid for every matrix (the TPU kernel's range limits on rotation
// and scale do not apply).
//
// What bounds it on an H100: bytes.  It must read each slot's source once
// and write the slot, 2*K*H*W*C*4 bytes (255.6 MB at K=26, 640x640x3:
// ~76 us at 3.35 TB/s); the arithmetic is ~40 flops per pixel.  What held
// the first design (one thread per output pixel, 0.165 ms) back was the
// load/store unit, not memory: each pixel issued 12 four-byte tap loads and
// 3 four-byte stores at a 12-byte stride, each warp instruction spanning
// several cache lines, and under rotation a warp's taps spread over ~25
// source rows; and around it three more full passes (gather, select,
// write-back) moved another ~640 MB.
//
// What the design does about it:
// - 32x32-pixel output tiles, one CTA each; a thread computes a run of 4
//   consecutive pixels of a row, 48 bytes.  When C = 3 and W is a multiple
//   of 4 the warp passes its four rows' results through shared memory and
//   stores them as 16-byte chunks, each store instruction covering whole
//   runs of a row (other shapes store by element).
// - The tile's source footprint is computed from its four corners (each
//   rounded step of sx, sy is monotone in x and in y, so the corners bound
//   every pixel's taps exactly), plus one pixel for the x1/y1 taps, and is
//   staged in shared memory with 16-byte cp.async loads aligned down to 4
//   pixels.  Taps are then gathered from shared memory at a stride of C
//   words (C = 3: conflict-free).  A footprint larger than the staging
//   buffer (30 KB: e.g. scale 0.5 at 60 degrees, and a few percent of the
//   tiles of SSR draws near the AugmentConfig bounds, whose worst footprint
//   is ~34 KB) or with a non-finite corner
//   reads its taps from global memory in the same kernel: exact for every
//   matrix.
// - The slot gather (images[top[k]]) is the kernel's source address and
//   the select is per slot: a slot with use[k] false is a straight copy,
//   16-byte chunks of the tile's rows, the same on load and store.  The write-back stays with the caller (index_copy_): writing in
//   place would race with other slots' reads of the same image.
//
// The coordinate arithmetic uses __f*_rn intrinsics in _affine_warp's
// operation order, so no FMA contraction can move a pixel across the
// inside/outside test or a truncation boundary: the result equals the
// plain PyTorch version's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                       // output tile: kTile x kTile
constexpr int kRun = 4;                         // pixels per thread
constexpr int kThreads = kTile * kTile / kRun;  // 256
constexpr int kStageBytes = 30 * 1024;          // staged source footprint
// C = 3: a warp's 4 tile rows of 32 pixels are 4 x 24 float4 of output,
// passed through shared memory so that each store instruction of the warp
// writes whole rows' runs of 16-byte chunks.
constexpr int kRowChunks = kTile * 3 / 4;             // 24
constexpr int kWarpChunks = 4 * kRowChunks;           // 96
constexpr int kOutBytes = kThreads / 32 * kWarpChunks * 16;   // 12 KB

__device__ __forceinline__ float src_coord(float a, float b, float c,
                                           float xx, float yy, float size) {
  return __fsub_rn(
      __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, xx), __fmul_rn(b, yy)), c),
                size),
      0.5f);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// kVec: C = 3, W a multiple of 4, images and out 16-byte aligned.  Five
// CTAs a SM on that path (42 KB of shared memory, 48 registers each).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kVec ? 5 : 4)
affine_warp_slots_kernel(const float* __restrict__ images, int B,
                         const long long* __restrict__ top,
                         const float* __restrict__ inv,
                         const bool* __restrict__ use,
                         float* __restrict__ out, int H, int W, int Cin) {
  extern __shared__ __align__(16) float stage[];
  const int C = kVec ? 3 : Cin;
  const int k = blockIdx.y;
  const long long src = top[k];
  if (src < 0 || src >= B) __trap();           // as an out-of-range index
  const size_t plane = (size_t)H * W * C;
  const float* img = images + (size_t)src * plane;
  float* o_img = out + (size_t)k * plane;

  const int tiles_x = (W + kTile - 1) / kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int y = ty0 + threadIdx.x / (kTile / kRun);
  const int xb = tx0 + (threadIdx.x % (kTile / kRun)) * kRun;
  const int npx = y < H ? min(kRun, W - xb) : 0;   // pixels of this run

  if (!use[k]) {                                   // the slot as it is
    if constexpr (kVec) {
      // chunk n of the tile: row n / 24, chunk n % 24 of the row's 32 pixels
      const int row_chunks = min(W - tx0, kTile) * 3 / 4;
      float4 v[3];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int n = s * kThreads + threadIdx.x;
        const int r = n / kRowChunks, q = n - r * kRowChunks;
        v[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (ty0 + r < H && q < row_chunks)
          v[s] = __ldg(reinterpret_cast<const float4*>(
                           img + ((size_t)(ty0 + r) * W + tx0) * 3) + q);
      }
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int n = s * kThreads + threadIdx.x;
        const int r = n / kRowChunks, q = n - r * kRowChunks;
        if (ty0 + r < H && q < row_chunks)
          reinterpret_cast<float4*>(
              o_img + ((size_t)(ty0 + r) * W + tx0) * 3)[q] = v[s];
      }
    } else if (npx > 0) {
      const size_t at = ((size_t)y * W + xb) * C;
      for (int e = 0; e < npx * C; ++e) o_img[at + e] = __ldg(img + at + e);
    }
    return;
  }

  const float* m = inv + (size_t)k * 9;
  const float m00 = m[0], m01 = m[1], m02 = m[2];
  const float m10 = m[3], m11 = m[4], m12 = m[5];
  const float fw = (float)W, fh = (float)H;

  // The tile's source footprint from its corners (clipped to the image).
  const int xr = min(tx0 + kTile - 1, W - 1);
  const int yb = min(ty0 + kTile - 1, H - 1);
  const float xl_n = __fdiv_rn(__fadd_rn((float)tx0, 0.5f), fw);
  const float xr_n = __fdiv_rn(__fadd_rn((float)xr, 0.5f), fw);
  const float yt_n = __fdiv_rn(__fadd_rn((float)ty0, 0.5f), fh);
  const float yb_n = __fdiv_rn(__fadd_rn((float)yb, 0.5f), fh);
  const float sx_a = src_coord(m00, m01, m02, xl_n, yt_n, fw);
  const float sx_b = src_coord(m00, m01, m02, xr_n, yt_n, fw);
  const float sx_c = src_coord(m00, m01, m02, xl_n, yb_n, fw);
  const float sx_d = src_coord(m00, m01, m02, xr_n, yb_n, fw);
  const float sy_a = src_coord(m10, m11, m12, xl_n, yt_n, fh);
  const float sy_b = src_coord(m10, m11, m12, xr_n, yt_n, fh);
  const float sy_c = src_coord(m10, m11, m12, xl_n, yb_n, fh);
  const float sy_d = src_coord(m10, m11, m12, xr_n, yb_n, fh);
  const float sx_lo = fminf(fminf(sx_a, sx_b), fminf(sx_c, sx_d));
  const float sx_hi = fmaxf(fmaxf(sx_a, sx_b), fmaxf(sx_c, sx_d));
  const float sy_lo = fminf(fminf(sy_a, sy_b), fminf(sy_c, sy_d));
  const float sy_hi = fmaxf(fmaxf(sy_a, sy_b), fmaxf(sy_c, sy_d));
  const bool finite = isfinite(sx_a) && isfinite(sx_b) && isfinite(sx_c) &&
                      isfinite(sx_d) && isfinite(sy_a) && isfinite(sy_b) &&
                      isfinite(sy_c) && isfinite(sy_d);
  // Taps of inside pixels: x0 in [floor(max(lo, 0)), floor(min(hi, W-1))],
  // x1 <= x0 + 1 (y alike).  No inside pixel: nothing to stage.
  const bool any_inside = finite && sx_hi >= 0.0f && sx_lo <= fw - 1.0f &&
                          sy_hi >= 0.0f && sy_lo <= fh - 1.0f;
  int gx0 = 0, sw = 0, fy0 = 0, sh = 0;
  if (any_inside) {
    const int fx0 = (int)fmaxf(sx_lo, 0.0f);
    const int fx1 = min((int)fminf(sx_hi, fw - 1.0f) + 1, W - 1);
    fy0 = (int)fmaxf(sy_lo, 0.0f);
    const int fy1 = min((int)fminf(sy_hi, fh - 1.0f) + 1, H - 1);
    gx0 = kVec ? fx0 & ~(kRun - 1) : fx0;
    const int gx1 = kVec ? fx1 | (kRun - 1) : fx1;   // <= W-1: W % 4 == 0
    sw = gx1 - gx0 + 1;
    sh = fy1 - fy0 + 1;
  }
  const bool staged =
      any_inside && (size_t)sw * sh * C * sizeof(float) <= kStageBytes;
  if (staged) {
    if constexpr (kVec) {
      const int per_row = sw * 3 / 4;                // 16-byte chunks
      for (int i = threadIdx.x; i < per_row * sh; i += kThreads) {
        const int r = i / per_row;
        const int q = i - r * per_row;
        cp_async16(stage + (size_t)r * sw * 3 + q * 4,
                   img + ((size_t)(fy0 + r) * W + gx0) * 3 + q * 4);
      }
      asm volatile("cp.async.wait_all;\n" ::);
    } else {
      const int per_row = sw * C;
      for (int i = threadIdx.x; i < per_row * sh; i += kThreads) {
        const int r = i / per_row;
        const int q = i - r * per_row;
        stage[i] = __ldg(img + ((size_t)(fy0 + r) * W + gx0) * C + q);
      }
    }
  }
  __syncthreads();
  if (!kVec && npx <= 0) return;

  const float yy = __fdiv_rn(__fadd_rn((float)y, 0.5f), fh);
  float res[kVec ? kRun * 3 : 1];
#pragma unroll
  for (int p = 0; p < (kVec ? kRun : npx); ++p) {
    const int x = xb + p;
    const float xx = __fdiv_rn(__fadd_rn((float)x, 0.5f), fw);
    const float sx = src_coord(m00, m01, m02, xx, yy, fw);
    const float sy = src_coord(m10, m11, m12, xx, yy, fh);
    // (kVec: a run past the image's last row or column computes and is
    // not stored)
    const bool inside = sx >= 0.0f && sx <= fw - 1.0f && sy >= 0.0f &&
                        sy <= fh - 1.0f && (!kVec || npx > 0);
    float* o = o_img + ((size_t)y * W + x) * C;
    if (!inside) {
      for (int c = 0; c < C; ++c) {
        if constexpr (kVec) res[p * 3 + c] = 0.0f; else o[c] = 0.0f;
      }
      continue;
    }
    // inside: sx, sy already lie in [0, W-1] x [0, H-1], so the clamp is a
    // no-op and truncation is the floor.
    const int x0 = (int)sx;
    const int y0 = (int)sy;
    const int x1 = min(x0 + 1, W - 1);
    const int y1 = min(y0 + 1, H - 1);
    const float dx = __fsub_rn(sx, (float)x0);
    const float dy = __fsub_rn(sy, (float)y0);
    const float omdx = __fsub_rn(1.0f, dx);
    const float omdy = __fsub_rn(1.0f, dy);
    const float *p00, *p01, *p10, *p11;
    if (staged) {
      p00 = stage + ((size_t)(y0 - fy0) * sw + (x0 - gx0)) * C;
      p01 = stage + ((size_t)(y0 - fy0) * sw + (x1 - gx0)) * C;
      p10 = stage + ((size_t)(y1 - fy0) * sw + (x0 - gx0)) * C;
      p11 = stage + ((size_t)(y1 - fy0) * sw + (x1 - gx0)) * C;
    } else {
      p00 = img + ((size_t)y0 * W + x0) * C;
      p01 = img + ((size_t)y0 * W + x1) * C;
      p10 = img + ((size_t)y1 * W + x0) * C;
      p11 = img + ((size_t)y1 * W + x1) * C;
    }
    for (int c = 0; c < C; ++c) {
      const float top_ =
          __fadd_rn(__fmul_rn(p00[c], omdx), __fmul_rn(p01[c], dx));
      const float bot =
          __fadd_rn(__fmul_rn(p10[c], omdx), __fmul_rn(p11[c], dx));
      const float v = __fadd_rn(__fmul_rn(top_, omdy), __fmul_rn(bot, dy));
      if constexpr (kVec) res[p * 3 + c] = v; else o[c] = v;
    }
  }
  if constexpr (kVec) {
    // through shared memory: lane l's three chunks, then chunks l, 32 + l
    // and 64 + l of the warp's four rows
    float4* obuf = reinterpret_cast<float4*>(
                       reinterpret_cast<unsigned char*>(stage) + kStageBytes) +
                   (threadIdx.x >> 5) * kWarpChunks;
    const int lane = threadIdx.x & 31;
    const int mine = (lane >> 3) * kRowChunks + (lane & 7) * 3;
    obuf[mine] = make_float4(res[0], res[1], res[2], res[3]);
    obuf[mine + 1] = make_float4(res[4], res[5], res[6], res[7]);
    obuf[mine + 2] = make_float4(res[8], res[9], res[10], res[11]);
    __syncwarp();
    const int row_chunks = min(W - tx0, kTile) * 3 / 4;
    const int row0 = ty0 + (threadIdx.x >> 5) * 4;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int n = s * 32 + lane;
      const int r = n / kRowChunks, q = n - r * kRowChunks;
      if (row0 + r < H && q < row_chunks)
        reinterpret_cast<float4*>(
            o_img + ((size_t)(row0 + r) * W + tx0) * 3)[q] = obuf[n];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// images [B, H, W, C] f32, top [K] i64 (each in [0, B)), inv [K, 3, 3] f32,
// use [K] bool, out [K, H, W, C] f32; all contiguous on the current device.
// vec != 0 asks for the 16-byte path: C = 3, W % 4 == 0, images and out
// 16-byte aligned.
extern "C" int affine_warp_slots_launch(const void* images, int B,
                                        const void* top, const void* inv,
                                        const void* use, void* out, int K,
                                        int H, int W, int C, int vec,
                                        void* stream) {
  if (B <= 0 || K <= 0 || H <= 0 || W <= 0 || C <= 0 || K > 65535 ||
      (long long)H * W * C > 0x7fffffffLL ||
      (vec && (C != 3 || W % kRun != 0)))
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)((W + kTile - 1) / kTile) * ((H + kTile - 1) / kTile);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, K);
  auto* fn = vec ? affine_warp_slots_kernel<true>
                 : affine_warp_slots_kernel<false>;
  fn<<<grid, kThreads, kStageBytes + (vec ? kOutBytes : 0),
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(images), B,
      static_cast<const long long*>(top), static_cast<const float*>(inv),
      static_cast<const bool*>(use), static_cast<float*>(out), H, W, C);
  return (int)cudaGetLastError();
}
