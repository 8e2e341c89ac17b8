// Batched inverse affine bilinear warp (shift-scale-rotate augmentation),
// one thread per output pixel.
//
// Replaces: objectdetectionpl_tpu/ops/pallas/warp_kernel.py:154
//   affine_warp_batch (pass kernel _pass_kernel :43, pallas_call :124).
//
// What it computes, for slot k, output pixel (y, x), channel c, with
// m = inv[k] the 3x3 output->input matrix in normalized [0, 1] coordinates
// (the semantics of objectdetectionpl_tpu/data/augment.py::_affine_warp):
//   xx = (x + 0.5) / W,  yy = (y + 0.5) / H            (pixel centers)
//   sx = (m00*xx + m01*yy + m02) * W - 0.5,  sy likewise with row 1 and H
//   inside = 0 <= sx <= W-1 && 0 <= sy <= H-1
//   x0 = (int)clamp(sx, 0, W-1), x1 = min(x0+1, W-1), dx = sx - x0 (y alike)
//   out = inside ? bilinear(img[k], x0, x1, y0, y1, dx, dy)[c] : 0
//
// The TPU kernel splits the warp into two 1-D shear/scale passes done as
// MXU matrix products, because gathers are slow on the TPU; the split adds
// half-texel smoothing and a ~2-texel band at the border.  On Hopper a
// 4-tap gather through L1/L2 is cheap, so this kernel computes the exact
// single-pass warp, valid for every matrix (the TPU kernel's range limits
// on rotation and scale do not apply).
//
// What bounds it on an H100: bytes.  It must read at least the input and
// write the output, 2*K*H*W*C*4 bytes (255.6 MB at K=26, 640x640x3: ~76 us
// at 3.35 TB/s); the arithmetic is ~40 flops per pixel.  The design is the
// simple one: neighbouring threads take neighbouring x, so the stores and,
// for matrices near the identity, the taps are coalesced; the four taps of
// a thread and of its neighbours mostly share cache lines.  Fusing the
// slot gather and write-back into the kernel, and 16-byte stores, are
// later work.
//
// The coordinate arithmetic uses __f*_rn intrinsics in _affine_warp's
// operation order, so no FMA contraction can move a pixel across the
// inside/outside test or a truncation boundary: the result equals the
// plain PyTorch version's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
affine_warp_kernel(const float* __restrict__ images,
                   const float* __restrict__ inv,
                   float* __restrict__ out, int H, int W, int C) {
  const int k = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= H * W) return;
  const int y = p / W;
  const int x = p - y * W;

  const float* m = inv + (size_t)k * 9;
  const float fw = (float)W, fh = (float)H;
  const float xx = __fdiv_rn(__fadd_rn((float)x, 0.5f), fw);
  const float yy = __fdiv_rn(__fadd_rn((float)y, 0.5f), fh);
  const float sx = __fsub_rn(
      __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], xx), __fmul_rn(m[1], yy)),
                          m[2]),
                fw),
      0.5f);
  const float sy = __fsub_rn(
      __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[3], xx), __fmul_rn(m[4], yy)),
                          m[5]),
                fh),
      0.5f);

  float* o = out + ((size_t)k * H * W + p) * C;
  const bool inside = sx >= 0.0f && sx <= fw - 1.0f && sy >= 0.0f &&
                      sy <= fh - 1.0f;
  if (!inside) {
    for (int c = 0; c < C; ++c) o[c] = 0.0f;
    return;
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

  const float* img = images + (size_t)k * H * W * C;
  const float* p00 = img + ((size_t)y0 * W + x0) * C;
  const float* p01 = img + ((size_t)y0 * W + x1) * C;
  const float* p10 = img + ((size_t)y1 * W + x0) * C;
  const float* p11 = img + ((size_t)y1 * W + x1) * C;
  for (int c = 0; c < C; ++c) {
    const float top =
        __fadd_rn(__fmul_rn(__ldg(p00 + c), omdx), __fmul_rn(__ldg(p01 + c), dx));
    const float bot =
        __fadd_rn(__fmul_rn(__ldg(p10 + c), omdx), __fmul_rn(__ldg(p11 + c), dx));
    o[c] = __fadd_rn(__fmul_rn(top, omdy), __fmul_rn(bot, dy));
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// images/out [K, H, W, C] f32, inv [K, 3, 3] f32; all contiguous on the
// current device.
extern "C" int affine_warp_launch(const void* images, const void* inv,
                                  void* out, int K, int H, int W, int C,
                                  void* stream) {
  if (K <= 0 || H <= 0 || W <= 0 || C <= 0 || K > 65535 ||
      (long long)H * W > 0x7fffffffLL - kThreads)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H * W + kThreads - 1) / kThreads, K);
  affine_warp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(images), static_cast<const float*>(inv),
      static_cast<float*>(out), H, W, C);
  return (int)cudaGetLastError();
}
