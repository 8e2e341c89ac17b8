// Host-side image preprocessing of the port: bilinear resize (or
// letterbox) of packed uint8 RGB images into a batch [N, S, S, 3], on a
// pool of threads, and the same fused with jpeg_decode.cc's decoder.
//
// Two resizes, picked per call:
// - float32 in [0, 1]: bilinear_rect and resize_one below are copies of
//   the JAX package's native library (native/preproc.cc), so the port's
//   batches equal JAX's bit for bit when both are built with the same
//   compiler and flags: half-pixel centres, taps clamped to the image,
//   float arithmetic, scaled by 1/255; letterbox sizes int(h*scale + 0.5f)
//   with scale = S / max(h, w) in float.
// - uint8: cv2.resize's INTER_LINEAR on 8-bit images, which the JAX
//   package fills its packed cache with, bit for bit: 11-bit fixed-point
//   weights, the horizontal pass into ints, the vertical combine of cv2's
//   vector code; letterbox sizes rounded half to even in double, as
//   Python's round(), on a canvas of gray 114.
//
// C interface:
//   preproc_batch(srcs, hs, ws, n, dst, S, letterbox, u8, threads,
//                 scales, pad_xs, pad_ys)
//     image i (srcs[i], hs[i] x ws[i] x 3) into slot i of dst;
//   decode_preproc_batch(paths, n, dst, S, letterbox, u8, max_denom, flags,
//                        threads, orig_ws, orig_hs, scales, pad_xs, pad_ys,
//                        codes, msgs, msg_len)
//     each worker reads and decodes file i into buffers it reuses, at the
//     JAX package's DCT scale (native/preproc.cc): 1/d for the largest d <=
//     max_denom with both sides of the file at least 2 * S at each step;
//     then it resizes it into slot i.  A file that fails sets codes[i]
//     (jpegdec's Code) and a message at msgs + i * msg_len, and leaves slot
//     i as it was.  orig_ws / orig_hs are the files' own (SOF) sizes, and
//     with letterbox the scales map their pixels, as JAX's do.  max_denom 1
//     decodes at full scale (the uint8 cache, which the JAX package fills
//     from cv2.imread at full scale); flags READ_EXIF turns each image by
//     its EXIF orientation first, as cv2.imread does, and then orig_ws /
//     orig_hs are the turned image's sizes (the cache again); READ_IMREAD
//     decodes CMYK and YCCK files as cv2.imread does, which an RGB request
//     to libjpeg (the JAX package's fused loader) refuses.
// dst is float32 or (u8 != 0) uint8; scales, pad_xs, pad_ys describe the
// letterbox (1, 0, 0 without).  A worker takes the next image when it is
// done with one.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

#include "jpeg_decode.h"

namespace {

// Row-precomputed bilinear resize of an HxWx3 u8 image into a float32
// sub-rectangle (scaled 1/255).  cv2.INTER_LINEAR sampling convention.
void bilinear_rect(const uint8_t* src, int h, int w, float* dst,
                   int dst_stride, int outw, int outh) {
  std::vector<int> xi0(outw), xi1(outw);
  std::vector<float> wx(outw);
  const float sx = static_cast<float>(w) / outw;
  for (int x = 0; x < outw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    fx = std::max(0.0f, std::min(fx, static_cast<float>(w - 1)));
    xi0[x] = static_cast<int>(fx);
    xi1[x] = std::min(xi0[x] + 1, w - 1);
    wx[x] = fx - xi0[x];
  }
  const float sy = static_cast<float>(h) / outh;
  constexpr float kInv255 = 1.0f / 255.0f;
  for (int y = 0; y < outh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(h - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, h - 1);
    const float dy = fy - y0;
    const uint8_t* r0 = src + static_cast<size_t>(y0) * w * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * w * 3;
    float* out = dst + static_cast<size_t>(y) * dst_stride;
    for (int x = 0; x < outw; ++x) {
      const int a = xi0[x] * 3, b = xi1[x] * 3;
      const float dx = wx[x];
      for (int c = 0; c < 3; ++c) {
        const float top = r0[a + c] + (r0[b + c] - r0[a + c]) * dx;
        const float bot = r1[a + c] + (r1[b + c] - r1[a + c]) * dx;
        out[x * 3 + c] = (top + (bot - top) * dy) * kInv255;
      }
    }
  }
}

// Resize src (h x w x 3 u8) into dst (S x S x 3 f32, already scaled /255).
// With letterbox: aspect-preserving, centered, gray 114 padding; returns the
// scale and pads so the caller can transform boxes.
void resize_one(const uint8_t* src, int h, int w, float* dst, int S,
                bool letterbox, float* scale_out, float* padx_out,
                float* pady_out) {
  if (!letterbox) {
    bilinear_rect(src, h, w, dst, S * 3, S, S);
    *scale_out = 1.0f;
    *padx_out = 0.0f;
    *pady_out = 0.0f;
    return;
  }

  const float scale = static_cast<float>(S) / std::max(h, w);
  const int nh = static_cast<int>(h * scale + 0.5f);
  const int nw = static_cast<int>(w * scale + 0.5f);
  const int pad_y = (S - nh) / 2;
  const int pad_x = (S - nw) / 2;
  const float gray = 114.0f / 255.0f;
  for (int i = 0; i < S * S * 3; ++i) dst[i] = gray;
  bilinear_rect(src, h, w, dst + (static_cast<size_t>(pad_y) * S + pad_x) * 3,
                S * 3, nw, nh);
  *scale_out = scale;
  *padx_out = static_cast<float>(pad_x);
  *pady_out = static_cast<float>(pad_y);
}

// --- cv2's INTER_LINEAR on uint8 -------------------------------------------

constexpr int kCoefBits = 11;            // INTER_RESIZE_COEF_BITS
constexpr float kCoefScale = 1 << kCoefBits;

struct Taps {
  std::vector<int> i0, i1;   // source indices, clamped to [0, n_src - 1]
  std::vector<int> a0, a1;   // their weights, summing to 2048
};

// One axis of cv2's map: f = float((d + 0.5) * (1 / (n_dst / n_src)) - 0.5)
// in double, s = floor(f), f -= s; the weights rint((1 - f) * 2048) and
// rint(f * 2048), half to even.  cv2 clamps the weights at the edges of x
// (f = 0 where s < 0 or s >= n_src - 1) and not of y, where only the row
// indices are clamped.  No contraction into fused multiply-adds: the
// rounding of each step is cv2's.
__attribute__((optimize("fp-contract=off")))
Taps linear_taps(int n_src, int n_dst, bool clamp_weights) {
  Taps t;
  t.i0.resize(n_dst);
  t.i1.resize(n_dst);
  t.a0.resize(n_dst);
  t.a1.resize(n_dst);
  const double scale = 1.0 / (static_cast<double>(n_dst) / n_src);
  for (int d = 0; d < n_dst; ++d) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    f -= static_cast<float>(s);
    if (clamp_weights && s < 0) f = 0.0f, s = 0;
    if (clamp_weights && s >= n_src - 1) f = 0.0f, s = n_src - 1;
    t.a0[d] = static_cast<int>(std::lrint((1.0f - f) * kCoefScale));
    t.a1[d] = static_cast<int>(std::lrint(f * kCoefScale));
    t.i0[d] = std::min(std::max(s, 0), n_src - 1);
    t.i1[d] = std::min(std::max(s + 1, 0), n_src - 1);
  }
  return t;
}

// cv2.resize(src, (outw, outh), INTER_LINEAR) of an h x w x 3 u8 image into
// a u8 sub-rectangle of dst (row stride dst_stride bytes).
void linear_rect_u8(const uint8_t* src, int h, int w, uint8_t* dst,
                    int dst_stride, int outw, int outh) {
  const Taps tx = linear_taps(w, outw, true);
  const Taps ty = linear_taps(h, outh, false);
  const int n = outw * 3;
  // the horizontal pass of two source rows, each kept while the next
  // output rows need it (the rows needed never decrease)
  std::vector<int> rows[2] = {std::vector<int>(n), std::vector<int>(n)};
  int row_of[2] = {-1, -1};
  auto hpass = [&](int sy, int keep) -> const int* {
    for (int k = 0; k < 2; ++k)
      if (row_of[k] == sy) return rows[k].data();
    const int k = row_of[0] == keep ? 1 : 0;
    const uint8_t* r = src + static_cast<size_t>(sy) * w * 3;
    int* D = rows[k].data();
    for (int x = 0; x < outw; ++x) {
      const uint8_t* p0 = r + tx.i0[x] * 3;
      const uint8_t* p1 = r + tx.i1[x] * 3;
      for (int c = 0; c < 3; ++c)
        D[x * 3 + c] = p0[c] * tx.a0[x] + p1[c] * tx.a1[x];
    }
    row_of[k] = sy;
    return D;
  };
  for (int y = 0; y < outh; ++y) {
    const int* D0 = hpass(ty.i0[y], ty.i1[y]);
    const int* D1 = hpass(ty.i1[y], ty.i0[y]);
    const int b0 = ty.a0[y], b1 = ty.a1[y];
    uint8_t* out = dst + static_cast<size_t>(y) * dst_stride;
    for (int i = 0; i < n; ++i) {
      // cv2's VResizeLinearVec_32s8u: 16-bit products of D >> 4
      const int v = (((b0 * (D0[i] >> 4)) >> 16) +
                     ((b1 * (D1[i] >> 4)) >> 16) + 2) >> 2;
      out[i] = static_cast<uint8_t>(std::min(std::max(v, 0), 255));
    }
  }
}

// The JAX package's uint8 resize and letterbox (data/pipeline.py:
// _resize, _resize_letterbox) into dst (S x S x 3 u8).
void resize_one_u8(const uint8_t* src, int h, int w, uint8_t* dst, int S,
                   bool letterbox, float* scale_out, float* padx_out,
                   float* pady_out) {
  if (!letterbox) {
    linear_rect_u8(src, h, w, dst, S * 3, S, S);
    *scale_out = 1.0f;
    *padx_out = 0.0f;
    *pady_out = 0.0f;
    return;
  }
  const double scale = static_cast<double>(S) / std::max(h, w);
  const int nh = static_cast<int>(std::nearbyint(h * scale));
  const int nw = static_cast<int>(std::nearbyint(w * scale));
  const int pad_y = (S - nh) / 2;
  const int pad_x = (S - nw) / 2;
  std::memset(dst, 114, static_cast<size_t>(S) * S * 3);
  linear_rect_u8(src, h, w, dst + (static_cast<size_t>(pad_y) * S + pad_x) * 3,
                 S * 3, nw, nh);
  *scale_out = static_cast<float>(scale);
  *padx_out = static_cast<float>(pad_x);
  *pady_out = static_cast<float>(pad_y);
}

// Image i into slot i of dst, float32 or uint8.
void resize_into(const uint8_t* src, int h, int w, void* dst, int64_t i,
                 int S, bool letterbox, bool u8, float* scale, float* padx,
                 float* pady) {
  const int64_t slot = i * S * S * 3;
  if (u8)
    resize_one_u8(src, h, w, static_cast<uint8_t*>(dst) + slot, S, letterbox,
                  scale, padx, pady);
  else
    resize_one(src, h, w, static_cast<float*>(dst) + slot, S, letterbox,
               scale, padx, pady);
}

// Runs work(i, buffers) for i in [0, n) on up to `threads` threads, each
// with buffers of its own, taking the next i when it is done with one.
template <typename Work>
void for_each_image(int n, int threads, Work work) {
  const int nt = std::max(1, std::min(threads, n));
  std::atomic<int> next{0};
  auto run = [&] {
    jpegdec::Buffers buffers;
    for (int i; (i = next.fetch_add(1)) < n;) work(i, &buffers);
  };
  if (nt == 1) {
    run();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(run);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void preproc_batch(const uint8_t** srcs, const int* hs, const int* ws, int n,
                   void* dst, int S, int letterbox, int u8, int threads,
                   float* scales, float* pad_xs, float* pad_ys) {
  for_each_image(n, threads, [&](int i, jpegdec::Buffers*) {
    resize_into(srcs[i], hs[i], ws[i], dst, i, S, letterbox != 0, u8 != 0,
                &scales[i], &pad_xs[i], &pad_ys[i]);
  });
}

void decode_preproc_batch(const char** paths, int n, void* dst, int S,
                          int letterbox, int u8, int max_denom, int flags,
                          int threads, int* orig_ws, int* orig_hs,
                          float* scales, float* pad_xs, float* pad_ys,
                          int* codes, char* msgs, int msg_len) {
  for_each_image(n, threads, [&](int i, jpegdec::Buffers* b) {
    int w = 0, h = 0, orientation = 0;
    codes[i] = jpegdec::decode_into(paths[i], b, S, max_denom,
                                    (flags & jpegdec::READ_IMREAD) != 0, &w, &h,
                                    &orig_ws[i], &orig_hs[i], &orientation,
                                    msgs + static_cast<int64_t>(i) * msg_len,
                                    msg_len);
    if (codes[i] != jpegdec::JPEG_OK) return;
    const uint8_t* src = b->rgb.data();
    if ((flags & jpegdec::READ_EXIF) && orientation >= 2 && orientation <= 8) {
      b->turned.resize(b->rgb.size());
      jpegdec::orient(src, w, h, orientation, b->turned.data(), &w, &h);
      src = b->turned.data();
      if (orientation >= 5) std::swap(orig_ws[i], orig_hs[i]);
    }
    resize_into(src, h, w, dst, i, S, letterbox != 0, u8 != 0, &scales[i],
                &pad_xs[i], &pad_ys[i]);
    // the letterbox scale is the decoded image's; the boxes are in the
    // original's pixels (native/preproc.cc)
    if (letterbox) scales[i] *= static_cast<float>(w) / orig_ws[i];
  });
}

}  // extern "C"
