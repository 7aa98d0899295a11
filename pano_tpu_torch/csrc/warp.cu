// K4a: fused inverse warp + overlay composite over the whole canvas, and
// K4b: the same inverse warp onto a window of its own, with a weight.
//
// K4a replaces the TPU kernel pano_tpu/ops/pallas_warp.py::
// warp_compose_overlay (the pallas_call at its compose branch of
// _warp_kernel). Every canvas pixel (y, x) starts from the base: the left
// image placed at (ty, tx), or 0 outside it. Inside the window [wy0, wy1)
// x [wx0, wx1) the pixel maps through m_inv to (sx, sy) with the formula of
// ops/warp.py's _inverse_map, samples the right image bilinearly with a zero
// border (taps (0,0), (0,1), (1,0), (1,1) weighted (1-fx)(1-fy), fx(1-fy),
// (1-fx)fy, fx*fy, summed in that order), rounds half to even and clips to
// u8; a warped pixel with any non-zero channel replaces the base.
//
// K4b replaces pano_tpu/ops/pallas_warp.py::warp_packed (the pallas_call
// in _warp_batched_call). Each pixel of a (win_h, win_w) window at canvas
// origin (wy0, wx0) takes the same sample and writes it as 3 u8 channels,
// plus an f32 weight: with has_alpha, the same bilinear sample of the
// alpha plane clip(rint(_edge_ramp(hr, wr) * 127), 1, 127), whose value at
// each tap is computed here from the tap's integer coordinates (the plane
// is never stored), rounded back to the 7-bit grid and divided by 127, as
// the TPU kernel's packed alpha byte is: a sub-pixel fringe where less than
// half a tap lands on the image weighs 0, not a sliver; without has_alpha,
// the summed in-bounds bilinear weight. emit_weight=0 skips the weight
// store.
//
// Both are the exact single-pass bilinear, not the TPU kernel's two-pass
// SWAR approximation over a packed BGRA plane, so there is no scale or
// tilt envelope and no tile alignment: any finite homography and any
// window are served, and "non-black" is any channel != 0.
//
// What bounds them on an H100: memory traffic. K4a writes a 3154x5556
// canvas (53 MB) and reads up to the same of left and right pixels (the
// right image's four taps mostly hit L1/L2); K4b reads the right image
// (39 MB) and writes a window of about the same size in RGB (39 MB) and in
// f32 weight (52 MB): ~0.13 GB, 39 us at 3.35 TB/s, against ~60 flops a
// pixel. One thread per output pixel (all three channels), 32-wide rows per
// warp, so the u8 and f32 stores coalesce. Built with -fmad=false, the
// arithmetic rounds exactly like the plain versions
// (ops/warp.py::warp_and_blend, ops/cuda_warp.py::warp_packed_plain).
#include "common.cuh"

namespace {

constexpr int BX = 32, BY = 8;

__global__ void __launch_bounds__(BX* BY)
warp_compose_overlay_kernel(const uint8_t* __restrict__ right,
                            const uint8_t* __restrict__ left,
                            uint8_t* __restrict__ out, int hr, int wr, int hl,
                            int wl, int out_h, int out_w, int ty, int tx,
                            int wy0, int wx0, int wy1, int wx1, float m00,
                            float m01, float m02, float m10, float m11,
                            float m12, float m20, float m21, float m22) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= out_w || y >= out_h) return;

  uint8_t px[3] = {0, 0, 0};
  const int ly = y - ty, lx = x - tx;
  if (ly >= 0 && ly < hl && lx >= 0 && lx < wl) {
    const uint8_t* p = left + (static_cast<size_t>(ly) * wl + lx) * 3;
    px[0] = p[0];
    px[1] = p[1];
    px[2] = p[2];
  }

  if (y >= wy0 && y < wy1 && x >= wx0 && x < wx1) {
    const float xs = static_cast<float>(x), ys = static_cast<float>(y);
    const float den = m20 * xs + m21 * ys + m22;
    const float sx = (m00 * xs + m01 * ys + m02) / den;
    const float sy = (m10 * xs + m11 * ys + m12) / den;
    // Every tap misses the image unless -1 < s < dim (NaN included).
    if (sx > -1.0f && sx < static_cast<float>(wr) && sy > -1.0f &&
        sy < static_cast<float>(hr)) {
      const float x0 = floorf(sx), y0 = floorf(sy);
      const float fx = sx - x0, fy = sy - y0;
      const int x0i = static_cast<int>(x0), y0i = static_cast<int>(y0);
      const float wt[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                           (1.0f - fx) * fy, fx * fy};
      float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const int xi = x0i + (tap & 1), yi = y0i + (tap >> 1);
        if (xi >= 0 && xi < wr && yi >= 0 && yi < hr) {
          const uint8_t* p = right + (static_cast<size_t>(yi) * wr + xi) * 3;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            acc[c] = acc[c] + static_cast<float>(p[c]) * wt[tap];
        }
      }
      uint8_t wp[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        wp[c] = static_cast<uint8_t>(fminf(fmaxf(rintf(acc[c]), 0.0f), 255.0f));
      if (wp[0] | wp[1] | wp[2]) {
        px[0] = wp[0];
        px[1] = wp[1];
        px[2] = wp[2];
      }
    }
  }
  uint8_t* o = out + (static_cast<size_t>(y) * out_w + x) * 3;
  o[0] = px[0];
  o[1] = px[1];
  o[2] = px[2];
}


// The JAX package's 7-bit ramp alpha at integer source pixel (xi, yi) of
// an (h, w) image: clip(rint(_edge_ramp * 127), 1, 127), the ramp divided
// (not multiplied by a reciprocal) by min(h, w) / 2.
__device__ __forceinline__ float ramp_alpha(int xi, int yi, int h, int w,
                                            float half_min) {
  const float fx = static_cast<float>(xi), fy = static_cast<float>(yi);
  const float d = fminf(fminf(fx + 1.0f, static_cast<float>(w) - fx),
                        fminf(fy + 1.0f, static_cast<float>(h) - fy));
  return fminf(fmaxf(rintf((d / half_min) * 127.0f), 1.0f), 127.0f);
}

__global__ void __launch_bounds__(BX* BY)
warp_packed_kernel(const uint8_t* __restrict__ right,
                   uint8_t* __restrict__ rgb, float* __restrict__ weight,
                   int hr, int wr, int wy0, int wx0, int win_h, int win_w,
                   int has_alpha, float half_min, float m00, float m01,
                   float m02, float m10, float m11, float m12, float m20,
                   float m21, float m22) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (j >= win_w || i >= win_h) return;

  const float xs = static_cast<float>(wx0 + j);
  const float ys = static_cast<float>(wy0 + i);
  const float den = m20 * xs + m21 * ys + m22;
  const float sx = (m00 * xs + m01 * ys + m02) / den;
  const float sy = (m10 * xs + m11 * ys + m12) / den;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  float wsum = 0.0f, asum = 0.0f;
  // Every tap misses the image unless -1 < s < dim (NaN included).
  if (sx > -1.0f && sx < static_cast<float>(wr) && sy > -1.0f &&
      sy < static_cast<float>(hr)) {
    const float x0 = floorf(sx), y0 = floorf(sy);
    const float fx = sx - x0, fy = sy - y0;
    const int x0i = static_cast<int>(x0), y0i = static_cast<int>(y0);
    const float wt[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                         (1.0f - fx) * fy, fx * fy};
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int xi = x0i + (tap & 1), yi = y0i + (tap >> 1);
      if (xi >= 0 && xi < wr && yi >= 0 && yi < hr) {
        const uint8_t* p = right + (static_cast<size_t>(yi) * wr + xi) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc[c] = acc[c] + static_cast<float>(p[c]) * wt[tap];
        wsum = wsum + wt[tap];
        if (has_alpha)
          asum = asum + ramp_alpha(xi, yi, hr, wr, half_min) * wt[tap];
      }
    }
  }
  const size_t o = static_cast<size_t>(i) * win_w + j;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    rgb[o * 3 + c] =
        static_cast<uint8_t>(fminf(fmaxf(rintf(acc[c]), 0.0f), 255.0f));
  if (weight != nullptr) weight[o] = has_alpha ? rintf(asum) / 127.0f : wsum;
}

}  // namespace

PANO_API int pano_warp_compose_overlay(
    const void* right, const void* left, void* out, int hr, int wr, int hl,
    int wl, int out_h, int out_w, int ty, int tx, int wy0, int wx0, int wy1,
    int wx1, float m00, float m01, float m02, float m10, float m11, float m12,
    float m20, float m21, float m22, void* stream) {
  const dim3 grid(pano_cdiv(out_w, BX), pano_cdiv(out_h, BY));
  const dim3 block(BX, BY);
  warp_compose_overlay_kernel<<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(right), static_cast<const uint8_t*>(left),
      static_cast<uint8_t*>(out), hr, wr, hl, wl, out_h, out_w, ty, tx, wy0,
      wx0, wy1, wx1, m00, m01, m02, m10, m11, m12, m20, m21, m22);
  return static_cast<int>(cudaGetLastError());
}

PANO_API int pano_warp_packed(const void* right, void* rgb, void* weight,
                              int hr, int wr, int wy0, int wx0, int win_h,
                              int win_w, int has_alpha, int emit_weight,
                              float m00, float m01, float m02, float m10,
                              float m11, float m12, float m20, float m21,
                              float m22, void* stream) {
  const dim3 grid(pano_cdiv(win_w, BX), pano_cdiv(win_h, BY));
  const dim3 block(BX, BY);
  // min(h, w) / 2 is a half-integer, exact in f32.
  const float half_min = static_cast<float>(hr < wr ? hr : wr) * 0.5f;
  warp_packed_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(right), static_cast<uint8_t*>(rgb),
      emit_weight ? static_cast<float*>(weight) : nullptr, hr, wr, wy0, wx0,
      win_h, win_w, has_alpha, half_min, m00, m01, m02, m10, m11, m12, m20,
      m21, m22);
  return static_cast<int>(cudaGetLastError());
}
