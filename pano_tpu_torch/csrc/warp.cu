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
// each tap comes from the tap's integer coordinates through a table of the
// ramp's values (the plane is never stored), rounded back to the 7-bit
// grid and divided by 127, as
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
// What bounds them on an H100: memory traffic at best. K4a writes a
// 3154x5556 canvas (53 MB) and reads up to the same of left and right
// pixels (the right image's four taps mostly hit L1/L2); K4b reads the
// right image (39 MB) and writes a window of about the same size in RGB
// (39 MB) and in f32 weight (52 MB): ~0.13 GB, 39 us at 3.35 TB/s, against
// ~60 flops a pixel and as many more instructions of addressing, loads
// and conversions. K4a: one thread per output pixel (all three
// channels), 32-wide rows per warp, so the u8 stores coalesce. K4b's
// design is noted at its kernel below. Built with -fmad=false, the
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


// K4b. What bounds it on an H100: the issue rate, not bytes. The exact
// sample costs about two hundred instructions a pixel: the map's two IEEE
// divisions, twelve byte-to-float conversions, twelve products and their
// sums in tap order, the rounding; the weight adds the alpha's and one
// more division. At one instruction a clock per scheduler that is several
// times the 39 us the 0.13 GB take at 3.35 TB/s. The design takes out
// every instruction the exact result does not need:
//
// - The window as a flat array of pixels: lane l of a warp samples pixel
//   base + l of each run of 32, so a warp's taps of one source row are
//   adjacent bytes, and each thread steps its (i, j) by 32 pixels with no
//   division (one at its start) and updates the map's row terms
//   (m01 * ys etc.) only when its row changes. 32-bit indices.
// - The ramp alpha from a table: alpha(xi, yi) = g(min(dx, dy)) with
//   dx = min(xi+1, w-xi), dy = min(yi+1, h-yi) and g(d) =
//   clip(rint((d / half_min) * 127), 1, 127), which is non-decreasing, so
//   alpha = min(g(dx), g(dy)). The wrapper builds g over 0..ceil(max(h,
//   w)/2) once per source shape (ops/cuda_warp.py::ramp_alpha_table, the
//   plain formula); a tap costs two cached loads and a min, no division.
// - Interior taps (all four inside the source, most of a window) skip the
//   bounds tests and read each source row's two pixels as 6 bytes from two
//   (at times three) aligned 32-bit words, funnel-shifted into place.
// - No conversion instructions on the hot path (they issue at 1/8 rate):
//   bytes become floats by the 2^23 trick, floor is a round-down add of
//   1.5 * 2^23 whose bits give the integer, and rint, the clip and the u8
//   are an add of 2^23 after the clip (exact: see the helpers).
// - The outputs leave as the plain byte and f32 stores: the kernel is not
//   held by bytes, and assembling wider RGB stores across lanes took more
//   instructions than it saved.
//
// The sample's formulas and their order stay the plain version's: the map
// (m00*xs + m01*ys) + m02 and its IEEE divisions, the tap weights, each
// sum in tap order, rint and the clip, rint(asum) / 127.
constexpr int PACKED_THREADS = 256;
constexpr int PACKED_RUNS = 8;  // runs of 32 pixels per warp

// Exact f32 tricks that keep the 1/8-rate conversion pipe free: 2^23 + v
// is exact with the bits 0x4B000000 + v for an integer v in [0, 2^23), and
// x + 1.5 * 2^23 lands on an integer for x in (-2^22, 2^22), rounded as
// the add is rounded.
constexpr float TWO23 = 8388608.0f;
constexpr float TWO23_15 = 12582912.0f;  // 1.5 * 2^23, bits 0x4B400000

// An integer in [0, 2^23) as a float.
__device__ __forceinline__ float int_f(int v) {
  return __int_as_float(0x4B000000 + v) - TWO23;
}

// Byte k (0-3) of v as a float.
__device__ __forceinline__ float byte_f(uint32_t v, int k) {
  return __int_as_float(__byte_perm(v, 0x4B000000u, 0x7440u | k)) - TWO23;
}

// The bits of 2^23 + clip(rint(v), 0, 255): its low byte is the u8 (the
// add rounds half to even, as rintf; the clip commutes with rounding).
__device__ __forceinline__ uint32_t u8_bits(float v) {
  return __float_as_uint(fminf(fmaxf(v, 0.0f), 255.0f) + TWO23);
}

// The 6 bytes at p (two adjacent pixels) as the low 6 bytes of lo:hi,
// read as the aligned words that hold them.
__device__ __forceinline__ void load6(const uint8_t* p, uint32_t& lo,
                                      uint32_t& hi) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  const uint32_t* a = reinterpret_cast<const uint32_t*>(at & ~uintptr_t(3));
  const unsigned sh = static_cast<unsigned>(at & 3) * 8;
  const uint32_t v0 = __ldg(a), v1 = __ldg(a + 1);
  const uint32_t v2 = sh == 24 ? __ldg(a + 2) : 0u;  // 6 bytes from byte 3
  lo = __funnelshift_r(v0, v1, sh);
  hi = __funnelshift_r(v1, v2, sh);
}

// The ramp alpha table's entry for source row or column k of n.
__device__ __forceinline__ float ramp_g(const float* __restrict__ table,
                                        int k, int n) {
  return __ldg(table + min(k + 1, n - k));
}

__global__ void __launch_bounds__(PACKED_THREADS)
warp_packed_kernel(const uint8_t* __restrict__ right,
                   uint8_t* __restrict__ rgb, float* __restrict__ weight,
                   const float* __restrict__ table, int hr, int wr,
                   float fhr, float fwr, int wy0, int wx0, int win_w,
                   unsigned total, int has_alpha, float m00, float m01,
                   float m02, float m10, float m11, float m12, float m20,
                   float m21, float m22) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp_base =
      (blockIdx.x * (PACKED_THREADS / 32) + (threadIdx.x >> 5)) *
      (32 * PACKED_RUNS);
  if (warp_base >= total) return;  // the whole warp
  unsigned o = warp_base + lane;
  int i = static_cast<int>(o / static_cast<unsigned>(win_w));
  int j = static_cast<int>(o) - i * win_w;
  // The map's row terms, m01 * ys etc., change only with the row.
  float ys = int_f(wy0 + i);
  float r0 = m01 * ys, r1 = m11 * ys, r2 = m21 * ys;

  for (int run = 0; run < PACKED_RUNS && o < total; ++run) {
    const float xs = int_f(wx0 + j);
    const float den = m20 * xs + r2 + m22;
    const float sx = (m00 * xs + r0 + m02) / den;
    const float sy = (m10 * xs + r1 + m12) / den;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
    float wsum = 0.0f, asum = 0.0f;
    // Every tap misses the image unless -1 < s < dim (NaN included).
    if (sx > -1.0f && sx < fwr && sy > -1.0f && sy < fhr) {
      // floor(s) by a round-down add; its integer from the sum's bits.
      const float tx = __fadd_rd(sx, TWO23_15);
      const float ty = __fadd_rd(sy, TWO23_15);
      const float fx = sx - (tx - TWO23_15), fy = sy - (ty - TWO23_15);
      const int x0i = __float_as_int(tx) - 0x4B400000;
      const int y0i = __float_as_int(ty) - 0x4B400000;
      const float wt[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                           (1.0f - fx) * fy, fx * fy};
      if (x0i >= 0 && x0i + 1 < wr && y0i >= 0 && y0i + 1 < hr) {
        const uint8_t* p =
            right + static_cast<unsigned>(y0i * wr + x0i) * 3u;
        uint32_t w[4];  // row y0i, then row y0i + 1
        load6(p, w[0], w[1]);
        load6(p + static_cast<unsigned>(wr) * 3u, w[2], w[3]);
        // Every product is >= +0, so each sum starts at its first term,
        // as the plain version's does.
        acc0 = byte_f(w[0], 0) * wt[0];
        acc1 = byte_f(w[0], 1) * wt[0];
        acc2 = byte_f(w[0], 2) * wt[0];
        wsum = wt[0];
#pragma unroll
        for (int tap = 1; tap < 4; ++tap) {
          // Byte b of the row's 6: tap (_, 0) bytes 0-2, (_, 1) 3-5.
          const int r = 2 * (tap >> 1), b = 3 * (tap & 1);
          acc0 = acc0 + byte_f(w[r + b / 4], b % 4) * wt[tap];
          acc1 = acc1 + byte_f(w[r + (b + 1) / 4], (b + 1) % 4) * wt[tap];
          acc2 = acc2 + byte_f(w[r + (b + 2) / 4], (b + 2) % 4) * wt[tap];
          wsum = wsum + wt[tap];
        }
        if (has_alpha) {
          const float gx0 = ramp_g(table, x0i, wr);
          const float gx1 = ramp_g(table, x0i + 1, wr);
          const float gy0 = ramp_g(table, y0i, hr);
          const float gy1 = ramp_g(table, y0i + 1, hr);
          asum = fminf(gx0, gy0) * wt[0];
          asum = asum + fminf(gx1, gy0) * wt[1];
          asum = asum + fminf(gx0, gy1) * wt[2];
          asum = asum + fminf(gx1, gy1) * wt[3];
        }
      } else {  // the source's edge cuts the taps
#pragma unroll
        for (int tap = 0; tap < 4; ++tap) {
          const int xi = x0i + (tap & 1), yi = y0i + (tap >> 1);
          if (xi >= 0 && xi < wr && yi >= 0 && yi < hr) {
            const uint8_t* p =
                right + static_cast<unsigned>(yi * wr + xi) * 3u;
            acc0 = acc0 + static_cast<float>(p[0]) * wt[tap];
            acc1 = acc1 + static_cast<float>(p[1]) * wt[tap];
            acc2 = acc2 + static_cast<float>(p[2]) * wt[tap];
            wsum = wsum + wt[tap];
            if (has_alpha)
              asum = asum + fminf(ramp_g(table, xi, wr),
                                  ramp_g(table, yi, hr)) * wt[tap];
          }
        }
      }
    }
    uint8_t* const out = rgb + o * 3u;
    out[0] = static_cast<uint8_t>(u8_bits(acc0));
    out[1] = static_cast<uint8_t>(u8_bits(acc1));
    out[2] = static_cast<uint8_t>(u8_bits(acc2));
    // rint(asum) by the 2^23 add: asum is in [0, 127].
    if (weight != nullptr)
      weight[o] = has_alpha ? ((asum + TWO23) - TWO23) / 127.0f : wsum;
    o += 32;
    j += 32;
    if (j >= win_w) {
      do {
        j -= win_w;
        ++i;
      } while (j >= win_w);
      ys = int_f(wy0 + i);
      r0 = m01 * ys;
      r1 = m11 * ys;
      r2 = m21 * ys;
    }
  }
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

// `table`: the ramp alpha table g(0..ceil(max(hr, wr) / 2)) when has_alpha
// and emit_weight (ops/cuda_warp.py::ramp_alpha_table).
PANO_API int pano_warp_packed(const void* right, void* rgb, void* weight,
                              const void* table, int hr, int wr, int wy0,
                              int wx0, int win_h, int win_w, int has_alpha,
                              int emit_weight, float m00, float m01,
                              float m02, float m10, float m11, float m12,
                              float m20, float m21, float m22, void* stream) {
  has_alpha = has_alpha && emit_weight;  // the alpha feeds the weight only
  // The kernel's indices are 32-bit and its exact f32 tricks need canvas
  // coordinates below 2^23 and source sides below 2^22.
  const long long total = static_cast<long long>(win_h) * win_w;
  if ((has_alpha && table == nullptr) || total * 3 > 0xffffffffLL ||
      static_cast<long long>(hr) * wr * 3 > 0xffffffffLL ||
      hr >= (1 << 22) || wr >= (1 << 22) || wy0 + win_h > (1 << 23) ||
      wx0 + win_w > (1 << 23))
    return static_cast<int>(cudaErrorInvalidValue);
  if (total <= 0) return 0;
  const long long per_block = 32LL * PACKED_RUNS * (PACKED_THREADS / 32);
  const unsigned blocks =
      static_cast<unsigned>((total + per_block - 1) / per_block);
  warp_packed_kernel<<<blocks, PACKED_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(right), static_cast<uint8_t*>(rgb),
      emit_weight ? static_cast<float*>(weight) : nullptr,
      static_cast<const float*>(table), hr, wr, static_cast<float>(hr),
      static_cast<float>(wr), wy0, wx0, win_w,
      static_cast<unsigned>(total), has_alpha, m00, m01, m02, m10, m11, m12,
      m20, m21, m22);
  return static_cast<int>(cudaGetLastError());
}
