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
// in _warp_batched_call). A launch warps a group of images that share one
// source shape, each into its own window (the TPU kernel's (B, tiles_y,
// tiles_x) grid; one image is a group of one): see warp_packed_kernel.
// Each pixel of a (win_h, win_w) window at canvas
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
// What bounds them on an H100: the issue rate of the exact sample, not
// bytes. K4a writes a 3154x5556 canvas (53 MB) and reads the left image
// (39 MB) and the right (39 MB; its four taps mostly hit L1/L2): ~0.13
// GB, 39 us at 3.35 TB/s; K4b reads the right image and writes a window
// of about its size in RGB (39 MB) and in f32 weight (52 MB), as much.
// The sample takes about two hundred instructions a pixel (see K4b's
// notes below), several times those bytes' time. Both kernels run the
// same sample, sample_px, designed around that; K4a adds a byte stream
// around it (see its kernel). Built with -fmad=false, the arithmetic
// rounds exactly like the plain versions (ops/warp.py::warp_and_blend,
// ops/cuda_warp.py::warp_packed_plain).
#include "canvas.cuh"

namespace {

// The exact sample (sample_px, K4a and K4b). What bounds it on an H100:
// the issue rate, not bytes. It costs about two hundred instructions a
// pixel: the map's two IEEE divisions, twelve byte-to-float conversions,
// twelve products and their sums in tap order, the rounding; K4b's
// weight adds the alpha's and one more division. At one instruction a
// clock per scheduler that is several times the 39 us the 0.13 GB take
// at 3.35 TB/s. The design takes out every instruction the exact result
// does not need:
//
// - The window as a flat array of pixels: lane l of a warp samples pixel
//   base + l of each run of 32, so a warp's taps of one source row are
//   adjacent bytes, and each thread steps its (i, j) by a fixed stride
//   with no division (one at its start) and updates the map's row terms
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
// - K4b's outputs leave as the plain byte and f32 stores: the kernel is
//   not held by bytes, and assembling wider RGB stores across lanes took
//   more instructions than it saved.
//
// The sample's formulas and their order stay the plain version's: the map
// (m00*xs + m01*ys) + m02 and its IEEE divisions, the tap weights, each
// sum in tap order, rint and the clip, rint(asum) / 127.
constexpr int PACKED_THREADS = 256;
constexpr int PACKED_RUNS = 8;  // runs of 32 pixels per warp
// Window pixels a K4b block covers.
constexpr int PACKED_BLOCK_PX = 32 * PACKED_RUNS * (PACKED_THREADS / 32);
static_assert(PACKED_THREADS == CANVAS_THREADS,
              "K4a's stream blocks stride by CANVAS_THREADS");

// More exact f32 tricks (int_f, u8_bits and TWO23 are in canvas.cuh):
// x + 1.5 * 2^23 lands on an integer for x in (-2^22, 2^22), rounded as
// the add is rounded.
constexpr float TWO23_15 = 12582912.0f;  // 1.5 * 2^23, bits 0x4B400000

// Byte k (0-3) of v as a float.
__device__ __forceinline__ float byte_f(uint32_t v, int k) {
  return __int_as_float(__byte_perm(v, 0x4B000000u, 0x7440u | k)) - TWO23;
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

// The canvas-to-source map m_inv.
struct Map {
  float m00, m01, m02, m10, m11, m12, m20, m21, m22;
};

// The exact sample of `right` at canvas column xs of the row whose map
// terms are r0 = m01 * ys, r1 = m11 * ys, r2 = m21 * ys: the three
// channels' sums in tap order (acc), the in-bounds tap weight (wsum) and,
// with has_alpha, the ramp alpha's sum (asum); all 0 where every tap
// misses the image. Forced inline: a caller that passes has_alpha = 0 and
// drops wsum keeps none of their instructions.
__device__ __forceinline__ void sample_px(
    const uint8_t* __restrict__ right, const float* __restrict__ table,
    int hr, int wr, float fhr, float fwr, int has_alpha, const Map& m,
    float xs, float r0, float r1, float r2, float& acc0, float& acc1,
    float& acc2, float& wsum, float& asum) {
  const float den = m.m20 * xs + r2 + m.m22;
  const float sx = (m.m00 * xs + r0 + m.m02) / den;
  const float sy = (m.m10 * xs + r1 + m.m12) / den;
  acc0 = acc1 = acc2 = wsum = asum = 0.0f;
  // Every tap misses the image unless -1 < s < dim (NaN included).
  if (!(sx > -1.0f && sx < fwr && sy > -1.0f && sy < fhr)) return;
  // floor(s) by a round-down add; its integer from the sum's bits.
  const float tx = __fadd_rd(sx, TWO23_15);
  const float ty = __fadd_rd(sy, TWO23_15);
  const float fx = sx - (tx - TWO23_15), fy = sy - (ty - TWO23_15);
  const int x0i = __float_as_int(tx) - 0x4B400000;
  const int y0i = __float_as_int(ty) - 0x4B400000;
  const float wt[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                       (1.0f - fx) * fy, fx * fy};
  if (x0i >= 0 && x0i + 1 < wr && y0i >= 0 && y0i + 1 < hr) {
    const uint8_t* p = right + static_cast<unsigned>(y0i * wr + x0i) * 3u;
    uint32_t w[4];  // row y0i, then row y0i + 1
    load6(p, w[0], w[1]);
    load6(p + static_cast<unsigned>(wr) * 3u, w[2], w[3]);
    // Every product is >= +0, so each sum starts at its first term, as
    // the plain version's does.
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
        const uint8_t* p = right + static_cast<unsigned>(yi * wr + xi) * 3u;
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

// Block `block` of a K4b window: PACKED_THREADS / 32 warps, each
// PACKED_RUNS runs of 32 pixels of the flat window.
__device__ __forceinline__ void warp_window_block(
    const uint8_t* __restrict__ right, uint8_t* __restrict__ rgb,
    float* __restrict__ weight, const float* __restrict__ table, int hr,
    int wr, float fhr, float fwr, int wy0, int wx0, int win_w, unsigned total,
    int has_alpha, const Map& m, unsigned block) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp_base =
      (block * (PACKED_THREADS / 32) + (threadIdx.x >> 5)) *
      (32 * PACKED_RUNS);
  if (warp_base >= total) return;  // the whole warp
  unsigned o = warp_base + lane;
  int i = static_cast<int>(o / static_cast<unsigned>(win_w));
  int j = static_cast<int>(o) - i * win_w;
  // The map's row terms, m01 * ys etc., change only with the row.
  float ys = int_f(wy0 + i);
  float r0 = m.m01 * ys, r1 = m.m11 * ys, r2 = m.m21 * ys;

  for (int run = 0; run < PACKED_RUNS && o < total; ++run) {
    float acc0, acc1, acc2, wsum, asum;
    sample_px(right, table, hr, wr, fhr, fwr, has_alpha, m,
              int_f(wx0 + j), r0, r1, r2, acc0, acc1, acc2, wsum, asum);
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
      r0 = m.m01 * ys;
      r1 = m.m11 * ys;
      r2 = m.m21 * ys;
    }
  }
}

// One element of a K4b launch, as ops/cuda_warp.py packs it (80 bytes,
// no padding): its source image, where its window starts in the flat RGB
// buffer (bytes) and in the flat weight buffer (floats), its map in
// _m_floats' order, its window, and its first block (set by the C entry).
struct WarpElem {
  const uint8_t* src;
  long long rgb_off;
  long long w_off;
  float m[9];
  int wy0, wx0, win_h, win_w;
  unsigned block_start;
};
static_assert(sizeof(WarpElem) == 80, "ops/cuda_warp.py packs 80 bytes");

// A launch's elements, passed by value as a kernel parameter, in the
// parameter space every block reads through the constant cache (no device
// table, so no upload before the launch). 16 of them are 1280 bytes,
// inside the classic 4 KB parameter limit; a larger group takes a launch
// for each 16 elements.
constexpr int BATCH_CAP = 16;
struct WarpBatch {
  WarpElem e[BATCH_CAP];
};

// K4b: images of one source shape (hr, wr), each warped into its own
// window (one image is a batch of one). The blocks are spread over the
// elements by their block starts (each element gets ceil(win_h * win_w /
// PACKED_BLOCK_PX) blocks in turn); a block finds its element by a binary
// search over them, then samples its PACKED_THREADS / 32 warps' runs of
// the flat window. The map's row terms stay hoisted. Indices inside an
// element are 32-bit; the element offsets into the flat buffers are
// 64-bit (a throughput batch's windows pass 2^32 bytes).
__global__ void __launch_bounds__(PACKED_THREADS)
warp_packed_kernel(const __grid_constant__ WarpBatch batch, int n_elems,
                   uint8_t* __restrict__ rgb, float* __restrict__ weight,
                   const float* __restrict__ table, int hr, int wr,
                   float fhr, float fwr, int has_alpha) {
  int lo = 0, hi = n_elems - 1;  // the last element starting <= blockIdx.x
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (batch.e[mid].block_start <= blockIdx.x)
      lo = mid;
    else
      hi = mid - 1;
  }
  const WarpElem& e = batch.e[lo];
  const Map m{e.m[0], e.m[1], e.m[2], e.m[3], e.m[4],
              e.m[5], e.m[6], e.m[7], e.m[8]};
  warp_window_block(e.src, rgb + e.rgb_off,
                    weight != nullptr ? weight + e.w_off : nullptr, table, hr,
                    wr, fhr, fwr, e.wy0, e.wx0, e.win_w,
                    static_cast<unsigned>(e.win_h) *
                        static_cast<unsigned>(e.win_w),
                    has_alpha, m, blockIdx.x - e.block_start);
}

// K4a: the canvas by the two kinds of block of canvas.cuh. A window block
// is K4b's: flat runs of 32 window pixels a warp, PACKED_RUNS of them,
// each sampled with sample_px (no alpha, no weight) and its 3 bytes
// stored into the canvas: the sample where it is non-black, else the
// base there (the left image's pixel, or zeros). The stream blocks write
// every other canvas byte; their memory traffic runs beside the window
// blocks' arithmetic, which holds the kernel at the sample's issue rate,
// as K4b's without the weight.
__global__ void __launch_bounds__(PACKED_THREADS)
warp_overlay_canvas_kernel(const uint8_t* __restrict__ right,
                           const uint8_t* __restrict__ left,
                           uint8_t* __restrict__ out, int hr, int wr,
                           float fhr, float fwr, const CanvasGeo g,
                           const Map m, unsigned n_win, unsigned n_stream) {
  unsigned index;
  if (block_kind(blockIdx.x, n_win, n_stream, index)) {
    stream_row(out, left, g, static_cast<int>(index));
    return;
  }
  const unsigned total = static_cast<unsigned>(g.win_h) * g.win_w;
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp_base =
      (index * (PACKED_THREADS / 32) + (threadIdx.x >> 5)) *
      (32 * PACKED_RUNS);
  if (warp_base >= total) return;  // the whole warp
  unsigned o = warp_base + lane;
  int i = static_cast<int>(o / static_cast<unsigned>(g.win_w));
  int j = static_cast<int>(o) - i * g.win_w;
  float ys = int_f(g.wy0 + i);
  float r0 = m.m01 * ys, r1 = m.m11 * ys, r2 = m.m21 * ys;

  for (int run = 0; run < PACKED_RUNS && o < total; ++run) {
    float acc0, acc1, acc2, wsum, asum;
    sample_px(right, nullptr, hr, wr, fhr, fwr, 0, m, int_f(g.wx0 + j), r0,
              r1, r2, acc0, acc1, acc2, wsum, asum);
    uint32_t b0 = u8_bits(acc0), b1 = u8_bits(acc1), b2 = u8_bits(acc2);
    const int y = g.wy0 + i, x = g.wx0 + j;
    if (((b0 | b1 | b2) & 0xffu) == 0) {  // black: the base shows
      const int ly = y - g.ty, lx = x - g.tx;
      if (ly >= 0 && ly < g.hl && lx >= 0 && lx < g.wl) {
        const uint8_t* p = left + 3 * (ly * g.wl + lx);
        b0 = p[0];
        b1 = p[1];
        b2 = p[2];
      }
    }
    uint8_t* const c = out + 3 * (y * g.out_w + x);
    c[0] = static_cast<uint8_t>(b0);
    c[1] = static_cast<uint8_t>(b1);
    c[2] = static_cast<uint8_t>(b2);
    o += 32;
    j += 32;
    if (j >= g.win_w) {
      do {
        j -= g.win_w;
        ++i;
      } while (j >= g.win_w);
      ys = int_f(g.wy0 + i);
      r0 = m.m01 * ys;
      r1 = m.m11 * ys;
      r2 = m.m21 * ys;
    }
  }
}

}  // namespace

// The limits of the kernels' 32-bit indices and exact f32 tricks:
// canvas coordinates below 2^23, source sides below 2^22.
static bool sample_fits(int hr, int wr, long long canvas_h,
                        long long canvas_w) {
  return static_cast<long long>(hr) * wr * 3 <= 0xffffffffLL &&
         hr < (1 << 22) && wr < (1 << 22) && canvas_h <= (1 << 23) &&
         canvas_w <= (1 << 23);
}

PANO_API int pano_warp_compose_overlay(
    const void* right, const void* left, void* out, int hr, int wr, int hl,
    int wl, int out_h, int out_w, int ty, int tx, int wy0, int wx0, int wy1,
    int wx1, float m00, float m01, float m02, float m10, float m11, float m12,
    float m20, float m21, float m22, void* stream) {
  // The stream blocks' 16-byte words need a 16-byte aligned canvas; the
  // indices are ints.
  const long long total = static_cast<long long>(out_h) * out_w;
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      total * 3 + 16 > 0x7fffffffLL ||
      static_cast<long long>(hl) * wl * 3 > 0x7fffffffLL ||
      !sample_fits(hr, wr, out_h, out_w))
    return static_cast<int>(cudaErrorInvalidValue);
  if (total <= 0) return 0;
  const CanvasGeo g{out_w, hl, wl, ty, tx, wy0, wx0, wy1 - wy0, wx1 - wx0};
  const long long per_block = 32LL * PACKED_RUNS * (PACKED_THREADS / 32);
  const unsigned n_win = static_cast<unsigned>(
      (static_cast<long long>(g.win_h) * g.win_w + per_block - 1) / per_block);
  warp_overlay_canvas_kernel<<<n_win + out_h, PACKED_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(right), static_cast<const uint8_t*>(left),
      static_cast<uint8_t*>(out), hr, wr, static_cast<float>(hr),
      static_cast<float>(wr), g,
      Map{m00, m01, m02, m10, m11, m12, m20, m21, m22}, n_win,
      static_cast<unsigned>(out_h));
  return static_cast<int>(cudaGetLastError());
}

// K4b (warp_packed_kernel): `elems`, a HOST array of n_elems WarpElem
// rows (block_start is set here); `rgb` and `weight` the flat buffers the
// elements' offsets point into (weight null: no weight); `table` the ramp
// alpha table g(0..ceil(max(hr, wr) / 2)) of the shared source shape when
// has_alpha and emit_weight (ops/cuda_warp.py::ramp_alpha_table). One
// launch for each BATCH_CAP elements that have a pixel; their number goes
// to *launches. Refuses a window past the single window's limits: 32-bit
// indices inside it and canvas coordinates <= 2^23 (sample_fits).
PANO_API int pano_warp_packed(const void* elems, int n_elems, void* rgb,
                              void* weight, const void* table, int hr,
                              int wr, int has_alpha, int emit_weight,
                              int* launches, void* stream) {
  *launches = 0;
  has_alpha = has_alpha && emit_weight;  // the alpha feeds the weight only
  if (n_elems < 1 || (has_alpha && table == nullptr) ||
      !sample_fits(hr, wr, 0, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* all = static_cast<const WarpElem*>(elems);
  for (int i = 0; i < n_elems; ++i) {
    const WarpElem& e = all[i];
    if (e.wy0 < 0 || e.wx0 < 0 || e.win_h < 0 || e.win_w < 0 ||
        static_cast<long long>(e.win_h) * e.win_w * 3 > 0xffffffffLL ||
        !sample_fits(hr, wr, static_cast<long long>(e.wy0) + e.win_h,
                     static_cast<long long>(e.wx0) + e.win_w))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* out = static_cast<uint8_t*>(rgb);
  auto* w = emit_weight ? static_cast<float*>(weight) : nullptr;
  const auto* tab = static_cast<const float*>(table);
  const auto s = static_cast<cudaStream_t>(stream);
  for (int i0 = 0; i0 < n_elems; i0 += BATCH_CAP) {
    WarpBatch b;
    const int n = n_elems - i0 < BATCH_CAP ? n_elems - i0 : BATCH_CAP;
    unsigned blocks = 0;
    for (int i = 0; i < n; ++i) {
      b.e[i] = all[i0 + i];
      b.e[i].block_start = blocks;
      const long long px = static_cast<long long>(b.e[i].win_h) *
                           b.e[i].win_w;
      blocks += static_cast<unsigned>((px + PACKED_BLOCK_PX - 1) /
                                      PACKED_BLOCK_PX);
    }
    if (blocks == 0) continue;  // empty windows only
    warp_packed_kernel<<<blocks, PACKED_THREADS, 0, s>>>(
        b, n, out, w, tab, hr, wr, static_cast<float>(hr),
        static_cast<float>(wr), has_alpha);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    ++*launches;
  }
  return 0;
}
