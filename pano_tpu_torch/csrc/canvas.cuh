// Streaming helpers shared by the canvas kernels: K4a and K5, which write
// a fresh u8 canvas (the left image as the base, a window blended in),
// and K6, which updates a canvas in place.
//
// A fresh canvas is written by two kinds of block of one launch, spread
// evenly over its grid (block_kind), so that the memory stream of the
// one overlaps the arithmetic of the other on every SM:
// - window blocks, the kernel's own (K4a: the exact sample of flat runs of
//   window pixels; K5: a staged row segment of the window, blended);
// - stream blocks (stream_row), one a canvas row: the row's bytes outside
//   the window, the left image's or zeros, as 16-byte words (each the one
//   or two aligned words of the left image that hold it, shifted into
//   place), and byte by byte where a word is cut by the window, the left
//   image's edge or the row's end.
// Blocks own bytes, not words: a 16-byte word that holds bytes of two
// blocks is stored by neither whole, each storing its own bytes one by
// one, so no byte is written twice and none is read back.
#pragma once

#include "common.cuh"

namespace {

constexpr int CANVAS_THREADS = 256;  // threads of every canvas kernel's block

// Exact f32 tricks that keep the 1/8-rate conversion pipe free: 2^23 + v
// is exact with the bits 0x4B000000 + v for an integer v in [0, 2^23).
constexpr float TWO23 = 8388608.0f;

// An integer in [0, 2^23) as a float.
__device__ __forceinline__ float int_f(int v) {
  return __int_as_float(0x4B000000 + v) - TWO23;
}

// The bits of 2^23 + clip(rint(v), 0, 255): its low byte is the u8 (the
// add rounds half to even, as rintf; the clip commutes with rounding).
__device__ __forceinline__ uint32_t u8_bits(float v) {
  return __float_as_uint(fminf(fmaxf(v, 0.0f), 255.0f) + TWO23);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Start copying the bytes [begin, end) into `dst` as the aligned 16-byte
// words that hold them; returns the offset of `begin` in `dst`. Each word
// read holds a byte of the range, so it lies in the range's allocation.
__device__ __forceinline__ int stage(uint8_t* dst, const uint8_t* begin,
                                     const uint8_t* end) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(begin) & ~uintptr_t(15);
  const uintptr_t a1 =
      (reinterpret_cast<uintptr_t>(end) + 15) & ~uintptr_t(15);
  const int words = static_cast<int>((a1 - a0) >> 4);
  for (int k = threadIdx.x; k < words; k += CANVAS_THREADS)
    cp_async16(dst + 16 * k, reinterpret_cast<const void*>(a0 + 16 * k));
  return static_cast<int>(reinterpret_cast<uintptr_t>(begin) - a0);
}

// Store the bytes [begin, end) back from `src` (staged by stage()): whole
// 16-byte words where the word lies inside the range, else only the bytes
// of the range, `unit` (1 or 4) bytes at a time.
template <int unit>
__device__ __forceinline__ void unstage(uint8_t* begin, uint8_t* end,
                                        const uint8_t* src) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(begin);
  const uintptr_t e = reinterpret_cast<uintptr_t>(end);
  const uintptr_t a0 = b & ~uintptr_t(15);
  const int words = static_cast<int>((((e + 15) & ~uintptr_t(15)) - a0) >> 4);
  for (int k = threadIdx.x; k < words; k += CANVAS_THREADS) {
    const uintptr_t g = a0 + 16 * k;
    if (g >= b && g + 16 <= e) {
      *reinterpret_cast<uint4*>(g) =
          *reinterpret_cast<const uint4*>(src + 16 * k);
      continue;
    }
#pragma unroll
    for (int u = 0; u < 16; u += unit) {
      if (g + u < b || g + u >= e) continue;
      if (unit == 4)
        *reinterpret_cast<float*>(g + u) =
            *reinterpret_cast<const float*>(src + 16 * k + u);
      else
        *reinterpret_cast<uint8_t*>(g + u) = src[16 * k + u];
    }
  }
}

// Where a fresh canvas's pixels come from: the left image (hl, wl) placed
// at (ty, tx), zeros elsewhere; the window [wy0, wy0 + win_h) x [wx0,
// wx0 + win_w).
struct CanvasGeo {
  int out_w, hl, wl, ty, tx, wy0, wx0, win_h, win_w;
};

// The 16 bytes at p, any alignment, from the one or two aligned 16-byte
// words that hold them: the words shifted into place by a barrel of
// selects (by 2 words, by 1 word, then a funnel shift of bytes).
__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  const uint4* a = reinterpret_cast<const uint4*>(at & ~uintptr_t(15));
  const unsigned k = static_cast<unsigned>(at & 15);
  const uint4 lo = __ldg(a);
  if (k == 0) return lo;
  const uint4 hi = __ldg(a + 1);  // holds the range's last byte
  uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const bool by2 = k & 8, by1 = k & 4;
#pragma unroll
  for (int i = 0; i < 6; ++i) w[i] = by2 ? w[i + 2] : w[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) w[i] = by1 ? w[i + 1] : w[i];
  const unsigned sh = (k & 3) * 8;
  return make_uint4(__funnelshift_r(w[0], w[1], sh),
                    __funnelshift_r(w[1], w[2], sh),
                    __funnelshift_r(w[2], w[3], sh),
                    __funnelshift_r(w[3], w[4], sh));
}

// Block b of a grid of n_win window blocks and n_stream stream blocks,
// the stream blocks spread evenly: returns true for a stream block, with
// its index (its canvas row) in `index`, else the window block's index.
__device__ __forceinline__ bool block_kind(unsigned b, unsigned n_win,
                                           unsigned n_stream,
                                           unsigned& index) {
  const unsigned long long n = n_win + n_stream;
  const unsigned c0 = static_cast<unsigned>(b * n_stream / n);
  const unsigned c1 = static_cast<unsigned>((b + 1ull) * n_stream / n);
  index = c1 > c0 ? c0 : b - c0;
  return c1 > c0;
}

// Canvas row y's bytes of pixels [x0, x1): the base (the left image's
// bytes, or zeros), as whole 16-byte words where the word lies inside
// the range, else the range's bytes of it one by one.
__device__ __forceinline__ void stream_bytes(uint8_t* __restrict__ out,
                                             const uint8_t* __restrict__ left,
                                             const CanvasGeo& g, int y,
                                             int x0, int x1) {
  if (x1 <= x0) return;
  const int row = 3 * y * g.out_w;  // the row's first byte
  const int b = row + 3 * x0, e = row + 3 * x1;
  const int lb0 = row + 3 * g.tx, lb1 = lb0 + 3 * g.wl;  // the left's bytes
  const int ly = y - g.ty;
  const bool rows = ly >= 0 && ly < g.hl;
  const int lofs = (ly * g.wl - g.tx) * 3 - row;  // left byte - canvas byte
  const int a0 = b & ~15;
  const int words = (((e + 15) & ~15) - a0) >> 4;
  for (int k = threadIdx.x; k < words; k += CANVAS_THREADS) {
    const int w0 = a0 + 16 * k;
    if (w0 >= b && w0 + 16 <= e) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (rows && w0 >= lb0 && w0 + 16 <= lb1) {
        v = load16(left + (lofs + w0));
      } else if (rows && w0 + 16 > lb0 && w0 < lb1) {  // the left's edge
        uint32_t q[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          q[i] = 0u;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = w0 + 4 * i + u;
            if (c >= lb0 && c < lb1)
              q[i] |= static_cast<uint32_t>(__ldg(left + (lofs + c)))
                      << (8 * u);
          }
        }
        v = make_uint4(q[0], q[1], q[2], q[3]);
      }
      *reinterpret_cast<uint4*>(out + w0) = v;
      continue;
    }
    for (int c = max(w0, b); c < min(w0 + 16, e); ++c)
      out[c] = rows && c >= lb0 && c < lb1 ? __ldg(left + (lofs + c)) : 0;
  }
}

// Stream block y: canvas row y's pixels outside the window.
__device__ __forceinline__ void stream_row(uint8_t* __restrict__ out,
                                           const uint8_t* __restrict__ left,
                                           const CanvasGeo& g, int y) {
  if (y < g.wy0 || y >= g.wy0 + g.win_h || g.win_w == 0) {
    stream_bytes(out, left, g, y, 0, g.out_w);
  } else {
    stream_bytes(out, left, g, y, 0, g.wx0);
    stream_bytes(out, left, g, y, g.wx0 + g.win_w, g.out_w);
  }
}

}  // namespace
