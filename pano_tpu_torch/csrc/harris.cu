// K1: fused Harris scores, u8 BGR image -> 2x2 block-folded NMS'd score map.
//
// Replaces the TPU kernel pano_tpu/ops/pallas_harris.py (_make_kernel,
// launched by _scores_batched): gray (BT.601, round half to even) ->
// Sobel with the zero border outside [1, dim-2] -> Ix^2, Iy^2, IxIy ->
// separable 5x5 sigma=1 Gaussian (vertical pass, then horizontal) whose
// output is zero outside [2, dim-3] -> R = det - k*tr^2 -> strict 3x3 NMS
// with the [1, dim-1) border clip and R > thresh -> each peak's in-block
// offset ((y&1)<<1 | (x&1)) in its two mantissa LSBs -> 2x2 block max.
//
// Output layout: (ceil(h/2), ceil(w/2)) f32, -inf where a block holds no
// peak: the layout of the plain version (ops/cuda_harris.py), not the
// TPU kernel's tile-padded one, so harris_detect decodes the same flat
// index on every device. No packed-pixel plane is emitted: the gather and
// warp kernels read the u8 image directly.
//
// What bounds it on an H100: one read of the 3-byte pixels (~39 MB at
// 4156x3117) and one write of the quarter-size f32 map (~13 MB) take
// ~0.016 ms at 3.35 TB/s; the ~100 f32 operations a pixel of stencil
// arithmetic take more, so it is bound by the issue rate of the SIMT
// pipes. The design spends those issue slots on the stencil alone:
//
// - A streaming stencil. Each warp owns a strip of 128 gray columns by
//   STRIP_H + 8 gray rows and walks down it; a thread owns 4 adjacent
//   columns. The vertical taps live in registers as rolling windows: the
//   last two gray rows (Sobel), four partial sums per gradient product
//   (the vertical Gaussian, accumulated forward so each product row is
//   multiplied by g0, g1, g2 once), and the last two rows of R (NMS).
//   The horizontal taps (Sobel, Gaussian, NMS) come from the thread's own
//   columns and one warp shuffle per neighbour value, so no shared memory
//   and no __syncthreads. Lanes 1-30 write 120 output columns; the halo
//   is 8 of 128 columns and 8 of STRIP_H + 8 rows, paid once per strip.
// - Wide loads. A thread's 4 pixels are 12 bytes: three 4-byte words read
//   from the aligned word below them and funnel-shifted into place (a
//   fourth word when they are not 4-byte aligned; every word read holds
//   one of the thread's bytes). The next row's words load while the
//   current row computes. Bytes become floats by the 2^23 trick
//   (0x4B0000bb - 2^23), and gray rounds by adding and subtracting
//   1.5 * 2^23: full-rate f32 ops where a conversion would be quarter
//   rate. No integer division anywhere.
//
// Rounding: the file is built with -fmad=false and every rounded sum is
// written in the plain version's order (gray weights in the order b, g,
// r; Gaussian taps 0..4 left to right, each a product then an add;
// det - (k*tr)*tr), so the kernel reproduces the plain PyTorch chain bit
// for bit. Gray values and Sobel gradients are small integers, exact in
// any order (the Sobel is taken as separable column sums, its doublings
// as explicit fmaf, exact on integers), and neither is ever -0, as in
// the plain chain; the Gaussian and R round, each product once. NMS and
// the fold take maxima, exact in any order.
#include "common.cuh"

namespace {

constexpr int CPT = 4;                        // columns per thread
constexpr int HALO = 4;                       // gray halo: Sobel 1, Gaussian 2, NMS 1
constexpr int OUT_W = 32 * CPT - 2 * HALO;    // 120 output columns per warp
constexpr int STRIP_H = 56;                   // output rows per warp
constexpr int WARPS = 2;                      // warps per block, stacked in y
constexpr unsigned FULL = 0xffffffffu;

// The 12 bytes of pixels xs..xs+3 of row y as three little-endian words;
// zero for pixels outside the image.
__device__ __forceinline__ void load_px(const uint8_t* __restrict__ img, int y,
                                        int xs, int h, int w,
                                        uint32_t (&wd)[3]) {
  wd[0] = wd[1] = wd[2] = 0u;
  if (y < 0 || y >= h) return;
  if (xs >= 0 && xs + CPT <= w) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(img) +
                         (static_cast<size_t>(y) * w + xs) * 3;
    const uint32_t* a = reinterpret_cast<const uint32_t*>(at & ~uintptr_t(3));
    const unsigned sh = static_cast<unsigned>(at & 3) * 8;
    const uint32_t v0 = __ldg(a), v1 = __ldg(a + 1), v2 = __ldg(a + 2);
    const uint32_t v3 = sh ? __ldg(a + 3) : 0u;
    wd[0] = __funnelshift_r(v0, v1, sh);
    wd[1] = __funnelshift_r(v1, v2, sh);
    wd[2] = __funnelshift_r(v2, v3, sh);
  } else {  // the image's left or right edge cuts this thread's pixels
    const uint8_t* row = img + static_cast<size_t>(y) * w * 3;
#pragma unroll
    for (int i = 0; i < 3 * CPT; ++i) {
      const int x = xs + i / 3;
      if (x >= 0 && x < w)
        wd[i / 4] |= static_cast<uint32_t>(row[x * 3 + i % 3]) << (8 * (i % 4));
    }
  }
}

// Byte i of the 12 as a float: 0x4B0000bb is 2^23 + bb exactly.
__device__ __forceinline__ float byte_f(const uint32_t (&wd)[3], int i) {
  return __int_as_float(
             __byte_perm(wd[i / 4], 0x4B000000u, 0x7440u | (i % 4))) -
         8388608.0f;
}

__global__ void __launch_bounds__(32 * WARPS)
harris_scores_kernel(const uint8_t* __restrict__ img, float* __restrict__ out,
                     int h, int w, float k, float thresh, float g0, float g1,
                     float g2) {
  const int lane = threadIdx.x & 31;
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  const int y0 = (blockIdx.y * WARPS + (threadIdx.x >> 5)) * STRIP_H;
  if (y0 >= 2 * h2) return;  // the whole warp
  const int y_end = min(y0 + STRIP_H, 2 * h2);  // output rows [y0, y_end)
  const int xs = blockIdx.x * OUT_W - HALO + CPT * lane;  // even
  const bool writer = lane >= 1 && lane <= 30;
  const float inf = __int_as_float(0x7f800000);

  bool sob_x[CPT], r_x[CPT];  // [1, w-2] (Sobel and NMS), [2, w-3] (R)
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    sob_x[c] = xs + c >= 1 && xs + c <= w - 2;
    r_x[c] = xs + c >= 2 && xs + c <= w - 3;
  }

  // Rolling state at the top of iteration gy: gray rows gy-2 and gy-1;
  // the vertical Gaussian's partial sums of each product plane for rows
  // gy (tap 0 done), gy-1 (taps 0-1), gy-2 (0-2) and gy-3 (0-3); R rows
  // gy-5 and gy-4; the fold's maxima of the last even row.
  float gm2[CPT], gm1[CPT], r0[CPT], r1[CPT];
  float a1[3][CPT], a2[3][CPT], a3[3][CPT], a4[3][CPT];
  float f0 = -inf, f1 = -inf;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    gm2[c] = gm1[c] = r0[c] = r1[c] = 0.0f;
#pragma unroll
    for (int p = 0; p < 3; ++p) a1[p][c] = a2[p][c] = a3[p][c] = a4[p][c] = 0.0f;
  }

  uint32_t cur[3];
  load_px(img, y0 - HALO, xs, h, w, cur);
  for (int gy = y0 - HALO; gy < y_end + HALO; ++gy) {
    uint32_t nxt[3];
    load_px(img, gy + 1, xs, h, w, nxt);

    // Gray row gy (0 outside the image: its bytes are 0).
    float gr[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float v = 0.114f * byte_f(cur, 3 * c) +
                      0.587f * byte_f(cur, 3 * c + 1) +
                      0.299f * byte_f(cur, 3 * c + 2);
      gr[c] = (v + 12582912.0f) - 12582912.0f;  // rint, half to even
    }

    // Sobel at row sy = gy - 1 from column sums of the three gray rows.
    const int sy = gy - 1;
    const bool sob_y = sy >= 1 && sy <= h - 2;
    float s[CPT + 2], d[CPT + 2];  // columns xs-1 .. xs+4
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      s[c + 1] = __fmaf_rn(2.0f, gm1[c], gm2[c]) + gr[c];
      d[c + 1] = gr[c] - gm2[c];
    }
    s[0] = __shfl_up_sync(FULL, s[CPT], 1);
    d[0] = __shfl_up_sync(FULL, d[CPT], 1);
    s[CPT + 1] = __shfl_down_sync(FULL, s[1], 1);
    d[CPT + 1] = __shfl_down_sync(FULL, d[1], 1);

    // Products at row sy, then the vertical Gaussian forward: row sy is
    // tap 0 of row sy+2, ..., tap 4 of row sy-2, which completes (vy).
    float v[3][CPT + 4];  // completed row vy = gy - 3, columns xs-2 .. xs+5
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      float gx = 0.0f, gyv = 0.0f;
      if (sob_y && sob_x[c]) {
        gx = s[c + 2] - s[c];
        gyv = __fmaf_rn(2.0f, d[c + 1], d[c]) + d[c + 2];
      }
      const float prod[3] = {gx * gx, gyv * gyv, gx * gyv};
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const float t0 = prod[p] * g0, t1 = prod[p] * g1, t2 = prod[p] * g2;
        v[p][c + 2] = a4[p][c] + t0;
        a4[p][c] = a3[p][c] + t1;
        a3[p][c] = a2[p][c] + t2;
        a2[p][c] = a1[p][c] + t1;
        a1[p][c] = t0;
      }
    }

    // Horizontal Gaussian and R at row vy.
    const int vy = gy - 3;
    const bool r_y = vy >= 2 && vy <= h - 3;
    float rc[CPT];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      v[p][0] = __shfl_up_sync(FULL, v[p][CPT], 1);
      v[p][1] = __shfl_up_sync(FULL, v[p][CPT + 1], 1);
      v[p][CPT + 2] = __shfl_down_sync(FULL, v[p][2], 1);
      v[p][CPT + 3] = __shfl_down_sync(FULL, v[p][3], 1);
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      float sm[3];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        float acc = v[p][c] * g0;
        acc = acc + v[p][c + 1] * g1;
        acc = acc + v[p][c + 2] * g2;
        acc = acc + v[p][c + 3] * g1;
        acc = acc + v[p][c + 4] * g0;
        sm[p] = acc;
      }
      const float det = sm[0] * sm[1] - sm[2] * sm[2];
      const float tr = sm[0] + sm[1];
      rc[c] = (r_y && r_x[c]) ? det - k * tr * tr : 0.0f;
    }

    // Strict NMS at row ny = gy - 4 (R rows ny-1, ny, ny+1 = r0, r1, rc).
    const int ny = gy - 4;
    const bool nms_y = ny >= 1 && ny <= h - 2;
    float vm[CPT + 2];  // column maxima over the three rows, xs-1 .. xs+4
#pragma unroll
    for (int c = 0; c < CPT; ++c) vm[c + 1] = fmaxf(fmaxf(r0[c], r1[c]), rc[c]);
    vm[0] = __shfl_up_sync(FULL, vm[CPT], 1);
    vm[CPT + 1] = __shfl_down_sync(FULL, vm[1], 1);
    float pk[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float nmax = fmaxf(fmaxf(vm[c], vm[c + 2]), fmaxf(r0[c], rc[c]));
      const float ctr = r1[c];
      const int bits = (__float_as_int(ctr) & ~3) | (((ny & 1) << 1) | (c & 1));
      pk[c] = (nms_y && sob_x[c] && ctr > thresh && ctr > nmax)
                  ? __int_as_float(bits)
                  : -inf;
    }

    // 2x2 fold: xs is even, so columns (0, 1) and (2, 3) are blocks.
    const float c0 = fmaxf(pk[0], pk[1]), c1 = fmaxf(pk[2], pk[3]);
    if ((ny & 1) == 0) {
      f0 = c0;
      f1 = c1;
    } else if (ny >= y0 && writer) {
      float* orow = out + static_cast<size_t>(ny >> 1) * w2;
      const int ox = xs >> 1;
      if (ox < w2) orow[ox] = fmaxf(f0, c0);
      if (ox + 1 < w2) orow[ox + 1] = fmaxf(f1, c1);
    }

#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      gm2[c] = gm1[c];
      gm1[c] = gr[c];
      r0[c] = r1[c];
      r1[c] = rc[c];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) cur[i] = nxt[i];
  }
}

}  // namespace

PANO_API int pano_harris_scores(const void* img, void* out, int h, int w,
                                float k, float thresh, float g0, float g1,
                                float g2, void* stream) {
  const int strips = static_cast<int>(pano_cdiv(2 * ((h + 1) / 2), STRIP_H));
  const dim3 grid(pano_cdiv(2 * ((w + 1) / 2), OUT_W), pano_cdiv(strips, WARPS));
  harris_scores_kernel<<<grid, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<float*>(out), h, w, k,
      thresh, g0, g1, g2);
  return static_cast<int>(cudaGetLastError());
}
