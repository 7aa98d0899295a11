// K1: fused Harris scores, u8 BGR image -> 2x2 block-folded NMS'd score map.
//
// Replaces the TPU kernel pano_tpu/ops/pallas_harris.py (_make_kernel,
// launched by _scores_batched): gray (BT.601, round half to even) ->
// Sobel with the zero border outside [1, dim-2] -> Ix^2, Iy^2, IxIy ->
// separable 5x5 sigma=1 Gaussian (vertical pass, then horizontal) whose
// output is zero outside [2, dim-3] -> R = det - k*tr^2 -> strict n x n
// NMS (n = 2r + 1) with the [r, dim-r) border clip and R > thresh -> each
// peak's in-block offset ((y&1)<<1 | (x&1)) in its two mantissa LSBs ->
// 2x2 block max.
//
// Output layout: (ceil(h/2), ceil(w/2)) f32, -inf where a block holds no
// peak: the layout of the plain version (ops/cuda_harris.py), not the
// TPU kernel's tile-padded one, so harris_detect decodes the same flat
// index on every device. No packed-pixel plane is emitted: the gather and
// warp kernels read the u8 image directly.
//
// A batch of b same-shape images, (b, h, w, 3) u8 -> (b, ceil(h/2),
// ceil(w/2)) f32, is one launch with grid.z = b (the TPU kernel's batched
// grid, _scores_batched): each z-slice offsets the image, the map and
// the R plane by its element and runs the single-image code unchanged.
// Every read stays inside its element: rows outside [0, h) read nothing,
// and the aligned words of a row's bytes hold none of another row's
// (load_px), so element b's last row never reads element b+1.
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
//   multiplied by g0, g1, g2 once), and the last 2r rows of R (NMS).
//   The horizontal taps (Sobel, Gaussian, NMS) come from the thread's own
//   columns and one warp shuffle per neighbour value, so no shared memory
//   and no __syncthreads. The halo is 3 + r rows and, rounded up to even,
//   as many columns on each side (r = 1: lanes 1-30 write 120 of the 128
//   columns; the halo is paid once per strip).
// - The NMS half-width r is a template parameter, r = 1..4 (n = 3, 5,
//   7, 9): a lane's 4 columns hold every neighbour column a shuffle
//   brings. A wider window takes two launches: the same stencil with
//   r = 0 writes the (h, w) R plane, and harris_nms_fold_kernel takes
//   each block's strict n x n maximum test and the fold over it. Wider
//   windows are off the default path (n = 3), and the second pass is a
//   plain loop that leaves a candidate at its first neighbour >= it.
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
constexpr int STRIP_H = 56;                   // output rows per warp
constexpr int MAX_NR = 4;                     // widest NMS half-width of a lane

// The halo of NMS half-width NR (0: the R plane, no NMS): VH gray rows
// (Sobel 1, Gaussian 2, NMS NR) above and below a strip, HH columns on
// each side (VH rounded up to even, so that a lane's first column is
// even and its 4 columns are two fold blocks), OUT_W output columns of a
// warp's 128.
template <int NR>
struct Halo {
  static constexpr int VH = 3 + NR;
  static constexpr int HH = (VH + 1) & ~1;
  static constexpr int OUT_W = 32 * CPT - 2 * HH;
};
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

// NR = 1..4: the folded map `out`, (ceil(h/2), ceil(w/2)). NR = 0: the
// (h, w) R plane instead, for harris_nms_fold_kernel. The default path's
// NR = 1 is held to 128 registers, 8 blocks an SM: left to itself, ptxas
// took 148 once the batch offsets came in, and 6 blocks an SM ran 27 %
// slower.
template <int NR>
__global__ void __launch_bounds__(32 * WARPS, NR == 1 ? 8 : 1)
harris_scores_kernel(const uint8_t* __restrict__ img, float* __restrict__ out,
                     int h, int w, float k, float thresh, float g0, float g1,
                     float g2) {
  constexpr int VH = Halo<NR>::VH, HH = Halo<NR>::HH;
  constexpr int OUT_W = Halo<NR>::OUT_W;
  constexpr int NROWS = NR > 0 ? 2 * NR : 1;  // R rows kept for the NMS
  const int lane = threadIdx.x & 31;
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  // This z-slice's element of the batch.
  img += static_cast<size_t>(blockIdx.z) * h * w * 3;
  out += static_cast<size_t>(blockIdx.z) *
         (NR > 0 ? static_cast<size_t>(h2) * w2 : static_cast<size_t>(h) * w);
  const int y0 = (blockIdx.y * WARPS + (threadIdx.x >> 5)) * STRIP_H;
  if (y0 >= 2 * h2) return;  // the whole warp
  const int y_end = min(y0 + STRIP_H, 2 * h2);  // output rows [y0, y_end)
  const int xs = blockIdx.x * OUT_W - HH + CPT * lane;  // even
  // This lane's columns inside the warp's output columns: (0, 1), (2, 3).
  const int rel = CPT * lane - HH;
  const bool writer0 = rel >= 0 && rel < OUT_W;
  const bool writer1 = rel + 2 >= 0 && rel + 2 < OUT_W;
  const float inf = __int_as_float(0x7f800000);

  // [1, w-2] (Sobel), [2, w-3] (R), [NR, w-1-NR] (NMS)
  bool sob_x[CPT], r_x[CPT], nms_x[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    sob_x[c] = xs + c >= 1 && xs + c <= w - 2;
    r_x[c] = xs + c >= 2 && xs + c <= w - 3;
    nms_x[c] = xs + c >= NR && xs + c <= w - 1 - NR;
  }

  // Rolling state at the top of iteration gy: gray rows gy-2 and gy-1;
  // the vertical Gaussian's partial sums of each product plane for rows
  // gy (tap 0 done), gy-1 (taps 0-1), gy-2 (0-2) and gy-3 (0-3); R rows
  // gy-3-2NR .. gy-4 (rr[0] the oldest); the fold's maxima of the last
  // even row.
  float gm2[CPT], gm1[CPT], rr[NROWS][CPT];
  float a1[3][CPT], a2[3][CPT], a3[3][CPT], a4[3][CPT];
  float f0 = -inf, f1 = -inf;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    gm2[c] = gm1[c] = 0.0f;
#pragma unroll
    for (int q = 0; q < NROWS; ++q) rr[q][c] = 0.0f;
#pragma unroll
    for (int p = 0; p < 3; ++p) a1[p][c] = a2[p][c] = a3[p][c] = a4[p][c] = 0.0f;
  }

  uint32_t cur[3];
  load_px(img, y0 - VH, xs, h, w, cur);
  for (int gy = y0 - VH; gy < y_end + VH; ++gy) {
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

    if constexpr (NR == 0) {  // the R plane: row vy, this lane's columns
      if (vy >= y0 && vy < h) {
        float* orow = out + static_cast<size_t>(vy) * w;
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (rel + c >= 0 && rel + c < OUT_W && xs + c < w) orow[xs + c] = rc[c];
      }
    } else {
      // Strict NMS at row ny = gy - 3 - NR (R rows ny-NR .. ny+NR =
      // rr[0 .. 2NR-1], rc; the centre row is rr[NR]).
      const int ny = gy - VH;
      const bool nms_y = ny >= NR && ny <= h - 1 - NR;
      // Column maxima over the 2NR+1 rows, columns xs-NR .. xs+3+NR.
      float vm[CPT + 2 * NR];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float m = rr[0][c];
#pragma unroll
        for (int q = 1; q < 2 * NR; ++q) m = fmaxf(m, rr[q][c]);
        vm[NR + c] = fmaxf(m, rc[c]);
      }
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        vm[j] = __shfl_up_sync(FULL, vm[CPT + j], 1);
        vm[NR + CPT + j] = __shfl_down_sync(FULL, vm[NR + j], 1);
      }
      float pk[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        // The other columns of the window, then the centre column's
        // other rows.
        float hm = vm[c];
#pragma unroll
        for (int dx = 1 - NR; dx <= NR; ++dx)
          if (dx != 0) hm = fmaxf(hm, vm[NR + c + dx]);
        float cm = rc[c];
#pragma unroll
        for (int q = 0; q < 2 * NR; ++q)
          if (q != NR) cm = fmaxf(rr[q][c], cm);
        const float nmax = fmaxf(hm, cm);
        const float ctr = rr[NR][c];
        const int bits = (__float_as_int(ctr) & ~3) | (((ny & 1) << 1) | (c & 1));
        pk[c] = (nms_y && nms_x[c] && ctr > thresh && ctr > nmax)
                    ? __int_as_float(bits)
                    : -inf;
      }

      // 2x2 fold: xs is even, so columns (0, 1) and (2, 3) are blocks.
      const float c0 = fmaxf(pk[0], pk[1]), c1 = fmaxf(pk[2], pk[3]);
      if ((ny & 1) == 0) {
        f0 = c0;
        f1 = c1;
      } else if (ny >= y0) {
        float* orow = out + static_cast<size_t>(ny >> 1) * w2;
        const int ox = xs >> 1;
        if (writer0 && ox < w2) orow[ox] = fmaxf(f0, c0);
        if (writer1 && ox + 1 < w2) orow[ox + 1] = fmaxf(f1, c1);
      }
    }

#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      gm2[c] = gm1[c];
      gm1[c] = gr[c];
#pragma unroll
      for (int q = 0; q + 1 < NROWS; ++q) rr[q][c] = rr[q + 1][c];
      rr[NROWS - 1][c] = rc[c];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) cur[i] = nxt[i];
  }
}

// Windows wider than 9: the strict n x n maximum test and the 2x2 fold
// over the R plane, one thread per output block. A candidate (inside
// the [r, dim-r) border, R > thresh) is a peak when it exceeds every
// other R of its window; the loop stops at the first that it does not.
// Element z's rows are rows z * h.. of the (b * h, w) R plane and z * h2..
// of the (b * h2, w2) map: the batch offset rides in the row index. (As
// offset pointers, resp and out stayed in registers through the loop
// where the parameters are read from the constant bank: 33 registers
// against 27, 6 blocks of 256 an SM against 8.)
constexpr int NMS_BX = 32, NMS_BY = 8;

__global__ void __launch_bounds__(NMS_BX* NMS_BY)
harris_nms_fold_kernel(const float* __restrict__ resp, float* __restrict__ out,
                       int h, int w, int r, float thresh) {
  const int bx = blockIdx.x * NMS_BX + threadIdx.x;
  const int by = blockIdx.y * NMS_BY + threadIdx.y;
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  if (bx >= w2 || by >= h2) return;
  const int z_row = static_cast<int>(blockIdx.z) * h;
  float best = -__int_as_float(0x7f800000);
  for (int o = 0; o < 4; ++o) {
    const int y = 2 * by + (o >> 1), x = 2 * bx + (o & 1);
    if (y < r || y > h - 1 - r || x < r || x > w - 1 - r) continue;
    const float ctr = __ldg(resp + static_cast<size_t>(z_row + y) * w + x);
    if (!(ctr > thresh)) continue;
    bool peak = true;
    for (int dy = -r; dy <= r && peak; ++dy) {
      const float* row = resp + static_cast<size_t>(z_row + y + dy) * w + x;
      for (int dx = -r; dx <= r; ++dx) {
        if (dy == 0 && dx == 0) continue;
        if (!(ctr > __ldg(row + dx))) {
          peak = false;
          break;
        }
      }
    }
    if (peak)
      best = fmaxf(best, __int_as_float((__float_as_int(ctr) & ~3) | o));
  }
  out[static_cast<size_t>(static_cast<int>(blockIdx.z) * h2 + by) * w2 + bx] =
      best;
}

template <int NR>
void launch_scores(const uint8_t* img, float* out, int b, int h, int w,
                   float k, float thresh, float g0, float g1, float g2,
                   cudaStream_t stream) {
  const int strips = static_cast<int>(pano_cdiv(2 * ((h + 1) / 2), STRIP_H));
  const dim3 grid(pano_cdiv(2 * ((w + 1) / 2), Halo<NR>::OUT_W),
                  pano_cdiv(strips, WARPS), b);
  harris_scores_kernel<NR><<<grid, 32 * WARPS, 0, stream>>>(
      img, out, h, w, k, thresh, g0, g1, g2);
}

}  // namespace

// `img`: b contiguous (h, w, 3) u8 images; `out`: b (ceil(h/2),
// ceil(w/2)) f32 maps. `nms`: the odd NMS window n >= 3. Above 9, `resp`
// is a (b, h, w) f32 scratch for R; below, it is not read.
PANO_API int pano_harris_scores(const void* img, void* out, void* resp, int b,
                                int h, int w, int nms, float k, float thresh,
                                float g0, float g1, float g2, void* stream) {
  const int r = nms / 2;
  if (nms < 3 || nms % 2 == 0 || (r > MAX_NR && resp == nullptr) || b < 1 ||
      b > 65535 || static_cast<long long>(b) * h > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* src = static_cast<const uint8_t*>(img);
  auto* dst = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: launch_scores<1>(src, dst, b, h, w, k, thresh, g0, g1, g2, s);
      break;
    case 2: launch_scores<2>(src, dst, b, h, w, k, thresh, g0, g1, g2, s);
      break;
    case 3: launch_scores<3>(src, dst, b, h, w, k, thresh, g0, g1, g2, s);
      break;
    case 4: launch_scores<4>(src, dst, b, h, w, k, thresh, g0, g1, g2, s);
      break;
    default: {
      auto* plane = static_cast<float*>(resp);
      launch_scores<0>(src, plane, b, h, w, k, thresh, g0, g1, g2, s);
      const int err = static_cast<int>(cudaGetLastError());
      if (err != 0) return err;
      const dim3 grid(pano_cdiv((w + 1) / 2, NMS_BX),
                      pano_cdiv((h + 1) / 2, NMS_BY), b);
      harris_nms_fold_kernel<<<grid, dim3(NMS_BX, NMS_BY), 0, s>>>(
          plane, dst, h, w, r, thresh);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
