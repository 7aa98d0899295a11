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
// What bounds it on an H100: memory traffic is one read of the 3-byte
// pixels (~39 MB at 4156x3117) and one write of a quarter-size f32 plane
// (~13 MB), a few microseconds at 3.35 TB/s; the ~60 flops per pixel of
// stencil arithmetic (~0.8 GFLOP) dominate. The design keeps every
// intermediate in shared memory: one block owns a 32x32 pixel tile, loads
// its 40x40 gray window (4-px halo: gray 0, Sobel 1, Gaussian 2, NMS 1)
// once, and builds gradients, the vertical and horizontal Gaussian passes
// and R in shared memory (38 KB), so nothing but the folded scores is
// written to device memory.
//
// Rounding: the file is built with -fmad=false and every sum is written
// in the plain version's order (weights in the order b, g, r; Gaussian
// taps 0..4 left to right; det - (k*tr)*tr), so the kernel reproduces the
// plain PyTorch chain bit for bit. Gray values and Sobel gradients are
// small integers, exact in any order; only the Gaussian and R round.
#include "common.cuh"

namespace {

constexpr int TILE = 32;            // pixels per block side
constexpr int HALO = 4;
constexpr int GW = TILE + 2 * HALO;  // 40: gray window
constexpr int DW = TILE + 6;         // 38: gradients (halo 3)
constexpr int RW = TILE + 2;         // 34: Gaussian rows / R (halo 1)
constexpr int NT = 256;              // threads; one per output slot

__global__ void __launch_bounds__(NT)
harris_scores_kernel(const uint8_t* __restrict__ img, float* __restrict__ out,
                     int h, int w, float k, float thresh, float g0, float g1,
                     float g2) {
  __shared__ float gray[GW][GW];
  __shared__ float gxs[DW][DW];
  __shared__ float gys[DW][DW];
  __shared__ float vsm[3][RW][DW];
  __shared__ float rsm[RW][RW];

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;

  // Gray window: pixel (y0 - 4 + r, x0 - 4 + c); 0 outside the image.
  for (int i = tid; i < GW * GW; i += NT) {
    const int r = i / GW, c = i % GW;
    const int y = y0 - HALO + r, x = x0 - HALO + c;
    float v = 0.0f;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const uint8_t* p = img + (static_cast<size_t>(y) * w + x) * 3;
      v = rintf(0.114f * static_cast<float>(p[0]) +
                0.587f * static_cast<float>(p[1]) +
                0.299f * static_cast<float>(p[2]));
    }
    gray[r][c] = v;
  }
  __syncthreads();

  // Sobel gradients at pixel (y0 - 3 + r, x0 - 3 + c), zero outside
  // [1, dim-2]; that pixel sits at gray[r + 1][c + 1].
  for (int i = tid; i < DW * DW; i += NT) {
    const int r = i / DW, c = i % DW;
    const int y = y0 - 3 + r, x = x0 - 3 + c;
    float gx = 0.0f, gy = 0.0f;
    if (y >= 1 && y <= h - 2 && x >= 1 && x <= w - 2) {
      const float a = gray[r][c], b = gray[r][c + 1], d = gray[r][c + 2];
      const float e = gray[r + 1][c], f = gray[r + 1][c + 2];
      const float g = gray[r + 2][c], hh = gray[r + 2][c + 1];
      const float ii = gray[r + 2][c + 2];
      gx = -a + d + -2.0f * e + 2.0f * f + -g + ii;
      gy = -a + -2.0f * b + -d + g + 2.0f * hh + ii;
    }
    gxs[r][c] = gx;
    gys[r][c] = gy;
  }
  __syncthreads();

  // Vertical Gaussian pass over the three gradient products: row r is
  // pixel row y0 - 1 + r, column c is pixel column x0 - 3 + c.
  for (int i = tid; i < 3 * RW * DW; i += NT) {
    const int p = i / (RW * DW);
    const int r = (i / DW) % RW, c = i % DW;
    float t[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const float ax = gxs[r + j][c], ay = gys[r + j][c];
      t[j] = p == 0 ? ax * ax : (p == 1 ? ay * ay : ax * ay);
    }
    float acc = t[0] * g0;
    acc = acc + t[1] * g1;
    acc = acc + t[2] * g2;
    acc = acc + t[3] * g1;
    acc = acc + t[4] * g0;
    vsm[p][r][c] = acc;
  }
  __syncthreads();

  // Horizontal pass and the response at pixel (y0 - 1 + r, x0 - 1 + c);
  // the smoothed products are zero outside [2, dim-3], and so is R.
  for (int i = tid; i < RW * RW; i += NT) {
    const int r = i / RW, c = i % RW;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    float resp = 0.0f;
    if (y >= 2 && y <= h - 3 && x >= 2 && x <= w - 3) {
      float s[3];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        float acc = vsm[p][r][c] * g0;
        acc = acc + vsm[p][r][c + 1] * g1;
        acc = acc + vsm[p][r][c + 2] * g2;
        acc = acc + vsm[p][r][c + 3] * g1;
        acc = acc + vsm[p][r][c + 4] * g0;
        s[p] = acc;
      }
      const float det = s[0] * s[1] - s[2] * s[2];
      const float tr = s[0] + s[1];
      resp = det - k * tr * tr;
    }
    rsm[r][c] = resp;
  }
  __syncthreads();

  // Strict NMS + offset packing + 2x2 fold: thread = output slot.
  const int sr = tid / (TILE / 2), sc = tid % (TILE / 2);
  const float neg_inf = __int_as_float(0xff800000);
  float best = neg_inf;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int y = y0 + 2 * sr + a, x = x0 + 2 * sc + b;
      const int ry = 2 * sr + a + 1, rx = 2 * sc + b + 1;
      if (y >= 1 && y < h - 1 && x >= 1 && x < w - 1) {
        const float ctr = rsm[ry][rx];
        float nmax = rsm[ry - 1][rx - 1];
        nmax = fmaxf(nmax, rsm[ry - 1][rx]);
        nmax = fmaxf(nmax, rsm[ry - 1][rx + 1]);
        nmax = fmaxf(nmax, rsm[ry][rx - 1]);
        nmax = fmaxf(nmax, rsm[ry][rx + 1]);
        nmax = fmaxf(nmax, rsm[ry + 1][rx - 1]);
        nmax = fmaxf(nmax, rsm[ry + 1][rx]);
        nmax = fmaxf(nmax, rsm[ry + 1][rx + 1]);
        if (ctr > thresh && ctr > nmax) {
          const int bits =
              (__float_as_int(ctr) & ~3) | (((y & 1) << 1) | (x & 1));
          best = fmaxf(best, __int_as_float(bits));
        }
      }
    }
  }
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  const int oy = blockIdx.y * (TILE / 2) + sr;
  const int ox = blockIdx.x * (TILE / 2) + sc;
  if (oy < h2 && ox < w2) out[static_cast<size_t>(oy) * w2 + ox] = best;
}

}  // namespace

PANO_API int pano_harris_scores(const void* img, void* out, int h, int w,
                                float k, float thresh, float g0, float g1,
                                float g2, void* stream) {
  const dim3 grid(pano_cdiv(w, TILE), pano_cdiv(h, TILE));
  harris_scores_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<float*>(out), h, w, k,
      thresh, g0, g1, g2);
  return static_cast<int>(cudaGetLastError());
}
