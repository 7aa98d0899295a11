// Multiband's Laplacian pyramid (ops/blend.py::laplacian_blend) as two
// stencil kernels: REDUCE (the 5x5 binomial blur with a replicate border,
// decimated by 2) and the collapse step (EXPAND fused with the band and
// the collapse that consume it).
//
// Replaces no TPU kernel: the JAX package leaves the pyramid to XLA
// (pano_tpu/ops/blend.py), which fuses it on the TPU. The plain PyTorch
// route runs each tap as its own elementwise pass over a full plane:
// ~50 launches a blur, ~100 an expand, ~1,000 a 5-level blend of two
// images and a mask, each pass reading and writing the whole level.
//
// What bounds them on an H100: bytes. A chain window is ~1504x2016; the
// blend reads its two images and the mask at level 0 twice (REDUCE and
// the last collapse step), 7 planes of 12 MB, and writes the 3-plane
// result, 36 MB; the coarser levels add a third of that. ~0.22 GB, about
// 65 us at 3.35 TB/s, where the tap-per-launch route moves several GB.
// What the design does about it:
//
// - REDUCE computes only the kept even samples, all channels of a pixel
//   in one thread, and reads the replicate border as clamped indices:
//   no padded plane, no discarded 3/4 of the blur. The taps of
//   neighbouring threads overlap and are served by L1.
// - The collapse step computes, per fine pixel, the expand of the coarse
//   level straight from the coarse samples: the taps that land on the
//   zero-stuffed samples are skipped, and the normaliser (the blurred
//   stuffed ones-field) is the product of the hit taps' 1-D weights. It
//   expands the two coarse Gaussians and the coarse result together and
//   writes only the next result: the Laplacian bands, the blended band
//   and the expanded planes never reach device memory.
// - Planes are passed as (pointer, row stride, column stride), so level
//   0 reads the channels of the (H, W, 3) images in place, with no
//   transposing copy.
//
// Exactness: built with -fmad=false, every value is the plain route's,
// bit for bit. REDUCE runs the 25 taps in row-major order, t0 then acc +
// t_k, each weight (k_i k_j / 256, k = 1 4 6 4 1) exact in f32. The
// expand's sum runs the hit taps in the same row-major order; a skipped
// tap is a +0 product, which leaves the running sum unchanged. Its
// normaliser is a sum of multiples of 1/256 no larger than 1/4, exact in
// any order; the quotient is one IEEE division. Band and collapse keep
// the plain operations and order: la = ga - up(ga'), lb = gb - up(gb'),
// m = clamp(gm, 0, 1), band = la * (1 - m) + lb * m, out = up(out') +
// band.
#include "common.cuh"

namespace {

constexpr int MAX_PLANES = 9;  // the collapse's coarse inputs: a, b, out
constexpr int REDUCE_CH = 7;   // most channels of a REDUCE: a, b, mask
constexpr int BX = 32, BY = 8;

// Element (y, x) of a plane lies at p[y * rs + x * cs].
struct Plane {
  float* p;
  int rs;
  int cs;
};
struct Planes {
  Plane c[MAX_PLANES];
};

// The 1-D binomial tap k_i of 1 4 6 4 1 (i in 0..4).
__device__ __forceinline__ int k1(int i) {
  return i == 2 ? 6 : ((i & 1) ? 4 : 1);
}

__device__ __forceinline__ float at(const Plane& q, int y, int x) {
  return __ldg(q.p + y * q.rs + x * q.cs);
}

// One thread per kept output pixel (Y, X) of the (oh, ow) level, all
// n_ch channels: out[ch][Y][X] = sum over the 5x5 taps of
// in[ch][clamp(2Y + i - 2)][clamp(2X + j - 2)] * k_i k_j / 256.
__global__ void __launch_bounds__(BX* BY)
    pyramid_reduce_kernel(const __grid_constant__ Planes in, int n_ch,
                          int h, int w, float* __restrict__ out, int oh,
                          int ow) {
  const int X = blockIdx.x * BX + threadIdx.x;
  const int Y = blockIdx.y * BY + threadIdx.y;
  if (X >= ow || Y >= oh) return;
  int r[5], c[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    r[k] = min(max(2 * Y + k - 2, 0), h - 1);
    c[k] = min(max(2 * X + k - 2, 0), w - 1);
  }
#pragma unroll
  for (int ch = 0; ch < REDUCE_CH; ++ch) {
    if (ch >= n_ch) break;
    const Plane& q = in.c[ch];
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const float wt = static_cast<float>(k1(i) * k1(j)) * (1.0f / 256.0f);
        const float t = at(q, r[i], c[j]) * wt;
        acc = (i == 0 && j == 0) ? t : acc + t;
      }
    }
    out[(static_cast<size_t>(ch) * oh + Y) * ow + X] = acc;
  }
}

// One thread per fine pixel (y, x) of the (H, W) level. `fine` holds ga
// (3), gb (3) and gm (1) at this level; `coarse` the (h, w) level's ga
// (3), gb (3) and result (3), unread when has_coarse is 0 (the top
// level: out = band of ga and gb). Writes the 3 planes of `out`.
__global__ void __launch_bounds__(BX* BY)
    pyramid_collapse_kernel(const __grid_constant__ Planes fine,
                            const __grid_constant__ Planes coarse,
                            const __grid_constant__ Planes out, int H,
                            int W, int h, int w, int has_coarse) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= W || y >= H) return;
  float up[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) up[q] = 0.0f;
  if (has_coarse) {
    // The taps i (rows) and j (columns) that land on a stuffed sample:
    // y + i - 2 even and inside the (2h, 2w) stuffed plane; at most 3 a
    // side, in increasing order, so the loop below is row-major.
    int cy[3], cx[3], ky[3], kx[3];
    int sy = 0, sx = 0;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int i = (y & 1) + 2 * s;
      const int r = y + i - 2;
      const bool vy = i <= 4 && r >= 0 && r < 2 * h;
      cy[s] = r >> 1;
      ky[s] = vy ? k1(i) : 0;
      sy += ky[s];
      const int j = (x & 1) + 2 * s;
      const int c = x + j - 2;
      const bool vx = j <= 4 && c >= 0 && c < 2 * w;
      cx[s] = c >> 1;
      kx[s] = vx ? k1(j) : 0;
      sx += kx[s];
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (ky[s] == 0) continue;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        if (kx[t] == 0) continue;
        const float wt = static_cast<float>(ky[s] * kx[t]) * (1.0f / 256.0f);
#pragma unroll
        for (int q = 0; q < 9; ++q)
          up[q] = up[q] + at(coarse.c[q], cy[s], cx[t]) * wt;
      }
    }
    const float den =
        fmaxf(static_cast<float>(sy * sx) * (1.0f / 256.0f), 1e-8f);
#pragma unroll
    for (int q = 0; q < 9; ++q) up[q] = __fdiv_rn(up[q], den);
  }
  const float m = fminf(fmaxf(at(fine.c[6], y, x), 0.0f), 1.0f);
  const float om = 1.0f - m;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float la = at(fine.c[ch], y, x);
    float lb = at(fine.c[3 + ch], y, x);
    if (has_coarse) {
      la = la - up[ch];
      lb = lb - up[3 + ch];
    }
    const float band = la * om + lb * m;
    const Plane& o = out.c[ch];
    o.p[y * o.rs + x * o.cs] = has_coarse ? up[6 + ch] + band : band;
  }
}

// Whether every element of an (h, w) plane has a non-negative int offset.
bool plane_fits(const Plane& q, int h, int w) {
  if (q.p == nullptr || q.rs < 0 || q.cs < 0) return false;
  return static_cast<long long>(h - 1) * q.rs +
             static_cast<long long>(w - 1) * q.cs <=
         0x7fffffffLL;
}

bool planes_fit(const Planes& s, int n, int h, int w) {
  for (int i = 0; i < n; ++i)
    if (!plane_fits(s.c[i], h, w)) return false;
  return true;
}

dim3 grid_of(int h, int w) { return dim3(pano_cdiv(w, BX), pano_cdiv(h, BY)); }

}  // namespace

// REDUCE: `planes`, a HOST array of n_ch Plane rows, each an (h, w) f32
// plane; `out` the contiguous (n_ch, (h + 1) / 2, (w + 1) / 2) f32 level.
PANO_API int pano_pyramid_reduce(const void* planes, int n_ch, int h, int w,
                                 void* out, void* stream) {
  if (n_ch < 1 || n_ch > REDUCE_CH || h < 1 || w < 1 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Planes in{};
  for (int i = 0; i < n_ch; ++i) in.c[i] = static_cast<const Plane*>(planes)[i];
  const int oh = (h + 1) / 2, ow = (w + 1) / 2;
  if (!planes_fit(in, n_ch, h, w) ||
      static_cast<long long>(n_ch) * oh * ow > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  pyramid_reduce_kernel<<<grid_of(oh, ow), dim3(BX, BY), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      in, n_ch, h, w, static_cast<float*>(out), oh, ow);
  return static_cast<int>(cudaGetLastError());
}

// The collapse step: `fine` a HOST array of 7 Plane rows (ga, gb, gm) of
// the (H, W) level; `coarse` one of 9 (ga, gb, result) of the (h, w)
// level, or null at the top level; `out` one of 3 planes of (H, W) to
// write, which overlap no input.
PANO_API int pano_pyramid_collapse(const void* fine, const void* coarse,
                                   const void* out, int H, int W, int h,
                                   int w, void* stream) {
  if (H < 1 || W < 1 || fine == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Planes f{}, c{}, o{};
  for (int i = 0; i < 7; ++i) f.c[i] = static_cast<const Plane*>(fine)[i];
  for (int i = 0; i < 3; ++i) o.c[i] = static_cast<const Plane*>(out)[i];
  const int has_coarse = coarse != nullptr;
  if (has_coarse) {
    for (int i = 0; i < 9; ++i) c.c[i] = static_cast<const Plane*>(coarse)[i];
    if (h < 1 || w < 1 || 2LL * h < H || 2LL * w < W ||
        !planes_fit(c, 9, h, w))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!planes_fit(f, 7, H, W) || !planes_fit(o, 3, H, W))
    return static_cast<int>(cudaErrorInvalidValue);
  pyramid_collapse_kernel<<<grid_of(H, W), dim3(BX, BY), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      f, c, o, H, W, h, w, has_coarse);
  return static_cast<int>(cudaGetLastError());
}
