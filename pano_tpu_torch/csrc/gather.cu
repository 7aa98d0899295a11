// K2: the whole descriptor step, border test included, straight from the
// u8 BGR image.
//
// Replaces the TPU kernel pano_tpu/ops/pallas_gather.py (_make_kernel,
// launched by _gather_kernel_call) together with what
// ops/match.py::extract_patch_descriptors runs around it: the border test,
// the unpack, the mask and the pad. For keypoint k at (x, y):
//   border_valid[k] = kp_valid[k] & x >= b & y >= b & x < w - b & y < h - b
// with b = p / 2 (the JAX rule x + b < w, without its int32 wrap), and
// descriptor row k holds, at column (dy*p + dx)*3 + c, channel c of the
// pixel (y + dy - b, x + dx - b) as f32 where border_valid[k], zeros
// elsewhere and in the padding columns p*p*3 .. d_pad-1. A border-valid
// patch lies inside the image, so no tap needs the XLA path's per-tap
// clamp, and no pixel of any other row is read: such a row may hold any
// coordinates.
//
// What bounds it on an H100: not its ~4.9 MB of traffic at K = 8192, p =
// 5 (75 patch bytes and 9 bytes of keypoint a row in, a 512-byte row and
// a flag out: ~1.5 us at 3.35 TB/s), but a launch's fixed cost and two
// dependent trips to memory, keypoint then pixels. The first design ran a
// thread per output entry that divided its index by d_pad in 64 bits,
// then by 3 and by p, and loaded the keypoint, its flag and its pixel in
// a chain: ~200 instructions an entry, ~7 us of issue alone. This design:
//
// - A warp per keypoint row. Lane l owns columns 128j + 4l .. 128j + 4l +
//   3 of each 128-column chunk j of the row and stores them as one float4:
//   a chunk of a row is one coalesced 512-byte store. More keypoints a
//   warp (2, 4, 8, unrolled so that their loads overlap) measured no
//   faster than more warps (PERF.md, section 6).
// - Each lane decodes its columns to byte offsets (dy*w + dx)*3 + c from
//   the patch's top-left byte, without a division instruction: p = 3, 5
//   and 7 are compile-time (the compiler divides by multiplying), any
//   other odd p runs the same code and takes tap / p as the high word of
//   tap times the host's 64-bit reciprocal (exact, see launch).
// - Every lane loads the keypoint's coordinates and flag itself
//   (broadcast loads: one transaction a warp each). While they are on
//   their way, the lanes whose four columns are all padding (53 of 128 at
//   p = 5) store their zeros; then the border test, lane 0 stores the
//   flag, and the other lanes load their bytes (none for a border-invalid
//   row) and store them.
// - Bytes become floats by the exact 2^23 trick (an OR and an add), not by
//   the conversion unit.
//
// Why no TMA or cp.async: a patch row is 3p bytes (15 at p = 5) at any
// byte alignment; cp.async copies 4, 8 or 16 aligned bytes, and a TMA box
// per keypoint costs more to issue than the 75 bytes it brings. Hopper's
// streaming shape (a ring of large tiles) is for dense tiles, not for
// this gather. The stores are what is dense, and they are already whole
// 16-byte vectors a lane.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;  // warps a block, a keypoint each
constexpr int NT = 32 * WARPS;

// A byte (0-255) as a float: the bits 0x4B000000 | v are 2^23 + v.
__device__ __forceinline__ float byte_f(uint32_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

// P > 0: the patch size at compile time; P == 0: p_rt at run time, with
// p_inv = ceil(2^64 / p_rt).
template <int P>
__global__ void __launch_bounds__(NT)
gather_patches_kernel(const uint8_t* __restrict__ img,
                      const int32_t* __restrict__ xy,
                      const uint8_t* __restrict__ kp_valid,
                      float* __restrict__ desc,
                      uint8_t* __restrict__ border_valid, int h, int w,
                      int k, int p_rt, unsigned long long p_inv,
                      int d_pad) {
  const int p = P > 0 ? P : p_rt;
  const int half = p / 2;
  const int used = p * p * 3;
  const int chunks = P > 0 ? (P * P * 3 + 127) / 128 : d_pad / 128;
  const int lane = threadIdx.x & 31;
  const int kk = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (kk >= k) return;

  const int x = xy[2 * kk];
  const int y = xy[2 * kk + 1];
  const bool valid = kp_valid[kk] != 0;
  float4* const row =
      reinterpret_cast<float4*>(desc + static_cast<size_t>(kk) * d_pad);
#pragma unroll
  for (int j = 0; j < chunks; ++j) {
    if (128 * j + 4 * lane >= used)
      row[32 * j + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const bool ok = valid & (x >= half) & (y >= half) & (x < w - half) &
                  (y < h - half);
  if (lane == 0) border_valid[kk] = ok ? 1 : 0;
  // The patch's top-left byte (read only where ok).
  const uint8_t* const base =
      img + (ok ? (static_cast<long long>(y - half) * w + (x - half)) * 3
                : 0LL);
  const int row_bytes = 3 * w;
#pragma unroll
  for (int j = 0; j < chunks; ++j) {
    if (128 * j + 4 * lane >= used) continue;
    uint32_t b[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned d = 128u * j + 4u * lane + c;
      const unsigned tap = d / 3u;
      const unsigned dy =
          P > 0 ? tap / P : static_cast<unsigned>(__umul64hi(tap, p_inv));
      const int off = static_cast<int>(dy) * row_bytes +
                      static_cast<int>(tap - dy * p) * 3 +
                      static_cast<int>(d - 3u * tap);
      b[c] = (ok & (static_cast<int>(d) < used)) ? base[off] : 0u;
    }
    row[32 * j + lane] = make_float4(byte_f(b[0]), byte_f(b[1]),
                                     byte_f(b[2]), byte_f(b[3]));
  }
}

// p_inv = floor((2^64 - 1) / p) + 1 = ceil(2^64 / p) for an odd p > 1, and
// floor(tap * p_inv / 2^64) = tap / p for every 32-bit tap: the product is
// tap / p plus less than tap / 2^64 < 2^-32, while the fraction of tap / p
// is at most 1 - 1/p. For p = 1, p_inv wraps to 0 and every dy is 0, right
// for its one tap (the padding columns read nothing).
template <int P>
void launch(const void* img, const void* xy, const void* kp_valid,
            void* desc, void* border_valid, int h, int w, int k, int p,
            int d_pad, cudaStream_t stream) {
  const unsigned long long p_inv = P > 0 ? 0ull : ~0ull / p + 1;
  gather_patches_kernel<P><<<pano_cdiv(k, WARPS), NT, 0, stream>>>(
      static_cast<const uint8_t*>(img), static_cast<const int32_t*>(xy),
      static_cast<const uint8_t*>(kp_valid), static_cast<float*>(desc),
      static_cast<uint8_t*>(border_valid), h, w, k, p, p_inv, d_pad);
}

}  // namespace

// desc: (k, d_pad) f32 with d_pad = round_up(p*p*3, 128); border_valid:
// (k,) bytes, 0 or 1. k > 0 and p odd (the wrapper checks both).
PANO_API int pano_gather_patches(const void* img, const void* xy,
                                 const void* kp_valid, void* desc,
                                 void* border_valid, int h, int w, int k,
                                 int p, int d_pad, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 3:
      launch<3>(img, xy, kp_valid, desc, border_valid, h, w, k, p, d_pad, s);
      break;
    case 5:
      launch<5>(img, xy, kp_valid, desc, border_valid, h, w, k, p, d_pad, s);
      break;
    case 7:
      launch<7>(img, xy, kp_valid, desc, border_valid, h, w, k, p, d_pad, s);
      break;
    default:
      launch<0>(img, xy, kp_valid, desc, border_valid, h, w, k, p, d_pad, s);
  }
  return static_cast<int>(cudaGetLastError());
}
