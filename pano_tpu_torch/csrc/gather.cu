// K2: patch descriptors straight from the u8 BGR image.
//
// Replaces the TPU kernel pano_tpu/ops/pallas_gather.py (_make_kernel,
// launched by _gather_kernel_call) together with the unpack, mask and pad
// that ops/match.py::extract_patch_descriptors runs around it: the output
// is the final (K, d_pad) f32 descriptor matrix. Entry
// (k, (dy*p + dx)*3 + c) is channel c of the pixel at the per-tap clamped
// (clip(y + dy - p/2, 0, h-1), clip(x + dx - p/2, 0, w-1)), as the XLA
// path gathers it; columns p*p*3 .. d_pad-1 and the rows of border-invalid
// keypoints are zero.
//
// What bounds it on an H100: K = 8192 keypoints read 75 bytes each and
// write a 4 MB descriptor matrix: a few microseconds of traffic, so the
// launch and the latency of the scattered reads dominate. The TPU kernel's
// band sort and band DMA existed because its scalar gathers were slow;
// here one thread per output entry reads its byte through L2 directly
// (neighbouring threads read neighbouring bytes of one patch row), and
// writes are fully coalesced rows of the descriptor matrix.
#include "common.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
gather_patches_kernel(const uint8_t* __restrict__ img,
                      const int32_t* __restrict__ xy,
                      const uint8_t* __restrict__ border_valid,
                      float* __restrict__ desc, int h, int w, int kcap, int p,
                      int d_pad) {
  const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<long long>(kcap) * d_pad) return;
  const int kk = static_cast<int>(i / d_pad);
  const int d = static_cast<int>(i % d_pad);
  float v = 0.0f;
  if (d < p * p * 3 && border_valid[kk]) {
    const int tap = d / 3, c = d % 3;
    const int dy = tap / p, dx = tap % p;
    const int half = p / 2;
    const int y = min(max(xy[2 * kk + 1] + dy - half, 0), h - 1);
    const int x = min(max(xy[2 * kk] + dx - half, 0), w - 1);
    v = static_cast<float>(img[(static_cast<size_t>(y) * w + x) * 3 + c]);
  }
  desc[i] = v;
}

}  // namespace

PANO_API int pano_gather_patches(const void* img, const void* xy,
                                 const void* border_valid, void* desc, int h,
                                 int w, int kcap, int p, int d_pad,
                                 void* stream) {
  const long long n = static_cast<long long>(kcap) * d_pad;
  const unsigned int blocks = static_cast<unsigned int>((n + NT - 1) / NT);
  gather_patches_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<const int32_t*>(xy),
      static_cast<const uint8_t*>(border_valid), static_cast<float*>(desc), h,
      w, kcap, p, d_pad);
  return static_cast<int>(cudaGetLastError());
}
