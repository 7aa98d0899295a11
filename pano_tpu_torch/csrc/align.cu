// K11: the Gauss-Newton passes of the direct alignment of a pair's
// homography (ops/align.py): one launch a pass over the right image forms
// the photometric residuals against the left image, the 8x8 normal
// equations of the homography's 8 parameters in float64, solves them and
// updates the parameters, all on the card.
//
// Replaces no pallas_call: the JAX package has no direct alignment. The
// port added it for a camera that rotates about its centre, where the
// refine's homography from whole-pixel Harris corners lands tenths of a
// pixel off over the overlap and pixels off at the far corners.
//
// What bounds it on an H100: the float64 sums. Each right pixel inside
// the overlap gives a residual and its 8 Jacobian entries (~90 float32
// operations, four bilinear taps of the left image) and adds 46 products
// to float64 sums (the upper triangle of J^T J, J^T r, r^2, the count):
// ~92 float64 operations, ~17 us a pass at 34 TFLOP/s for the ~6.5 M
// overlap pixels of a 4156x3117 pair, against ~12 us for its ~40 MB of
// image bytes at 3.35 TB/s.
//
// Design. A fixed grid of BLOCKS blocks of THREADS threads walks the right
// image's pixels in a grid-stride loop (so the order of every sum is
// fixed, whatever the card), each thread keeping its 46 sums in registers
// (a walk by row segments, which saves the pixel's division, measured
// 1.6x slower on the card).
// A warp adds its lanes' sums by a shuffle tree, the block its warps' in
// order, and each block writes its 46 sums to its row of `partial`. The
// last block to finish (a ticket after __threadfence, reset by that block
// for the next pass) adds the rows in block order, writes the first pass's
// and the last pass's mean squared residual and count into the state, and
// solves the system: Gauss-Jordan with partial pivoting on the 8 x 9
// augmented matrix in shared memory, a row a thread (the plain version's
// _solve8 order), then adds the step to the parameters unless a step
// entry is not finite, which sets the singular flag for good. One C call
// launches all passes; nothing reads a value on the host.
//
// The per-pixel arithmetic is float32 in the plain version's order
// (ops/cuda_align.py: pass_terms) under -fmad=false; the sums are float64
// in this kernel's fixed order, so kernel and plain version agree to the
// rounding of the float64 sums.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// 3 blocks a streaming multiprocessor of an H100: a thread's 46 float64
// sums take 92 of its at most 170 registers.
constexpr int BLOCKS = 396;
constexpr int NJ = 8;           // parameters
constexpr int NA = NJ * (NJ + 1) / 2;   // upper triangle of J^T J
constexpr int SUMS = NA + NJ + 2;       // + J^T r, r^2, count
// The state's entries after the 8 parameters (ops/cuda_align.py).
constexpr int E_START = 8, E_END = 9, N_START = 10, N_END = 11;
constexpr int SINGULAR = 12;

// Gray of pixel i of an interleaved BGR image: (0.114 b + 0.587 g) +
// 0.299 r.
__device__ __forceinline__ float gray(const unsigned char* __restrict__ img,
                                      long long i) {
  const unsigned char* p = img + 3 * i;
  return (0.114f * static_cast<float>(p[0])
          + 0.587f * static_cast<float>(p[1]))
         + 0.299f * static_cast<float>(p[2]);
}

__global__ void __launch_bounds__(THREADS, 3)
align_gauss_newton_kernel(const unsigned char* __restrict__ left,
                          const unsigned char* __restrict__ right,
                          double* __restrict__ state,
                          double* __restrict__ partial,
                          unsigned int* __restrict__ ticket, int hl, int wl,
                          int hr, int wr, float s, float inv_s, float cxl,
                          float cyl, float cxr, float cyr, int first,
                          int update) {
  __shared__ double sh[WARPS][SUMS];
  __shared__ double tot[SUMS];
  __shared__ double m[NJ][NJ + 1];
  __shared__ int piv;
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float pa = static_cast<float>(state[0]);
  const float pb = static_cast<float>(state[1]);
  const float pc = static_cast<float>(state[2]);
  const float pd = static_cast<float>(state[3]);
  const float pe = static_cast<float>(state[4]);
  const float pf = static_cast<float>(state[5]);
  const float pg = static_cast<float>(state[6]);
  const float ph = static_cast<float>(state[7]);
  const float xmax = static_cast<float>(wl - 1);
  const float ymax = static_cast<float>(hl - 1);

  double acc[SUMS];
#pragma unroll
  for (int k = 0; k < SUMS; ++k) acc[k] = 0.0;
  const int n_px = hr * wr;   // < 2^31 (the wrapper checks)
  for (int i = blockIdx.x * THREADS + tid; i < n_px; i += BLOCKS * THREADS) {
    const int v = i / wr;
    const int u = i - v * wr;
    const float un = (static_cast<float>(u) - cxr) * inv_s;
    const float vn = (static_cast<float>(v) - cyr) * inv_s;
    const float w = (pg * un + ph * vn) + 1.0f;
    const float xn = ((pa * un + pb * vn) + pc) / w;
    const float yn = ((pd * un + pe * vn) + pf) / w;
    const float x = xn * s + cxl;
    const float y = yn * s + cyl;
    // False for a NaN as in the plain version's mask.
    if (!(w > 0.0f && x >= 0.0f && y >= 0.0f && x < xmax && y < ymax)) {
      continue;
    }
    const float fx = floorf(x), fy = floorf(y);
    const float ax = x - fx, ay = y - fy;
    const long long o = static_cast<long long>(fy) * wl
                        + static_cast<long long>(fx);
    const float t00 = gray(left, o), t01 = gray(left, o + 1);
    const float t10 = gray(left, o + wl), t11 = gray(left, o + wl + 1);
    const float d0 = t01 - t00, d1 = t11 - t10;
    const float top = t00 + ax * d0;
    const float bottom = t10 + ax * d1;
    const float r = (top + ay * (bottom - top)) - gray(right, i);
    const float lx = (d0 + ay * (d1 - d0)) * s;
    const float ly = (bottom - top) * s;
    const float iw = 1.0f / w;
    const float q = -(lx * xn + ly * yn);
    const float a0 = lx * iw, a1 = ly * iw, a2 = q * iw;
    const double j[NJ] = {a0 * un, a0 * vn, a0, a1 * un,
                          a1 * vn, a1, a2 * un, a2 * vn};
    const double rd = r;
    int k = 0;
#pragma unroll
    for (int a = 0; a < NJ; ++a) {
#pragma unroll
      for (int b = a; b < NJ; ++b) acc[k++] += j[a] * j[b];
    }
#pragma unroll
    for (int a = 0; a < NJ; ++a) acc[NA + a] += j[a] * rd;
    acc[NA + NJ] += rd * rd;
    acc[NA + NJ + 1] += 1.0;
  }

  // The block's sums: a shuffle tree in each warp, then the warps in order.
#pragma unroll
  for (int k = 0; k < SUMS; ++k) {
    double t = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      t += __shfl_down_sync(0xffffffffu, t, off);
    }
    if (lane == 0) sh[warp][k] = t;
  }
  __syncthreads();
  if (tid < SUMS) {
    double t = 0.0;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) t += sh[wi][tid];
    partial[static_cast<long long>(blockIdx.x) * SUMS + tid] = t;
  }
  // This block's row before its ticket; the last block reads them all.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  if (tid < SUMS) {
    double t = 0.0;
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b) {
      t += __ldcg(partial + static_cast<long long>(b) * SUMS + tid);
    }
    tot[tid] = t;
  }
  __syncthreads();
  if (tid == 0) {
    const double mse = tot[NA + NJ] / tot[NA + NJ + 1];
    if (first) {
      state[E_START] = mse;
      state[N_START] = tot[NA + NJ + 1];
    }
    if (!update) {
      state[E_END] = mse;
      state[N_END] = tot[NA + NJ + 1];
    }
    *ticket = 0u;   // for the next pass
  }
  if (!update) return;

  // [J^T J | -J^T r], row `tid` by thread `tid`.
  if (tid < NJ) {
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      const int a = tid < c ? tid : c, b = tid < c ? c : tid;
      m[tid][c] = tot[a * NJ - a * (a - 1) / 2 + (b - a)];
    }
    m[tid][NJ] = -tot[NA + tid];
  }
  __syncthreads();
  for (int col = 0; col < NJ; ++col) {
    // The first largest |m[r][col]|, r >= col, a NaN first (torch.argmax).
    if (tid == 0) {
      int p = col;
      double best = fabs(m[col][col]);
      for (int r = col + 1; r < NJ; ++r) {
        const double a = fabs(m[r][col]);
        if (best == best && (a > best || a != a)) {
          p = r;
          best = a;
        }
      }
      piv = p;
    }
    __syncthreads();
    if (tid <= NJ && piv != col) {
      const double t = m[col][tid];
      m[col][tid] = m[piv][tid];
      m[piv][tid] = t;
    }
    __syncthreads();
    if (tid < NJ && tid != col) {
      const double f = m[tid][col] / m[col][col];
#pragma unroll
      for (int c = 0; c <= NJ; ++c) m[tid][c] = m[tid][c] - f * m[col][c];
    }
    __syncthreads();
  }
  if (tid == 0) {
    double d[NJ];
    bool finite = true;
#pragma unroll
    for (int r = 0; r < NJ; ++r) {
      d[r] = m[r][NJ] / m[r][r];
      finite = finite && isfinite(d[r]);
    }
    if (finite && state[SINGULAR] == 0.0) {
#pragma unroll
      for (int r = 0; r < NJ; ++r) state[r] += d[r];
    } else {
      state[SINGULAR] = 1.0;
    }
  }
}

}  // namespace

// left: (hl, wl, 3) u8, right: (hr, wr, 3) u8; state: (16,) f64, the
// parameters in its first 8 entries; scratch: BLOCKS * 46 f64 of partial
// sums and 8 bytes of ticket, zeroed here; passes >= 2: passes - 1
// updating, then one measuring.
PANO_API int pano_align_gauss_newton(const void* left, const void* right,
                                     void* state, void* scratch, int hl,
                                     int wl, int hr, int wr, float s,
                                     float inv_s, float cxl, float cyl,
                                     float cxr, float cyr, int passes,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* partial = static_cast<double*>(scratch);
  auto* ticket = reinterpret_cast<unsigned int*>(partial + BLOCKS * SUMS);
  const cudaError_t err = cudaMemsetAsync(ticket, 0, 8, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k = 0; k < passes; ++k) {
    align_gauss_newton_kernel<<<BLOCKS, THREADS, 0, st>>>(
        static_cast<const unsigned char*>(left),
        static_cast<const unsigned char*>(right),
        static_cast<double*>(state), partial, ticket, hl, wl, hr, wr, s,
        inv_s, cxl, cyl, cxr, cyr, k == 0, k < passes - 1);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
