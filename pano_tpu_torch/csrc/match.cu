// K3: streaming argmin-SSD matcher; the (Kq, Kt) distance matrix never
// reaches device memory.
//
// Replaces the TPU kernel pano_tpu/ops/pallas_match.py (_kernel, launched
// by _cores_pallas). For every query row i: the best SSD over valid train
// columns, its index (lowest on ties) and the second best (the best of the
// rest, so an exact duplicate gives second == best); for every train
// column j: the lowest valid query row with the column's smallest SSD
// (row 0 when no valid row or an invalid column, as argmin over +inf).
// SSD = (|q|^2 + |t|^2) - 2 q.t; invalid train columns are +inf.
//
// Exactness: descriptor entries are u8 values and the true width is 75,
// so every partial dot product and every SSD is an integer below 2^24.
// fp32 FMA on the CUDA cores is then exact in any summation order, and
// the results are bit-identical to the dense plain version. No tensor
// cores yet (bf16 wgmma would be exact for the same reason).
//
// What bounds it on an H100: 2*Kq*Kt*D = 17 GFLOP at K = 8192, D = 128,
// against ~4 MB of descriptors, so it is compute-bound on the FP32 pipes
// (67 TFLOP/s peak). Design: one block owns 64 query rows and loops over
// all train tiles of 64 columns inside the block (the TPU's sequential
// train grid axis); 256 threads each hold a 4x4 register tile, fed from
// 32-wide shared-memory chunks. The row triples merge in registers across
// tiles and across the 16 threads of a row by warp shuffles. The column
// best is one 64-bit atomicMin per column and block on
// (float_bits(ssd) << 32) | row: SSD >= 0, so the bits order as unsigned
// integers and the lowest row wins ties, whatever the block order.
#include "common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BT = 64;  // train columns per tile
constexpr int BK = 32;  // descriptor chunk
constexpr int NT = 256;
constexpr unsigned long long kInfKey = 0x7f80000000000000ULL;  // (+inf, 0)
constexpr unsigned long long kNoKey = ~0ULL;

// Add (v, j) to a running (best, idx, second).
__device__ __forceinline__ void push(float& b, int& i, float& s, float v,
                                     int j) {
  if (v < b || (v == b && j < i)) {
    s = b;
    b = v;
    i = j;
  } else {
    s = fminf(s, v);
  }
}

// Merge another partial (b2, i2, s2) into (b, i, s).
__device__ __forceinline__ void merge(float& b, int& i, float& s, float b2,
                                      int i2, float s2) {
  if (b2 < b || (b2 == b && i2 < i)) {
    s = fminf(s2, b);
    b = b2;
    i = i2;
  } else {
    s = fminf(s, b2);
  }
}

__global__ void init_keys_kernel(unsigned long long* col_key, int kt) {
  const int j = blockIdx.x * NT + threadIdx.x;
  if (j < kt) col_key[j] = kInfKey;
}

__global__ void finish_keys_kernel(const unsigned long long* col_key,
                                   int32_t* col_best, int kt) {
  const int j = blockIdx.x * NT + threadIdx.x;
  if (j < kt) col_best[j] = static_cast<int32_t>(col_key[j] & 0xffffffffULL);
}

__global__ void __launch_bounds__(NT)
match_kernel(const float* __restrict__ q, const float* __restrict__ t,
             const float* __restrict__ qsq, const float* __restrict__ tsq,
             const uint8_t* __restrict__ vq, const uint8_t* __restrict__ vt,
             float* __restrict__ best_out, int32_t* __restrict__ idx_out,
             float* __restrict__ sec_out,
             unsigned long long* __restrict__ col_key, int kq, int kt,
             int d) {
  __shared__ float qs[BQ][BK + 1];
  __shared__ float ts[BT][BK + 1];
  __shared__ unsigned long long ck[NT / 16][BT];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const float inf = __int_as_float(0x7f800000);

  float rb[4], rs[4], qn[4];
  int ri[4];
  bool qv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    rb[r] = inf;
    rs[r] = inf;
    ri[r] = 0;
    qn[r] = row < kq ? qsq[row] : 0.0f;
    qv[r] = row < kq && vq[row];
  }

  for (int t0 = 0; t0 < kt; t0 += BT) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int i = tid; i < BQ * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        const int row = q0 + r, col = k0 + c;
        qs[r][c] =
            (row < kq && col < d) ? q[static_cast<size_t>(row) * d + col] : 0.f;
      }
      for (int i = tid; i < BT * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        const int row = t0 + r, col = k0 + c;
        ts[r][c] =
            (row < kt && col < d) ? t[static_cast<size_t>(row) * d + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qs[ty + 16 * r][kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = ts[tx + 16 * c][kk];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
      __syncthreads();
    }

    // Tile epilogue: row triples in registers, column keys via shared.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = t0 + tx + 16 * c;
      unsigned long long key = kNoKey;
      if (col < kt) {
        const bool cvalid = vt[col] != 0;
        const float tn = tsq[col];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float ssd = cvalid ? (qn[r] + tn) - 2.0f * acc[r][c] : inf;
          push(rb[r], ri[r], rs[r], ssd, col);
          if (qv[r]) {
            const unsigned long long k =
                (static_cast<unsigned long long>(__float_as_uint(ssd)) << 32) |
                static_cast<unsigned int>(q0 + ty + 16 * r);
            key = k < key ? k : key;
          }
        }
      }
      ck[ty][tx + 16 * c] = key;
    }
    __syncthreads();
    if (tid < BT) {
      const int col = t0 + tid;
      if (col < kt) {
        unsigned long long m = ck[0][tid];
        for (int j = 1; j < NT / 16; ++j) m = ck[j][tid] < m ? ck[j][tid] : m;
        if (m != kNoKey) atomicMin(&col_key[col], m);
      }
    }
    // The next tile rewrites ck only after the __syncthreads of its
    // descriptor loop, which every reader above must reach first.
  }

  // Merge each row's triple across the 16 threads (lanes) that share it.
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float b2 = __shfl_xor_sync(0xffffffffu, rb[r], off);
      const int i2 = __shfl_xor_sync(0xffffffffu, ri[r], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, rs[r], off);
      merge(rb[r], ri[r], rs[r], b2, i2, s2);
    }
    const int row = q0 + ty + 16 * r;
    if (tx == 0 && row < kq) {
      best_out[row] = rb[r];
      idx_out[row] = ri[r];
      sec_out[row] = rs[r];
    }
  }
}

}  // namespace

PANO_API int pano_match_streaming(const void* q, const void* t,
                                  const void* qsq, const void* tsq,
                                  const void* vq, const void* vt, void* best,
                                  void* idx, void* second, void* col_key,
                                  void* col_best, int kq, int kt, int d,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* keys = static_cast<unsigned long long*>(col_key);
  init_keys_kernel<<<pano_cdiv(kt, NT), NT, 0, s>>>(keys, kt);
  match_kernel<<<pano_cdiv(kq, BQ), NT, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(t),
      static_cast<const float*>(qsq), static_cast<const float*>(tsq),
      static_cast<const uint8_t*>(vq), static_cast<const uint8_t*>(vt),
      static_cast<float*>(best), static_cast<int32_t*>(idx),
      static_cast<float*>(second), keys, kq, kt, d);
  finish_keys_kernel<<<pano_cdiv(kt, NT), NT, 0, s>>>(
      keys, static_cast<int32_t*>(col_best), kt);
  return static_cast<int>(cudaGetLastError());
}
