// K3: streaming argmin-SSD matcher on the tensor cores; the (Kq, Kt)
// distance matrix never reaches device memory.
//
// Replaces the TPU kernel pano_tpu/ops/pallas_match.py (_kernel, launched
// by _cores_pallas). For every query row i: the best SSD over valid train
// columns, its index (lowest on ties) and the second best (the best of the
// rest, so an exact duplicate gives second == best); for every train
// column j: the lowest valid query row with the column's smallest SSD
// (row 0 when no valid row or an invalid column, as argmin over +inf).
// SSD = (|q|^2 + |t|^2) - 2 q.t; invalid train columns are +inf.
//
// Route: integer tensor cores, mma.sync m16n8k32 u8 x u8 -> s32. The
// descriptor entries are u8 values (K2 copies image bytes), so q.t is an
// exact integer on any route; the s32 sum is at most 256 * 255^2 < 2^24,
// so it converts to f32 exactly, and (qn + tn) - 2 * dot then rounds like
// the dense plain version's f32 arithmetic, op for op: bit-identical. The
// integer route needs no argument about the tensor core's f32 accumulator
// (bf16 would) and runs at the int8 rate. mma.sync rather than wgmma: the
// product is a few percent of the time (below), and mma.sync's fragment
// layout is fixed and documented, which the epilogue reads element by
// element.
//
// What bounds it on an H100 at Kq = Kt = 8192, D = 128: the product is
// 2 * 8192^2 * 75 = 10.1 G integer operations on the data columns
// (0.005 ms at 1,979 TOP/s); the epilogue is ~13 f32 operations for each
// of the 67 M (query, train) pairs (0.013 ms at 67 TFLOP/s): the SSD,
// the row's (best, index, second) and the column's minimum. So the
// epilogue binds, and the design keeps it branch-free and in registers:
//
// - A prologue kernel converts both (K, D) f32 blocks to u8 rows of
//   dp bytes, D rounded up to a power of two >= 32 (1 MB each here),
//   computes each row's squared norm as an exact integer sum (train
//   norms +inf for an invalid column) and resets the column keys. The
//   main kernel then streams u8 tiles with cp.async, which cannot
//   convert.
// - One block owns 128 query rows (4 warps x 32), loaded into shared
//   memory once, and a contiguous range of train tiles of 64 columns:
//   the train axis is split across blocks so that Kq = 8192 gives 512
//   blocks, about 4 per SM. Train tiles stream through a double-buffered
//   ring (cp.async, one __syncthreads a tile besides the column merge).
//   Shared rows are padded to an odd number of 16-byte chunks, so the
//   ldmatrix loads of A and B fragments are free of bank conflicts.
// - Epilogue on the mma fragments: a lane holds 4 query rows x 2 columns
//   of each 8-column slice and sees its columns in increasing order, so
//   the row triple updates without branches (strict < keeps the lowest
//   index; an equal value becomes the second). Per column, the lane's 4
//   rows (increasing) reduce to one key, then the 8 lanes of the column
//   by shfl_xor 4, 8, 16, then the 4 warps through shared memory, then
//   one 64-bit atomicMin per column and block on
//   (float_bits(ssd) << 32) | row: SSD >= 0, so the bits order as
//   unsigned integers and the lowest row wins ties, whatever the order.
// - Each block writes its rows' partial triples; a finish kernel merges
//   the splits with the same order-independent merge (lowest index wins
//   on equal best, and the loser's best becomes the second) and unpacks
//   the column keys.
#include "common.cuh"

namespace {

constexpr int BQ = 128;   // query rows per block: 4 warps x 32
constexpr int BT = 64;    // train columns per tile
constexpr int NT = 128;   // threads of the main kernel
constexpr int KSTEP = 32; // bytes of depth per mma
constexpr int PAD = 16;   // shared row padding: rows are an odd number of 16 B
constexpr int CT = 256;   // threads of the prologue and finish kernels
constexpr int TARGET_BLOCKS = 512;  // ~4 blocks on each of the 132 SMs
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long kInfKey = 0x7f80000000000000ULL;  // (+inf, 0)

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices (8 rows of 16 bytes each); lanes 8m..8m+7 give
// the row addresses of matrix m, and lane l receives word l % 4 of row
// l / 4 of each.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x32 u8, row) * b (32x8 u8, col), s32 accumulate.
__device__ __forceinline__ void mma_u8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp per descriptor row (queries, then train rows): f32 -> u8 rows
// of dp bytes (zero past d), and the row's squared norm, an integer sum
// below 2^24 and so exactly the plain version's f32 sum. Train rows store
// +inf for an invalid row and reset their column key to (+inf, 0).
__global__ void __launch_bounds__(CT)
prologue_kernel(const float* __restrict__ q, const float* __restrict__ t,
                const uint8_t* __restrict__ vt, uint32_t* __restrict__ q8,
                uint32_t* __restrict__ t8, float* __restrict__ qsq,
                float* __restrict__ tsq,
                unsigned long long* __restrict__ col_key, int kq, int kt,
                int d, int dp) {
  const int row = blockIdx.x * (CT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= kq + kt) return;  // the whole warp
  const bool is_q = row < kq;
  const int r = is_q ? row : row - kq;
  const float* src = (is_q ? q : t) + static_cast<size_t>(r) * d;
  uint32_t* dst = (is_q ? q8 : t8) + static_cast<size_t>(r) * (dp / 4);
  int sq = 0;
  for (int wd = lane; wd < dp / 4; wd += 32) {
    uint32_t v = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = wd * 4 + b;
      if (c < d) {
        const uint32_t x = static_cast<uint32_t>(src[c]);
        v |= x << (8 * b);
        sq += static_cast<int>(x * x);
      }
    }
    dst[wd] = v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(FULL, sq, off);
  if (lane == 0) {
    if (is_q) {
      qsq[r] = static_cast<float>(sq);
    } else {
      tsq[r] = vt[r] ? static_cast<float>(sq) : __int_as_float(0x7f800000);
      col_key[r] = kInfKey;
    }
  }
}

__global__ void __launch_bounds__(NT, 4)
match_kernel(const uint8_t* __restrict__ q8, const uint8_t* __restrict__ t8,
             const float* __restrict__ qsq, const uint8_t* __restrict__ vq,
             const float* __restrict__ tsq, float* __restrict__ part,
             unsigned long long* __restrict__ col_key, int kq, int kt, int dp,
             int tiles_per_split) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int srow = dp + PAD;
  uint8_t* qs = smem;                                   // BQ rows
  uint8_t* ts = qs + BQ * srow;                         // 2 x BT rows
  float* tns = reinterpret_cast<float*>(ts + 2 * BT * srow);  // 2 x BT
  unsigned long long* ck =
      reinterpret_cast<unsigned long long*>(tns + 2 * BT);    // 4 x BT

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (kt + BT - 1) / BT;
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tile1 = min(tile0 + tiles_per_split, ntiles);
  const int chunks = dp / 16;  // a power of two
  const int cshift = __ffs(chunks) - 1;
  const float inf = __int_as_float(0x7f800000);

  // This lane's 4 query rows, increasing: g, g+8 of m-tile 0, then of 1.
  int rows[4];
  float rb[4], rs[4], qn[4];
  int ri[4];
  bool qv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    rows[r] = q0 + warp * 32 + (r >> 1) * 16 + (r & 1) * 8 + g;
    rb[r] = inf;
    rs[r] = inf;
    ri[r] = 0;
    qn[r] = rows[r] < kq ? qsq[rows[r]] : 0.0f;
    qv[r] = rows[r] < kq && vq[rows[r]] != 0;
  }

  auto load_tile = [&](int tile, int buf) {
    uint8_t* dst = ts + buf * BT * srow;
    const int t0 = tile * BT;
    for (int i = tid; i < BT * chunks; i += NT) {
      const int r = i >> cshift, c = i & (chunks - 1);
      const bool in = t0 + r < kt;
      cp_async16(dst + r * srow + c * 16,
                 in ? t8 + static_cast<size_t>(t0 + r) * dp + c * 16 : t8, in);
    }
    if (tid < BT) tns[buf * BT + tid] = t0 + tid < kt ? tsq[t0 + tid] : inf;
  };

  if (tile0 < tile1) {
    for (int i = tid; i < BQ * chunks; i += NT) {  // the query tile, once
      const int r = i >> cshift, c = i & (chunks - 1);
      const bool in = q0 + r < kq;
      cp_async16(qs + r * srow + c * 16,
                 in ? q8 + static_cast<size_t>(q0 + r) * dp + c * 16 : q8, in);
    }
    load_tile(tile0, 0);
    cp_async_commit();
  }

  for (int tile = tile0; tile < tile1; ++tile) {
    const int buf = (tile - tile0) & 1;
    // The current tile has landed for every thread, and every thread is
    // done with the other buffer and with ck.
    cp_async_wait_all();
    __syncthreads();
    if (tile + 1 < tile1) load_tile(tile + 1, buf ^ 1);
    cp_async_commit();

    // q.t for this warp's 32 rows x the tile's 64 columns.
    const uint8_t* tb = ts + buf * BT * srow;
    int acc[2][8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0;
    for (int kb = 0; kb < dp; kb += KSTEP) {
      unsigned a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldsm_x4(a[m], qs + (warp * 32 + m * 16 + (lane & 15)) * srow + kb +
                          (lane >> 4) * 16);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned b[4];
        ldsm_x4(b, tb + ((2 * jp + (lane >> 4)) * 8 + (lane & 7)) * srow + kb +
                       ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_u8(acc[m][2 * jp], a[m], b[0], b[1]);
          mma_u8(acc[m][2 * jp + 1], a[m], b[2], b[3]);
        }
      }
    }

    // Epilogue: element (row g + 8h of m-tile m, column 2 tq + p of slice
    // j) is acc[m][j][2 h + p].
    const float* tn = tns + buf * BT;
    const int c0 = tile * BT;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 tnp =
          *reinterpret_cast<const float2*>(tn + j * 8 + 2 * tq);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int col = c0 + j * 8 + 2 * tq + p;
        const float tnc = p ? tnp.y : tnp.x;
        float cv = inf;
        int cr = 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float dot2 =
              2.0f * __int2float_rn(acc[r >> 1][j][(r & 1) * 2 + p]);
          const float ssd = (qn[r] + tnc) - dot2;
          rs[r] = fminf(rs[r], fmaxf(rb[r], ssd));
          ri[r] = ssd < rb[r] ? col : ri[r];
          rb[r] = fminf(rb[r], ssd);
          const float vc = qv[r] ? ssd : inf;
          cr = vc < cv ? rows[r] : cr;
          cv = fminf(cv, vc);
        }
        unsigned long long key =
            (static_cast<unsigned long long>(__float_as_uint(cv)) << 32) |
            static_cast<unsigned>(cr);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const unsigned long long o = __shfl_xor_sync(FULL, key, off);
          key = o < key ? o : key;
        }
        if (g == 0) ck[warp * BT + j * 8 + 2 * tq + p] = key;
      }
    }
    __syncthreads();
    if (tid < BT) {
      unsigned long long m = ck[tid];
#pragma unroll
      for (int w = 1; w < NT / 32; ++w) m = ck[w * BT + tid] < m ? ck[w * BT + tid] : m;
      if (c0 + tid < kt && m < kInfKey) atomicMin(&col_key[c0 + tid], m);
    }
  }

  // Merge each row's triple across the 4 lanes that share it; lane tq = 0
  // writes this split's partial.
  float* pb = part + static_cast<size_t>(blockIdx.y) * 3 * kq;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float b2 = __shfl_xor_sync(FULL, rb[r], off);
      const int i2 = __shfl_xor_sync(FULL, ri[r], off);
      const float s2 = __shfl_xor_sync(FULL, rs[r], off);
      merge(rb[r], ri[r], rs[r], b2, i2, s2);
    }
    if (tq == 0 && rows[r] < kq) {
      pb[rows[r]] = rb[r];
      pb[kq + rows[r]] = __int_as_float(ri[r]);
      pb[2 * kq + rows[r]] = rs[r];
    }
  }
}

// Merge the splits' partial triples; unpack the column keys.
__global__ void __launch_bounds__(CT)
finish_kernel(const float* __restrict__ part,
              const unsigned long long* __restrict__ col_key,
              float* __restrict__ best, int32_t* __restrict__ idx,
              float* __restrict__ second, int32_t* __restrict__ col_best,
              int kq, int kt, int splits) {
  const int i = blockIdx.x * CT + threadIdx.x;
  if (i < kq) {
    float b = part[i], s = part[2 * kq + i];
    int ix = __float_as_int(part[kq + i]);
    for (int sp = 1; sp < splits; ++sp) {
      const float* pp = part + static_cast<size_t>(sp) * 3 * kq;
      merge(b, ix, s, pp[i], __float_as_int(pp[kq + i]), pp[2 * kq + i]);
    }
    best[i] = b;
    idx[i] = ix;
    second[i] = s;
  }
  if (i < kt) col_best[i] = static_cast<int32_t>(col_key[i] & 0xffffffffULL);
}

// A call's geometry and scratch layout, decided here alone. Scratch is
// one caller-allocated buffer of `bytes`, its parts 256-byte aligned:
// qsq (kq,) and tsq (kt,) f32 norms, q8 (kq, dp) and t8 (kt, dp) u8 rows,
// col_key (kt,) u64, part (splits, 3, kq) f32 partial triples.
struct Plan {
  int dp;      // u8 row bytes: d rounded up to a power of two >= KSTEP
  int splits;  // blocks along the train axis (any count >= 1 is exact)
  int per;     // train tiles of each split
  size_t off[6], bytes;
};

Plan plan(int kq, int kt, int d) {
  Plan p;
  p.dp = KSTEP;
  while (p.dp < d) p.dp *= 2;
  const int row_blocks = static_cast<int>(pano_cdiv(kq, BQ));
  const int tiles = static_cast<int>(pano_cdiv(kt, BT));
  const int want = static_cast<int>(pano_cdiv(TARGET_BLOCKS, row_blocks));
  p.splits = want < tiles ? want : tiles;
  p.per = static_cast<int>(pano_cdiv(tiles, p.splits));
  const size_t sizes[6] = {
      4 * static_cast<size_t>(kq), 4 * static_cast<size_t>(kt),
      static_cast<size_t>(kq) * p.dp, static_cast<size_t>(kt) * p.dp,
      8 * static_cast<size_t>(kt), 12 * static_cast<size_t>(p.splits) * kq};
  size_t o = 0;
  for (int i = 0; i < 6; ++i) {
    p.off[i] = o;
    o += (sizes[i] + 255) / 256 * 256;
  }
  p.bytes = o;
  return p;
}

}  // namespace

// The scratch bytes one call needs, and the train columns each split
// covers (for tests that place ties across split boundaries).
PANO_API int pano_match_scratch(int kq, int kt, int d, long long* bytes,
                                int* split_cols) {
  if (kq <= 0 || kt <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(kq, kt, d);
  *bytes = static_cast<long long>(p.bytes);
  *split_cols = p.per * BT;
  return 0;
}

// `scratch` holds `scratch_bytes`, at least pano_match_scratch's count;
// a smaller buffer is refused before anything is launched.
PANO_API int pano_match_streaming(const void* q, const void* t, const void* vq,
                                  const void* vt, void* best, void* idx,
                                  void* second, void* col_best, void* scratch,
                                  long long scratch_bytes, int kq, int kt,
                                  int d, void* stream) {
  if (kq <= 0 || kt <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(kq, kt, d);
  if (scratch_bytes < static_cast<long long>(p.bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  auto* qsq = reinterpret_cast<float*>(base + p.off[0]);
  auto* tsq = reinterpret_cast<float*>(base + p.off[1]);
  uint8_t* q8 = base + p.off[2];
  uint8_t* t8 = base + p.off[3];
  auto* keys = reinterpret_cast<unsigned long long*>(base + p.off[4]);
  auto* part = reinterpret_cast<float*>(base + p.off[5]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  prologue_kernel<<<pano_cdiv(kq + kt, CT / 32), CT, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(t),
      static_cast<const uint8_t*>(vt), reinterpret_cast<uint32_t*>(q8),
      reinterpret_cast<uint32_t*>(t8), qsq, tsq, keys, kq, kt, d, p.dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem = (BQ + 2 * BT) * (p.dp + PAD) +
                   2 * BT * static_cast<int>(sizeof(float)) +
                   (NT / 32) * BT * static_cast<int>(sizeof(unsigned long long));
  err = cudaFuncSetAttribute(match_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  match_kernel<<<dim3(pano_cdiv(kq, BQ), p.splits), NT, smem, s>>>(
      q8, t8, qsq, static_cast<const uint8_t*>(vq), tsq, part, keys, kq, kt,
      p.dp, p.per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  finish_kernel<<<pano_cdiv(kq > kt ? kq : kt, CT), CT, 0, s>>>(
      part, keys, static_cast<float*>(best), static_cast<int32_t*>(idx),
      static_cast<float*>(second), static_cast<int32_t*>(col_best), kq, kt,
      p.splits);
  return static_cast<int>(cudaGetLastError());
}
