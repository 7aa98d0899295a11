// K10: RANSAC's hypothesis search. For each of N hypotheses (4 sample
// indices into M matches) the Hartley-normalized 4-point DLT homography,
// its inlier count over all M matches, and the first hypothesis with the
// largest count (torch.argmax's rule).
//
// Replaces no pallas_call: the JAX package leaves this search to XLA
// (pano_tpu/ops/ransac.py: homography_from_4pts under vmap, then
// _score_hypotheses and argmax). The port had it as plain torch inside the
// estimate's CUDA graph: ~290 launches on (N, 8, 9) tensors for the
// solves and over (N, M) f32 and bool planes (32.8 MB each at N 1000,
// M 8192) for the scores, ~1.07 ms of the card an estimate.
//
// What bounds it on an H100: the arithmetic of the scores, ~20 f32
// operations and two IEEE divisions a (hypothesis, valid match), about
// 45 instructions with the divisions' fast path: N 1000 x M 8192 is ~140
// MFLOP, ~2 us at the f32 peak, ~12 us of issue for every match valid.
// Its data are small and L2-resident (64 KB of points each side, 8 KB
// of flags, 32 KB of indices); a DLT is ~1,700 operations, but a chain
// of dependent divisions, and each IEEE division ends in a branch to its
// slow path, which the compiler does not schedule across.
//
// Design. One block a tile of TILE hypotheses (125 blocks for N 1000:
// one wave over the 132 SMs). Its first warps build the tile's DLTs,
// nine lanes a hypothesis, three a warp: lane j holds column j of the 8x9
// system [A | b] in registers, and the Gauss-Jordan elimination runs a
// column step at a time on all nine columns at once: the pivot column
// comes by shuffles, the pivot row is found in registers by selects, and
// each lane divides one row's entry, so a lane does one division a step
// where one thread a hypothesis did eight in series (its elimination
// took ~15.3K cycles; the lanes' whole DLT ~13.8K with the loads). The H
// go to `hs` and to shared memory. Then every thread takes every
// THREADS-th match straight from L2 into registers, CHUNK matches' loads
// at once (each match is read by one thread, so shared memory would only
// add a copy), skips it if it is not valid, and scores it against the
// tile's hypotheses held in registers, one count each: the TILE
// independent chains hide the divisions' latency. A warp's counts are
// summed by __reduce_add_sync, the block's by shared memory. The first
// maximum: every hypothesis puts (count << 32) | (N - 1 - i) into a 64-bit
// atomicMax slot, so the largest count wins and, among equal counts, the
// lowest index; the last block to finish (a ticket after __threadfence)
// reads the slot and copies that hypothesis's H and count out. The slot
// and the ticket are the caller's scratch, zeroed by a memset on the
// stream before the launch: one memset node and one kernel node in a
// captured graph, reset on every replay.
//
// Exactness: under -fmad=false every operation is rounded as in
// ops/cuda_ransac.py's plain version, in its order: the 4-term sums left
// to right, true divisions, (a*x + b*y) + c, each 3x3 product entry
// (a0*b0 + a1*b1) + a2*b2, squares as x*x, the pivot torch.argmax's
// (the first largest magnitude, a NaN first), the pivot row as a sum with
// zeros (so -0 reads +0); a NaN compares False in the inlier test, and
// an index outside [0, M) reads a NaN point (the plain version's
// index_select would raise).
#include "common.cuh"

namespace {

constexpr int TILE = 8;         // hypotheses a block
constexpr int THREADS = 512;    // threads a block
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 9;        // lanes a DLT: a column of [A | b] each
constexpr int PER_WARP = 32 / LANES;                      // DLTs a warp
constexpr int BUILD_WARPS = (TILE + PER_WARP - 1) / PER_WARP;
constexpr int CHUNK = 4;        // matches a thread loads at once

// Match i of `pts`, or a NaN point outside [0, m).
__device__ __forceinline__ float2 point(const float2* __restrict__ pts,
                                        long long i, int m) {
  if (i < 0 || i >= m) {
    const float nan = __int_as_float(0x7fffffff);
    return make_float2(nan, nan);
  }
  return pts[i];
}

// ((v0 + v1) + v2) + v3
__device__ __forceinline__ float sum4(float v0, float v1, float v2,
                                      float v3) {
  return ((v0 + v1) + v2) + v3;
}

// The Hartley similarity of 4 points, row-major: [[s, 0, -s*mx],
// [0, s, -s*my], [0, 0, 1]] with the points' mean (mx, my) and s =
// sqrt(2) / max(mean distance from it, 1e-8) (a NaN stays NaN).
__device__ void hartley4(const float2 (&p)[4], float (&t)[9]) {
  const float mx = sum4(p[0].x, p[1].x, p[2].x, p[3].x) / 4.0f;
  const float my = sum4(p[0].y, p[1].y, p[2].y, p[3].y) / 4.0f;
  float d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float ex = p[k].x - mx, ey = p[k].y - my;
    d[k] = sqrtf(ex * ex + ey * ey);
  }
  const float md = sum4(d[0], d[1], d[2], d[3]) / 4.0f;
  const float s = sqrtf(2.0f) / (md < 1e-8f ? 1e-8f : md);
  t[0] = s;    t[1] = 0.0f; t[2] = -s * mx;
  t[3] = 0.0f; t[4] = s;    t[5] = -s * my;
  t[6] = 0.0f; t[7] = 0.0f; t[8] = 1.0f;
}

// c = a @ b, 3x3 row-major, each entry (a_i0 b_0j + a_i1 b_1j) + a_i2 b_2j.
__device__ void matmul3(const float (&a)[9], const float (&b)[9],
                        float (&c)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c[3 * i + j] = (a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j])
                     + a[3 * i + 2] * b[6 + j];
    }
  }
}

// One of v[0..8], by a runtime j (selects: no local memory).
__device__ __forceinline__ float pick(int j, const float (&v)[9]) {
  float o = v[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) o = j == k ? v[k] : o;
  return o;
}

// Entry j of the homography taking src[k] to dst[k], normalized so that
// H[2][2] = 1 (ops/cuda_ransac.py's homography_from_4pts), built by a
// group of LANES lanes of one warp starting at lane `base`. Lane j of the
// group holds column j of the system [A | b] (rows 0-3 the u equations,
// 4-7 the v equations), and the Gauss-Jordan elimination (_solve8) runs a
// column step at a time on all nine columns at once: the pivot column
// comes by shuffles, lane r divides row r's entry of it by the pivot and
// the factors go back by shuffles. Each IEEE division ends in a branch to
// its slow path, which the compiler does not schedule across, so the
// divisions are spread over the lanes: one a lane a step. Every lane of
// the warp calls it (the shuffles take all 32).
__device__ float homography4_lanes(const float2 (&src)[4],
                                   const float2 (&dst)[4], int j, int base) {
  constexpr unsigned FULL = 0xffffffffu;
  float ts[9], td[9];
  hartley4(src, ts);
  hartley4(dst, td);
  float m[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float x = (src[k].x * ts[0] + src[k].y * ts[1]) + ts[2];
    const float y = (src[k].x * ts[3] + src[k].y * ts[4]) + ts[5];
    const float u = (dst[k].x * td[0] + dst[k].y * td[1]) + td[2];
    const float v = (dst[k].x * td[3] + dst[k].y * td[4]) + td[5];
    const float ru[9] = {x, y, 1.0f, 0.0f, 0.0f, 0.0f, -u * x, -u * y, u};
    const float rv[9] = {0.0f, 0.0f, 0.0f, x, y, 1.0f, -v * x, -v * y, v};
    m[k] = pick(j, ru);
    m[4 + k] = pick(j, rv);
  }
#pragma unroll 1
  for (int col = 0; col < 8; ++col) {
    float c[8];  // the pivot column, from lane base + col
#pragma unroll
    for (int r = 0; r < 8; ++r) c[r] = __shfl_sync(FULL, m[r], base + col);
    // The first largest |c[r]|, r >= col, a NaN first (torch.argmax).
    int piv = col;
    float best = 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float a = fabsf(c[r]);
      if (r == col || (r > col && best == best && (a > best || a != a))) {
        piv = r;
        best = a;
      }
    }
    // Swap rows col and piv; the pivot row arrives as a sum with zeros.
    float c_col = 0.0f, c_piv = 0.0f, m_col = 0.0f, m_piv = 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r == col) {
        c_col = c[r];
        m_col = m[r];
      }
      if (r == piv) {
        c_piv = c[r];
        m_piv = m[r];
      }
    }
    const float pivot = c_piv + 0.0f, pr = m_piv + 0.0f;
    float cj = 0.0f;  // row j of the pivot column, swapped
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r == j) cj = r == col ? pivot : (r == piv ? c_col : c[r]);
    }
    const float fj = j == col ? 0.0f : cj / pivot;  // row j's factor
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float factor = __shfl_sync(FULL, fj, base + r);
      const float mr = r == col ? pr : (r == piv ? m_col : m[r]);
      m[r] = mr - factor * pr;
    }
  }
  // h[r] = b[r] / A[r][r], in lane r: b in lane base + 8, A[r][r] its own.
  float bj = 0.0f, diag = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float b = __shfl_sync(FULL, m[r], base + 8);
    if (r == j) {
      bj = b;
      diag = m[r];
    }
  }
  const float hj = bj / diag;
  float h[9];
#pragma unroll
  for (int r = 0; r < 8; ++r) h[r] = __shfl_sync(FULL, hj, base + r);
  h[8] = 1.0f;
  // inv3x3(td), entry k by lane k; then the two products in every lane.
  const float a = td[0], b = td[1], c = td[2];
  const float d = td[3], e = td[4], f = td[5];
  const float g = td[6], hh = td[7], i = td[8];
  const float co[9] = {e * i - f * hh, c * hh - b * i, b * f - c * e,
                       f * g - d * i, a * i - c * g, c * d - a * f,
                       d * hh - e * g, b * g - a * hh, a * e - b * d};
  const float det = (a * co[0] + b * co[3]) + c * co[6];
  const float tj = pick(j, co) / det;
  float tinv[9], p[9], full[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) tinv[k] = __shfl_sync(FULL, tj, base + k);
  matmul3(tinv, h, p);
  matmul3(p, ts, full);
  return pick(j, full) / full[8];
}

__global__ void __launch_bounds__(THREADS)
ransac_search_kernel(const float2* __restrict__ src,
                     const float2* __restrict__ dst,
                     const unsigned char* __restrict__ valid,
                     const long long* __restrict__ idx,
                     float* __restrict__ hs, int* __restrict__ counts,
                     float* __restrict__ best_h, int* __restrict__ best_count,
                     unsigned long long* __restrict__ slot,
                     unsigned int* __restrict__ ticket,
                     int m, int n, float t2) {
  __shared__ float sh_h[TILE][9];
  __shared__ int part[WARPS][TILE];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = blockIdx.x * TILE;
  const int tile = min(TILE, n - h0);

  // The tile's DLTs: group g of warp w builds hypothesis PER_WARP * w + g.
  // Lanes past the groups and groups past N build hypothesis h0 as well
  // (the shuffles need every lane) and store nothing.
  if (warp < BUILD_WARPS) {
    const int g = min(lane / LANES, PER_WARP - 1);
    const int t = PER_WARP * warp + g;
    const int j = lane - g * LANES;
    const long long* s = idx + 4LL * (h0 + (t < tile ? t : 0));
    float2 ps[4], pd[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ps[k] = point(src, s[k], m);
      pd[k] = point(dst, s[k], m);
    }
    const float hj = homography4_lanes(ps, pd, j, g * LANES);
    if (j < 9 && t < TILE) {
      sh_h[t][j] = t < tile ? hj : __int_as_float(0x7fffffff);
      if (t < tile) hs[9LL * (h0 + t) + j] = hj;
    }
  }
  __syncthreads();

  float h[TILE][9];
#pragma unroll
  for (int t = 0; t < TILE; ++t) {
#pragma unroll
    for (int k = 0; k < 9; ++k) h[t][k] = sh_h[t][k];
  }
  int cnt[TILE];
#pragma unroll
  for (int t = 0; t < TILE; ++t) cnt[t] = 0;
  // CHUNK matches a step, their loads issued together.
  for (int i0 = tid; i0 < m; i0 += CHUNK * THREADS) {
    float2 p[CHUNK], q[CHUNK];
    bool ok[CHUNK];
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      const int i = i0 + u * THREADS;
      ok[u] = i < m && valid[i];
      p[u] = i < m ? src[i] : make_float2(0.0f, 0.0f);
      q[u] = i < m ? dst[i] : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        const float w = (h[t][6] * p[u].x + h[t][7] * p[u].y) + h[t][8];
        const float px =
            ((h[t][0] * p[u].x + h[t][1] * p[u].y) + h[t][2]) / w;
        const float py =
            ((h[t][3] * p[u].x + h[t][4] * p[u].y) + h[t][5]) / w;
        const float ex = px - q[u].x, ey = py - q[u].y;
        cnt[t] += ex * ex + ey * ey < t2;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < TILE; ++t) {
    const int c = __reduce_add_sync(0xffffffffu, cnt[t]);
    if (lane == 0) part[warp][t] = c;
  }
  __syncthreads();
  if (tid < tile) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) c += part[w][tid];
    const int i = h0 + tid;
    counts[i] = c;
    atomicMax(slot, (static_cast<unsigned long long>(c) << 32)
                        | static_cast<unsigned int>(n - 1 - i));
  }
  // This block's hs, counts and slot before its ticket; the last block
  // reads them all.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last && tid == 0) {
    const unsigned long long key = atomicAdd(slot, 0ull);
    const long long i = n - 1 - static_cast<long long>(key & 0xffffffffull);
    *best_count = static_cast<int>(key >> 32);
#pragma unroll
    for (int k = 0; k < 9; ++k) best_h[k] = __ldcg(hs + 9 * i + k);
  }
}

}  // namespace

// src, dst: (m, 2) f32, 8-byte aligned; valid: (m,) bool; idx: (n, 4)
// int64; hs: (n, 3, 3) f32, counts: (n,) int32, best_h: (3, 3) f32,
// best_count: () int32 out; scratch: 16 bytes (the slot and the ticket),
// zeroed here; t2: the squared threshold. n >= 1.
PANO_API int pano_ransac_search(const void* src, const void* dst,
                                const void* valid, const void* idx, void* hs,
                                void* counts, void* best_h, void* best_count,
                                void* scratch, int m, int n, float t2,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(scratch, 0, 16, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* slot = static_cast<unsigned long long*>(scratch);
  ransac_search_kernel<<<pano_cdiv(n, TILE), THREADS, 0, s>>>(
      static_cast<const float2*>(src), static_cast<const float2*>(dst),
      static_cast<const unsigned char*>(valid),
      static_cast<const long long*>(idx), static_cast<float*>(hs),
      static_cast<int*>(counts), static_cast<float*>(best_h),
      static_cast<int*>(best_count), slot,
      reinterpret_cast<unsigned int*>(slot + 1), m, n, t2);
  return static_cast<int>(cudaGetLastError());
}
