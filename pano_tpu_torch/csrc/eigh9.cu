// K7: the eigenvector of a symmetric 9x9 matrix at its smallest
// eigenvalue: the refine's normal matrix A^T A, whose smallest
// eigenvector is the least-squares homography.
//
// Replaces the jnp.linalg.eigh of pano_tpu/ops/ransac.py::refine_homography
// (ransac.py:245). It is no pallas_call: XLA's TPU lowering runs an eigh
// of this size on the device as Jacobi sweeps. The port had
// torch.linalg.eigh there, which reads its error code on the host, so
// every estimate waited for the card in its refine. This kernel leaves
// the host alone: the wrapper (ops/cuda_eigh.py) launches it and returns.
//
// Method (ops/cuda_eigh.py's plain version does the same rounds, operation
// for operation, so the two are bit-identical under -fmad=false): a cyclic
// Jacobi method in round-robin order, rotating in f64 (the input is f32,
// the vector is rounded to f32 at the end: in f32 the vector sits a few
// units in the last place from the exact one, enough to move a canvas
// edge that lies on an integer, where the JAX package's f32 LAPACK eigh
// on the CPU falls on the exact side). The 9 indices padded to 10 give 9
// rounds of 5 disjoint pairs, (r, 9) and ((r + k) % 9, (r - k) % 9) for
// k = 1..4 in round r. A round computes its five rotations from the
// matrix before it,
//   theta = (a_qq - a_pp) / (2 a_pq),
//   t = sign(theta) / (|theta| + sqrt(theta^2 + 1)), or 1 / (2 theta)
//       where |theta| > 1e18 (theta^2 overflows f64 from ~1e154; an f32
//       input can give |theta| up to ~1e83),
//   c = 1 / sqrt(t^2 + 1), s = t c,
// skips a pair whose a_pq is exactly zero (t = 0: the pad's pairs always),
// applies them to the columns of A and V (A J, V J), then to the rows of
// A (J^T A J), and sets a_pp = a_pp - t a_pq, a_qq = a_qq + t a_pq and
// a_pq = a_qp = 0 from the values before the round. After a fixed number
// of sweeps (no convergence test: nothing is read on the host) the result
// is V's column at the smallest diagonal entry, the first one on ties and
// the first NaN if there is one (torch.argmin's rule).
//
// What bounds it on an H100: nothing the card is short of. It reads 324
// bytes and writes 36; 8 sweeps are ~70 K f64 operations, a few
// microseconds of one warp's issue. Its time is the launch
// and a chain of dependent steps (72 rounds of four warp barriers), so
// it is one warp with A and V in shared memory; speed is not its aim.
#include "common.cuh"

namespace {

constexpr int N = 10;       // the 9 indices and a zero pad
constexpr int PAIRS = 5;    // disjoint rotations a round
constexpr int ROUNDS = 9;   // rounds a sweep: every pair once
constexpr double BIG = 1e18;  // |theta| above it: t = 1 / (2 theta)

// Pair k of round r.
__device__ __forceinline__ void pair_of(int r, int k, int& p, int& q) {
  if (k == 0) {
    p = r;
    q = 9;
  } else {
    p = (r + k) % 9;
    q = (r + 9 - k) % 9;
  }
}

__global__ void __launch_bounds__(32)
smallest_eigvec9_kernel(const float* __restrict__ ata,
                        float* __restrict__ out, int sweeps) {
  __shared__ double a[N][N];
  __shared__ double v[N][N];
  __shared__ double rot_c[PAIRS], rot_s[PAIRS], new_pp[PAIRS], new_qq[PAIRS];
  __shared__ int rot_p[PAIRS], rot_q[PAIRS];
  const int lane = threadIdx.x;

  for (int i = lane; i < N * N; i += 32) {
    const int r = i / N, c = i % N;
    a[r][c] = (r < 9 && c < 9) ? static_cast<double>(ata[r * 9 + c]) : 0.0;
    v[r][c] = r == c ? 1.0 : 0.0;
  }
  __syncwarp();

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int r = 0; r < ROUNDS; ++r) {
      // The round's rotations, lane k the k-th pair's.
      if (lane < PAIRS) {
        int p, q;
        pair_of(r, lane, p, q);
        const double app = a[p][p], aqq = a[q][q], apq = a[p][q];
        double t = 0.0;
        if (!(apq == 0.0)) {
          const double theta = (aqq - app) / (2.0 * apq);
          const double at = fabs(theta);
          if (at > BIG) {
            t = (1.0 / theta) * 0.5;
          } else {
            t = 1.0 / (at + sqrt(theta * theta + 1.0));
            if (theta < 0.0) t = -t;
          }
        }
        const double c = 1.0 / sqrt(t * t + 1.0);
        const double ta = t * apq;
        rot_c[lane] = c;
        rot_s[lane] = t * c;
        new_pp[lane] = app - ta;
        new_qq[lane] = aqq + ta;
        rot_p[lane] = p;
        rot_q[lane] = q;
      }
      __syncwarp();
      // Columns of A and V, a task per (matrix, row, pair).
      for (int task = lane; task < 2 * N * PAIRS; task += 32) {
        const int k = task % PAIRS;
        const int row = (task / PAIRS) % N;
        double* m = task < N * PAIRS ? a[row] : v[row];
        const int p = rot_p[k], q = rot_q[k];
        const double c = rot_c[k], s = rot_s[k];
        const double x = m[p], y = m[q];
        m[p] = c * x - s * y;
        m[q] = s * x + c * y;
      }
      __syncwarp();
      // Rows of A, a task per (pair, column).
      for (int task = lane; task < N * PAIRS; task += 32) {
        const int k = task % PAIRS, col = task / PAIRS;
        const int p = rot_p[k], q = rot_q[k];
        const double c = rot_c[k], s = rot_s[k];
        const double x = a[p][col], y = a[q][col];
        a[p][col] = c * x - s * y;
        a[q][col] = s * x + c * y;
      }
      __syncwarp();
      if (lane < PAIRS) {
        const int p = rot_p[lane], q = rot_q[lane];
        a[p][p] = new_pp[lane];
        a[q][q] = new_qq[lane];
        a[p][q] = 0.0;
        a[q][p] = 0.0;
      }
      __syncwarp();
    }
  }

  if (lane < 9) {
    int best = 0;
    double bv = a[0][0];
    for (int j = 1; j < 9; ++j) {
      const double d = a[j][j];
      if (bv == bv && (d < bv || d != d)) {  // a NaN stops the search
        best = j;
        bv = d;
      }
    }
    out[lane] = static_cast<float>(v[lane][best]);
  }
}

}  // namespace

// ata: (9, 9) f32 row-major; out: (9,) f32.
PANO_API int pano_smallest_eigvec9(const void* ata, void* out, int sweeps,
                                   void* stream) {
  smallest_eigvec9_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ata), static_cast<float*>(out), sweeps);
  return static_cast<int>(cudaGetLastError());
}
