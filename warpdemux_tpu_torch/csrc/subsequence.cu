// K10: subsequence DTW of one query (the 84-event consensus adapter) into
// every row of a batch of series (a read's normalized adapter event means).
// Writes per row the matched segment [start, end_excl) in series indices and
// the match distance.
//
// New: the JAX package has no Pallas kernel here. It runs the dynamic
// program as a lax.scan over the r + c + 1 anti-diagonals of the
// (r + 1) x (c + 1) grid (warpdemux_tpu/ops/subsequence.py:60), which XLA
// compiles into one loop; in eager PyTorch every diagonal would cost a score
// of launches, so the port gives it one kernel.
//
// Recurrence (grid point (i, j), i over the query, j over the series):
//   D[i, j] = fma(q[i-1] - s[j-1], q[i-1] - s[j-1], best)
//   best    = min(D[i-1, j-1], D[i-1, j] + p, D[i, j-1] + p),
// ties preferring the diagonal, then up, then left; D[0, 0..psi_2b] = 0,
// D[0..psi_1b, 0] = 0, every other boundary cell and every cell past the
// row's series length the "infinity" FLT_MAX / 4. S carries the row-0
// column each cell's path started from. Then matching = sqrt(D[r, j]) *
// float32(1 / r) for j = 1..c (infinity past the length), whose first
// minimum (the first NaN, if any) is the match. Each operation is the one
// XLA:CPU compiles for the jitted JAX function: it contracts d + best into
// the fused multiply-add and multiplies by the reciprocal of r. Minima
// propagate NaN, as XLA's do.
//
// Design: one block a row; thread i owns query row i and walks the
// diagonals k = 0..r+c, computing cell (i, k - i). D and S of the last
// three diagonals live in shared memory (a ring, so one barrier a diagonal
// suffices: a diagonal's buffer is rewritten only after the barrier that
// follows the last read of it); the series row is staged there once, and
// row r's D and S are kept as they are produced. Thread 0 then scans row r
// for the argmin.
//
// Bound: operations, 7 a cell (a subtract, a square, two adds, three
// compares) over r x c cells a row; the bytes (the series, the query and
// three outputs) are a tenth of that time at these shapes. The kernel's
// time is the r + c + 1 dependent steps a block, each a barrier.
#include "common.cuh"

// min(a, b) that propagates NaN (XLA's and torch.minimum's semantics)
__device__ __forceinline__ float wdx_min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

__global__ void wdx_subseq_dtw_kernel(const float* __restrict__ q, const float* __restrict__ series,
                                      const int* __restrict__ series_len, int* __restrict__ start_out,
                                      int* __restrict__ end_out, float* __restrict__ dist_out,
                                      int r, int c, int psi_1b, int psi_2b, float p, float inf,
                                      float inv_r) {
  extern __shared__ float smem[];
  const int rows = r + 1;
  float* s = smem;                                   // (c,) the series row
  float* d_last = s + c;                             // (c,) D[r, 1..c]
  int* s_last = reinterpret_cast<int*>(d_last + c);  // (c,) S[r, 1..c]
  float* dbuf = reinterpret_cast<float*>(s_last + c);  // (3, rows) D of diagonals k % 3
  int* sbuf = reinterpret_cast<int*>(dbuf + 3 * rows);  // (3, rows) S of them

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const float* srow = series + (long long)b * c;
  for (int t = i; t < c; t += blockDim.x) s[t] = srow[t];
  const int n = series_len[b];
  const float qi = q[i >= 1 && i <= r ? i - 1 : 0];
  if (i < rows) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      dbuf[m * rows + i] = inf;
      sbuf[m * rows + i] = 0;
    }
  }
  __syncthreads();

  for (int k = 0; k <= r + c; ++k) {
    if (i < rows) {
      const int cur = k % 3;
      const int prev1 = (k + 2) % 3;  // diagonal k - 1
      const int prev2 = (k + 1) % 3;  // diagonal k - 2
      const int j = k - i;
      float dk;
      int sk;
      if (i == 0 || j == 0) {
        dk = (i == 0 && j <= psi_2b) || (j == 0 && i <= psi_1b) ? 0.f : inf;
        sk = i == 0 ? j : 0;
      } else if (j >= 1 && j <= n) {
        const float diag_d = dbuf[prev2 * rows + i - 1];
        const float o1 = __fadd_rn(dbuf[prev1 * rows + i - 1], p);  // up
        const float o2 = __fadd_rn(dbuf[prev1 * rows + i], p);      // left
        const float m12 = wdx_min_nan(o1, o2);
        const float best = wdx_min_nan(diag_d, m12);
        sk = diag_d <= m12 ? sbuf[prev2 * rows + i - 1]
                           : (o1 <= o2 ? sbuf[prev1 * rows + i - 1] : sbuf[prev1 * rows + i]);
        const float diff = __fsub_rn(qi, s[min(j, c) - 1]);
        dk = __fmaf_rn(diff, diff, best);
      } else {
        dk = inf;
        sk = 0;
      }
      dbuf[cur * rows + i] = dk;
      sbuf[cur * rows + i] = sk;
      if (i == r && j >= 1 && j <= c) {
        d_last[j - 1] = dk;
        s_last[j - 1] = sk;
      }
    }
    __syncthreads();
  }

  if (i == 0) {
    int jstar = 0;
    float best = INFINITY;
    for (int t = 0; t < c; ++t) {
      const float m = t + 1 <= n ? __fmul_rn(__fsqrt_rn(d_last[t]), inv_r) : INFINITY;
      if (m != m) {  // argmin and min both stop at the first NaN
        jstar = t;
        best = m;
        break;
      }
      if (m < best) {
        best = m;
        jstar = t;
      }
    }
    start_out[b] = s_last[jstar];
    end_out[b] = jstar + 1;
    dist_out[b] = best;
  }
}

// Shared memory a block: the series row, row r's D and S, and three
// diagonals of D and S.
static long long wdx_subseq_shared_bytes(int r, int c) {
  return 4LL * (3LL * c + 6LL * (r + 1));
}

// q: (r,); series: (B, c); series_len: (B,); start, end: (B,) int32;
// dist: (B,) float32. psi_1b / psi_2b: the relaxed query / series starts;
// p: penalty**2; inf: the program's infinity; inv_r: float32(1 / r).
WDX_API int wdx_subseq_dtw(const float* q, const float* series, const int* series_len, int* start,
                           int* end, float* dist, int B, int r, int c, int psi_1b, int psi_2b,
                           float p, float inf, float inv_r, cudaStream_t stream) {
  if (B == 0) return 0;
  if (r < 1 || c < 1 || r + 1 > 1024) return (int)cudaErrorInvalidValue;
  const long long shared = wdx_subseq_shared_bytes(r, c);
  if (shared > WDX_MAX_SHARED_BYTES) return (int)cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const int err = wdx_allow_shared(wdx_subseq_dtw_kernel, (int)shared);
    if (err != 0) return err;
  }
  const int threads = (r + 1 + 31) / 32 * 32;
  wdx_subseq_dtw_kernel<<<B, threads, (size_t)shared, stream>>>(
      q, series, series_len, start, end, dist, r, c, psi_1b, psi_2b, p, inf, inv_r);
  return (int)cudaGetLastError();
}
