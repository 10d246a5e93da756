// K1: banded DTW distance matrix, dtaidistance 2.3.13 semantics.
//
// Replaces warpdemux_tpu/ops/dtw_pallas.py dtw_distance_matrix_pallas. The
// TPU kernel advances a (query x reference) tile of lattices one
// anti-diagonal at a time in VMEM; here one thread owns one
// (query, reference) pair and runs the row-by-row DP with the whole
// reference fingerprint and the previous DP row in registers (m <= 32, the
// loops over j are unrolled so the arrays never leave registers).
//
// Bound: arithmetic. B*N pairs times ~m*(2*window-1) cells, a handful of
// flops each, against (B + N)*m*4 bytes read and B*N*4 written.
//
// Numerics: each cell is (q_i - r_j)^2 + min(D[i-1][j-1], D[i-1][j] + p,
// D[i][j-1] + p) as one fused multiply-add, which is how XLA:CPU contracts
// the jnp wavefront's d*d + best; min is exact and sqrtf is correctly
// rounded, so the result is bit-identical to the plain version and to the
// jnp wavefront in float32.
#include "common.cuh"

#define WDX_DTW_MAX_M 32

__global__ void wdx_dtw_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                               float* __restrict__ out, int B, int N, int m, int window,
                               float p) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * N) return;
  const int b = (int)(idx / N);
  const int n = (int)(idx % N);
  const float* q = X + (long long)b * m;
  const float* ref = Y + (long long)n * m;

  float r[WDX_DTW_MAX_M];
  float row[WDX_DTW_MAX_M + 1];  // row[j] = D[i][j] of the previous DP row
#pragma unroll
  for (int j = 0; j < WDX_DTW_MAX_M; ++j) r[j] = j < m ? ref[j] : 0.f;
  row[0] = 0.f;
#pragma unroll
  for (int j = 1; j <= WDX_DTW_MAX_M; ++j) row[j] = INFINITY;

  for (int i = 0; i < m; ++i) {
    const float qi = q[i];
    float diag = row[0];   // D[i][j] for j = 0
    float left = INFINITY;  // D[i+1][j] for j = 0
    row[0] = INFINITY;
#pragma unroll
    for (int j = 0; j < WDX_DTW_MAX_M; ++j) {
      if (j < m) {
        const float up = row[j + 1];  // D[i][j+1]
        float val = INFINITY;
        if (abs(i - j) <= window - 1) {
          const float d = qi - r[j];
          const float best = fminf(diag, fminf(up + p, left + p));
          val = __fmaf_rn(d, d, best);
        }
        diag = up;
        row[j + 1] = val;
        left = val;
      }
    }
  }
  // row[m] = D[m][m]; select it with unrolled compares to stay in registers
  float last = INFINITY;
#pragma unroll
  for (int j = 1; j <= WDX_DTW_MAX_M; ++j)
    if (j == m) last = row[j];
  out[idx] = sqrtf(last);
}

WDX_API int wdx_dtw(const float* X, const float* Y, float* out, int B, int N, int m,
                    int window, float p, cudaStream_t stream) {
  if (m < 1 || m > WDX_DTW_MAX_M) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * N;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  wdx_dtw_kernel<<<(unsigned)blocks, threads, 0, stream>>>(X, Y, out, B, N, m, window, p);
  return (int)cudaGetLastError();
}
