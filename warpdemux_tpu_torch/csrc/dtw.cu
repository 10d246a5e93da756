// K1: banded DTW distance matrix, dtaidistance 2.3.13 semantics.
//
// Replaces warpdemux_tpu/ops/dtw_pallas.py dtw_distance_matrix_pallas. The
// TPU kernel advances a (query x reference) tile of lattices one
// anti-diagonal at a time in VMEM. Here a block owns a tile of
// WDX_DTW_THREADS references by WDX_DTW_TQ queries: both are staged in
// shared memory with coalesced loads (the reference rows at an odd stride,
// so that a warp reading one column of 32 references hits 32 banks), each
// thread keeps its own reference in registers across the whole tile and
// runs the row-by-row DP of one query after the other. The query values
// are shared-memory broadcasts; the output is written along n, coalesced.
// Edge tiles are masked here, not padded by the caller.
//
// Bound: arithmetic. B*N pairs times the in-band cells (515 for m = 25,
// window = 15), five instructions each (subtract, min, add, min, fused
// multiply-add), against (B + N)*m*4 bytes read and B*N*4 written.
//
// Two instances. The shape every shipped model has (m = 25, window = 15)
// is a template instance with both DP loops fully unrolled: the band is
// static, so the 515 in-band cells are straight-line code on registers, a
// neighbour outside the band or the lattice is left out of the min at
// compile time, and D[m][m] is a named register. Any other shape (m <= 32)
// runs the generic instance with m and the window as run-time arguments:
// a loop over the rows, 32 guarded column slots unrolled.
//
// Numerics: each cell is (q_i - r_j)^2 + min(D[i-1][j-1],
// min(D[i-1][j], D[i][j-1]) + p) as one fused multiply-add, which is how
// XLA:CPU contracts the jnp wavefront's d*d + best. Adding p after the min
// gives the bits of min(up + p, left + p), since rounding is monotone. The
// min propagates NaN as jnp.minimum and torch.minimum do (min.NaN.f32;
// fminf would drop it), and sqrtf is correctly rounded, so the result is
// bit-identical to the plain version and to the jnp wavefront in float32,
// non-finite fingerprints included.
#include "common.cuh"

#define WDX_DTW_MAX_M 32
#ifndef WDX_DTW_THREADS
#define WDX_DTW_THREADS 128  // references of a tile, one per thread
#endif
#ifndef WDX_DTW_TQ
#define WDX_DTW_TQ 3  // queries of a tile
#endif

__device__ __forceinline__ float wdx_min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// sqrt(D[M][M]) of the query q against the reference r; band and lattice
// edges resolved at compile time.
template <int M, int W>
__device__ __forceinline__ float wdx_dtw_static(const float (&r)[M], const float* q, float p) {
  float row[M + 1];  // row[j] = D[i][j], overwritten by D[i+1][j]
#pragma unroll
  for (int j = 0; j <= M; ++j) row[j] = INFINITY;

#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float qi = q[i];
    float diag = INFINITY, left = INFINITY;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (i - j > W - 1 || j - i > W - 1) continue;  // outside the band
      const bool has_up = i > 0 && j - (i - 1) <= W - 1;
      const bool has_left = j > 0 && i - (j - 1) <= W - 1;
      const bool has_diag = i > 0 && j > 0;
      const float up = row[j + 1];  // D[i][j+1]
      if (j > 0 && i - (j - 1) > W - 1) diag = row[j];  // first cell of the row
      float best = 0.f;  // cell (0, 0): D[0][0]
      if (has_up && has_left)
        best = wdx_min_nan(up, left) + p;
      else if (has_up)
        best = up + p;
      else if (has_left)
        best = left + p;
      if (has_diag) best = (has_up || has_left) ? wdx_min_nan(diag, best) : diag;
      const float d = qi - r[j];
      const float val = __fmaf_rn(d, d, best);
      diag = up;
      row[j + 1] = val;
      left = val;
    }
  }
  return sqrtf(row[M]);
}

// The same for any m <= WDX_DTW_MAX_M and any window.
__device__ __forceinline__ float wdx_dtw_generic(const float (&r)[WDX_DTW_MAX_M], const float* q,
                                                 int m, int window, float p) {
  float row[WDX_DTW_MAX_M + 1];
  row[0] = 0.f;
#pragma unroll
  for (int j = 1; j <= WDX_DTW_MAX_M; ++j) row[j] = INFINITY;
  for (int i = 0; i < m; ++i) {
    const float qi = q[i];
    float diag = row[0];    // D[i][0]
    float left = INFINITY;  // D[i+1][0]
    row[0] = INFINITY;
#pragma unroll
    for (int j = 0; j < WDX_DTW_MAX_M; ++j) {
      if (j < m) {
        const float up = row[j + 1];
        float val = INFINITY;
        if (abs(i - j) <= window - 1) {
          const float d = qi - r[j];
          const float best = wdx_min_nan(diag, wdx_min_nan(up, left) + p);
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
  return sqrtf(last);
}

// M > 0: the static instance (m == M, window == W); M == 0: the generic one.
// blockIdx.x walks the query tiles, blockIdx.y the reference tiles.
template <int M, int W>
__global__ void __launch_bounds__(WDX_DTW_THREADS)
    wdx_dtw_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                   float* __restrict__ out, int B, int N, int m_arg, int window, float p) {
  extern __shared__ float wdx_dtw_smem[];
  constexpr int R = M ? M : WDX_DTW_MAX_M;
  const int m = M ? M : m_arg;
  const int stride = m | 1;  // odd: references 32 apart fall in 32 banks
  float* ys = wdx_dtw_smem;                          // [WDX_DTW_THREADS][stride]
  float* qs = wdx_dtw_smem + WDX_DTW_THREADS * stride;  // [WDX_DTW_TQ][m]
  const int b0 = blockIdx.x * WDX_DTW_TQ;
  const int n0 = blockIdx.y * WDX_DTW_THREADS;
  const int n_tile = min(WDX_DTW_THREADS, N - n0);
  const int q_tile = min(WDX_DTW_TQ, B - b0);

  const float* y_tile = Y + (long long)n0 * m;
  for (int e = threadIdx.x; e < n_tile * m; e += WDX_DTW_THREADS)
    ys[(e / m) * stride + e % m] = y_tile[e];
  const float* x_tile = X + (long long)b0 * m;
  for (int e = threadIdx.x; e < q_tile * m; e += WDX_DTW_THREADS) qs[e] = x_tile[e];
  __syncthreads();
  if ((int)threadIdx.x >= n_tile) return;

  float r[R];
#pragma unroll
  for (int j = 0; j < R; ++j) r[j] = j < m ? ys[threadIdx.x * stride + j] : 0.f;
  float* o = out + (long long)b0 * N + n0 + threadIdx.x;
  for (int g = 0; g < q_tile; ++g) {
    if constexpr (M > 0)
      o[(long long)g * N] = wdx_dtw_static<R, (W > 0 ? W : 1)>(r, qs + g * m, p);
    else
      o[(long long)g * N] = wdx_dtw_generic(r, qs + g * m, m, window, p);
  }
}

WDX_API int wdx_dtw(const float* X, const float* Y, float* out, int B, int N, int m,
                    int window, float p, cudaStream_t stream) {
  if (m < 1 || m > WDX_DTW_MAX_M) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  const dim3 grid((B + WDX_DTW_TQ - 1) / WDX_DTW_TQ, (N + WDX_DTW_THREADS - 1) / WDX_DTW_THREADS);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(WDX_DTW_THREADS * (m | 1) + WDX_DTW_TQ * m) * sizeof(float);
  if (m == 25 && window == 15)
    wdx_dtw_kernel<25, 15><<<grid, WDX_DTW_THREADS, smem, stream>>>(X, Y, out, B, N, m, window, p);
  else
    wdx_dtw_kernel<0, 0><<<grid, WDX_DTW_THREADS, smem, stream>>>(X, Y, out, B, N, m, window, p);
  return (int)cudaGetLastError();
}
