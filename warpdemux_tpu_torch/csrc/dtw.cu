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
// Three variants behind the one entry point, chosen by the wrapper:
//
// The register kernel (m = 25, window = 15 alone: the shape every shipped
// model has). A template instance with both DP loops fully unrolled: the
// band is static, so the 515 in-band cells are straight-line code on
// registers, a neighbour outside the band or the lattice is left out of the
// min at compile time, and D[m][m] is a named register. A generic instance
// in registers (m and the window at run time, 32 or 64 guarded column
// slots) ran the whole lattice and was slower than the wide kernel on the
// H100: 1.126 ms against 0.339 at m = 32, 3.17 against 0.476 at m = 40
// (64 slots, spilling); every other shape takes the wide kernel.
//
// The wide kernels (any m and window; the wrapper's choice at every shape
// but (25, 15)). The same tile, a thread a reference, but each row of the
// lattice runs only its band's columns in a run-time loop, and the
// reference row and the DP row live in memory: in shared memory (the references at the odd stride, the DP rows
// thread-interleaved, row[j] of thread t at j T + t, so a warp at one
// column hits 32 banks) with T = 128, 64 or 32 threads, the most whose
// rows fit; else the DP rows in a global workspace the wrapper allocates
// (the same interleaving, so a warp's accesses coalesce) and the
// fingerprints read from device memory. The blocks walk the tiles.
//
// Numerics: each cell is (q_i - r_j)^2 + min(D[i-1][j-1],
// min(D[i-1][j], D[i][j-1]) + p) as one fused multiply-add, which is how
// XLA:CPU contracts the jnp wavefront's d*d + best. Adding p after the min
// gives the bits of min(up + p, left + p), since rounding is monotone. The
// min propagates NaN as jnp.minimum and torch.minimum do (min.NaN.f32;
// fminf would drop it), and sqrtf is correctly rounded, so the result is
// bit-identical to the plain version and to the jnp wavefront in float32,
// non-finite fingerprints included.
//
// The SVM's kernel matrix (ops/dtw.py dtw_kernel_matrix): with `exp_out`,
// every variant stores XLA's exp(scale * D) (wdx_xla_exp_scaled1 of
// common.cuh, K16's element; scale = -gamma) where it would store D, so
// the exp costs ~36 operations on a value already in a register and no
// pass over the (B, N) matrix of its own: K16's read of D and its launch
// leave the path.
#include "common.cuh"

#ifndef WDX_DTW_THREADS
#define WDX_DTW_THREADS 128  // references of a tile, one per thread
#endif
#ifndef WDX_DTW_TQ
#define WDX_DTW_TQ 3  // queries of a tile
#endif

// The value stored for a distance: D, or (exp_out) XLA's exp(scale * D).
__device__ __forceinline__ float wdx_dtw_store(float dist, bool exp_out, float scale) {
  return exp_out ? wdx_xla_exp_scaled1(dist, scale) : dist;
}

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

// The static instance (m == M, window == W). blockIdx.x walks the tiles,
// the query tiles first.
template <int M, int W>
__global__ void __launch_bounds__(WDX_DTW_THREADS)
    wdx_dtw_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                   float* __restrict__ out, int B, int N, float p, bool exp_out, float scale) {
  extern __shared__ float wdx_dtw_smem[];
  constexpr int stride = M | 1;  // odd: references 32 apart fall in 32 banks
  float* ys = wdx_dtw_smem;                          // [WDX_DTW_THREADS][stride]
  float* qs = wdx_dtw_smem + WDX_DTW_THREADS * stride;  // [WDX_DTW_TQ][M]
  const int q_tiles = (B + WDX_DTW_TQ - 1) / WDX_DTW_TQ;
  const int b0 = (int)(blockIdx.x % q_tiles) * WDX_DTW_TQ;
  const int n0 = (int)(blockIdx.x / q_tiles) * WDX_DTW_THREADS;
  const int n_tile = min(WDX_DTW_THREADS, N - n0);
  const int q_tile = min(WDX_DTW_TQ, B - b0);

  const float* y_tile = Y + (long long)n0 * M;
  for (int e = threadIdx.x; e < n_tile * M; e += WDX_DTW_THREADS)
    ys[(e / M) * stride + e % M] = y_tile[e];
  const float* x_tile = X + (long long)b0 * M;
  for (int e = threadIdx.x; e < q_tile * M; e += WDX_DTW_THREADS) qs[e] = x_tile[e];
  __syncthreads();
  if ((int)threadIdx.x >= n_tile) return;

  float r[M];
#pragma unroll
  for (int j = 0; j < M; ++j) r[j] = ys[threadIdx.x * stride + j];
  float* o = out + (long long)b0 * N + n0 + threadIdx.x;
  for (int g = 0; g < q_tile; ++g)
    o[(long long)g * N] = wdx_dtw_store(wdx_dtw_static<M, W>(r, qs + g * M, p), exp_out, scale);
}

// The wide kernels, any m: a block (T = blockDim.x threads, a reference a
// thread) walks the tiles of T references by WDX_DTW_TQ queries. GLOBAL:
// the DP rows at slot blockIdx.x of `ws` (T (m + 1) floats a slot), the
// fingerprints read from X and Y; else all three in dynamic shared memory.
// Row i of the lattice runs its band's columns [lo, hi] alone: the cells
// left of lo are never read again, those right of hi + 1 were never
// written (+inf), and the first cell's left neighbour is outside the band
// or the lattice (+inf).
template <bool GLOBAL>
__global__ void __launch_bounds__(128)
    wdx_dtw_wide_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                        float* __restrict__ out, float* ws, int B, int N, int m, int window, float p,
                        bool exp_out, float scale) {
  extern __shared__ float wdx_dtw_wide_smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int stride = m | 1;
  float* const ys = wdx_dtw_wide_smem;  // [T][stride]
  float* const qs = ys + T * stride;    // [WDX_DTW_TQ][m]
  float* const rows = GLOBAL ? ws + (long long)blockIdx.x * T * (m + 1) : qs + WDX_DTW_TQ * m;  // [m + 1][T]
  float* const row = rows + tid;
  const int q_tiles = (B + WDX_DTW_TQ - 1) / WDX_DTW_TQ;
  const long long tiles = (long long)q_tiles * ((N + T - 1) / T);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b0 = (int)(tile % q_tiles) * WDX_DTW_TQ;
    const int n0 = (int)(tile / q_tiles) * T;
    const int n_tile = min(T, N - n0), q_tile = min(WDX_DTW_TQ, B - b0);
    if (!GLOBAL) {
      __syncthreads();  // the last tile's reads are done
      const float* y_tile = Y + (long long)n0 * m;
      for (long long e = tid; e < (long long)n_tile * m; e += T)
        ys[(e / m) * stride + e % m] = y_tile[e];
      const float* x_tile = X + (long long)b0 * m;
      for (int e = tid; e < q_tile * m; e += T) qs[e] = x_tile[e];
      __syncthreads();
    }
    if (tid >= n_tile) continue;
    const float* const r = GLOBAL ? Y + (long long)(n0 + tid) * m : ys + tid * stride;
    for (int g = 0; g < q_tile; ++g) {
      const float* const q = GLOBAL ? X + (long long)(b0 + g) * m : qs + g * m;
      row[0] = 0.f;
      for (int j = 1; j <= m; ++j) row[(long long)j * T] = INFINITY;
      for (int i = 0; i < m; ++i) {
        const int lo = max(0, i - window + 1), hi = min(m - 1, i + window - 1);
        if (lo > hi) continue;  // window < 1: no cell in the band
        const float qi = q[i];
        float diag = row[(long long)lo * T];  // D[i][lo]
        if (lo == 0) row[0] = INFINITY;       // D[i+1][0]
        float left = INFINITY;
        for (int j = lo; j <= hi; ++j) {
          const float up = row[(long long)(j + 1) * T];
          const float d = qi - r[j];
          const float val = __fmaf_rn(d, d, wdx_min_nan(diag, wdx_min_nan(up, left) + p));
          diag = up;
          row[(long long)(j + 1) * T] = val;
          left = val;
        }
      }
      out[(long long)(b0 + g) * N + n0 + tid] = wdx_dtw_store(sqrtf(row[(long long)m * T]), exp_out, scale);
    }
  }
}

// The wide kernel's dynamic shared memory at T threads (0 for GLOBAL).
static size_t wdx_dtw_wide_bytes(int m, int T) {
  return ((size_t)T * (m | 1) + (size_t)WDX_DTW_TQ * m + (size_t)T * (m + 1)) * sizeof(float);
}

// variant 0: the register kernel (m = 25, window = 15); 1: the wide kernel
// in shared memory, `threads` a block; 2: the wide kernel over `slots`
// blocks of `threads`, its DP rows in `ws` (slots x threads x (m + 1) floats).
// exp_out: store exp(scale * D) (the SVM's kernel matrix) instead of D.
WDX_API int wdx_dtw(const float* X, const float* Y, float* out, float* ws, int B, int N, int m,
                    int window, float p, int variant, int threads, int slots, int exp_out,
                    float scale, cudaStream_t stream) {
  if (m < 1 || B < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  if (variant == 0) {
    if (m != 25 || window != 15) return (int)cudaErrorInvalidValue;
    const long long tiles =
        (long long)((B + WDX_DTW_TQ - 1) / WDX_DTW_TQ) * ((N + WDX_DTW_THREADS - 1) / WDX_DTW_THREADS);
    if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;  // an output of more than 3 TB
    const size_t smem = (size_t)(WDX_DTW_THREADS * (25 | 1) + WDX_DTW_TQ * 25) * sizeof(float);
    wdx_dtw_kernel<25, 15><<<(int)tiles, WDX_DTW_THREADS, smem, stream>>>(X, Y, out, B, N, p,
                                                                          exp_out != 0, scale);
    return (int)cudaGetLastError();
  }
  if (threads < 32 || threads > 128 || threads % 32) return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)((B + WDX_DTW_TQ - 1) / WDX_DTW_TQ) * ((N + threads - 1) / threads);
  if (variant == 1) {
    const size_t smem = wdx_dtw_wide_bytes(m, threads);
    if (smem > WDX_MAX_SHARED_BYTES) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const int err = wdx_allow_shared(wdx_dtw_wide_kernel<false>, (int)smem);
      if (err) return err;
    }
    const int blocks = (int)(tiles < INT_MAX ? tiles : INT_MAX);
    wdx_dtw_wide_kernel<false><<<blocks, threads, smem, stream>>>(X, Y, out, nullptr, B, N, m, window,
                                                                  p, exp_out != 0, scale);
    return (int)cudaGetLastError();
  }
  if (variant != 2 || ws == nullptr || slots < 1) return (int)cudaErrorInvalidValue;
  wdx_dtw_wide_kernel<true><<<slots, threads, 0, stream>>>(X, Y, out, ws, B, N, m, window, p,
                                                            exp_out != 0, scale);
  return (int)cudaGetLastError();
}
