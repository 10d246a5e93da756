// K6 + K7: forward rolling-window statistics of the boundary detector.
//
// K6 replaces warpdemux_tpu/ops/rolling_pallas.py rolling_mean_var_pallas:
// mean and variance over [t, min(t + w, L)) for w_mean (mean and var) and
// w_var (var), variance clamped at 0. Like the TPU kernel it differences
// prefix sums of x and x*x. One block owns one row. The prefix sums use the
// association of ops/numerics.blocked_cumsum (XLA:CPU's blocked scan):
// sequential float32 sums inside blocks of 16 samples, the block totals
// scanned the same way one level up, each block's exclusive offset added
// on the way down; every level is a pass of the block's threads over a
// scratch row in device memory. var = fma(-mean, mean, s2 / n) with one
// rounding, as XLA:CPU contracts it. The result is bit-identical to the
// plain version (up to its float64 emulation of the fused multiply-add).
//
// K7 replaces rolling_pallas.py rolling_run_sum_pallas: the int32 count of
// a 0/1 mask over [t, min(t + w, L)). One thread counts one window directly
// (w = min_obs_polya = 100 byte loads from L1); exact.
//
// K9 replaces rolling_pallas.py rolling_detect_pallas: K6's statistics
// and both poly(A) candidate run sums in one launch. One block owns one
// row: it runs K6's device code (so mean_f, var_f and var_w equal K6's bit
// for bit), builds the candidate mask
//   base = mean_f > thr & var_w < var_max & t < len & t + w_run <= len
// from its own outputs into a scratch row, and counts base and
// base & (region > 0) over [t, min(t + w_run, L)) as K7 does. The TPU
// kernel's doubling scan is not carried over: the prefix sums keep
// XLA:CPU's blocked association, so the fused and unfused detect decide
// identically.
//
// Bound: K6 is memory-bound (4 bytes in, ~9 bytes of scratch traffic per
// prefix, 12 bytes out per sample); K7 reads w bytes per output from cache
// and writes 4. K9 moves K6's bytes plus 4 bytes of region in, 2 scratch
// bytes and 8 bytes of run sums out per sample, and saves the two masks
// and K7's launches.
#include "common.cuh"

#define WDX_SCAN_BLOCK 16
#define WDX_SCAN_MAX_LEVELS 8

// Level sizes / offsets of the blocked scan of n values; returns the count.
__device__ int wdx_scan_levels(int n, int* sizes, int* offsets) {
  int lev = 0;
  sizes[0] = n;
  offsets[0] = 0;
  while (sizes[lev] > WDX_SCAN_BLOCK && lev + 1 < WDX_SCAN_MAX_LEVELS) {
    sizes[lev + 1] = (sizes[lev] + WDX_SCAN_BLOCK - 1) / WDX_SCAN_BLOCK;
    offsets[lev + 1] = offsets[lev] + sizes[lev];
    ++lev;
  }
  return lev + 1;
}

// Inclusive blocked prefix sum of xr (squared if `square`) into buf[0, L);
// buf holds every level (the wrapper sizes it). All threads of the block call.
__device__ void wdx_blocked_scan(const float* __restrict__ xr, bool square, float* buf, int L) {
  int sizes[WDX_SCAN_MAX_LEVELS], offs[WDX_SCAN_MAX_LEVELS];
  const int n_levels = wdx_scan_levels(L, sizes, offs);
  for (int lev = 0; lev < n_levels; ++lev) {  // up: in-block running sums
    const int n = sizes[lev];
    const int n_blocks = (n + WDX_SCAN_BLOCK - 1) / WDX_SCAN_BLOCK;
    for (int blk = threadIdx.x; blk < n_blocks; blk += blockDim.x) {
      const int lo = blk * WDX_SCAN_BLOCK;
      const int hi = min(lo + WDX_SCAN_BLOCK, n);
      float s = 0.f;
      for (int i = lo; i < hi; ++i) {
        float v;
        if (lev == 0) {
          v = xr[i];
          if (square) v = v * v;
        } else {  // the total of block i one level down
          v = buf[offs[lev - 1] + min(i * WDX_SCAN_BLOCK + WDX_SCAN_BLOCK - 1, sizes[lev - 1] - 1)];
        }
        s = i == lo ? v : s + v;
        buf[offs[lev] + i] = s;
      }
    }
    __syncthreads();
  }
  for (int lev = n_levels - 2; lev >= 0; --lev) {  // down: block offsets
    for (int i = threadIdx.x; i < sizes[lev]; i += blockDim.x) {
      const int blk = i / WDX_SCAN_BLOCK;
      if (blk > 0) buf[offs[lev] + i] = buf[offs[lev] + i] + buf[offs[lev + 1] + blk - 1];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float wdx_prefix(const float* c, int t) {
  return t == 0 ? 0.f : c[t - 1];  // sum of the first t samples
}

__device__ __forceinline__ void wdx_window_mean_var(const float* c1, const float* c2, int t,
                                                    int w, int L, float& mean, float& var) {
  const int hi = min(t + w, L);
  const float n = (float)(hi - t);
  const float s1 = wdx_prefix(c1, hi) - wdx_prefix(c1, t);
  const float s2 = wdx_prefix(c2, hi) - wdx_prefix(c2, t);
  mean = s1 / n;
  const float v = __fmaf_rn(-mean, mean, s2 / n);
  var = v < 0.f ? 0.f : v;  // jnp.maximum(v, 0): NaN stays NaN
}

// K6's work on row blockIdx.x; all threads of the block call.
__device__ void wdx_row_mean_var(const float* __restrict__ x, float* c1_all, float* c2_all,
                                 int scratch_len, float* __restrict__ mean_f,
                                 float* __restrict__ var_f, float* __restrict__ var_w, int L,
                                 int w_mean, int w_var) {
  const int b = blockIdx.x;
  const float* xr = x + (long long)b * L;
  float* c1 = c1_all + (long long)b * scratch_len;
  float* c2 = c2_all + (long long)b * scratch_len;
  wdx_blocked_scan(xr, false, c1, L);
  wdx_blocked_scan(xr, true, c2, L);

  const long long row = (long long)b * L;
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    float m, v, mw, vw;
    wdx_window_mean_var(c1, c2, t, w_mean, L, m, v);
    wdx_window_mean_var(c1, c2, t, w_var, L, mw, vw);
    mean_f[row + t] = m;
    var_f[row + t] = v;
    var_w[row + t] = vw;
  }
}

__global__ void wdx_rolling_mean_var_kernel(const float* __restrict__ x, float* c1_all,
                                            float* c2_all, int scratch_len,
                                            float* __restrict__ mean_f,
                                            float* __restrict__ var_f, float* __restrict__ var_w,
                                            int L, int w_mean, int w_var) {
  wdx_row_mean_var(x, c1_all, c2_all, scratch_len, mean_f, var_f, var_w, L, w_mean, w_var);
}

__global__ void wdx_rolling_detect_kernel(const float* __restrict__ x,
                                          const float* __restrict__ region,
                                          const float* __restrict__ thr,
                                          const int* __restrict__ lens, float* c1_all,
                                          float* c2_all, int scratch_len, uint8_t* base_all,
                                          float* __restrict__ mean_f, float* __restrict__ var_f,
                                          float* __restrict__ var_w, int* __restrict__ rs_plain,
                                          int* __restrict__ rs_masked, int L, int w_mean,
                                          int w_var, int w_run, float var_max) {
  wdx_row_mean_var(x, c1_all, c2_all, scratch_len, mean_f, var_f, var_w, L, w_mean, w_var);
  const int b = blockIdx.x;
  const long long row = (long long)b * L;
  const float th = thr[b];
  const int len = lens[b];
  // bit 0: the candidate mask; bit 1: the mask inside the CNN region. Each
  // thread reads back the statistics it wrote itself.
  uint8_t* base = base_all + row;
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    const bool cand = mean_f[row + t] > th && var_w[row + t] < var_max && t < len &&
                      t + w_run <= len;
    base[t] = (uint8_t)((cand ? 1 : 0) | (cand && region[row + t] > 0.f ? 2 : 0));
  }
  __syncthreads();
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    const int hi = min(t + w_run, L);
    int cp = 0, cm = 0;
    for (int i = t; i < hi; ++i) {
      const uint8_t v = base[i];
      cp += v & 1;
      cm += v >> 1;
    }
    rs_plain[row + t] = cp;
    rs_masked[row + t] = cm;
  }
}

__global__ void wdx_run_sum_kernel(const uint8_t* __restrict__ mask, int* __restrict__ out, int B,
                                   int L, int w) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * L) return;
  const int t = (int)(idx % L);
  const uint8_t* m = mask + (idx - t);
  const int hi = min(t + w, L);
  int c = 0;
  for (int i = t; i < hi; ++i) c += m[i] ? 1 : 0;
  out[idx] = c;
}

WDX_API int wdx_rolling_mean_var(const float* x, float* c1_scratch, float* c2_scratch,
                                 int scratch_len, float* mean_f, float* var_f, float* var_w,
                                 int B, int L, int w_mean, int w_var, cudaStream_t stream) {
  if (B == 0 || L == 0) return 0;
  wdx_rolling_mean_var_kernel<<<B, 1024, 0, stream>>>(x, c1_scratch, c2_scratch, scratch_len,
                                                      mean_f, var_f, var_w, L, w_mean, w_var);
  return (int)cudaGetLastError();
}

WDX_API int wdx_run_sum(const uint8_t* mask, int* out, int B, int L, int w, cudaStream_t stream) {
  const long long total = (long long)B * L;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  wdx_run_sum_kernel<<<(unsigned)blocks, threads, 0, stream>>>(mask, out, B, L, w);
  return (int)cudaGetLastError();
}

WDX_API int wdx_rolling_detect(const float* x, const float* region, const float* thr,
                               const int* lens, float* c1_scratch, float* c2_scratch,
                               int scratch_len, uint8_t* base_scratch, float* mean_f,
                               float* var_f, float* var_w, int* rs_plain, int* rs_masked, int B,
                               int L, int w_mean, int w_var, int w_run, float var_max,
                               cudaStream_t stream) {
  if (B == 0 || L == 0) return 0;
  wdx_rolling_detect_kernel<<<B, 1024, 0, stream>>>(
      x, region, thr, lens, c1_scratch, c2_scratch, scratch_len, base_scratch, mean_f, var_f,
      var_w, rs_plain, rs_masked, L, w_mean, w_var, w_run, var_max);
  return (int)cudaGetLastError();
}
