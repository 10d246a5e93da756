// K2: windowed t-test score curve of the event segmentation.
//
// Replaces warpdemux_tpu/ops/ttest_pallas.py windowed_t_test_pallas, which
// keeps a row tile in VMEM and builds the window sums from w_max lane rolls.
// Here one thread owns one (row, position) and sums its two windows
// directly from device memory (neighbouring threads read neighbouring
// samples, so the loads coalesce and hit L1/L2 for the overlap).
//
// Bound: memory. 4 bytes read (mostly from cache) and 4 written per
// position; ~6*w flops per position.
//
// Numerics: the same float32 operations in the same order as the jnp path
// of ops/segmentation.windowed_t_test: left-to-right window sums, mean =
// sum / w, sum of squared deviations, |m1 - m2| / sqrt(v1 + v2). The second
// window's statistics are recomputed by the same code at p + w, so they are
// bit-identical to the shifted first-window values. -fmad=false keeps the
// d*d accumulation unfused.
#include "common.cuh"

__device__ __forceinline__ void wdx_window_stats(const float* __restrict__ xr, int p, int w,
                                                 int n_take, float& mean, float& ssd) {
  float s = 0.f;
  for (int i = 0; i < n_take; ++i) s = s + xr[p + i];
  mean = s / (float)w;
  float acc = 0.f;
  for (int i = 0; i < n_take; ++i) {
    const float d = xr[p + i] - mean;
    acc = acc + d * d;
  }
  ssd = acc;
}

__global__ void wdx_ttest_kernel(const float* __restrict__ x, const int* __restrict__ n_valid,
                                 const int* __restrict__ width, float* __restrict__ out, int B,
                                 int L, int w_max) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * L) return;
  const int b = (int)(idx / L);
  const int p = (int)(idx % L);
  const int nv = min(n_valid[b], L);  // never read past the row
  const int w = width[b];
  const int n_scores = max(nv - 2 * w, 0);
  float score = 0.f;
  if (p < n_scores) {
    const float* xr = x + (long long)b * L;
    const int n_take = min(w, w_max);
    float m1, v1, m2 = 0.f, v2 = 0.f;
    wdx_window_stats(xr, p, w, n_take, m1, v1);
    // the jnp path shifts by w only for w in [1, w_max]; otherwise zeros
    if (w >= 1 && w <= w_max) wdx_window_stats(xr, p + w, w, n_take, m2, v2);
    const float vsum = v1 + v2;
    const float num = fabsf(m1 - m2);
    score = vsum > 0.f ? num / sqrtf(vsum) : 0.f;
  }
  out[idx] = score;
}

WDX_API int wdx_ttest(const float* x, const int* n_valid, const int* width, float* out, int B,
                      int L, int w_max, cudaStream_t stream) {
  const long long total = (long long)B * L;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  wdx_ttest_kernel<<<(unsigned)blocks, threads, 0, stream>>>(x, n_valid, width, out, B, L, w_max);
  return (int)cudaGetLastError();
}
