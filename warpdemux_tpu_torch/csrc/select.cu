// K4: exact median (+ MAD) of R [start, end) ranges per row.
//
// Replaces warpdemux_tpu/ops/select_pallas.py range_median_mad_pallas. Both
// find order statistics by radix bisection over the monotone int32 image of
// float32 (no sort): one sign-deciding count, then 31 MSB-first rounds that
// set bit b iff count(key < candidate) <= rank. The TPU kernel keeps an
// (8, L) row tile in VMEM; here one block owns one (range, row) pair and
// every round is a strided pass over the range plus a block reduction.
//
// Bound: the ~35 (70 with the MAD) counting passes over each range. The
// range is re-read from device memory every round; at detect shapes the
// rows sit in the 50 MB L2, so the passes run at cache bandwidth.
//
// Semantics match numpy exactly: the mean of the two middle order
// statistics for even counts, NaN for an empty range; MAD = median of
// |x - median|. given[r] regions take their median from given_meds and only
// search the MAD. With a calibration preimage (x = (adc + offset) * scale
// computed in the same program) the deviations are
// |fma(adc + offset, scale, -median)|, the one rounding XLA:CPU gives them
// when it fuses the calibration into the MAD.
#include "common.cuh"

struct WdxRangeKeys {
  const float* xr;
  const int16_t* ar;  // calibration preimage of the row, or null
  float off;
  float scale;
  int start;
  int end;
  bool absdev;
  float center;
  __device__ __forceinline__ int key(int i) const {
    float v = xr[i];
    if (absdev) v = ar ? fabsf(__fmaf_rn((float)ar[i] + off, scale, -center)) : fabsf(v - center);
    return wdx_order_key(v);
  }
};

__device__ int wdx_count_less(const WdxRangeKeys& k, int t) {
  int c = 0;
  for (int i = k.start + threadIdx.x; i < k.end; i += blockDim.x) c += k.key(i) < t ? 1 : 0;
  return wdx_block_reduce(c, WdxSum(), 0);
}

__device__ float wdx_range_median(const WdxRangeKeys& k) {
  const int n = k.end - k.start;
  if (n <= 0) return NAN;
  const int rank = (n - 1) / 2;

  // sign pass: the answer is negative iff rank < count(key < 0)
  int res = rank < wdx_count_less(k, 0) ? INT_MIN : 0;
  for (int bit = 30; bit >= 0; --bit) {
    const int t = res | (1 << bit);
    if (wdx_count_less(k, t) <= rank) res = t;
  }
  const int lo_key = res;

  int le = 0;
  int nxt = INT_MAX;
  for (int i = k.start + threadIdx.x; i < k.end; i += blockDim.x) {
    const int key = k.key(i);
    le += key <= lo_key ? 1 : 0;
    if (key > lo_key && key < nxt) nxt = key;
  }
  le = wdx_block_reduce(le, WdxSum(), 0);
  nxt = wdx_block_reduce(nxt, WdxMin(), INT_MAX);

  const float lo = wdx_key_to_float(lo_key);
  if (n % 2 == 1) return lo;
  const float hi = le <= n / 2 ? wdx_key_to_float(nxt) : lo;
  return 0.5f * (lo + hi);
}

__global__ void wdx_range_median_mad_kernel(const float* __restrict__ x,
                                            const int* __restrict__ starts,
                                            const int* __restrict__ ends,
                                            const float* __restrict__ given_meds,
                                            int given_mask, int with_mad,
                                            const int16_t* __restrict__ adc,
                                            const float* __restrict__ offset,
                                            const float* __restrict__ scale,
                                            float* __restrict__ meds,
                                            float* __restrict__ mads, int B, int L) {
  const int b = blockIdx.x;
  const int r = blockIdx.y;
  const long long o = (long long)r * B + b;
  WdxRangeKeys k;
  k.xr = x + (long long)b * L;
  k.ar = adc ? adc + (long long)b * L : nullptr;
  k.off = adc ? offset[b] : 0.f;
  k.scale = adc ? scale[b] : 0.f;
  k.start = min(max(starts[o], 0), L);
  k.end = min(max(ends[o], 0), L);
  k.absdev = false;
  k.center = 0.f;
  const bool given = (given_mask >> r) & 1;
  const float med = given ? given_meds[o] : wdx_range_median(k);
  if (threadIdx.x == 0) meds[o] = med;
  if (with_mad) {
    k.absdev = true;
    k.center = med;
    const float mad = wdx_range_median(k);
    if (threadIdx.x == 0) mads[o] = mad;
  }
}

WDX_API int wdx_range_median_mad(const float* x, const int* starts, const int* ends,
                                 const float* given_meds, int given_mask, int with_mad,
                                 const int16_t* adc, const float* offset, const float* scale,
                                 float* meds, float* mads, int R, int B, int L,
                                 cudaStream_t stream) {
  if (R == 0 || B == 0) return 0;
  if (R > 31) return (int)cudaErrorInvalidValue;  // given_mask has one bit per range
  dim3 grid(B, R);
  wdx_range_median_mad_kernel<<<grid, 256, 0, stream>>>(x, starts, ends, given_meds, given_mask,
                                                        with_mad, adc, offset, scale, meds,
                                                        mads, B, L);
  return (int)cudaGetLastError();
}

// K8: median of R [start, end) ranges per row of the calibrated signal,
// bisected over the row's int16 ADC preimage.
//
// Replaces warpdemux_tpu/ops/select_pallas.py range_median_pallas_adc. The
// key adc + 32768 lies in [0, 65535], so the rank-th smallest key takes 16
// MSB-first counting rounds (K4 takes 32 over float keys). One more pass
// reads the order statistics out of the float32 signal: lo = min x over
// key == lo_key, the next larger value = min x over key > lo_key, and
// count(key <= lo_key) decides whether an even count needs it. With a
// monotone calibration (scale > 0) this is bit-identical to K4 with the
// MAD off. One block owns one (range, row) pair, as in K4.
//
// Bound: 17 passes over the range, each reading 2 bytes a sample (the
// last also 4 bytes of x); at detect shapes the rows sit in L2. A
// shared-memory histogram of the key (two passes of 256 bins) would need
// 2 passes instead of 17.
__device__ __forceinline__ int wdx_count_adc_less(const int16_t* a, int start, int end, int t) {
  int c = 0;
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) c += (int)a[i] + 32768 < t ? 1 : 0;
  return wdx_block_reduce(c, WdxSum(), 0);
}

__global__ void wdx_range_median_adc_kernel(const float* __restrict__ x,
                                            const int16_t* __restrict__ adc,
                                            const int* __restrict__ starts,
                                            const int* __restrict__ ends,
                                            float* __restrict__ meds, int B, int L) {
  const int b = blockIdx.x;
  const int r = blockIdx.y;
  const long long o = (long long)r * B + b;
  const float* xr = x + (long long)b * L;
  const int16_t* ar = adc + (long long)b * L;
  const int start = min(max(starts[o], 0), L);
  const int end = min(max(ends[o], 0), L);
  const int n = end - start;
  if (n <= 0) {
    if (threadIdx.x == 0) meds[o] = NAN;
    return;
  }
  const int rank = (n - 1) / 2;
  int lo_key = 0;
  for (int bit = 15; bit >= 0; --bit) {
    const int t = lo_key | (1 << bit);
    if (wdx_count_adc_less(ar, start, end, t) <= rank) lo_key = t;
  }

  // order keys of x (a total order on floats) carry the two minima
  const int inf_key = wdx_order_key(INFINITY);
  int lo = inf_key;
  int nxt = inf_key;
  int le = 0;
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
    const int key = (int)ar[i] + 32768;
    const int xk = wdx_order_key(xr[i]);
    if (key == lo_key && xk < lo) lo = xk;
    if (key > lo_key && xk < nxt) nxt = xk;
    le += key <= lo_key ? 1 : 0;
  }
  lo = wdx_block_reduce(lo, WdxMin(), inf_key);
  nxt = wdx_block_reduce(nxt, WdxMin(), inf_key);
  le = wdx_block_reduce(le, WdxSum(), 0);
  if (threadIdx.x != 0) return;
  const float lo_f = wdx_key_to_float(lo);
  if (n % 2 == 1) {
    meds[o] = lo_f;
  } else {
    const float hi_f = le <= n / 2 ? wdx_key_to_float(nxt) : lo_f;
    meds[o] = 0.5f * (lo_f + hi_f);
  }
}

WDX_API int wdx_range_median_adc(const float* x, const int16_t* adc, const int* starts,
                                 const int* ends, float* meds, int R, int B, int L,
                                 cudaStream_t stream) {
  if (R == 0 || B == 0) return 0;
  dim3 grid(B, R);
  wdx_range_median_adc_kernel<<<grid, 256, 0, stream>>>(x, adc, starts, ends, meds, B, L);
  return (int)cudaGetLastError();
}
