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
// search the MAD.
#include "common.cuh"

struct WdxRangeKeys {
  const float* xr;
  int start;
  int end;
  bool absdev;
  float center;
  __device__ __forceinline__ int key(int i) const {
    const float v = absdev ? fabsf(xr[i] - center) : xr[i];
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
                                            int given_mask, int with_mad, float* __restrict__ meds,
                                            float* __restrict__ mads, int B, int L) {
  const int b = blockIdx.x;
  const int r = blockIdx.y;
  const long long o = (long long)r * B + b;
  WdxRangeKeys k;
  k.xr = x + (long long)b * L;
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
                                 float* meds, float* mads, int R, int B, int L,
                                 cudaStream_t stream) {
  if (R == 0 || B == 0) return 0;
  if (R > 31) return (int)cudaErrorInvalidValue;  // given_mask has one bit per range
  dim3 grid(B, R);
  wdx_range_median_mad_kernel<<<grid, 256, 0, stream>>>(x, starts, ends, given_meds, given_mask,
                                                        with_mad, meds, mads, B, L);
  return (int)cudaGetLastError();
}
