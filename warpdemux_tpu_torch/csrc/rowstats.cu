// K11: mean and population standard deviation of R [start, end) ranges of
// every row, with the bits of the jitted JAX step.
//
// New, with no Pallas counterpart: the JAX package computes these sums with
// XLA (warpdemux_tpu/ops/normalize.py masked_mean_std, the detector's region
// statistics; warpdemux_tpu/detect/boundaries.py:695, the [mvs_polya] gate's
// poly(A) mean). There each sum is a float32 reduction of the whole masked
// row, where(mask, x, 0), which XLA:CPU computes as a tree: the row
// zero-padded to whole windows of 32 (pad // 2 zeros in front), each window
// summed sequentially from 0, the window sums reduced the same way until 32
// or fewer are left, which are summed in order (ops/numerics.xla_sum). A
// row of one sample is that sample. Then
//   mean = sum / max(n, 1)                         (a true division)
//   d    = mask ? fma(adc + offset, scale, -mean)  (calibrated in the step)
//              : x - mean                          (else), 0 off the mask
//   std  = sqrt(tree sum of d * d / max(n, 1))     (d * d rounded alone; in
//                                                  a row of at most 32,
//                                                  fma(d, d, acc) instead)
// as ops/normalize.masked_mean_std computes them with torch operations.
//
// One warp a (range, row), no block barrier. Zeros add nothing to a sum that
// starts at +0 (it never becomes -0), so a window with no sample of the
// range sums to 0 and only the windows the range touches are read: the warp
// stages 32 of them at a time (32 x 32 samples, one coalesced 128-byte load
// a window, rows padded to 33 floats against bank conflicts) in shared
// memory, each lane sums its window sequentially, and the window sums land
// in the warp's array of ceil(L / 32) floats; the levels above are summed
// from there the same way, a lane a window. The same is done a second time
// for d * d. With the calibration, x = (adc + offset) * scale is formed from
// the int16 preimage in the kernel, as the step forms it (two roundings).
//
// Bound: memory, the range's samples read once (twice with stds: the second
// pass mostly from L2) and two floats written a (range, row).
#include "common.cuh"

#define WDX_ROWSTATS_WARPS 4  // warps a block; ops/rowstats.WARPS
#define WDX_ROWSTATS_TILE (32 * 33)

struct WdxRowSource {
  const float* x;  // (B, L), or null with the calibration
  const int16_t* adc;
  float offset, scale;

  __device__ __forceinline__ float value(long long i) const {
    return x ? x[i] : __fmul_rn(__fadd_rn((float)adc[i], offset), scale);
  }
  __device__ __forceinline__ float deviation(long long i, float mean) const {
    return x ? __fsub_rn(x[i], mean)
             : __fmaf_rn(__fadd_rn((float)adc[i], offset), scale, -mean);
  }
};

// The first level of the tree over the masked row: the sums of the windows
// of 32 into sums[0, n_win) (0 for windows outside [s, e)). SQUARE: sum
// deviation^2 from mean (each square rounded alone, or, in a row of at most
// 32, fused into the sum), else the values.
template <bool SQUARE>
__device__ void wdx_window_sums(const WdxRowSource& src, long long row, int L, int s, int e,
                                float mean, float* sums, float* tile, int lane) {
  const int n_win = (L + 31) / 32;
  const int front = (n_win * 32 - L) / 2;
  for (int w = lane; w < n_win; w += 32) sums[w] = 0.f;
  __syncwarp();
  if (e <= s) return;
  const int w_lo = (s + front) / 32, w_hi = (e - 1 + front) / 32;
  // a row of at most 32 samples is one sequential sum, into which XLA
  // contracts the squares: fma(d, d, acc)
  const bool fused = SQUARE && L <= 32;
  for (int w0 = w_lo; w0 <= w_hi; w0 += 32) {
    const int n_here = min(32, w_hi - w0 + 1);
    for (int j = 0; j < n_here; ++j) {
      const int pos = (w0 + j) * 32 - front + lane;
      float v = 0.f;
      if (pos >= s && pos < e) {
        if (SQUARE) {
          const float d = src.deviation(row + pos, mean);
          v = fused ? d : __fmul_rn(d, d);
        } else {
          v = src.value(row + pos);
        }
      }
      tile[j * 33 + lane] = v;
    }
    __syncwarp();
    if (lane < n_here) {
      float acc = 0.f;
      if (fused) {
        for (int j = 0; j < 32; ++j) {
          const float d = tile[lane * 33 + j];
          acc = __fmaf_rn(d, d, acc);
        }
      } else {
#pragma unroll 8
        for (int j = 0; j < 32; ++j) acc = __fadd_rn(acc, tile[lane * 33 + j]);
      }
      sums[w0 + lane] = acc;
    }
    __syncwarp();
  }
}

// The levels above: n window sums in sums[] reduced to one, every lane
// gets it.
__device__ float wdx_tree_top(float* sums, int n, int lane) {
  while (n > 32) {
    const int windows = (n + 31) / 32;
    const int front = (windows * 32 - n) / 2;
    for (int base = 0; base < windows; base += 32) {
      const int w = base + lane;
      float acc = 0.f;
      if (w < windows) {
        for (int j = 0; j < 32; ++j) {
          const int i = w * 32 - front + j;
          acc = __fadd_rn(acc, (i >= 0 && i < n) ? sums[i] : 0.f);
        }
      }
      __syncwarp();  // every read of this round before its writes
      if (w < windows) sums[w] = acc;
      __syncwarp();
    }
    n = windows;
  }
  float acc = 0.f;
  if (lane == 0)
    for (int j = 0; j < n; ++j) acc = __fadd_rn(acc, sums[j]);
  return __shfl_sync(0xffffffffu, acc, 0);
}

template <bool SQUARE>
__device__ float wdx_masked_row_sum(const WdxRowSource& src, long long row, int L, int s, int e,
                                    float mean, float* sums, float* tile, int lane) {
  if (L == 1) {  // XLA keeps a row of one as it is
    if (e <= s) return 0.f;
    if (SQUARE) {
      const float d = src.deviation(row, mean);
      return __fmul_rn(d, d);
    }
    return src.value(row);
  }
  wdx_window_sums<SQUARE>(src, row, L, s, e, mean, sums, tile, lane);
  return wdx_tree_top(sums, (L + 31) / 32, lane);
}

__global__ void __launch_bounds__(WDX_ROWSTATS_WARPS * 32)
    wdx_rowstats_kernel(const float* __restrict__ x, const int16_t* __restrict__ adc,
                        const float* __restrict__ offset, const float* __restrict__ scale,
                        const int* __restrict__ starts, const int* __restrict__ ends,
                        float* __restrict__ means, float* __restrict__ stds, int R, int B, int L) {
  extern __shared__ float wdx_rowstats_shared[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * WDX_ROWSTATS_WARPS + warp;
  if (g >= (long long)R * B) return;  // the whole warp
  const int b = (int)(g % B);
  const int n_win = (L + 31) / 32;
  float* sums = wdx_rowstats_shared + warp * (n_win + WDX_ROWSTATS_TILE);
  float* tile = sums + n_win;
  const int s = min(max(starts[g], 0), L), e = min(max(ends[g], 0), L);
  const float count = (float)max(e - s, 1);
  WdxRowSource src{x, adc, x ? 0.f : offset[b], x ? 0.f : scale[b]};
  const long long row = (long long)b * L;
  const float mean =
      __fdiv_rn(wdx_masked_row_sum<false>(src, row, L, s, e, 0.f, sums, tile, lane), count);
  float std = 0.f;
  if (stds != nullptr)
    std = __fsqrt_rn(
        __fdiv_rn(wdx_masked_row_sum<true>(src, row, L, s, e, mean, sums, tile, lane), count));
  if (lane == 0) {
    means[g] = mean;
    if (stds != nullptr) stds[g] = std;
  }
}

// x (B, L) float32, or null and the calibration adc (B, L) int16, offset
// and scale (B,); starts, ends (R, B) int32; means (and stds, or null)
// (R, B) float32. shared_bytes: WDX_ROWSTATS_WARPS x (ceil(L / 32) + 32 x 33)
// floats.
WDX_API int wdx_rowstats(const float* x, const int16_t* adc, const float* offset,
                         const float* scale, const int* starts, const int* ends, float* means,
                         float* stds, int R, int B, int L, int shared_bytes, cudaStream_t stream) {
  if (R == 0 || B == 0) return 0;
  if (L <= 0 || (x == nullptr && (adc == nullptr || offset == nullptr || scale == nullptr)) ||
      (long long)shared_bytes <
          4LL * WDX_ROWSTATS_WARPS * ((L + 31) / 32 + WDX_ROWSTATS_TILE))
    return (int)cudaErrorInvalidValue;
  if (shared_bytes > 48 * 1024) {
    const int err = wdx_allow_shared(wdx_rowstats_kernel, shared_bytes);
    if (err) return err;
  }
  const long long warps = (long long)R * B;
  const int blocks = (int)((warps + WDX_ROWSTATS_WARPS - 1) / WDX_ROWSTATS_WARPS);
  wdx_rowstats_kernel<<<blocks, WDX_ROWSTATS_WARPS * 32, shared_bytes, stream>>>(
      x, adc, offset, scale, starts, ends, means, stds, R, B, L);
  return (int)cudaGetLastError();
}
