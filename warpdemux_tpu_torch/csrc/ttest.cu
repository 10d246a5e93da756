// K2: windowed t-test score curve of the event segmentation.
//
// Replaces warpdemux_tpu/ops/ttest_pallas.py windowed_t_test_pallas, which
// keeps a row tile in VMEM and builds the window sums from w_max lane rolls.
//
// The function needs one read of a row's valid samples and one write of its
// L scores. A block owns a tile of WDX_TTEST_TILE positions of one row (a
// grid of every tile of every row, the rows' first tiles first: the tiles
// of a row are independent, many blocks share an SM, and a row of any
// length runs the same kernel). The tile's
// samples below n_valid, with the reach of its last windows, are staged once
// into shared memory by 16-byte loads (zeros past n_valid, no read there),
// then
//   pass 1: a thread owns runs of WDX_TTEST_RUN consecutive positions, holds
//           the w + run - 1 samples they cover in registers and computes the
//           mean and the sum of squared deviations of each window ONCE, into
//           two more shared arrays (the statistics of the window at p are
//           those of the second window of p - w, bit for bit);
//   pass 2: score[p] from the statistics at p and at p + w, written by
//           vector stores; positions at and past n_valid - 2w are written
//           as zeros by the same stores, with no arithmetic, and a tile
//           without a scored position stages nothing.
// The inner loops are unrolled by a switch over template instances for
// w = 1 .. 12; any other width (w < 1, w > w_max, or w_max > 12) takes a
// loop a position over the staged tile, which also gives a width outside
// [1, w_max] the jnp path's meaning: the second window's statistics are 0
// and min(w, w_max) samples are summed. The kernel also writes each row's
// n_scores = max(n_valid - 2w, 0), which the caller needs beside the scores.
//
// Where a tile and its halo of 2 w_max samples do not fit in shared memory
// (w_max past 8,986), the block stages only the rsqrt table and scores each
// position by the loop above, reading its windows from device memory (from
// L1 and L2: a tile's neighbouring positions share all but one sample of
// each window). The reads stay below n_valid: a scored position's windows
// end at p + 2w <= n_valid. Both paths sum each window in the same order,
// so they give the same bits.
//
// Bound: memory. 4 bytes read per valid sample and 4 written per position.
//
// Numerics: the float32 operations of the jnp path of
// ops/segmentation.windowed_t_test in the same order: left-to-right window
// sums from zero, mean = sum / w, sum of squared deviations (unfused:
// -fmad=false), then |m1 - m2| * rsqrt(v1 + v2) with the rsqrt XLA:CPU
// computes: the x86 estimate from a table of 2 x 1024 entries (parity of the
// exponent, top 10 mantissa bits; ops/_rsqrt_table.py) and two Newton steps
// whose multiply-adds are fused. Lanes index the table at random, so it is
// staged into shared memory (4 KB) and not read as __constant__.
#include "common.cuh"

#ifndef WDX_TTEST_THREADS
#define WDX_TTEST_THREADS 128
#endif
#ifndef WDX_TTEST_RUN
#define WDX_TTEST_RUN 2  // consecutive positions a thread: 1, 2, 4 or 8
#endif
#ifndef WDX_TTEST_TILE
#define WDX_TTEST_TILE 1024  // positions a tile: a multiple of 4
#endif
#define WDX_TTEST_TABLE 2048  // entries of the rsqrt table
#define WDX_TTEST_PAD 32      // floats past a tile and its windows' reach in each shared array

__device__ __forceinline__ void wdx_stage_rsqrt_table(const uint16_t* __restrict__ table,
                                                      uint16_t* tab) {
  // 2048 uint16 = 256 vectors of 16 bytes
  for (int i = threadIdx.x; i < WDX_TTEST_TABLE / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(tab)[i] = reinterpret_cast<const uint4*>(table)[i];
}

// XLA:CPU's float32 rsqrt of x > 0 (or NaN): see ops/numerics.xla_rsqrt.
__device__ __forceinline__ float wdx_xla_rsqrt(float x, const uint16_t* tab) {
  const int bits = __float_as_int(x);
  const int e = (bits >> 23) & 0xFF;
  if (e == 0) return __int_as_float(0x7F800000);   // subnormal: the raw estimate, +inf
  if (e == 255) return x == x ? 0.f : x;           // +inf: the raw estimate, 0
  const int p = (e - 127) & 1;
  const int k = (e - 127 - p) >> 1;
  const int entry = tab[(p << 10) | ((bits >> 13) & 0x3FF)];
  float y = __int_as_float(0x3F000000 + (entry << 11) - (k << 23));
#pragma unroll
  for (int step = 0; step < 2; ++step) {
    const float a = x * y;
    const float b = y * -0.5f;
    const float d = __fmaf_rn(a, y, -1.f);
    y = __fmaf_rn(b, d, y);
  }
  return y;
}

__device__ __forceinline__ float wdx_t_score(float m1, float v1, float m2, float v2,
                                             const uint16_t* tab) {
  const float vsum = v1 + v2;
  return vsum > 0.f ? fabsf(m1 - m2) * wdx_xla_rsqrt(vsum, tab) : 0.f;
}

// Mean and sum of squared deviations of the window of width w at xr[p],
// n_take = min(w, w_max) samples of it.
__device__ __forceinline__ void wdx_window_stats(const float* xr, int p, int w, int n_take,
                                                 float& mean, float& ssd) {
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

// The score at p of a row xr (valid below nv) with a width given at run
// time; 0 at and past n_scores.
__device__ __forceinline__ float wdx_score_any_width(const float* xr, int p, int w, int w_max,
                                                     int n_scores, const uint16_t* tab) {
  if (p >= n_scores) return 0.f;
  const int n_take = min(w, w_max);
  float m1, v1, m2 = 0.f, v2 = 0.f;
  wdx_window_stats(xr, p, w, n_take, m1, v1);
  // the jnp path shifts by w only for w in [1, w_max]; otherwise zeros
  if (w >= 1 && w <= w_max) wdx_window_stats(xr, p + w, w, n_take, m2, v2);
  return wdx_t_score(m1, v1, m2, v2, tab);
}

// N consecutive floats from shared memory at src, which is aligned to VW
// floats; N is a multiple of VW.
template <int N, int VW>
__device__ __forceinline__ void wdx_load_run(const float* src, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += VW) {
    if constexpr (VW == 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    } else if constexpr (VW == 2) {
      const float2 q = *reinterpret_cast<const float2*>(src + i);
      v[i] = q.x, v[i + 1] = q.y;
    } else {
      v[i] = src[i];
    }
  }
}

template <int N, int VW>
__device__ __forceinline__ void wdx_store_run(float* dst, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += VW) {
    if constexpr (VW == 4) {
      *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    } else if constexpr (VW == 2) {
      *reinterpret_cast<float2*>(dst + i) = make_float2(v[i], v[i + 1]);
    } else {
      dst[i] = v[i];
    }
  }
}

// Mean and sum of squared deviations of the R windows of width W that start
// at src[0], src[1], ...; src is aligned to VW floats.
template <int W, int R, int VW>
__device__ __forceinline__ void wdx_run_stats(const float* src, float (&m)[R], float (&v)[R]) {
  constexpr int NX = (W + R - 1 + VW - 1) / VW * VW;
  const float wf = (float)W;
  float xv[NX];
  wdx_load_run<NX, VW>(src, xv);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) s = s + xv[r + i];
    m[r] = s / wf;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float d = xv[r + i] - m[r];
      acc = acc + d * d;
    }
    v[r] = acc;
  }
}

// One tile of a row with the width W known at compile time. xs: the staged
// samples from the tile's first position on; mean, ssd: the shared arrays
// of the window statistics; n_scores, n_out: the row's scores and positions
// from the tile's first position on (n_scores > 0).
template <int W, int R>
__device__ __forceinline__ void wdx_ttest_tile(const float* xs, float* mean, float* ssd,
                                               const uint16_t* tab, float* __restrict__ out_tile,
                                               int n_scores, int n_out, bool vector_stores) {
  constexpr int VW = R >= 4 ? 4 : R;              // floats a shared-memory access
  constexpr int A = W % VW;                       // offset of p + W in its vector
  constexpr int NS = (A + R + VW - 1) / VW * VW;  // statistics read around p + W
  const int stride = blockDim.x * R;
  // pass 1: the statistics of the windows at q < n_scores + W
  for (int q0 = threadIdx.x * R; q0 < n_scores + W; q0 += stride) {
    float m[R], v[R];
    wdx_run_stats<W, R, VW>(xs + q0, m, v);
    wdx_store_run<R, VW>(mean + q0, m);
    wdx_store_run<R, VW>(ssd + q0, v);
  }
  __syncthreads();
  // pass 2: the scores, and the zeros past them
  for (int p0 = threadIdx.x * R; p0 < n_out; p0 += stride) {
    float score[R];
#pragma unroll
    for (int r = 0; r < R; ++r) score[r] = 0.f;
    if (p0 < n_scores) {
      float m1[R], v1[R], m2[NS], v2[NS];
      wdx_load_run<R, VW>(mean + p0, m1);
      wdx_load_run<R, VW>(ssd + p0, v1);
      wdx_load_run<NS, VW>(mean + p0 + W - A, m2);
      wdx_load_run<NS, VW>(ssd + p0 + W - A, v2);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (p0 + r < n_scores) score[r] = wdx_t_score(m1[r], v1[r], m2[A + r], v2[A + r], tab);
    }
    if (vector_stores && p0 + R <= n_out) {
      wdx_store_run<R, VW>(out_tile + p0, score);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (p0 + r < n_out) out_tile[p0 + r] = score[r];
    }
  }
}

// Block t * B + b owns the WDX_TTEST_TILE positions from t * WDX_TTEST_TILE
// on of row b: tiles are independent, so a row's tiles run side by side and
// many blocks share an SM. Shared memory: the rsqrt table, then (staged)
// xs, mean and ssd of a tile plus halo floats each (halo: what the windows
// of a tile's last positions reach; their statistics are computed by both
// neighbours). The first tile's block also writes the row's n_scores =
// max(n_valid - 2w, 0).
__global__ void __launch_bounds__(WDX_TTEST_THREADS)
    wdx_ttest_kernel(const float* __restrict__ x, const int* __restrict__ n_valid,
                     const int* __restrict__ width, const uint16_t* __restrict__ table,
                     float* __restrict__ out, int* __restrict__ n_scores_out, int B, int L,
                     int w_max, int halo, int staged, int vector_access) {
  extern __shared__ __align__(16) unsigned char wdx_ttest_shared[];
  uint16_t* tab = reinterpret_cast<uint16_t*>(wdx_ttest_shared);
  float* xs = reinterpret_cast<float*>(wdx_ttest_shared + WDX_TTEST_TABLE * sizeof(uint16_t));
  float* mean = xs + WDX_TTEST_TILE + halo;
  float* ssd = mean + WDX_TTEST_TILE + halo;

  const int b = (int)(blockIdx.x % (unsigned)B);
  const int base = (int)(blockIdx.x / (unsigned)B) * WDX_TTEST_TILE;
  const float* x_tile = x + (long long)b * L + base;
  float* out_tile = out + (long long)b * L + base;
  const int n_out = min(WDX_TTEST_TILE, L - base);
  const int w = width[b];
  const long long row_scores = (long long)n_valid[b] - 2LL * w;
  if (base == 0 && threadIdx.x == 0)
    n_scores_out[b] = (int)min(max(row_scores, 0LL), (long long)INT_MAX);
  const int row_valid = min(n_valid[b], L);  // never read past the row
  const int n_scores = (int)min(max((long long)row_valid - 2LL * w - base, 0LL), (long long)n_out);
  if (n_scores == 0) {  // nothing is scored in this tile: zeros, no read
    if (vector_access) {
      for (int j = threadIdx.x * 4; j < n_out; j += blockDim.x * 4)
        *reinterpret_cast<float4*>(out_tile + j) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int j = threadIdx.x; j < n_out; j += blockDim.x) out_tile[j] = 0.f;
    }
    return;
  }

  wdx_stage_rsqrt_table(table, tab);
  if (!staged) {  // windows too wide for shared memory: read from device memory
    __syncthreads();
    for (int p = threadIdx.x; p < n_out; p += blockDim.x)
      out_tile[p] = wdx_score_any_width(x_tile, p, w, w_max, n_scores, tab);
    return;
  }
  // the samples below the valid length, zeros up to what the windows of
  // the tile's scored positions can touch
  const int nv = max(row_valid - base, 0);
  const int stage_end =
      min(WDX_TTEST_TILE + halo, (min(nv, n_scores + 2 * w_max) + 3) / 4 * 4 + 16);
  if (vector_access) {
    for (int j = threadIdx.x * 4; j < stage_end; j += blockDim.x * 4) {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < nv) {
        q = *reinterpret_cast<const float4*>(x_tile + j);  // L is a multiple of 4 here
        if (j + 1 >= nv) q.y = 0.f;
        if (j + 2 >= nv) q.z = 0.f;
        if (j + 3 >= nv) q.w = 0.f;
      }
      *reinterpret_cast<float4*>(xs + j) = q;
    }
  } else {
    for (int j = threadIdx.x; j < stage_end; j += blockDim.x) xs[j] = j < nv ? x_tile[j] : 0.f;
  }
  __syncthreads();

  if (!(w >= 1 && w <= w_max && w <= 12)) {
    for (int p = threadIdx.x; p < n_out; p += blockDim.x)
      out_tile[p] = wdx_score_any_width(xs, p, w, w_max, n_scores, tab);
    return;
  }
#define WDX_TTEST_CASE(W)                                                            \
  case W:                                                                            \
    wdx_ttest_tile<W, WDX_TTEST_RUN>(xs, mean, ssd, tab, out_tile, n_scores, n_out,  \
                                     vector_access != 0);                            \
    break;
  switch (w) {
    WDX_TTEST_CASE(1) WDX_TTEST_CASE(2) WDX_TTEST_CASE(3) WDX_TTEST_CASE(4)
    WDX_TTEST_CASE(5) WDX_TTEST_CASE(6) WDX_TTEST_CASE(7) WDX_TTEST_CASE(8)
    WDX_TTEST_CASE(9) WDX_TTEST_CASE(10) WDX_TTEST_CASE(11) WDX_TTEST_CASE(12)
  }
#undef WDX_TTEST_CASE
}

// x, out: (B, L); n_valid, width, n_scores: (B,); table: the 2048 entries of
// ops/_rsqrt_table.py. Any w_max >= 0 and L: the tile staged in shared
// memory where it fits with its halo, else the windows read from device
// memory.
WDX_API int wdx_ttest(const float* x, const int* n_valid, const int* width, const uint16_t* table,
                      float* out, int* n_scores, int B, int L, int w_max, cudaStream_t stream) {
  if ((long long)B * L == 0) return 0;
  if (w_max < 0 || B < 0 || L < 0) return (int)cudaErrorInvalidValue;
  const long long halo = (2LL * w_max + 3) / 4 * 4 + WDX_TTEST_PAD;
  const long long staged_bytes = WDX_TTEST_TABLE * 2 + 4LL * 3 * (WDX_TTEST_TILE + halo);
  const int staged = staged_bytes <= WDX_MAX_SHARED_BYTES;
  const int shared_bytes = staged ? (int)staged_bytes : WDX_TTEST_TABLE * 2;
  const long long blocks = (long long)B * (((long long)L + WDX_TTEST_TILE - 1) / WDX_TTEST_TILE);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;  // x and out of more than 8 TB each
  if (staged) {
    const int err = wdx_allow_shared(wdx_ttest_kernel, shared_bytes);
    if (err != 0) return err;
  }
  const int vector_access = L % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  wdx_ttest_kernel<<<(unsigned)blocks, WDX_TTEST_THREADS, shared_bytes, stream>>>(
      x, n_valid, width, table, out, n_scores, B, L, w_max, staged ? (int)halo : 0, staged,
      vector_access);
  return (int)cudaGetLastError();
}
