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
// Zeros add nothing to a sum that starts at +0 (it never becomes -0), so a
// window no sample of a range falls in sums to 0 and is never read: only
// the windows a range touches, and above them only the entries of the
// levels that hold one, are summed, each in XLA's order.
//
// Three variants behind the one entry point wdx_rowstats.
//
// The block kernel (the default): one block a row, every range of the row in
// that block. The block stages the span of the row that any range covers
// once in shared memory (the int16 preimage where the step calibrated, else
// the floats), with 16-byte loads, WDX_ROWSTATS_IN_FLIGHT a thread in
// flight; the window of 32 samples is laid out in 17 words (int16) or 33
// (float), so the 32 lanes of a warp, each reading its own window, hit 32
// banks. Each thread then sums whole windows of every range, in order, with
// the mask and the calibration applied as it reads; a window at a range's
// edge runs the same unrolled code under a mask of its samples, so no lane
// waits on another's loop. Then a warp a range: its lanes take the windows
// of the level above that hold a touched entry, and lane 0 the top, each
// issuing its 32 loads before its chain of adds, with only __syncwarp
// between the levels. After a barrier the means are in shared memory, and
// the same steps run on the squared deviations, read from the staged span
// again. A row takes five barriers and no serial walk. It answers the four
// limits of the warp kernel below: one dependent chain a warp (32 windows
// staged a round, then summed lane by lane), the top of the tree run over
// all ceil(L / 32) window sums of every pass, too few warps to hide that
// chain (8 an SM at the gate's one range), and the squares' pass reading
// device memory a second time.
//
// The warp kernel, the first design and the variant for rows whose staged
// span and sums do not fit a block's shared memory: one warp a (range,
// row), no block barrier. It stages 32 of its range's windows at a time
// (32 x 32 samples, one coalesced 128-byte load a window, rows padded to
// 33 floats against bank conflicts) in shared memory, each lane sums its
// window sequentially, and the window sums land in the warp's array of
// ceil(L / 32) floats; the levels above are summed from there the same way,
// a lane a window. The same is done a second time for d * d.
//
// The workspace kernel, for rows whose window sums outgrow the warp
// kernel's shared memory (past 431,104 samples): the warp kernel with each
// warp's window sums, level 1 and every level above, in a global workspace
// of ceil(L / 32) floats a (range, row) that the wrapper allocates; only
// the staged tile stays in shared memory. The tree's top is the same loop
// over however many levels the row needs (a fourth past 1,048,576
// samples), each in XLA's order. A warp writes and reads back its own
// sums alone, ordered by __syncwarp, so the sums stay in L1 and L2 at the
// rows it serves: the extra traffic is a write and a read of 4 bytes a
// window of 32 samples.
//
// With the calibration, x = (adc + offset) * scale is formed from the
// int16 preimage in the kernel, as the step forms it (two roundings).
//
// Bound: memory. The samples of the span the ranges cover are read once
// (the block kernel; the warp kernel reads a range again for its squares,
// mostly from L2) and two floats are written a (range, row). The wrapper
// (ops/rowstats.range_mean_std) takes the block kernel where its shared
// memory (wdx_rowstats_block_bytes) fits a block: rows of up to 92,480
// samples on the calibrated feed and 51,456 on the float feed at three
// ranges (103,072 and 54,624 at one); the warp kernel above, to 431,104;
// the workspace kernel at any longer row.
#include "common.cuh"

#define WDX_ROWSTATS_WARPS 4  // warps a block of the warp kernel; ops/rowstats.WARPS
#define WDX_ROWSTATS_TILE (32 * 33)

#ifndef WDX_ROWSTATS_BLOCK_WARPS
#define WDX_ROWSTATS_BLOCK_WARPS 4  // warps a block (a row) of the block kernel
#endif
#ifndef WDX_ROWSTATS_MIN_BLOCKS
// blocks an SM the block kernel's registers are held to (1,024 threads)
#define WDX_ROWSTATS_MIN_BLOCKS (32 / WDX_ROWSTATS_BLOCK_WARPS)
#endif
#ifndef WDX_ROWSTATS_IN_FLIGHT
#define WDX_ROWSTATS_IN_FLIGHT 4  // 16-byte loads a thread issues before it stores them
#endif

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

// ---------------------------------------------------------------------------
// The warp kernel

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
                        float* __restrict__ means, float* __restrict__ stds, float* ws, int R,
                        int B, int L) {
  extern __shared__ float wdx_rowstats_shared[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * WDX_ROWSTATS_WARPS + warp;
  if (g >= (long long)R * B) return;  // the whole warp
  const int b = (int)(g % B);
  const int n_win = (L + 31) / 32;
  // the window sums in shared memory before the warp's tile, or (the
  // workspace kernel) at the warp's slot of ws
  float* sums = ws ? ws + g * n_win : wdx_rowstats_shared + warp * (n_win + WDX_ROWSTATS_TILE);
  float* tile = ws ? wdx_rowstats_shared + warp * WDX_ROWSTATS_TILE : sums + n_win;
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

// ---------------------------------------------------------------------------
// The block kernel

// Entries of the tree's levels over a row of L: level 1 the ceil(L / 32)
// window sums, each level above ceil(n / 32) of the one below while that
// has more than 32 (0 where there is no such level).
struct WdxLevels {
  int n1, n2, n3;
  __host__ __device__ explicit WdxLevels(int L) {
    n1 = (L + 31) / 32;
    n2 = n1 > 32 ? (n1 + 31) / 32 : 0;
    n3 = n2 > 32 ? (n2 + 31) / 32 : 0;
  }
  __host__ __device__ int top() const { return n3 ? 3 : n2 ? 2 : 1; }
};


// Per range in shared memory: s, e, then the first and last touched entry
// of levels 1, 2 and 3 (an empty range: 0, -1)
#define WDX_RANGE_INTS 8

__host__ __device__ inline long long wdx_align16(long long n) { return (n + 15) / 16 * 16; }

// Words of the staged span a window of 32 samples: 16 int16 pairs or 32
// floats, and one more
__host__ __device__ inline int wdx_stage_words(bool calibrated) { return calibrated ? 17 : 33; }

// The block kernel's dynamic shared memory: the ranges' bounds and means,
// the sums of every level, the staged span; 0 where a level beyond the
// third would be needed.
__host__ __device__ inline long long wdx_rowstats_block_bytes(int R, int L, bool calibrated) {
  const WdxLevels lv(L);
  if (lv.n3 > 32) return 0;
  return wdx_align16(4LL * R * (WDX_RANGE_INTS + 1)) +
         wdx_align16(4LL * R * (lv.n1 + lv.n2 + lv.n3)) +
         4LL * lv.n1 * wdx_stage_words(calibrated);
}

// The range and the entry of thread t's k-th item of a level: the touched
// entries [lo, hi] of every range, ranges in order. `r` and `before` carry
// from one item to the next (t only grows). False when t is past the last.
__device__ __forceinline__ bool wdx_next_item(const int* rng, int R, int level, int t, int& r,
                                              int& before, int& entry) {
  while (r < R) {
    const int lo = rng[r * WDX_RANGE_INTS + 2 * level], hi = rng[r * WDX_RANGE_INTS + 2 * level + 1];
    if (t < before + hi - lo + 1) {
      entry = lo + t - before;
      return true;
    }
    before += hi - lo + 1;
    ++r;
  }
  return false;
}

// One staged window of 32 samples summed in order from +0 over the samples
// of [s, e): the values, or (SQUARE) the squared deviations from mean, fused
// into the sum (FUSED, a row of at most 32) or rounded alone. p0: the
// position of the window's first sample.
template <bool CAL, bool SQUARE, bool FUSED>
__device__ __forceinline__ float wdx_staged_window_sum(const uint32_t* words, const float* floats, int p0,
                                                       int s, int e, float mean, float off,
                                                       float sc) {
  auto add = [&](float acc, float v) {
    if (SQUARE) {
      const float d = CAL ? __fmaf_rn(__fadd_rn(v, off), sc, -mean) : __fsub_rn(v, mean);
      return FUSED ? __fmaf_rn(d, d, acc) : __fadd_rn(acc, __fmul_rn(d, d));
    }
    return __fadd_rn(acc, CAL ? __fmul_rn(__fadd_rn(v, off), sc) : v);
  };
  // the samples of [s, e) among the window's 32, as bits: a window at a
  // range's edge takes the same unrolled code as the others (no lane of a
  // warp waits on another's loop), a masked sample adds nothing
  const int j0 = max(s - p0, 0), j1 = min(e - p0, 32);
  const uint32_t mask = j1 <= j0 ? 0u : (0xffffffffu >> (32 - (j1 - j0))) << j0;
  auto add_if = [&](float acc, float v, int j) { return (mask >> j) & 1u ? add(acc, v) : acc; };
  float acc = 0.f;
  if (CAL) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t u = words[i];
      acc = add_if(acc, (float)(int16_t)(u & 0xffffu), 2 * i);
      acc = add_if(acc, (float)(int16_t)(u >> 16), 2 * i + 1);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc = add_if(acc, floats[j], j);
  }
  return acc;
}

// Level 1 of every range: each thread sums whole touched windows.
template <bool CAL, bool SQUARE, bool FUSED>
__device__ void wdx_block_level1(const int* rng, const float* mean_of, float* sums1, int n1,
                                 const void* stage, int f1, int w_span, int R, float off,
                                 float sc) {
  int r = 0, before = 0, w;
  for (int t = threadIdx.x; wdx_next_item(rng, R, 1, t, r, before, w); t += blockDim.x) {
    const int k = w - w_span;  // the window's place in the staged span
    const uint32_t* words = (const uint32_t*)stage + k * 17;
    const float* floats = (const float*)stage + k * 33;
    sums1[r * n1 + w] = wdx_staged_window_sum<CAL, SQUARE, FUSED>(
        words, floats, w * 32 - f1, rng[r * WDX_RANGE_INTS], rng[r * WDX_RANGE_INTS + 1],
        SQUARE ? mean_of[r] : 0.f, off, sc);
  }
}

// Entries i0 .. i0 + 31 of an array, those in [lo, hi], summed in
// order from +0: the 32 loads issued together (predicated), then the chain
// of adds; a skipped entry adds +0
__device__ __forceinline__ float wdx_sum_entries(const float* in, int i0, int lo, int hi) {
  float v[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i = i0 + j;
    v[j] = (i >= lo && i <= hi) ? in[i] : 0.f;
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) acc = __fadd_rn(acc, v[j]);
  return acc;
}

// The levels above 1 and the top of range r, by one warp (every lane
// calls): each lane sums windows of 32 entries of the level below that hold
// a touched entry, the warp syncs, and the next level; lane 0 sums the top
// and gets the sum (the other lanes get 0).
__device__ float wdx_warp_tree(const int* rng, float* sums, const WdxLevels& lv, int R, int r, int lane) {
  const int* q = rng + r * WDX_RANGE_INTS;
  auto n_of = [&](int k) { return k == 1 ? lv.n1 : k == 2 ? lv.n2 : lv.n3; };
  auto range_sums = [&](int k) {  // range r's array of level k
    const int before = k == 1 ? 0 : k == 2 ? R * lv.n1 : R * (lv.n1 + lv.n2);
    return sums + before + r * n_of(k);
  };
  const int top = lv.top();
  for (int up = 2; up <= top; ++up) {
    const float* below = range_sums(up - 1);
    float* above = range_sums(up);
    const int f = (n_of(up) * 32 - n_of(up - 1)) / 2;
    for (int w = q[2 * up] + lane; w <= q[2 * up + 1]; w += 32)
      above[w] = wdx_sum_entries(below, w * 32 - f, q[2 * up - 2], q[2 * up - 1]);
    __syncwarp();
  }
  return lane == 0 ? wdx_sum_entries(range_sums(top), 0, q[2 * top], q[2 * top + 1]) : 0.f;
}

// The tree of every range after level 1: a warp a range (in steps of the
// block's warps), out(r, sum) by its lane 0; every thread of the block
// calls.
template <typename Out>
__device__ void wdx_block_tree(const int* rng, float* sums, const WdxLevels& lv, int R, Out out) {
  __syncthreads();  // level 1 written
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
    const float sum = wdx_warp_tree(rng, sums, lv, R, r, lane);
    if (lane == 0) out(r, sum);
  }
}

// Sample i of a 16-byte load (i a constant once unrolled): a float of 4, or
// an int16 of 8, little-endian.
template <typename T>
__device__ __forceinline__ T wdx_vector_element(const int4& v, int i);
template <>
__device__ __forceinline__ float wdx_vector_element<float>(const int4& v, int i) {
  return __int_as_float(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
}
template <>
__device__ __forceinline__ int16_t wdx_vector_element<int16_t>(const int4& v, int i) {
  const int k = i >> 1;
  const unsigned w = (unsigned)(k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w);
  return (int16_t)(i & 1 ? w >> 16 : w & 0xffffu);
}

// The span [lo, hi) of the row into shared memory: sample p at word
// (or int16) k * 17 (k * 33) + j of the staged window k = (p + f1) / 32 -
// w_span, j = (p + f1) % 32; 16-byte loads from the first aligned sample,
// WDX_ROWSTATS_IN_FLIGHT a thread in flight.
template <typename T>
__device__ void wdx_stage_span(const T* __restrict__ src, int lo, int hi, int f1, int w_span,
                               T* stage) {
  constexpr int V = 16 / sizeof(T);       // samples a 16-byte load
  constexpr int PAD = 4 / sizeof(T);      // samples of the extra word a window
  const int q0 = f1 - w_span * 32;        // p + q0: the sample's place in the span's windows
  auto put = [&](int p, T v) {
    const int q = p + q0;
    stage[q + PAD * (q >> 5)] = v;
  };
  const int misaligned = (int)(((uintptr_t)(src + lo) & 15) / sizeof(T));
  const int head = min((V - misaligned) % V, hi - lo);
  for (int p = lo + threadIdx.x; p < lo + head; p += blockDim.x) put(p, src[p]);
  const int body = lo + head;
  const int n_vec = (hi - body) / V;
  const int4* vsrc = (const int4*)(src + body);
  constexpr int IN_FLIGHT = WDX_ROWSTATS_IN_FLIGHT;
  for (int v0 = threadIdx.x; v0 < n_vec; v0 += IN_FLIGHT * blockDim.x) {
    int4 got[IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v < n_vec) got[u] = __ldg(vsrc + v);
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v < n_vec) {
#pragma unroll
        for (int i = 0; i < V; ++i) put(body + v * V + i, wdx_vector_element<T>(got[u], i));
      }
    }
  }
  for (int p = body + n_vec * V + threadIdx.x; p < hi; p += blockDim.x) put(p, src[p]);
}

template <bool CAL>
__global__ void __launch_bounds__(WDX_ROWSTATS_BLOCK_WARPS * 32, WDX_ROWSTATS_MIN_BLOCKS)
    wdx_rowstats_block_kernel(const float* __restrict__ x, const int16_t* __restrict__ adc,
                              const float* __restrict__ offset, const float* __restrict__ scale,
                              const int* __restrict__ starts, const int* __restrict__ ends,
                              float* __restrict__ means, float* __restrict__ stds, int R, int B,
                              int L) {
  extern __shared__ float4 wdx_rowstats_block_shared[];
  const int b = blockIdx.x;
  const long long row = (long long)b * L;
  const float off = CAL ? offset[b] : 0.f, sc = CAL ? scale[b] : 0.f;
  const WdxLevels lv(L);
  char* smem = (char*)wdx_rowstats_block_shared;
  int* rng = (int*)smem;
  float* mean_of = (float*)(rng + R * WDX_RANGE_INTS);
  float* sums = (float*)(smem + wdx_align16(4LL * R * (WDX_RANGE_INTS + 1)));
  void* stage =
      (char*)sums + wdx_align16(4LL * R * (lv.n1 + lv.n2 + lv.n3));

  if (L == 1) {  // XLA keeps a row of one as it is
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      const bool in = min(max(ends[(long long)r * B + b], 0), 1) > min(max(starts[(long long)r * B + b], 0), 1);
      const float v = CAL ? __fmul_rn(__fadd_rn((float)adc[row], off), sc) : x[row];
      const float mean = __fdiv_rn(in ? v : 0.f, 1.f);
      means[(long long)r * B + b] = mean;
      if (stds != nullptr) {
        const float d = CAL ? __fmaf_rn(__fadd_rn((float)adc[row], off), sc, -mean) : __fsub_rn(x[row], mean);
        stds[(long long)r * B + b] = __fsqrt_rn(__fdiv_rn(in ? __fmul_rn(d, d) : 0.f, 1.f));
      }
    }
    return;
  }

  const int f1 = (lv.n1 * 32 - L) / 2;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const long long g = (long long)r * B + b;
    const int s = min(max(starts[g], 0), L), e = min(max(ends[g], 0), L);
    int* q = rng + r * WDX_RANGE_INTS;
    q[0] = s;
    q[1] = e;
    int lo = 0, hi = -1;
    if (e > s) {
      lo = (s + f1) >> 5;
      hi = (e - 1 + f1) >> 5;
    }
    q[2] = lo;
    q[3] = hi;
    if (lv.n2 && e > s) {
      const int f2 = (lv.n2 * 32 - lv.n1) / 2;
      lo = (lo + f2) >> 5;
      hi = (hi + f2) >> 5;
    }
    q[4] = lo;
    q[5] = hi;
    if (lv.n3 && e > s) {
      const int f3 = (lv.n3 * 32 - lv.n2) / 2;
      lo = (lo + f3) >> 5;
      hi = (hi + f3) >> 5;
    }
    q[6] = lo;
    q[7] = hi;
  }
  __syncthreads();
  int lo = L, hi = 0;  // the span the ranges cover
  for (int r = 0; r < R; ++r) {
    const int s = rng[r * WDX_RANGE_INTS], e = rng[r * WDX_RANGE_INTS + 1];
    if (e > s) {
      lo = min(lo, s);
      hi = max(hi, e);
    }
  }
  const int w_span = (min(lo, L - 1) + f1) >> 5;
  if (lo >= hi) {
    // no range holds a sample: every sum is 0
  } else if (CAL)
    wdx_stage_span<int16_t>(adc + row, lo, hi, f1, w_span, (int16_t*)stage);
  else
    wdx_stage_span<float>(x + row, lo, hi, f1, w_span, (float*)stage);
  __syncthreads();

  const bool fused = L <= 32;  // XLA contracts the squares into the one sequential sum
  wdx_block_level1<CAL, false, false>(rng, mean_of, sums, lv.n1, stage, f1, w_span, R, off, sc);
  wdx_block_tree(rng, sums, lv, R, [&](int r, float sum) {
    const float count = (float)max(rng[r * WDX_RANGE_INTS + 1] - rng[r * WDX_RANGE_INTS], 1);
    const float mean = __fdiv_rn(sum, count);
    mean_of[r] = mean;
    means[(long long)r * B + b] = mean;
  });
  if (stds == nullptr) return;
  __syncthreads();  // the means in shared memory, the top's reads of the sums done
  if (fused)
    wdx_block_level1<CAL, true, true>(rng, mean_of, sums, lv.n1, stage, f1, w_span, R, off, sc);
  else
    wdx_block_level1<CAL, true, false>(rng, mean_of, sums, lv.n1, stage, f1, w_span, R, off, sc);
  wdx_block_tree(rng, sums, lv, R, [&](int r, float sum) {
    const float count = (float)max(rng[r * WDX_RANGE_INTS + 1] - rng[r * WDX_RANGE_INTS], 1);
    stds[(long long)r * B + b] = __fsqrt_rn(__fdiv_rn(sum, count));
  });
}

// ---------------------------------------------------------------------------

// x (B, L) float32, or null and the calibration adc (B, L) int16, offset
// and scale (B,); starts, ends (R, B) int32; means (and stds, or null)
// (R, B) float32. variant 0: the block kernel, shared_bytes at least
// wdx_rowstats_block_bytes(R, L, calibrated); 1: the warp kernel,
// shared_bytes WDX_ROWSTATS_WARPS x (ceil(L / 32) + 32 x 33) floats; 2: the
// workspace kernel, shared_bytes WDX_ROWSTATS_WARPS x 32 x 33 floats and ws
// R x B x ceil(L / 32) floats (null for the other variants).
WDX_API int wdx_rowstats(const float* x, const int16_t* adc, const float* offset,
                         const float* scale, const int* starts, const int* ends, float* means,
                         float* stds, float* ws, int R, int B, int L, int variant,
                         int shared_bytes, cudaStream_t stream) {
  if (R == 0 || B == 0) return 0;
  const bool calibrated = x == nullptr;
  if (L <= 0 || (calibrated && (adc == nullptr || offset == nullptr || scale == nullptr)) ||
      shared_bytes > WDX_MAX_SHARED_BYTES)
    return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    const long long need = wdx_rowstats_block_bytes(R, L, calibrated);
    if (need == 0 || shared_bytes < need) return (int)cudaErrorInvalidValue;
    const int threads = WDX_ROWSTATS_BLOCK_WARPS * 32;
    if (calibrated) {
      if (shared_bytes > 48 * 1024) {
        const int err = wdx_allow_shared(wdx_rowstats_block_kernel<true>, shared_bytes);
        if (err) return err;
      }
      wdx_rowstats_block_kernel<true><<<B, threads, shared_bytes, stream>>>(
          x, adc, offset, scale, starts, ends, means, stds, R, B, L);
    } else {
      if (shared_bytes > 48 * 1024) {
        const int err = wdx_allow_shared(wdx_rowstats_block_kernel<false>, shared_bytes);
        if (err) return err;
      }
      wdx_rowstats_block_kernel<false><<<B, threads, shared_bytes, stream>>>(
          x, adc, offset, scale, starts, ends, means, stds, R, B, L);
    }
    return (int)cudaGetLastError();
  }
  const long long window_floats = variant == 2 ? 0 : (L + 31) / 32;
  if ((variant != 1 && variant != 2) || (variant == 2) != (ws != nullptr) ||
      (long long)shared_bytes < 4LL * WDX_ROWSTATS_WARPS * (window_floats + WDX_ROWSTATS_TILE))
    return (int)cudaErrorInvalidValue;
  if (shared_bytes > 48 * 1024) {
    const int err = wdx_allow_shared(wdx_rowstats_kernel, shared_bytes);
    if (err) return err;
  }
  const long long warps = (long long)R * B;
  const int blocks = (int)((warps + WDX_ROWSTATS_WARPS - 1) / WDX_ROWSTATS_WARPS);
  wdx_rowstats_kernel<<<blocks, WDX_ROWSTATS_WARPS * 32, shared_bytes, stream>>>(
      x, adc, offset, scale, starts, ends, means, stds, ws, R, B, L);
  return (int)cudaGetLastError();
}
