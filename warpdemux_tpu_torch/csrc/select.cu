// K4: exact median (+ MAD) of R [start, end) ranges per row.
//
// Replaces warpdemux_tpu/ops/select_pallas.py range_median_mad_pallas. Both
// find order statistics over the monotone integer image of float32 (no
// sort). The TPU kernel keeps an (8, L) row tile in VMEM and bisects it one
// bit a round; here one block owns one (range, row) pair.
//
// Bound: bytes by the roofline (a range is 4 bytes a sample), but the time
// is that of the passes a block makes over its range, each with a barrier
// and a scan behind it. So the passes are few and run from shared memory:
//   - the block reads its range once from device memory (float4 where the
//     rows are aligned) and stages the keys in dynamic shared memory, sized
//     by the row length (4 L bytes; the range lengths are device data);
//   - the rank-th key is found most significant digit first, 8 bits a round
//     (WDX_SELECT_BITS): a round adds the digit of every key that matches
//     the digits found so far into a 256-bin histogram in shared memory
//     (four keys a thread from one 16-byte load), a barrier, and every warp
//     scans the bins to the one holding the rank. Each round has a
//     histogram of its own (two bins a word), so one barrier a round;
//   - calibrated picoampere values share sign and exponent, so the staging
//     pass also reduces the smallest and largest key and the digits start
//     at the highest bit in which the two differ (WDX_SELECT_PREFIX): 3
//     rounds instead of 4 for a read's samples, none for an all-equal range;
//   - the first round adds every key, and what is left of the ties there
//     (quantised samples, the exponent bits of the deviations) would make
//     the lanes of a warp add to the same few words, which the card replays
//     one lane at a time. It counts into eight copies of each bin, chosen
//     by the lane, summed after the barrier (WDX_SELECT_SPREAD). The later
//     rounds add the few keys on the prefix with plain atomics;
//   - the last round's bin gives count(key < lo) and lo's multiplicity, so
//     only an even count whose two middle keys differ pays one more pass
//     (the smallest key above lo);
//   - the MAD rewrites the staged keys in place as the keys of the
//     deviations, computed once a sample, and selects again; with a
//     calibration preimage the deviations come from the int16 row instead.
// A row whose keys do not fit shared memory runs the streaming kernel below
// (one bit a round, every round a strided pass over the range from L2 plus
// a block reduction); the wrapper picks by L.
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

#ifndef WDX_SELECT_THREADS
#define WDX_SELECT_THREADS 256
#endif
#ifndef WDX_SELECT_BITS
#define WDX_SELECT_BITS 8  // of a digit: 8 or 11
#endif
#ifndef WDX_SELECT_PREFIX
#define WDX_SELECT_PREFIX 1  // skip the leading bits the range's keys share
#endif
#ifndef WDX_SELECT_SPREAD
#define WDX_SELECT_SPREAD (WDX_SELECT_BITS == 8)  // a selection's first round counts into 8 copies
#endif
#ifndef WDX_SELECT_MIN_BLOCKS
#define WDX_SELECT_MIN_BLOCKS 4  // blocks an SM the register allocation must allow
#endif
#define WDX_SELECT_BINS (1 << WDX_SELECT_BITS)
#define WDX_SELECT_ROUNDS ((32 + WDX_SELECT_BITS - 1) / WDX_SELECT_BITS)
// A histogram packs two bins into a word (a range in shared memory has
// fewer than 65,536 keys, so no half carries): bin b is half b % 2 of word
// b / 2 + b / 64. A lane of the scan reads BINS / 64 neighbouring words,
// and the pad after every 32 spreads the 32 lanes' reads over the banks.
#define WDX_SELECT_HIST_WORDS (WDX_SELECT_BINS / 2 + WDX_SELECT_BINS / 64)

// Staged keys are unsigned: the order key with its sign bit flipped, so
// that unsigned compares and digits order them.
__device__ __forceinline__ unsigned wdx_staged_key(float v) {
  return (unsigned)wdx_order_key(v) ^ 0x80000000u;
}

__device__ __forceinline__ float wdx_staged_key_to_float(unsigned u) {
  return wdx_key_to_float((int)(u ^ 0x80000000u));
}

// A block's static shared memory for selections over staged keys.
struct __align__(16) WdxSelectShared {  // spread is read as 16-byte vectors
  unsigned hist[WDX_SELECT_ROUNDS][WDX_SELECT_HIST_WORDS];  // one histogram a round
#if WDX_SELECT_SPREAD
  // The first round adds every key, and lanes of a warp that add to one
  // word are replayed one by one: it counts into eight copies of a bin,
  // chosen by the lane (word lane % 4 of the bin's four, half lane / 4 % 2)
  // and summed into hist[0] afterwards.
  unsigned spread[WDX_SELECT_BINS * 4];
#endif
  unsigned lo[32];  // a slot a warp
  unsigned hi[32];
};

__device__ __forceinline__ void wdx_select_clear(WdxSelectShared& sh) {
  unsigned* h = &sh.hist[0][0];
  for (int i = threadIdx.x; i < WDX_SELECT_ROUNDS * WDX_SELECT_HIST_WORDS; i += blockDim.x)
    h[i] = 0u;
#if WDX_SELECT_SPREAD
  for (int i = threadIdx.x; i < WDX_SELECT_BINS; i += blockDim.x)
    reinterpret_cast<uint4*>(sh.spread)[i] = make_uint4(0u, 0u, 0u, 0u);
#endif
}

__device__ __forceinline__ void wdx_hist_add(unsigned* h, unsigned bin, unsigned count) {
  const unsigned word = bin >> 1;
  atomicAdd(&h[word + (word >> 5)], count << (16 * (bin & 1u)));
}

// f(j, key) for every staged key, four neighbours a thread and iteration
// (one 16-byte load; the buffer is padded to whole vectors). Every lane of
// a warp makes the same number of calls, those past the range with j >= n.
template <typename F>
__device__ __forceinline__ void wdx_for_each_key(const unsigned* keys, int n, F f) {
  for (int first = 0; first < n; first += 4 * blockDim.x) {
    const int j = first + 4 * threadIdx.x;
    uint4 k = make_uint4(0u, 0u, 0u, 0u);
    if (j < n) k = *reinterpret_cast<const uint4*>(keys + j);
    f(j, k.x);
    f(j + 1, k.y);
    f(j + 2, k.z);
    f(j + 3, k.w);
  }
}

// Block-wide min of lo and max of hi (one value a thread; every thread gets
// both), with one barrier: it also publishes the keys staged and the
// histograms cleared before it. Two calls need a barrier between them.
__device__ void wdx_block_min_max(unsigned& lo, unsigned& hi, WdxSelectShared& sh) {
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    sh.lo[threadIdx.x >> 5] = lo;
    sh.hi[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
    lo = min(lo, sh.lo[k]);
    hi = max(hi, sh.hi[k]);
  }
}

struct WdxRank {
  unsigned key;  // the rank-th smallest staged key
  int less;      // count(keys < key)
  int mult;      // count(keys == key)
};

// The rank-th smallest (0-based) of the n < 65,536 staged keys in shared
// memory, given their smallest and largest, by histograms of MSB-first
// digits. The histograms must be zero and visible; every thread gets the
// result. All threads of the block call.
__device__ WdxRank wdx_radix_select(const unsigned* keys, int n, int rank, unsigned lo,
                                    unsigned hi, WdxSelectShared& sh) {
  WdxRank res;
  res.key = lo;  // its bits above the highest differing one are every key's
  res.less = 0;
  res.mult = n;
  const unsigned diff = lo ^ hi;
  if (diff == 0u) return res;
  const int top = WDX_SELECT_PREFIX ? 31 - __clz(diff) : 31;
  const int lane = threadIdx.x & 31;
  const int lane_words = WDX_SELECT_BINS / 64;  // of a lane of the scan: two bins a word
  int round = 0;
  for (int shift = top / WDX_SELECT_BITS * WDX_SELECT_BITS; shift >= 0;
       shift -= WDX_SELECT_BITS, ++round) {
    unsigned* h = sh.hist[round];
    const int above = shift + WDX_SELECT_BITS;  // bits found so far: [above, 32)
    const unsigned prefix = res.key;
#if WDX_SELECT_SPREAD
    if (round == 0) {  // every key is on the prefix
      unsigned* mine = sh.spread + (lane & 3);
      const unsigned one = 1u << (4 * (lane & 4));
      wdx_for_each_key(keys, n, [&](int j, unsigned u) {
        if (j < n) atomicAdd(&mine[4 * ((u >> shift) & (WDX_SELECT_BINS - 1))], one);
      });
      __syncthreads();
      for (int w = threadIdx.x; w < WDX_SELECT_BINS / 2; w += blockDim.x) {  // bins 2w, 2w + 1
        const uint4 a = reinterpret_cast<const uint4*>(sh.spread)[2 * w];
        const uint4 b = reinterpret_cast<const uint4*>(sh.spread)[2 * w + 1];
        const unsigned sa = a.x + a.y + a.z + a.w;  // no half carries: at most n keys in all
        const unsigned sb = b.x + b.y + b.z + b.w;
        h[w + (w >> 5)] = ((sa & 0xffffu) + (sa >> 16)) | (((sb & 0xffffu) + (sb >> 16)) << 16);
      }
    } else
#endif
    {
      wdx_for_each_key(keys, n, [&](int j, unsigned u) {
        // no digit past the range or off the prefix
        const bool on = j < n && (above >= 32 || ((u ^ prefix) >> above) == 0u);
        if (on) wdx_hist_add(h, (u >> shift) & (WDX_SELECT_BINS - 1), 1u);
      });
    }
    __syncthreads();
    // every warp scans the bins (a lane takes 2 * lane_words neighbours) to
    // the one that holds the rank among the keys on the prefix
    const int want = rank - res.less;
    int mine = 0;
    for (int q = 0; q < lane_words; ++q) {
      const unsigned word = h[lane * lane_words + q + ((lane * lane_words + q) >> 5)];
      mine += (int)(word & 0xffffu) + (int)(word >> 16);
    }
    int incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    const int excl = incl - mine;
    const unsigned holds = __ballot_sync(0xffffffffu, excl <= want && want < incl);
    const int owner = __ffs(holds) - 1;
    int bin = 0, before = 0, mult = 0, acc = excl;
    for (int q = 0; q < 2 * lane_words; ++q) {  // only the owner's result is read
      const int w = lane * lane_words + q / 2;
      const int c = (int)((h[w + (w >> 5)] >> (16 * (q % 2))) & 0xffffu);
      if (acc <= want && want < acc + c) {
        bin = 2 * lane * lane_words + q;
        before = acc;
        mult = c;
      }
      acc += c;
    }
    bin = __shfl_sync(0xffffffffu, bin, owner);
    res.less += __shfl_sync(0xffffffffu, before, owner);
    res.mult = __shfl_sync(0xffffffffu, mult, owner);
    const unsigned field = (unsigned)(WDX_SELECT_BINS - 1) << shift;
    res.key = (res.key & ~field) | ((unsigned)bin << shift);
  }
  return res;
}

// Median (numpy semantics) of the n >= 1 staged keys, given their smallest
// and largest. All threads of the block call; every thread gets it.
__device__ float wdx_median_staged(const unsigned* keys, int n, unsigned lo, unsigned hi,
                                   WdxSelectShared& sh) {
  const WdxRank r = wdx_radix_select(keys, n, (n - 1) / 2, lo, hi, sh);
  const float lo_f = wdx_staged_key_to_float(r.key);
  if (n % 2 == 1) return lo_f;
  float hi_f = lo_f;
  if (r.less + r.mult <= n / 2) {  // the upper middle is the next larger key
    unsigned nxt = 0xffffffffu, unused = 0u;
    wdx_for_each_key(keys, n, [&](int j, unsigned u) {
      if (j < n && u > r.key && u < nxt) nxt = u;
    });
    wdx_block_min_max(nxt, unused, sh);  // rounds (and their barriers) lie behind the last call
    hi_f = wdx_staged_key_to_float(nxt);
  }
  return 0.5f * (lo_f + hi_f);
}

enum { WDX_STAGE_VALUE, WDX_STAGE_DEV, WDX_STAGE_DEV_ADC };

// Reads the range once from device memory and stages its keys: of the
// samples, of |x - center|, or of the calibrated deviations from the int16
// preimage; lo and hi get this thread's smallest and largest key.
template <int MODE>
__device__ void wdx_stage_range(const WdxRangeKeys& k, float center, bool vec, unsigned* keys,
                                unsigned& lo, unsigned& hi) {
  const int n = k.end - k.start;
  lo = 0xffffffffu;
  hi = 0u;
  if (MODE == WDX_STAGE_DEV_ADC) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float v = fabsf(__fmaf_rn((float)k.ar[k.start + j] + k.off, k.scale, -center));
      const unsigned u = wdx_staged_key(v);
      keys[j] = u;
      lo = min(lo, u);
      hi = max(hi, u);
    }
  } else if (vec) {  // the row is whole, aligned float4s
    const float4* row4 = reinterpret_cast<const float4*>(k.xr);
    for (int q = (k.start >> 2) + threadIdx.x; q < (k.end + 3) >> 2; q += blockDim.x) {
      const float4 f = row4[q];
      const float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * q + e - k.start;
        if (j >= 0 && j < n) {
          const unsigned u = wdx_staged_key(MODE == WDX_STAGE_DEV ? fabsf(v[e] - center) : v[e]);
          keys[j] = u;
          lo = min(lo, u);
          hi = max(hi, u);
        }
      }
    }
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float v = k.xr[k.start + j];
      const unsigned u = wdx_staged_key(MODE == WDX_STAGE_DEV ? fabsf(v - center) : v);
      keys[j] = u;
      lo = min(lo, u);
      hi = max(hi, u);
    }
  }
}

extern __shared__ __align__(16) unsigned wdx_select_keys[];

// K4 with the range's keys staged in dynamic shared memory (4 bytes a
// sample of the row, in whole 16-byte vectors).
__global__ void __launch_bounds__(WDX_SELECT_THREADS, WDX_SELECT_MIN_BLOCKS)
    wdx_range_median_mad_staged_kernel(const float* __restrict__ x,
                                       const int* __restrict__ starts,
                                       const int* __restrict__ ends,
                                       const float* __restrict__ given_meds, int given_mask,
                                       int with_mad, const int16_t* __restrict__ adc,
                                       const float* __restrict__ offset,
                                       const float* __restrict__ scale,
                                       float* __restrict__ meds, float* __restrict__ mads,
                                       int B, int L) {
  __shared__ WdxSelectShared sh;
  unsigned* keys = wdx_select_keys;
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
  const int n = k.end - k.start;
  const bool vec = L % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool given = (given_mask >> r) & 1;
  // every branch below is the same for the whole block
  bool staged = false;
  unsigned lo, hi;
  float med;
  if (given) {
    med = given_meds[o];
  } else if (n <= 0) {
    med = NAN;
  } else {
    wdx_select_clear(sh);
    wdx_stage_range<WDX_STAGE_VALUE>(k, 0.f, vec, keys, lo, hi);
    wdx_block_min_max(lo, hi, sh);
    med = wdx_median_staged(keys, n, lo, hi, sh);
    staged = true;
  }
  if (threadIdx.x == 0) meds[o] = med;
  if (!with_mad) return;
  if (n <= 0) {
    if (threadIdx.x == 0) mads[o] = NAN;
    return;
  }
  __syncthreads();  // the median's histograms and slots are read no more
  wdx_select_clear(sh);
  if (k.ar) {
    wdx_stage_range<WDX_STAGE_DEV_ADC>(k, med, vec, keys, lo, hi);
  } else if (staged) {  // in place, from the samples' keys
    lo = 0xffffffffu;
    hi = 0u;
    wdx_for_each_key(keys, n, [&](int j, unsigned u) {
      if (j < n) {
        u = wdx_staged_key(fabsf(wdx_staged_key_to_float(u) - med));
        keys[j] = u;
        lo = min(lo, u);
        hi = max(hi, u);
      }
    });
  } else {
    wdx_stage_range<WDX_STAGE_DEV>(k, med, vec, keys, lo, hi);
  }
  wdx_block_min_max(lo, hi, sh);
  const float mad = wdx_median_staged(keys, n, lo, hi, sh);
  if (threadIdx.x == 0) mads[o] = mad;
}

// K4 for rows too long for shared memory: the streaming bisection.
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
                                 int shared_bytes, cudaStream_t stream) {
  if (R == 0 || B == 0) return 0;
  if (R > 31) return (int)cudaErrorInvalidValue;  // given_mask has one bit per range
  dim3 grid(B, R);
  if (shared_bytes > 0) {  // the staged variant; shared_bytes must hold a row's keys
    if ((long long)shared_bytes < 16LL * ((L + 3) / 4) || L > 65535)
      return (int)cudaErrorInvalidValue;
    const int err = wdx_allow_shared(wdx_range_median_mad_staged_kernel, shared_bytes);
    if (err) return err;
    wdx_range_median_mad_staged_kernel<<<grid, WDX_SELECT_THREADS, shared_bytes, stream>>>(
        x, starts, ends, given_meds, given_mask, with_mad, adc, offset, scale, meds, mads, B, L);
  } else {
    wdx_range_median_mad_kernel<<<grid, 256, 0, stream>>>(x, starts, ends, given_meds,
                                                          given_mask, with_mad, adc, offset,
                                                          scale, meds, mads, B, L);
  }
  return (int)cudaGetLastError();
}

// An empty kernel: what a launch of a grid costs before any work.
__global__ void wdx_empty_kernel() {}

WDX_API int wdx_empty_launch(int blocks, int threads, cudaStream_t stream) {
  wdx_empty_kernel<<<blocks, threads, 0, stream>>>();
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
