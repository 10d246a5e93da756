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
//     rounds instead of 4 for a read's samples, none for an all-equal range.
//     The first digit is the 8 bits from that bit down, so the first round,
//     which adds every key, fills a whole histogram whatever byte the bit
//     falls in; the last digit is what is left;
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
// rounds of a selection over keys of `bits` bits
#define WDX_SELECT_ROUNDS(bits) (((bits) + WDX_SELECT_BITS - 1) / WDX_SELECT_BITS)
// A histogram packs two bins into a word (a range in shared memory has
// fewer than 65,536 keys, so no half carries): bin b is half b % 2 of word
// b / 2 + b / 64. A lane of the scan reads BINS / 64 neighbouring words,
// and the pad after every 32 spreads the 32 lanes' reads over the banks.
#define WDX_SELECT_HIST_WORDS (WDX_SELECT_BINS / 2 + WDX_SELECT_BINS / 64)

// The selection below is generic over the staged key: K4 stages 32-bit
// keys (unsigned), K8 16-bit keys (uint16_t); a 16-byte vector of shared
// memory holds 4 or 8 of them.

// Staged float keys are unsigned: the order key with its sign bit flipped,
// so that unsigned compares and digits order them.
__device__ __forceinline__ unsigned wdx_staged_key(float v) {
  return (unsigned)wdx_order_key(v) ^ 0x80000000u;
}

__device__ __forceinline__ float wdx_staged_key_to_float(unsigned u) {
  return wdx_key_to_float((int)(u ^ 0x80000000u));
}

// A block's static shared memory for selections of at most ROUNDS rounds
// over staged keys.
template <int ROUNDS>
struct __align__(16) WdxSelectShared {  // spread is read as 16-byte vectors
  static constexpr int rounds = ROUNDS;
  unsigned hist[ROUNDS][WDX_SELECT_HIST_WORDS];  // one histogram a round
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

template <typename Shared>
__device__ __forceinline__ void wdx_select_clear(Shared& sh) {
  unsigned* h = &sh.hist[0][0];
  for (int i = threadIdx.x; i < Shared::rounds * WDX_SELECT_HIST_WORDS; i += blockDim.x)
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

// f(j, key) for the staged keys [0, end), the neighbours of one 16-byte
// load a thread and iteration (4 keys of 32 bits, 8 of 16; the buffer is
// padded to whole vectors). Every lane of a warp makes the same number of
// calls, those past the keys with j >= end.
template <typename Key, typename F>
__device__ __forceinline__ void wdx_for_each_key(const Key* keys, int end, F f) {
  constexpr int per = 16 / (int)sizeof(Key);
  for (int first = 0; first < end; first += per * blockDim.x) {
    const int j = first + per * threadIdx.x;
    uint4 k = make_uint4(0u, 0u, 0u, 0u);
    if (j < end) k = *reinterpret_cast<const uint4*>(keys + j);
    if constexpr (sizeof(Key) == 4) {
      f(j, k.x);
      f(j + 1, k.y);
      f(j + 2, k.z);
      f(j + 3, k.w);
    } else {
      f(j, k.x & 0xffffu);
      f(j + 1, k.x >> 16);
      f(j + 2, k.y & 0xffffu);
      f(j + 3, k.y >> 16);
      f(j + 4, k.z & 0xffffu);
      f(j + 5, k.z >> 16);
      f(j + 6, k.w & 0xffffu);
      f(j + 7, k.w >> 16);
    }
  }
}

// Block-wide min of lo and max of hi (one value a thread; every thread gets
// both), with one barrier: it also publishes the keys staged and the
// histograms cleared before it. Two calls need a barrier between them.
template <typename Shared>
__device__ void wdx_block_min_max(unsigned& lo, unsigned& hi, Shared& sh) {
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

// The rank-th smallest (0-based) of the fewer than 65,536 staged keys
// [begin, end) in shared memory, given their smallest and largest, by
// histograms of MSB-first digits. The histograms must be zero and visible;
// every thread gets the result. All threads of the block call.
template <typename Key, typename Shared>
__device__ WdxRank wdx_radix_select(const Key* keys, int begin, int end, int rank, unsigned lo,
                                    unsigned hi, Shared& sh) {
  WdxRank res;
  res.key = lo;  // its bits above the highest differing one are every key's
  res.less = 0;
  res.mult = end - begin;
  const unsigned diff = lo ^ hi;
  if (diff == 0u) return res;
  const int top = WDX_SELECT_PREFIX ? 31 - __clz(diff) : 8 * (int)sizeof(Key) - 1;
  const int lane = threadIdx.x & 31;
  const int lane_words = WDX_SELECT_BINS / 64;  // of a lane of the scan: two bins a word
  int shift = top + 1;  // the bits [shift, top] are found
  for (int round = 0; shift > 0; ++round) {
    unsigned* h = sh.hist[round];
    const int above = shift;
    const int width = min(WDX_SELECT_BITS, shift);
    shift -= width;
    const unsigned digits = (1u << width) - 1u;
    const unsigned prefix = res.key;
#if WDX_SELECT_SPREAD
    if (round == 0) {  // every key is on the prefix
      unsigned* mine = sh.spread + (lane & 3);
      const unsigned one = 1u << (4 * (lane & 4));
      wdx_for_each_key(keys, end, [&](int j, unsigned u) {
        if (j >= begin && j < end) atomicAdd(&mine[4 * ((u >> shift) & digits)], one);
      });
      __syncthreads();
      for (int w = threadIdx.x; w < WDX_SELECT_BINS / 2; w += blockDim.x) {  // bins 2w, 2w + 1
        const uint4 a = reinterpret_cast<const uint4*>(sh.spread)[2 * w];
        const uint4 b = reinterpret_cast<const uint4*>(sh.spread)[2 * w + 1];
        const unsigned sa = a.x + a.y + a.z + a.w;  // no half carries: fewer than 65,536 keys in all
        const unsigned sb = b.x + b.y + b.z + b.w;
        h[w + (w >> 5)] = ((sa & 0xffffu) + (sa >> 16)) | (((sb & 0xffffu) + (sb >> 16)) << 16);
      }
    } else
#endif
    {
      wdx_for_each_key(keys, end, [&](int j, unsigned u) {
        // no digit outside the range or off the prefix (round 0: every key is on it)
        const bool on = j >= begin && j < end && (round == 0 || ((u ^ prefix) >> above) == 0u);
        if (on) wdx_hist_add(h, (u >> shift) & digits, 1u);
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
    res.key = (res.key & ~(digits << shift)) | ((unsigned)bin << shift);
  }
  return res;
}

// Median (numpy semantics) of the n >= 1 staged float keys, given their
// smallest and largest. All threads of the block call; every thread gets it.
template <typename Shared>
__device__ float wdx_median_staged(const unsigned* keys, int n, unsigned lo, unsigned hi,
                                   Shared& sh) {
  const WdxRank r = wdx_radix_select(keys, 0, n, (n - 1) / 2, lo, hi, sh);
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
  __shared__ WdxSelectShared<WDX_SELECT_ROUNDS(32)> sh;
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
// selected over the row's int16 ADC preimage.
//
// Replaces warpdemux_tpu/ops/select_pallas.py range_median_pallas_adc. The
// key adc + 32768 lies in [0, 65535] and the calibration is monotone
// (scale > 0), so the rank-th smallest sample is x at a position that
// carries the rank-th smallest key: the selection runs over 2-byte keys and
// reads x at one or two positions. With such an x this is bit-identical to
// K4 with the MAD off. One block owns one (range, row) pair, as in K4.
//
// Bound: bytes by the roofline (2 bytes a sample of the range), in practice
// the passes over the range. So, as K4 and with its selection:
//   - the range's keys are read once from device memory (16-byte loads of
//     eight int16 where the rows are aligned, copied as whole vectors, so
//     the range begins up to 7 keys into the buffer) and staged in dynamic
//     shared memory as uint16, 2 L bytes, twice K4's blocks an SM; the
//     smallest and largest key are reduced on the way (two keys a word with
//     the SIMD-in-a-word min and max);
//   - at most two rounds of 8-bit digit histograms from the highest bit in
//     which smallest and largest differ (ADC samples of a read span a few
//     hundred counts: the first round's 256 bins hold them, the second
//     sees the few keys of one bin), none for an all-equal range;
//   - the last histogram gives count(key < lo) and lo's multiplicity, and
//     one pass over the staged keys without atomics finds the first
//     position of lo and, with it, the next larger key and its first
//     position; thread 0 reads x there.
// Where x is no monotone image of adc the result is x at those first
// positions (the plain version takes minima over all positions of a key);
// every caller passes the calibrated signal.
// A row whose keys do not fit (L > 65,535: the histograms' 16-bit halves)
// runs the streaming kernel below: 16 bisection rounds from L2, then one
// pass that reads x; the wrapper picks by L.
#ifndef WDX_ADC_THREADS
#define WDX_ADC_THREADS 128
#endif
#ifndef WDX_ADC_MIN_BLOCKS
#define WDX_ADC_MIN_BLOCKS 8  // blocks an SM the register allocation must allow
#endif

__global__ void __launch_bounds__(WDX_ADC_THREADS, WDX_ADC_MIN_BLOCKS)
    wdx_range_median_adc_staged_kernel(const float* __restrict__ x,
                                       const int16_t* __restrict__ adc,
                                       const int* __restrict__ starts,
                                       const int* __restrict__ ends, float* __restrict__ meds,
                                       int B, int L) {
  __shared__ WdxSelectShared<WDX_SELECT_ROUNDS(16)> sh;
  uint16_t* keys = reinterpret_cast<uint16_t*>(wdx_select_keys);
  const int b = blockIdx.x;
  const long long o = (long long)blockIdx.y * B + b;
  const int16_t* ar = adc + (long long)b * L;
  const int start = min(max(starts[o], 0), L);
  const int n = min(max(ends[o], 0), L) - start;
  if (n <= 0) {  // the same for the whole block
    if (threadIdx.x == 0) meds[o] = NAN;
    return;
  }
  wdx_select_clear(sh);
  // stage the keys: the range is [begin, begin + n) of the buffer
  unsigned lo = 0xffffu, hi = 0u;
  int begin = 0;
  if (L % 8 == 0 && (reinterpret_cast<uintptr_t>(adc) & 15) == 0) {  // whole, aligned vectors
    begin = start & 7;
    const int q0 = start >> 3;
    const uint4* row8 = reinterpret_cast<const uint4*>(ar);
    unsigned lo2 = 0xffffffffu, hi2 = 0u;  // two keys a word
    for (int q = q0 + threadIdx.x; q < (start + n + 7) >> 3; q += blockDim.x) {
      uint4 v = row8[q];
      v.x ^= 0x80008000u;  // adc + 32768 in both halves
      v.y ^= 0x80008000u;
      v.z ^= 0x80008000u;
      v.w ^= 0x80008000u;
      reinterpret_cast<uint4*>(keys)[q - q0] = v;
      const int j = 8 * (q - q0);
      if (j >= begin && j + 8 <= begin + n) {
        lo2 = __vminu2(__vminu2(lo2, v.x), __vminu2(v.y, __vminu2(v.z, v.w)));
        hi2 = __vmaxu2(__vmaxu2(hi2, v.x), __vmaxu2(v.y, __vmaxu2(v.z, v.w)));
      } else {  // the range's first or last vector
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (j + e >= begin && j + e < begin + n) {
            const unsigned u = (w[e >> 1] >> (16 * (e & 1))) & 0xffffu;
            lo = min(lo, u);
            hi = max(hi, u);
          }
        }
      }
    }
    lo = min(lo, min(lo2 & 0xffffu, lo2 >> 16));
    hi = max(hi, max(hi2 & 0xffffu, hi2 >> 16));
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const unsigned u = (unsigned)((int)ar[start + j] + 32768);
      keys[j] = (uint16_t)u;
      lo = min(lo, u);
      hi = max(hi, u);
    }
  }
  const int end = begin + n;
  wdx_block_min_max(lo, hi, sh);
  const WdxRank r = wdx_radix_select(keys, begin, end, (n - 1) / 2, lo, hi, sh);
  // the first position of the rank-th key, and the next larger key with its
  // first position (key << 16 | position: a staged row has < 65,536 keys)
  unsigned at = (unsigned)begin, above = 0xffffffffu;
  if (r.mult < n) {  // not all equal: a round's barrier lies behind the last reduction
    at = 0xffffffffu;
    wdx_for_each_key(keys, end, [&](int j, unsigned u) {
      if (j >= begin && j < end) {
        if (u == r.key) at = min(at, (unsigned)j);
        if (u > r.key) above = min(above, (u << 16) | (unsigned)j);
      }
    });
    unsigned inverse = ~above;  // a max of the complement is a min
    wdx_block_min_max(at, inverse, sh);
    above = ~inverse;
  }
  if (threadIdx.x != 0) return;
  const float* xr = x + (long long)b * L + (start - begin);  // of the buffer's position 0
  const float lo_f = xr[at];
  if (n % 2 == 1) {
    meds[o] = lo_f;
  } else {
    const float hi_f = r.less + r.mult <= n / 2 ? xr[above & 0xffffu] : lo_f;
    meds[o] = 0.5f * (lo_f + hi_f);
  }
}

// K8 for rows too long for the staged keys: the streaming bisection.
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
                                 int shared_bytes, cudaStream_t stream) {
  if (R == 0 || B == 0) return 0;
  dim3 grid(B, R);
  if (shared_bytes > 0) {  // the staged variant; shared_bytes must hold a row's keys
    if ((long long)shared_bytes < 16LL * ((L + 7) / 8) || L > 65535)
      return (int)cudaErrorInvalidValue;
    const int err = wdx_allow_shared(wdx_range_median_adc_staged_kernel, shared_bytes);
    if (err) return err;
    wdx_range_median_adc_staged_kernel<<<grid, WDX_ADC_THREADS, shared_bytes, stream>>>(
        x, adc, starts, ends, meds, B, L);
  } else {
    wdx_range_median_adc_kernel<<<grid, 256, 0, stream>>>(x, adc, starts, ends, meds, B, L);
  }
  return (int)cudaGetLastError();
}
