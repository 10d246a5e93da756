// K3: scipy _select_by_peak_distance as a priority fixpoint.
//
// Replaces warpdemux_tpu/ops/peaks_pallas.py suppress_by_distance_pallas.
// The rounds are those of the jnp fixpoint of ops/peaks.suppress_by_distance:
//
//   winner = alive peak with no higher-priority alive peak within distance
//            (priority = score, later position winning ties)
//   keep |= winner; alive -= winner + (alive within distance of a winner)
//
// until no peak is alive. A dead or out-of-row neighbour counts as a score
// of -inf, as in the jnp version (so a peak that scores -inf itself is
// dominated by any such neighbour to its right).
//
// Bound: bytes by the roofline (scores, flags in, flags out), in practice
// the latency of the rounds (three a row on average on a read's t-scores).
// So a row lives on chip for the whole fixpoint and the work follows the
// alive peaks, not the positions:
//   - one block owns one row; is_peak is read once (16-byte loads where the
//     rows are aligned, decided per launch) and packed into bit words, 32
//     positions a word and a word a thread (6272 positions are 196 words);
//     alive, win and keep are bit words in shared memory; keep goes out
//     once, as bytes in 16-byte stores. No device scratch;
//   - a thread walks the set bits of its alive words; a peak's alive
//     neighbours within reach are the bits of a window taken from two
//     adjacent words, and only their scores are read (through L1: a copy of
//     the row's scores in shared memory was no faster at this width);
//   - the kill phase is word arithmetic: alive &= ~(win | win << o |
//     win >> o for o < reach) with the carries from the neighbouring words;
//     the distance is one value a row, so the shifts are uniform;
//   - a round has two barriers, the first a vote: a row ends when a round
//     has no winner (no peak is alive, or the alive ones all score -inf
//     beside dead neighbours, which the jnp fixpoint never resolves).
// A warp a row with several rows a block (__syncwarp for the barriers) was
// three times slower: a row's first round is some 2000 peaks with dependent
// score loads, and 1000 warps do not hide them.
// The windows are 64 bits wide, so the reach is at most 32 (offsets to 31).
// A larger max_distance, or a row whose bit words do not fit shared memory,
// runs the kernel at the end of the file (flags as bytes in device memory,
// two passes over all positions a round); the wrapper picks by (L, W).
#include "common.cuh"

#ifndef WDX_SUPPRESS_THREADS
#define WDX_SUPPRESS_THREADS 256  // a row
#endif

// The 32 flags of positions [32 w, 32 w + 32) as a bit word.
__device__ __forceinline__ unsigned wdx_flag_word(const uint8_t* flags, int w, int L, bool vec) {
  unsigned word = 0u;
  if (vec && 32 * w + 32 <= L) {
    const uint4* f = reinterpret_cast<const uint4*>(flags + 32 * w);
    const uint4 a = f[0], b = f[1];
    const unsigned v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int q = 0; q < 8; ++q)  // four 0/1 bytes to four bits: no two products share a bit
      word |= (((__vsetne4(v[q], 0u) * 0x01020408u) >> 24) & 0xfu) << (4 * q);
  } else {
    for (int i = 0; i < 32 && 32 * w + i < L; ++i) word |= (flags[32 * w + i] ? 1u : 0u) << i;
  }
  return word;
}

__device__ __forceinline__ void wdx_store_flag_word(uint8_t* flags, int w, int L, bool vec,
                                                    unsigned word) {
  if (vec && 32 * w + 32 <= L) {
    unsigned v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)  // four bits to four 0/1 bytes
      v[q] = (((word >> (4 * q)) & 0xfu) * 0x00204081u) & 0x01010101u;
    uint4* f = reinterpret_cast<uint4*>(flags + 32 * w);
    f[0] = make_uint4(v[0], v[1], v[2], v[3]);
    f[1] = make_uint4(v[4], v[5], v[6], v[7]);
  } else {
    for (int i = 0; i < 32 && 32 * w + i < L; ++i) flags[32 * w + i] = (word >> i) & 1u;
  }
}

extern __shared__ __align__(16) unsigned wdx_suppress_words[];

// Words of a row in shared memory: the bit words alive and win with a zero
// word on both sides (the neighbours of the first and the last word), then
// keep, in whole 16-byte vectors.
__host__ __device__ inline int wdx_suppress_row_words(int L) {
  return (3 * ((L + 31) / 32) + 4 + 3) / 4 * 4;
}

__global__ void __launch_bounds__(WDX_SUPPRESS_THREADS)
    wdx_suppress_words_kernel(const float* __restrict__ scores,
                              const uint8_t* __restrict__ is_peak,
                              const int* __restrict__ distance, uint8_t* __restrict__ keep_all,
                              int L, int W) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int n_words = (L + 31) / 32;
  unsigned* alive = wdx_suppress_words + 1;
  unsigned* win = alive + n_words + 2;
  unsigned* keep = win + n_words + 1;
  const float* s = scores + (long long)b * L;
  const uint8_t* peaks = is_peak + (long long)b * L;
  uint8_t* out = keep_all + (long long)b * L;
  const bool vec = L % 16 == 0 && ((reinterpret_cast<uintptr_t>(is_peak) |
                                    reinterpret_cast<uintptr_t>(keep_all)) & 15) == 0;
  const int reach = max(min(distance[b], W), 1);           // offsets o in [1, reach), reach <= 32
  const unsigned window = (1u << (reach - 1)) - 1u;         // the reach - 1 neighbours of a side

  for (int w = t; w < n_words; w += WDX_SUPPRESS_THREADS) {
    alive[w] = wdx_flag_word(peaks, w, L, vec);
    win[w] = 0u;
    keep[w] = 0u;
  }
  if (t == 0) alive[-1] = alive[n_words] = win[-1] = win[n_words] = 0u;
  __syncthreads();

  for (;;) {
    // phase 1: winners among the alive peaks
    bool won_any = false;
    for (int w = t; w < n_words; w += WDX_SUPPRESS_THREADS) {
      const unsigned cur = alive[w];
      unsigned won = 0u;
      if (cur) {
        const unsigned long long right = cur | ((unsigned long long)alive[w + 1] << 32);
        const unsigned long long left = alive[w - 1] | ((unsigned long long)cur << 32);
        for (unsigned bits = cur; bits; bits &= bits - 1u) {
          const int i = __ffs(bits) - 1;
          const float* sp = s + 32 * w + i;
          const float mine = *sp;
          unsigned r = (unsigned)(right >> (i + 1)) & window;        // bit k: alive at p + 1 + k
          unsigned l = (unsigned)(left >> (i + 33 - reach)) & window;  // alive at p - (reach - 1) + k
          // a dead neighbour to the right scores -inf >= mine
          bool dom = mine == -INFINITY && r != window;
          for (; r && !dom; r &= r - 1u) dom = sp[__ffs(r)] >= mine;
          for (; l && !dom; l &= l - 1u) dom = sp[__ffs(l) - reach] > mine;
          if (!dom) won |= 1u << i;
        }
      }
      win[w] = won;
      won_any |= won != 0u;
    }
    if (!__syncthreads_or(won_any)) break;
    // phase 2: winners are kept; they and their neighbourhoods die
    for (int w = t; w < n_words; w += WDX_SUPPRESS_THREADS) {
      const unsigned a = alive[w];
      if (a == 0u) continue;
      const unsigned below = win[w - 1], here = win[w], over = win[w + 1];
      unsigned dead = here;
      for (int o = 1; o < reach; ++o)
        dead |= (here << o) | (below >> (32 - o)) | (here >> o) | (over << (32 - o));
      keep[w] |= here;
      alive[w] = a & ~dead;
    }
    __syncthreads();
  }
  for (int w = t; w < n_words; w += WDX_SUPPRESS_THREADS)
    wdx_store_flag_word(out, w, L, vec, keep[w]);
}

// K3 for a reach above 32 or a row too long for shared memory: the flags
// are bytes in device memory (alive and win are scratch from the wrapper),
// one block owns one row, every round passes twice over all positions.
__device__ __forceinline__ float wdx_alive_score(const float* s, const uint8_t* alive, int q,
                                                 int L) {
  return (q >= 0 && q < L && alive[q]) ? s[q] : -INFINITY;
}

__global__ void wdx_suppress_kernel(const float* __restrict__ scores,
                                    const uint8_t* __restrict__ is_peak,
                                    const int* __restrict__ distance, uint8_t* alive_all,
                                    uint8_t* win_all, uint8_t* keep_all, int L, int W) {
  const int b = blockIdx.x;
  const float* s = scores + (long long)b * L;
  uint8_t* alive = alive_all + (long long)b * L;
  uint8_t* win = win_all + (long long)b * L;
  uint8_t* keep = keep_all + (long long)b * L;
  const int reach = min(distance[b], W);  // offsets o in [1, reach)

  int any_alive = 0;
  for (int p = threadIdx.x; p < L; p += blockDim.x) {
    const uint8_t a = is_peak[(long long)b * L + p] ? 1 : 0;
    alive[p] = a;
    keep[p] = 0;
    any_alive |= a;
  }
  any_alive = __syncthreads_or(any_alive);

  while (any_alive) {
    // phase 1: winners among the alive peaks
    for (int p = threadIdx.x; p < L; p += blockDim.x) {
      uint8_t w = 0;
      if (alive[p]) {
        const float sp = s[p];
        bool dom = false;
        for (int o = 1; o < reach && !dom; ++o) {
          dom = (wdx_alive_score(s, alive, p + o, L) >= sp) ||
                (wdx_alive_score(s, alive, p - o, L) > sp);
        }
        w = dom ? 0 : 1;
      }
      win[p] = w;
    }
    __syncthreads();
    // phase 2: winners are kept; they and their neighbourhoods die
    int local = 0;
    for (int p = threadIdx.x; p < L; p += blockDim.x) {
      if (!alive[p]) continue;
      bool dead = win[p] != 0;
      if (dead) keep[p] = 1;
      for (int o = 1; o < reach && !dead; ++o) {
        dead = (p + o < L && win[p + o]) || (p - o >= 0 && win[p - o]);
      }
      if (dead)
        alive[p] = 0;
      else
        local = 1;
    }
    any_alive = __syncthreads_or(local);
  }
}

// shared_bytes > 0: the bit-word kernel, with that much shared memory for
// a row's words (W <= 32); 0: the byte-flag kernel with its two scratch
// arrays.
WDX_API int wdx_suppress(const float* scores, const uint8_t* is_peak, const int* distance,
                         uint8_t* alive_scratch, uint8_t* win_scratch, uint8_t* keep, int B,
                         int L, int W, int shared_bytes, cudaStream_t stream) {
  if (B == 0 || L == 0) return 0;
  if (shared_bytes > 0) {
    if (W > 32 || shared_bytes < 4 * wdx_suppress_row_words(L)) return (int)cudaErrorInvalidValue;
    if (shared_bytes > 48 * 1024) {  // no carve-out hint: the scores come through L1
      const cudaError_t err = cudaFuncSetAttribute(
          wdx_suppress_words_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    wdx_suppress_words_kernel<<<B, WDX_SUPPRESS_THREADS, shared_bytes, stream>>>(
        scores, is_peak, distance, keep, L, W);
  } else {
    wdx_suppress_kernel<<<B, 256, 0, stream>>>(scores, is_peak, distance, alive_scratch,
                                               win_scratch, keep, L, W);
  }
  return (int)cudaGetLastError();
}
