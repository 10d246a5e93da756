// K6 + K7 + K9: forward rolling-window statistics of the boundary detector.
//
// K6 replaces warpdemux_tpu/ops/rolling_pallas.py rolling_mean_var_pallas:
// mean and variance over [t, min(t + w, L)) for w_mean (mean and var) and
// w_var (var), variance clamped at 0. Like the TPU kernel it differences
// prefix sums of x and x*x. One block owns one row. The prefix sums use the
// association of ops/numerics.blocked_cumsum (XLA:CPU's blocked scan):
// sequential float32 sums inside blocks of 16 samples, the block totals
// scanned the same way one level up, each block's exclusive offset added
// on the way down. var = fma(-mean, mean, s2 / n) with one rounding, as
// XLA:CPU contracts it. The result is bit-identical to the plain version
// (up to its float64 emulation of the fused multiply-add).
//
// Bound: memory, 4 bytes read and 12 written per sample. So the row is
// read once and nothing but the outputs goes back to device memory:
//   - both prefix-sum arrays, every level of them, live in the block's
//     dynamic shared memory (2 x 11,292 floats = 90 KB at L = 10000; two
//     blocks fit an SM). Level 0 is stored at the padded index i + i/16, so
//     that threads 16 samples apart fall in different banks;
//   - level 0: a thread loads its block of 16 samples as four float4 (its
//     neighbours take the neighbouring 64 bytes) and carries the running
//     sums of x and of x*x side by side in registers;
//   - the levels above (625, 40 and 3 totals at L = 10000) are the work of
//     one warp between two block barriers;
//   - the last step down is folded into the output pass, which reads
//     c[t] = local[t] + offset[t/16 - 1] (the same single add) for its three
//     window edges from shared memory and writes the outputs coalesced.
// A row too long for shared memory (L above 25,731) runs the same code
// over a scratch row in device memory (unpadded); the wrapper picks by L.
//
// K7 replaces rolling_pallas.py rolling_run_sum_pallas: the int32 count of
// a 0/1 mask over [t, min(t + w, L)), as c[min(t + w, L)] - c[t] with c the
// row's exclusive prefix count. Integer sums are exact in any association.
//
// Bound: memory, 1 byte read and 4 written per sample. One block owns one
// row and reads each mask byte once: a thread takes 16 bytes (one 16-byte
// load where the row starts are aligned, byte loads else), turns them into
// 0/1 bytes and counts them with popc; a block-wide exclusive scan of the
// chunk counts (warp shuffles, then the warp totals) gives the chunk's
// offset; the L + 1 counts go into shared memory as uint16 (20 KB at
// L = 10000, so eight blocks share an SM and the loads of one overlap the
// stores of another), written as 16-byte stores; after one barrier the output pass writes the differences as
// int4 stores. A row of more than 65,535 samples (a count would not fit
// uint16) runs the direct kernel (one thread counts one window); the
// wrapper picks by L.
//
// K9 replaces rolling_pallas.py rolling_detect_pallas: K6's statistics
// and both poly(A) candidate run sums in one launch. One block owns one
// row: it runs K6's device code (so mean_f, var_f and var_w equal K6's bit
// for bit), builds the candidate mask
//   base = mean_f > thr & var_w < var_max & t < len & t + w_run <= len
// in the output pass into a byte row (shared memory after the prefix sums,
// or device scratch for a long row), and counts base and
// base & (region > 0) over [t, min(t + w_run, L)) by K7's prefix count:
// once the output pass is done the float prefix sums are dead, so the
// L + 1 counts take their place in shared memory, and since a row there
// has fewer than 65,536 samples both counts ride in one int32 (plain in the
// low half, inside the region in the high half) through one scan. The
// device-scratch variant counts each window directly. The TPU kernel's
// doubling scan is not carried over: the prefix sums keep XLA:CPU's
// blocked association, so the fused and unfused detect decide identically.
// K9 moves K6's bytes plus 4 bytes of region in and 8 bytes of run sums
// out per sample, and saves the two masks and K7's launches.
#include "common.cuh"

#define WDX_SCAN_BLOCK 16
#define WDX_SCAN_MAX_LEVELS 8
#ifndef WDX_ROLLING_THREADS
#define WDX_ROLLING_THREADS 512
#endif
#ifndef WDX_RUNSUM_THREADS
#define WDX_RUNSUM_THREADS 256
#endif
#define WDX_COUNT_CHUNK 16  // mask bytes a thread counts in one round

// Where the levels of a row's blocked scan of L values lie in its buffer.
// Level 0 takes [0, L) (padded: index i + i/16); level k >= 1 starts at
// offs[k].
struct WdxScanLayout {
  int n_levels;
  int sizes[WDX_SCAN_MAX_LEVELS];
  int offs[WDX_SCAN_MAX_LEVELS];
  int total;  // floats of the whole buffer
};

template <bool PAD>
__host__ __device__ inline WdxScanLayout wdx_scan_layout(int L) {
  WdxScanLayout s;
  int lev = 0;
  s.sizes[0] = L;
  s.offs[0] = 0;
  int end = PAD ? L + (L - 1) / WDX_SCAN_BLOCK : L;
  while (s.sizes[lev] > WDX_SCAN_BLOCK && lev + 1 < WDX_SCAN_MAX_LEVELS) {
    s.sizes[lev + 1] = (s.sizes[lev] + WDX_SCAN_BLOCK - 1) / WDX_SCAN_BLOCK;
    s.offs[lev + 1] = end;
    end += s.sizes[lev + 1];
    ++lev;
  }
  s.n_levels = lev + 1;
  s.total = end;
  return s;
}

template <bool PAD>
__device__ __forceinline__ int wdx_scan_index(const WdxScanLayout& s, int lev, int i) {
  if (lev == 0) return PAD ? i + i / WDX_SCAN_BLOCK : i;
  return s.offs[lev] + i;
}

// Blocked prefix sums of row xr and of its squares into c1 and c2: level 0
// holds the running sums inside each block of 16 (its offsets are added by
// wdx_prefix), the levels above are complete. Returns the index of level 1,
// or -1 when there is none. All threads of the block call.
template <bool PAD>
__device__ int wdx_row_prefix_sums(const float* __restrict__ xr, float* c1, float* c2, int L) {
  const WdxScanLayout s = wdx_scan_layout<PAD>(L);
  const int n_blocks = (L + WDX_SCAN_BLOCK - 1) / WDX_SCAN_BLOCK;
  const bool vec = L % 4 == 0 && (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
  for (int blk = threadIdx.x; blk < n_blocks; blk += blockDim.x) {
    const int lo = blk * WDX_SCAN_BLOCK;
    const int n = min(WDX_SCAN_BLOCK, L - lo);
    float v[WDX_SCAN_BLOCK];
    if (vec) {  // n is a multiple of 4
#pragma unroll
      for (int q = 0; q < WDX_SCAN_BLOCK / 4; ++q) {
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
        if (4 * q < n) f = reinterpret_cast<const float4*>(xr + lo)[q];
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < WDX_SCAN_BLOCK; ++k) v[k] = k < n ? xr[lo + k] : 0.f;
    }
    const int o = wdx_scan_index<PAD>(s, 0, lo);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < WDX_SCAN_BLOCK; ++k) {
      if (k < n) {
        const float x = v[k];
        const float xx = x * x;
        s1 = k == 0 ? x : s1 + x;
        s2 = k == 0 ? xx : s2 + xx;
        c1[o + k] = s1;
        c2[o + k] = s2;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // the levels above 0: one warp, both arrays
    const int lane = threadIdx.x;
    for (int lev = 1; lev < s.n_levels; ++lev) {  // up: in-block running sums
      const int n = s.sizes[lev];
      const int nb = (n + WDX_SCAN_BLOCK - 1) / WDX_SCAN_BLOCK;
      for (int task = lane; task < 2 * nb; task += 32) {
        float* c = task < nb ? c1 : c2;
        const int lo = (task < nb ? task : task - nb) * WDX_SCAN_BLOCK;
        const int hi = min(lo + WDX_SCAN_BLOCK, n);
        float acc = 0.f;
        for (int i = lo; i < hi; ++i) {  // the total of block i one level down
          const int last = min(i * WDX_SCAN_BLOCK + WDX_SCAN_BLOCK - 1, s.sizes[lev - 1] - 1);
          const float v = c[wdx_scan_index<PAD>(s, lev - 1, last)];
          acc = i == lo ? v : acc + v;
          c[s.offs[lev] + i] = acc;
        }
      }
      __syncwarp();
    }
    for (int lev = s.n_levels - 2; lev >= 1; --lev) {  // down: block offsets
      const int n = s.sizes[lev];
      for (int task = lane; task < 2 * n; task += 32) {
        float* c = task < n ? c1 : c2;
        const int i = task < n ? task : task - n;
        const int blk = i / WDX_SCAN_BLOCK;
        if (blk > 0) c[s.offs[lev] + i] = c[s.offs[lev] + i] + c[s.offs[lev + 1] + blk - 1];
      }
      __syncwarp();
    }
  }
  __syncthreads();
  return s.n_levels > 1 ? s.offs[1] : -1;
}

// Sum of the first t samples: the last step down of the blocked scan.
template <bool PAD>
__device__ __forceinline__ float wdx_prefix(const float* c, int level1, int t) {
  if (t == 0) return 0.f;
  const int i = t - 1;
  const int blk = i / WDX_SCAN_BLOCK;
  float v = c[PAD ? i + blk : i];
  if (level1 >= 0 && blk > 0) v = v + c[level1 + blk - 1];
  return v;
}

__device__ __forceinline__ void wdx_mean_var(float s1, float s2, float n, float& mean, float& var) {
  mean = s1 / n;
  const float v = __fmaf_rn(-mean, mean, s2 / n);
  var = v < 0.f ? 0.f : v;  // jnp.maximum(v, 0): NaN stays NaN
}

// The poly(A) candidate inputs of K9's row (unused by K6).
struct WdxDetectRow {
  const float* region;  // the row's CNN region prior
  uint8_t* base;        // out: bit 0 the candidate mask, bit 1 inside the region
  float thr;
  int len;
  int w_run;
  float var_max;
};

// K6's work on row blockIdx.x over the prefix buffers c1 and c2; with
// DETECT also K9's candidate bytes. All threads of the block call.
template <bool PAD, bool DETECT>
__device__ void wdx_row_mean_var(const float* __restrict__ x, float* c1, float* c2,
                                 float* __restrict__ mean_f, float* __restrict__ var_f,
                                 float* __restrict__ var_w, int L, int w_mean, int w_var,
                                 const WdxDetectRow& det) {
  const long long row = (long long)blockIdx.x * L;
  const int level1 = wdx_row_prefix_sums<PAD>(x + row, c1, c2, L);
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    const float lo1 = wdx_prefix<PAD>(c1, level1, t);
    const float lo2 = wdx_prefix<PAD>(c2, level1, t);
    const int hi_m = min(t + w_mean, L);
    const int hi_v = min(t + w_var, L);
    float m, v, mw, vw;
    wdx_mean_var(wdx_prefix<PAD>(c1, level1, hi_m) - lo1, wdx_prefix<PAD>(c2, level1, hi_m) - lo2,
                 (float)(hi_m - t), m, v);
    wdx_mean_var(wdx_prefix<PAD>(c1, level1, hi_v) - lo1, wdx_prefix<PAD>(c2, level1, hi_v) - lo2,
                 (float)(hi_v - t), mw, vw);
    mean_f[row + t] = m;
    var_f[row + t] = v;
    var_w[row + t] = vw;
    if (DETECT) {
      const bool cand = m > det.thr && vw < det.var_max && t < det.len && t + det.w_run <= det.len;
      det.base[t] = (uint8_t)((cand ? 1 : 0) | (cand && det.region[t] > 0.f ? 2 : 0));
    }
  }
}

// c[0 .. limit) = base + the exclusive prefix counts of the chunk's 0/1
// bytes n (four words of four), two counts a word: neither half carries,
// since no count exceeds 65,535. limit is WDX_COUNT_CHUNK for a whole chunk
// (vector stores; c is 16-byte aligned there) and less at the row's end.
__device__ __forceinline__ void wdx_store_counts(uint16_t* c, int base, const unsigned n[4],
                                                 int limit) {
  unsigned w[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int total;
    const unsigned e = wdx_byte_prefix(n[q], total);
    const unsigned both = (unsigned)base * 0x00010001u;
    w[2 * q] = __byte_perm(e, 0, 0x4140) + both;      // bytes 0 and 1 as halves
    w[2 * q + 1] = __byte_perm(e, 0, 0x4342) + both;  // bytes 2 and 3
    base += total;
  }
  if (limit >= WDX_COUNT_CHUNK) {
    reinterpret_cast<uint4*>(c)[0] = make_uint4(w[0], w[1], w[2], w[3]);
    reinterpret_cast<uint4*>(c)[1] = make_uint4(w[4], w[5], w[6], w[7]);
  } else {
#pragma unroll
    for (int j = 0; j < WDX_COUNT_CHUNK; ++j)
      if (j < limit) c[j] = (uint16_t)(w[j / 2] >> (16 * (j % 2)));
  }
}

// K9's run sums over row bytes in shared memory (bit 0 the candidate, bit
// 1 the candidate inside the region; `words` holds them four a word, its
// buffer padded to a multiple of WDX_COUNT_CHUNK bytes): the packed prefix
// counts cnt[0 .. L] (plain | inside << 16), then both differences over
// [t, min(t + w, L)). L < 65,536; w <= L. All threads of the block call.
__device__ void wdx_detect_run_sums(int* cnt, const unsigned* words, int* __restrict__ rs_plain,
                                    int* __restrict__ rs_masked, int L, int w) {
  __shared__ int warp_sums[64];
  const int n_chunks = (L + WDX_COUNT_CHUNK - 1) / WDX_COUNT_CHUNK;
  int carry = 0;
  for (int round = 0; round * (int)blockDim.x < n_chunks; ++round) {
    const int chunk = round * blockDim.x + threadIdx.x;
    const int off = chunk * WDX_COUNT_CHUNK;
    unsigned plain[4], inside[4];
    int v = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int valid = L - off - 4 * q;  // bytes of this word inside the row
      unsigned word = valid > 0 ? words[chunk * 4 + q] : 0u;
      if (valid > 0 && valid < 4) word &= (1u << (8 * valid)) - 1u;
      plain[q] = word & 0x01010101u;
      inside[q] = (word >> 1) & 0x01010101u;
      v += __popc(plain[q]) + (__popc(inside[q]) << 16);
    }
    int base = wdx_block_exclusive_scan(v, warp_sums, round, carry);
    if (off < L) {
      const int limit = min(WDX_COUNT_CHUNK, L - off + 1);  // the row's last chunk writes cnt[L]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int tp, ti;
        const unsigned ep = wdx_byte_prefix(plain[q], tp);
        const unsigned ei = wdx_byte_prefix(inside[q], ti);
        const int4 c4 = make_int4(base + (int)((ep & 0xff) | ((ei & 0xff) << 16)),
                                  base + (int)(((ep >> 8) & 0xff) | (((ei >> 8) & 0xff) << 16)),
                                  base + (int)(((ep >> 16) & 0xff) | (((ei >> 16) & 0xff) << 16)),
                                  base + (int)((ep >> 24) | ((ei >> 24) << 16)));
        int* c = cnt + off + 4 * q;
        if (limit >= WDX_COUNT_CHUNK) {
          *reinterpret_cast<int4*>(c) = c4;
        } else {
          if (4 * q < limit) c[0] = c4.x;
          if (4 * q + 1 < limit) c[1] = c4.y;
          if (4 * q + 2 < limit) c[2] = c4.z;
          if (4 * q + 3 < limit) c[3] = c4.w;
        }
        base += tp + (ti << 16);
      }
    }
  }
  if (L % WDX_COUNT_CHUNK == 0 && threadIdx.x == 0) cnt[L] = carry;
  __syncthreads();
  // no half of a difference borrows: both counts grow with t
  const bool vec = L % 4 == 0 && ((reinterpret_cast<uintptr_t>(rs_plain) |
                                   reinterpret_cast<uintptr_t>(rs_masked)) & 15) == 0;
  if (vec) {
    for (int t = 4 * threadIdx.x; t < L; t += 4 * blockDim.x) {
      const int4 lo = *reinterpret_cast<const int4*>(cnt + t);
      const int d0 = cnt[min(t + w, L)] - lo.x;
      const int d1 = cnt[min(t + 1 + w, L)] - lo.y;
      const int d2 = cnt[min(t + 2 + w, L)] - lo.z;
      const int d3 = cnt[min(t + 3 + w, L)] - lo.w;
      *reinterpret_cast<int4*>(rs_plain + t) =
          make_int4(d0 & 0xffff, d1 & 0xffff, d2 & 0xffff, d3 & 0xffff);
      *reinterpret_cast<int4*>(rs_masked + t) = make_int4(d0 >> 16, d1 >> 16, d2 >> 16, d3 >> 16);
    }
  } else {
    for (int t = threadIdx.x; t < L; t += blockDim.x) {
      const int d = cnt[min(t + w, L)] - cnt[t];
      rs_plain[t] = d & 0xffff;
      rs_masked[t] = d >> 16;
    }
  }
}

extern __shared__ __align__(16) float wdx_rolling_smem[];

// SHARED: the prefix buffers (row_len floats each) are the block's dynamic
// shared memory; else rows of the scratch tensors c1_all and c2_all.
template <bool SHARED>
__global__ void __launch_bounds__(WDX_ROLLING_THREADS)
    wdx_rolling_mean_var_kernel(const float* __restrict__ x, float* c1_all, float* c2_all,
                                int row_len, float* __restrict__ mean_f,
                                float* __restrict__ var_f, float* __restrict__ var_w, int L,
                                int w_mean, int w_var) {
  float* c1 = SHARED ? wdx_rolling_smem : c1_all + (long long)blockIdx.x * row_len;
  float* c2 = SHARED ? wdx_rolling_smem + row_len : c2_all + (long long)blockIdx.x * row_len;
  wdx_row_mean_var<SHARED, false>(x, c1, c2, mean_f, var_f, var_w, L, w_mean, w_var,
                                  WdxDetectRow());
}

template <bool SHARED>
__global__ void __launch_bounds__(WDX_ROLLING_THREADS)
    wdx_rolling_detect_kernel(const float* __restrict__ x, const float* __restrict__ region,
                              const float* __restrict__ thr, const int* __restrict__ lens,
                              float* c1_all, float* c2_all, int row_len, uint8_t* base_all,
                              float* __restrict__ mean_f, float* __restrict__ var_f,
                              float* __restrict__ var_w, int* __restrict__ rs_plain,
                              int* __restrict__ rs_masked, int L, int w_mean, int w_var,
                              int w_run, float var_max) {
  const int b = blockIdx.x;
  const long long row = (long long)b * L;
  float* c1 = SHARED ? wdx_rolling_smem : c1_all + (long long)b * row_len;
  float* c2 = SHARED ? wdx_rolling_smem + row_len : c2_all + (long long)b * row_len;
  WdxDetectRow det;
  det.region = region + row;
  det.base = SHARED ? reinterpret_cast<uint8_t*>(wdx_rolling_smem + 2 * row_len) : base_all + row;
  det.thr = thr[b];
  det.len = lens[b];
  det.w_run = w_run;
  det.var_max = var_max;
  wdx_row_mean_var<SHARED, true>(x, c1, c2, mean_f, var_f, var_w, L, w_mean, w_var, det);
  __syncthreads();
  if (SHARED) {
    // the prefix sums are dead: both prefix counts of the candidate bytes,
    // packed into one int32, take their place
    wdx_detect_run_sums(reinterpret_cast<int*>(wdx_rolling_smem),
                        reinterpret_cast<const unsigned*>(det.base), rs_plain + row,
                        rs_masked + row, L, max(min(w_run, L), 0));
    return;
  }
  const uint8_t* base = det.base;
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

// K7, a row's prefix count in shared memory. VEC: every row start is
// 16-byte aligned (L % 16 == 0 and an aligned mask). w <= L <= 65,535.
template <bool VEC>
__global__ void __launch_bounds__(WDX_RUNSUM_THREADS)
    wdx_run_sum_prefix_kernel(const uint8_t* __restrict__ mask, int* __restrict__ out, int L,
                              int w) {
  __shared__ int warp_sums[64];
  uint16_t* c = reinterpret_cast<uint16_t*>(wdx_rolling_smem);
  const uint8_t* m = mask + (long long)blockIdx.x * L;
  const int n_chunks = (L + WDX_COUNT_CHUNK - 1) / WDX_COUNT_CHUNK;
  int carry = 0;
  for (int round = 0; round * (int)blockDim.x < n_chunks; ++round) {
    const int off = (round * blockDim.x + threadIdx.x) * WDX_COUNT_CHUNK;
    unsigned n[4] = {0u, 0u, 0u, 0u};  // the chunk as 0/1 bytes (non-zero -> 1)
    if (off < L) {
      if (VEC) {
        const uint4 v = *reinterpret_cast<const uint4*>(m + off);
        n[0] = __vsetne4(v.x, 0u);
        n[1] = __vsetne4(v.y, 0u);
        n[2] = __vsetne4(v.z, 0u);
        n[3] = __vsetne4(v.w, 0u);
      } else {
#pragma unroll
        for (int j = 0; j < WDX_COUNT_CHUNK; ++j)
          if (off + j < L && m[off + j]) n[j / 4] |= 1u << (8 * (j % 4));
      }
    }
    const int count = __popc(n[0]) + __popc(n[1]) + __popc(n[2]) + __popc(n[3]);
    const int base = wdx_block_exclusive_scan(count, warp_sums, round, carry);
    // the row's last chunk writes c[L] too, unless it ends at L
    if (off < L) wdx_store_counts(c + off, base, n, min(WDX_COUNT_CHUNK, L - off + 1));
  }
  if (L % WDX_COUNT_CHUNK == 0 && threadIdx.x == 0) c[L] = (uint16_t)carry;
  __syncthreads();
  int* o = out + (long long)blockIdx.x * L;
  if (L % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    for (int t = 4 * threadIdx.x; t < L; t += 4 * blockDim.x) {
      *reinterpret_cast<int4*>(o + t) = make_int4(
          (int)c[min(t + w, L)] - (int)c[t], (int)c[min(t + 1 + w, L)] - (int)c[t + 1],
          (int)c[min(t + 2 + w, L)] - (int)c[t + 2], (int)c[min(t + 3 + w, L)] - (int)c[t + 3]);
    }
  } else {
    for (int t = threadIdx.x; t < L; t += blockDim.x) o[t] = (int)c[min(t + w, L)] - (int)c[t];
  }
}

// K7 for a row too long for uint16 counts: one thread counts one window.
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

// shared_bytes > 0 selects the shared-memory variant (the scratch pointers
// are then unused); it and row_len must cover what the layout needs.
static int wdx_check_rolling(int L, int row_len, int shared_bytes, int extra_bytes) {
  const int need = shared_bytes > 0 ? wdx_scan_layout<true>(L).total : wdx_scan_layout<false>(L).total;
  if (row_len < need) return (int)cudaErrorInvalidValue;
  if (shared_bytes > 0 && (long long)shared_bytes < 2LL * row_len * (long long)sizeof(float) + extra_bytes)
    return (int)cudaErrorInvalidValue;
  return 0;
}

WDX_API int wdx_rolling_mean_var(const float* x, float* c1_scratch, float* c2_scratch,
                                 int row_len, int shared_bytes, float* mean_f, float* var_f,
                                 float* var_w, int B, int L, int w_mean, int w_var,
                                 cudaStream_t stream) {
  if (B == 0 || L == 0) return 0;
  int err = wdx_check_rolling(L, row_len, shared_bytes, 0);
  if (err) return err;
  if (shared_bytes > 0) {
    err = wdx_allow_shared(wdx_rolling_mean_var_kernel<true>, shared_bytes);
    if (err) return err;
    wdx_rolling_mean_var_kernel<true><<<B, WDX_ROLLING_THREADS, shared_bytes, stream>>>(
        x, nullptr, nullptr, row_len, mean_f, var_f, var_w, L, w_mean, w_var);
  } else {
    wdx_rolling_mean_var_kernel<false><<<B, WDX_ROLLING_THREADS, 0, stream>>>(
        x, c1_scratch, c2_scratch, row_len, mean_f, var_f, var_w, L, w_mean, w_var);
  }
  return (int)cudaGetLastError();
}

template <bool VEC>
static int wdx_launch_run_sum_prefix(const uint8_t* mask, int* out, int B, int L, int w,
                                     int shared_bytes, cudaStream_t stream) {
  const int err = wdx_allow_shared(wdx_run_sum_prefix_kernel<VEC>, shared_bytes);
  if (err) return err;
  wdx_run_sum_prefix_kernel<VEC>
      <<<B, WDX_RUNSUM_THREADS, shared_bytes, stream>>>(mask, out, L, w);
  return (int)cudaGetLastError();
}

// shared_bytes > 0 selects the prefix-count variant (L <= 65535); it must
// hold L + 1 uint16 counts. shared_bytes == 0 selects the direct kernel.
WDX_API int wdx_run_sum(const uint8_t* mask, int* out, int B, int L, int w, int shared_bytes,
                        cudaStream_t stream) {
  const long long total = (long long)B * L;
  if (total == 0) return 0;
  w = w < 0 ? 0 : (w > L ? L : w);  // the same counts, and t + w cannot overflow
  if (shared_bytes > 0) {
    if (L > 65535 || (long long)shared_bytes < ((long long)L + 1) * (long long)sizeof(uint16_t))
      return (int)cudaErrorInvalidValue;
    const bool vec = L % WDX_COUNT_CHUNK == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
    return vec ? wdx_launch_run_sum_prefix<true>(mask, out, B, L, w, shared_bytes, stream)
               : wdx_launch_run_sum_prefix<false>(mask, out, B, L, w, shared_bytes, stream);
  }
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  wdx_run_sum_kernel<<<(unsigned)blocks, threads, 0, stream>>>(mask, out, B, L, w);
  return (int)cudaGetLastError();
}

WDX_API int wdx_rolling_detect(const float* x, const float* region, const float* thr,
                               const int* lens, float* c1_scratch, float* c2_scratch,
                               int row_len, int shared_bytes, uint8_t* base_scratch,
                               float* mean_f, float* var_f, float* var_w, int* rs_plain,
                               int* rs_masked, int B, int L, int w_mean, int w_var, int w_run,
                               float var_max, cudaStream_t stream) {
  if (B == 0 || L == 0) return 0;
  // the candidate bytes, padded to whole chunks of the run-sum count
  int err = wdx_check_rolling(L, row_len, shared_bytes,
                              (L + WDX_COUNT_CHUNK - 1) / WDX_COUNT_CHUNK * WDX_COUNT_CHUNK);
  if (err) return err;
  if (shared_bytes > 0) {
    err = wdx_allow_shared(wdx_rolling_detect_kernel<true>, shared_bytes);
    if (err) return err;
    wdx_rolling_detect_kernel<true><<<B, WDX_ROLLING_THREADS, shared_bytes, stream>>>(
        x, region, thr, lens, nullptr, nullptr, row_len, nullptr, mean_f, var_f, var_w, rs_plain,
        rs_masked, L, w_mean, w_var, w_run, var_max);
  } else {
    wdx_rolling_detect_kernel<false><<<B, WDX_ROLLING_THREADS, 0, stream>>>(
        x, region, thr, lens, c1_scratch, c2_scratch, row_len, base_scratch, mean_f, var_f,
        var_w, rs_plain, rs_masked, L, w_mean, w_var, w_run, var_max);
  }
  return (int)cudaGetLastError();
}
