// K15: the softmax over the last dim of a (B, k) float32 tensor with the bits
// of XLA:CPU's jitted jax.nn.softmax (ops/numerics.py `xla_softmax`, whose
// plain version `xla_softmax_plain` is the same function in torch
// operations): the row max, e = XLA's exp (wdx_xla_exp) of z - max, their
// sum in `xla_sum`'s order, then e / sum as an IEEE division with a
// subnormal quotient flushed to zero, as XLA:CPU runs flush-to-zero. A row
// holding NaN gives NaN; +inf gives NaN (inf - inf); -inf gives 0 where
// another value is finite, NaN where the whole row is -inf.
//
// Replaces no Pallas kernel: the JAX package leaves the softmax of the
// DTW-MLP and Fpt-Boost families to XLA (warpdemux_tpu/models/dtw_mlp.py:42,
// warpdemux_tpu/models/fpt_boost.py:101, jax.nn.softmax). torch.softmax
// rounds otherwise (an ulp off in some cells); `xla_softmax_plain` in torch
// operations took ~100 launches a call; here it is one.
//
// Four kernels behind the one entry point, chosen by the wrapper (a test
// may force any at a width it takes):
//
// The lanes kernel (k <= 32: every family's 5-13 classes; the default
// there). A warp a row, lane c class c. Every lane reads the row's k floats
// (one transaction a float for the warp) and takes the max itself, in
// registers (max.NaN.f32, no shuffles); lane c takes e_c; every lane
// gathers the k e's with shuffles that wait on nothing but e, issued back to
// back, and sums them 0 + e0 + ... + e(k-1) in registers; lane c divides.
// Instances unrolled to exactly 5, 7, 9, 11 and 13 classes, and to 8, 16
// and 32 with the slots past k left out by a select. Its chain is one
// load, k maxes, one exp, k adds and one division. (A thread a row, the
// block's rows staged in shared memory by 16-byte loads, took 1.5-1.8x
// this kernel's time at 1,000 rows on the H100 and was dropped.)
//
// The warp kernel (k <= 1,024; the default past 32 classes). One warp a row,
// one lane a class. The max is a butterfly of shuffles (a max is exact in
// any order). The sum takes XLA's order term by term, which a tree
// reduction does not give: the row zero-padded to windows of 32 (half the
// padding in front; no padding up to 32 classes), each window summed in
// order from 0, the window sums summed so in turn; every lane gathers a
// window's 32 terms by shuffles and adds them in that order, so every lane
// holds the sum without a broadcast. Past 32 classes each lane writes its e
// to the output as it goes and divides what it wrote once the sum is known.
//
// The block kernels (any k; past 1,024 classes). A block a row. The max by
// warp butterflies and the warps' maxima; each e staged where the sum
// reads it: in shared memory at its padded position of `xla_sum`'s windows,
// 33 words a window (so that 32 threads, a window each, read 32 banks) with
// the pads zeroed, where a row fits; else in the output row itself. Then
// every level of the tree: a thread a window sums its 32 in order from 0
// into the next level's buffer (shared memory, or a global workspace of the
// row), a barrier a level, until 32 or fewer are left, which every thread
// sums in order; then each thread divides its classes.
//
// Bound: latency at the families' shapes (a launch, a row's dependent chain
// of loads, exp, adds and a division); the bytes are 8 a class.
#include "common.cuh"

#ifndef WDX_SOFTMAX_WARPS  // rows a block of the warp and lanes kernels
#define WDX_SOFTMAX_WARPS 4
#endif
constexpr int WDX_SOFTMAX_BLOCK_THREADS = 512;
#define WDX_SOFTMAX_FULL_MASK 0xffffffffu

// The quotient as XLA:CPU gives it: IEEE, flushed to zero where subnormal.
__device__ __forceinline__ float wdx_softmax_quotient(float e, float sum) {
  const float q = __fdiv_rn(e, sum);
  return q < __int_as_float(0x00800000) ? 0.f : q;
}

// The lanes kernel: a warp a row, k <= KM <= 32 (FIXED: k == KM).
template <int KM, bool FIXED>
__global__ void __launch_bounds__(WDX_SOFTMAX_WARPS * 32)
    wdx_xla_softmax_lanes_kernel(const float* __restrict__ z, float* __restrict__ out, int B, int k_arg) {
  const int k = FIXED ? KM : k_arg;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WDX_SOFTMAX_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const float* const row = z + b * k;
  const float ninf = __int_as_float(0xFF800000);
  float x[KM];
#pragma unroll
  for (int c = 0; c < KM; ++c) x[c] = c < k ? __ldg(row + c) : ninf;
  const float mine = lane < k ? __ldg(row + lane) : ninf;
  float m = x[0];
#pragma unroll
  for (int c = 1; c < KM; ++c) m = wdx_nan_max(m, x[c]);
  const float e = wdx_xla_exp(__fsub_rn(mine, m));
  float t[KM];
#pragma unroll
  for (int c = 0; c < KM; ++c) t[c] = __shfl_sync(WDX_SOFTMAX_FULL_MASK, e, c);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < KM; ++c) sum = __fadd_rn(sum, c < k ? t[c] : 0.f);
  if (lane < k) out[b * k + lane] = wdx_softmax_quotient(e, sum);
}

// The block kernels: a row a block. GLOBAL: e in the output row, the levels'
// sums in `ws` (ws_stride floats a row); else both in dynamic shared memory
// (windows x 33 floats of padded terms, then the levels).
template <bool GLOBAL>
__global__ void __launch_bounds__(WDX_SOFTMAX_BLOCK_THREADS)
    wdx_xla_softmax_block_kernel(const float* __restrict__ z, float* __restrict__ out, float* ws,
                                 int k, long long ws_stride) {
  extern __shared__ float wdx_softmax_block_smem[];
  __shared__ float warp_max[32];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const float* const row = z + b * k;
  float* const orow = out + b * k;
  const int windows = (k + 31) / 32;
  const int front = windows == 1 ? 0 : (windows * 32 - k) / 2;
  float* const terms = wdx_softmax_block_smem;  // [windows][33], !GLOBAL
  float* const levels = GLOBAL ? ws + b * ws_stride : terms + (long long)windows * 33;
  float m = __int_as_float(0xFF800000);
  for (int c = tid; c < k; c += nt) m = wdx_nan_max(m, row[c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = wdx_nan_max(m, __shfl_xor_sync(WDX_SOFTMAX_FULL_MASK, m, o));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < (nt >> 5); ++w) m = wdx_nan_max(m, warp_max[w]);
  auto at = [&](int c) -> float& {  // where class c's e is staged
    if (GLOBAL) return orow[c];
    const int pos = c + front;
    return terms[(pos >> 5) * 33 + (pos & 31)];
  };
  for (int c = tid; c < k; c += nt) at(c) = wdx_xla_exp(__fsub_rn(row[c], m));
  if (!GLOBAL)
    for (int pos = tid; pos < windows * 32; pos += nt)
      if (pos < front || pos >= front + k) terms[(pos >> 5) * 33 + (pos & 31)] = 0.f;
  __syncthreads();
  // level 1: the padded terms' windows; then the window sums' own windows
  int d = k;
  const float* src = nullptr;  // the level being summed (nullptr: the terms)
  float* dst = levels;
  while (d > 32) {
    const int w_n = (d + 31) / 32, fr = (w_n * 32 - d) / 2;
    for (int w = tid; w < w_n; w += nt) {
      float acc = 0.f;
      if (src == nullptr && !GLOBAL) {
#pragma unroll 8
        for (int i = 0; i < 32; ++i) acc = __fadd_rn(acc, terms[w * 33 + i]);  // pads add +0
      } else {
        for (int i = 0; i < 32; ++i) {
          const int c = w * 32 + i - fr;
          if (c >= 0 && c < d) acc = __fadd_rn(acc, src == nullptr ? orow[c] : src[c]);
        }
      }
      dst[w] = acc;
    }
    __syncthreads();
    src = dst;
    dst += w_n;
    d = w_n;
  }
  float sum = 0.f;
  for (int i = 0; i < d; ++i) sum = __fadd_rn(sum, src == nullptr ? at(i) : src[i]);
  __syncthreads();  // every sum read, before the output row is overwritten
  for (int c = tid; c < k; c += nt) orow[c] = wdx_softmax_quotient(at(c), sum);
}

__global__ void __launch_bounds__(WDX_SOFTMAX_WARPS * 32)
    wdx_xla_softmax_kernel(const float* __restrict__ z, float* __restrict__ out, int B, int k) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WDX_SOFTMAX_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const float* row = z + (long long)b * k;
  float* orow = out + (long long)b * k;
  float m = __int_as_float(0xFF800000);  // -inf
  for (int c = lane; c < k; c += 32) m = wdx_nan_max(m, row[c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = wdx_nan_max(m, __shfl_xor_sync(WDX_SOFTMAX_FULL_MASK, m, o));
  const int windows = (k + 31) / 32;
  const int front = windows == 1 ? 0 : (windows * 32 - k) / 2;  // xla_sum pads rows above one window
  const int terms = windows == 1 ? k : 32;
  float e = 0.f;
  float sum = 0.f;
  for (int w = 0; w < windows; ++w) {
    const int c = w * 32 + lane - front;
    const bool mine = c >= 0 && c < k;
    e = mine ? wdx_xla_exp(__fsub_rn(row[c], m)) : 0.f;
    if (windows > 1 && mine) orow[c] = e;
    float t[32];  // the window's terms, gathered by shuffles that wait on nothing but e
#pragma unroll
    for (int j = 0; j < 32; ++j) t[j] = __shfl_sync(WDX_SOFTMAX_FULL_MASK, e, j);
    float window_sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) window_sum = __fadd_rn(window_sum, j < terms ? t[j] : 0.f);
    sum = windows == 1 ? window_sum : __fadd_rn(sum, window_sum);
  }
  const float tiny = __int_as_float(0x00800000);
  if (windows == 1) {
    if (lane < k) {
      const float q = __fdiv_rn(e, sum);
      orow[lane] = q < tiny ? 0.f : q;
    }
    return;
  }
  for (int c = lane - front; c < k; c += 32) {
    if (c < 0) continue;
    const float q = __fdiv_rn(orow[c], sum);  // the lane's own e, written above
    orow[c] = q < tiny ? 0.f : q;
  }
}

// variant 0: the lanes kernel (k <= 32); 1: the warp kernel (k <= 1,024);
// 2: the block kernel in shared memory; 3: the block kernel with the
// levels' sums in `ws`, ws_stride floats a row.
WDX_API int wdx_xla_softmax(const float* z, float* out, float* ws, int B, int k, int variant,
                            long long ws_stride, cudaStream_t stream) {
  if (B == 0) return 0;
  if (B < 0 || k < 1) return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    if (k > 32) return (int)cudaErrorInvalidValue;
    const int blocks = (B + WDX_SOFTMAX_WARPS - 1) / WDX_SOFTMAX_WARPS;
#define WDX_SOFTMAX_LANES(KM, FIXED) \
  wdx_xla_softmax_lanes_kernel<KM, FIXED><<<blocks, WDX_SOFTMAX_WARPS * 32, 0, stream>>>(z, out, B, k)
    switch (k) {  // the families' class counts, and any k <= 8, 16 or 32
      case 5: WDX_SOFTMAX_LANES(5, true); break;
      case 7: WDX_SOFTMAX_LANES(7, true); break;
      case 9: WDX_SOFTMAX_LANES(9, true); break;
      case 11: WDX_SOFTMAX_LANES(11, true); break;
      case 13: WDX_SOFTMAX_LANES(13, true); break;
      default:
        if (k <= 8)
          WDX_SOFTMAX_LANES(8, false);
        else if (k <= 16)
          WDX_SOFTMAX_LANES(16, false);
        else
          WDX_SOFTMAX_LANES(32, false);
    }
#undef WDX_SOFTMAX_LANES
    return (int)cudaGetLastError();
  }
  if (variant == 1) {
    if (k > 32 * 32) return (int)cudaErrorInvalidValue;
    const int blocks = (B + WDX_SOFTMAX_WARPS - 1) / WDX_SOFTMAX_WARPS;
    wdx_xla_softmax_kernel<<<blocks, WDX_SOFTMAX_WARPS * 32, 0, stream>>>(z, out, B, k);
    return (int)cudaGetLastError();
  }
  long long level_floats = 0;
  for (int d = k; d > 32; d = (d + 31) / 32) level_floats += (d + 31) / 32;
  if (variant == 2) {
    const size_t bytes = ((size_t)(k + 31) / 32 * 33 + level_floats) * sizeof(float);
    if (bytes + 32 * sizeof(float) > WDX_MAX_SHARED_BYTES) return (int)cudaErrorInvalidValue;
    if (bytes > 48 * 1024) {
      const int err = wdx_allow_shared(wdx_xla_softmax_block_kernel<false>, (int)bytes);
      if (err) return err;
    }
    wdx_xla_softmax_block_kernel<false><<<B, WDX_SOFTMAX_BLOCK_THREADS, bytes, stream>>>(z, out, nullptr, k, 0);
    return (int)cudaGetLastError();
  }
  if (variant != 3 || ws_stride < level_floats || (level_floats > 0 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  wdx_xla_softmax_block_kernel<true><<<B, WDX_SOFTMAX_BLOCK_THREADS, 0, stream>>>(z, out, ws, k, ws_stride);
  return (int)cudaGetLastError();
}
