// XLA:CPU's float32 natural log, and K14, the LLR changepoint split that
// takes it.
//
// `wdx_xla_log`, elementwise over a contiguous tensor (ops/numerics.py
// `xla_log`, whose plain version `xla_log_plain` is the same function in
// torch operations): the range reduction to a mantissa m in
// [sqrt(1/2) - 1, sqrt(2) - 1) and an exponent e, the degree-8 Cephes
// polynomial as three FMA chains in m**3, and e * ln(2) added in two parts,
// each of the eleven multiply-adds one __fmaf_rn (one rounding; the library
// is built with -fmad=false, so the compiler fuses nothing else). Zero and
// subnormal inputs give -inf (XLA reads a subnormal as zero), +inf gives
// +inf, negative numbers and NaN give NaN.
//
// Bound: memory (4 bytes read and 4 written an element against ~30
// operations). Each thread takes WDX_XLALOG_ITEMS elements a block-width
// apart, so a warp's loads and stores are coalesced and several loads are
// in flight a thread. No step launches it since K14 took the whole cost;
// it stays the log that is held on every float32 bit pattern.
//
// K14, `wdx_llr_split` (detect/boundaries.py `llr_split`, plain version
// `llr_split_plain`): for each of R windows of W samples, the split t in
// 1..W-1 minimizing n1 * log(var1) + n2 * log(var2), from the windows'
// prefix sums. Replaces no Pallas kernel: the JAX package leaves the cost
// and its argmin to XLA (warpdemux_tpu/detect/boundaries.py:201
// `_llr_refine`, :229 `_llr_split_window`); in torch operations the cost
// took ~100 launches a call. One block a window, the threads striding over
// the splits (a warp's prefix-sum loads coalesced); each cost in the plain
// version's order, every division __fdiv_rn, every multiply-add one
// __fmaf_rn, the log `wdx_xla_logf`; the first index of the minimum by a
// min over (cost, t) packed in 64 bits, across the warp by shuffles, then
// across the block. Bound: memory (the two prefix sums read once, ~90
// operations a split).
#include "common.cuh"

constexpr int WDX_XLALOG_THREADS = 256;
constexpr int WDX_XLALOG_ITEMS = 4;

__device__ __forceinline__ float wdx_xla_logf(float x) {
  const float tiny = __int_as_float(0x00800000);
  const int bits = __float_as_int(x > tiny ? x : tiny);  // NaN and x <= tiny: tiny, fixed below
  float e = (float)((bits >> 23) - 126);
  float m = __int_as_float((bits & 0x807FFFFF) | 0x3F000000);  // [0.5, 1)
  if (m < __int_as_float(0x3F3504F3)) {  // sqrt(1/2)
    e = __fsub_rn(e, 1.f);
    m = __fadd_rn(__fsub_rn(m, 1.f), m);
  } else {
    m = __fsub_rn(m, 1.f);
  }
  const float x2 = __fmul_rn(m, m);
  const float x3 = __fmul_rn(m, x2);
  const float A = __fmaf_rn(__fmaf_rn(m, __int_as_float(0x3D9021BB), __int_as_float(0xBDEBD1B8)), m,
                            __int_as_float(0x3DEF251A));
  const float B = __fmaf_rn(__fmaf_rn(m, __int_as_float(0xBDFE5D4F), __int_as_float(0x3E11E9BF)), m,
                            __int_as_float(0xBE2AAE50));
  const float C = __fmaf_rn(__fmaf_rn(m, __int_as_float(0x3E4CCEAC), __int_as_float(0xBE7FFFFC)), m,
                            __int_as_float(0x3EAAAAAA));
  const float y = __fmaf_rn(__fmaf_rn(A, x3, B), x3, C);
  const float t = __fmaf_rn(y, x3, __fmul_rn(e, __int_as_float(0xB95E8083)));  // e * -2.12194440e-4
  float r = __fmaf_rn(e, 0.693359375f, __fadd_rn(__fmaf_rn(x2, -0.5f, m), t));
  if (x == __int_as_float(0x7F800000)) r = x;
  if (x < 0.f || isnan(x)) r = __int_as_float(0x7FC00000);
  if (fabsf(x) < tiny) r = __int_as_float(0xFF800000);
  return r;
}

__global__ void __launch_bounds__(WDX_XLALOG_THREADS)
    wdx_xla_log_kernel(const float* __restrict__ in, float* __restrict__ out, long long n) {
  const long long base = (long long)blockIdx.x * (WDX_XLALOG_THREADS * WDX_XLALOG_ITEMS) + threadIdx.x;
  float v[WDX_XLALOG_ITEMS];
#pragma unroll
  for (int i = 0; i < WDX_XLALOG_ITEMS; ++i) {
    const long long j = base + (long long)i * WDX_XLALOG_THREADS;
    v[i] = j < n ? in[j] : 1.f;
  }
#pragma unroll
  for (int i = 0; i < WDX_XLALOG_ITEMS; ++i) {
    const long long j = base + (long long)i * WDX_XLALOG_THREADS;
    if (j < n) out[j] = wdx_xla_logf(v[i]);
  }
}

WDX_API int wdx_xla_log(const float* in, float* out, long long n, cudaStream_t stream) {
  if (n == 0) return 0;
  if (n < 0) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)WDX_XLALOG_THREADS * WDX_XLALOG_ITEMS;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  wdx_xla_log_kernel<<<(unsigned)blocks, WDX_XLALOG_THREADS, 0, stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

constexpr int WDX_LLR_THREADS = 256;

// The variance clamp of the cost: torch.clamp_min(v, 1e-6) keeps NaN,
// where fmaxf would give 1e-6.
__device__ __forceinline__ float wdx_llr_clamp(float v) { return v < 1e-6f ? 1e-6f : v; }

// (cost, t) as one key whose unsigned order is jnp.argmin's: any NaN
// before every number, then by value with -0.0 equal to 0.0, then by t.
__device__ __forceinline__ unsigned long long wdx_argmin_key(float cost, int t) {
  const unsigned k = isnan(cost) ? 0u : (unsigned)wdx_order_key(cost == 0.f ? 0.f : cost) ^ 0x80000000u;
  return ((unsigned long long)k << 32) | (unsigned)t;
}

// weff null: the second segment of every window runs to W and every split
// counts. Else it runs to the window's own end weff[r] (clamped to [1, W]),
// and only the splits in [min_split, weff[r]) count (the others cost inf).
__global__ void __launch_bounds__(WDX_LLR_THREADS)
    wdx_llr_split_kernel(const float* __restrict__ c1, const float* __restrict__ c2,
                         const int* __restrict__ weff, int* __restrict__ split, int W, int min_split) {
  const long long row = (long long)blockIdx.x * (W + 1);
  const float* a = c1 + row;
  const float* b = c2 + row;
  const int end = weff ? min(max(weff[blockIdx.x], 1), W) : W;
  const int lo = weff ? max(min_split, 1) : 1;
  const float cT1 = a[end], cT2 = b[end];
  unsigned long long best = ~0ull;
  for (int t = threadIdx.x + 1; t < W; t += WDX_LLR_THREADS) {
    float cost = __int_as_float(0x7F800000);
    if (t >= lo && t < end) {
      const float n1 = (float)t, n2 = (float)(end - t);
      const float s1 = a[t], s2 = b[t];
      const float q1 = __fdiv_rn(s1, n1);
      const float v1 = wdx_llr_clamp(__fmaf_rn(-q1, q1, __fdiv_rn(s2, n1)));
      const float sT1 = __fsub_rn(cT1, s1), sT2 = __fsub_rn(cT2, s2);
      const float q2 = __fdiv_rn(sT1, n2);
      const float v2 = wdx_llr_clamp(__fmaf_rn(-q2, q2, __fdiv_rn(sT2, n2)));
      cost = __fmaf_rn(n1, wdx_xla_logf(v1), __fmul_rn(n2, wdx_xla_logf(v2)));
    }
    const unsigned long long key = wdx_argmin_key(cost, t);
    best = key < best ? key : best;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, o);
    best = other < best ? other : best;
  }
  __shared__ unsigned long long partial[WDX_LLR_THREADS / 32];
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < WDX_LLR_THREADS / 32; ++w) best = partial[w] < best ? partial[w] : best;
    split[blockIdx.x] = (int)(unsigned)best;
  }
}

WDX_API int wdx_llr_split(const float* c1, const float* c2, const int* weff, int* split, int R, int W,
                          int min_split, cudaStream_t stream) {
  if (R == 0) return 0;
  if (R < 0 || W < 2 || W == INT_MAX) return (int)cudaErrorInvalidValue;
  wdx_llr_split_kernel<<<(unsigned)R, WDX_LLR_THREADS, 0, stream>>>(c1, c2, weff, split, W, min_split);
  return (int)cudaGetLastError();
}
