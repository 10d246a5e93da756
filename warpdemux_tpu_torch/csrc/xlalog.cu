// K14: XLA:CPU's float32 natural log, elementwise over a contiguous tensor
// (ops/numerics.py `xla_log`, whose plain version `xla_log_plain` is the same
// function in torch operations): the range reduction to a mantissa m in
// [sqrt(1/2) - 1, sqrt(2) - 1) and an exponent e, the degree-8 Cephes
// polynomial as three FMA chains in m**3, and e * ln(2) added in two parts,
// each of the eleven multiply-adds one __fmaf_rn (one rounding; the library
// is built with -fmad=false, so the compiler fuses nothing else). Zero and
// subnormal inputs give -inf (XLA reads a subnormal as zero), +inf gives
// +inf, negative numbers and NaN give NaN.
//
// Replaces no Pallas kernel: the JAX package leaves the log of the LLR
// changepoint cost to XLA (warpdemux_tpu/detect/boundaries.py:224 and :259,
// jnp.log). In torch operations it took ~50 launches a call; here it is one.
//
// Bound: memory (4 bytes read and 4 written an element against ~30
// operations). Each thread takes WDX_XLALOG_ITEMS elements a block-width
// apart, so a warp's loads and stores are coalesced and several loads are
// in flight a thread.
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
