// K16: XLA:CPU's float32 exp of a float32 scale times x, elementwise over a
// contiguous tensor (ops/numerics.py `xla_exp`, whose plain version
// `xla_exp_plain` is the same function in torch operations): the product
// rounded once (__fmul_rn, as torch and a jitted JAX function multiply a
// Python float by a float32 array), then `wdx_xla_exp` of common.cuh,
// Cephes with its multiply-adds as __fmaf_rn and subnormal results flushed
// to zero (`wdx_xla_exp_scaled1`, common.cuh). The SVM's kernel matrix
// exp(-gamma * D**pwr_dist) is one launch a classified batch where
// pwr_dist != 1 (ops/svm.py `pdist_kernel`); at pwr_dist = 1, every shipped
// bundle's, K1 stores exp(-gamma * D) itself with the same function
// (ops/dtw.py `dtw_kernel_matrix`).
//
// Replaces no Pallas kernel: the JAX package leaves the exp to XLA
// (warpdemux_tpu/ops/svm.py:184-189, jnp.exp(-gamma * Dp)); in torch
// operations it took ~100 launches a call.
//
// Bound: memory (4 bytes read and 4 written an element against ~35
// operations). Each thread takes WDX_XLAEXP_ITEMS vectors of four floats a
// block-width apart, one 16-byte load and store each, where both pointers
// are 16-byte aligned (the vectors' last partial one in single floats);
// else WDX_XLAEXP_ITEMS single floats.
#include "common.cuh"

constexpr int WDX_XLAEXP_THREADS = 256;
constexpr int WDX_XLAEXP_ITEMS = 4;

template <bool VEC>
__global__ void __launch_bounds__(WDX_XLAEXP_THREADS)
    wdx_xla_exp_scaled_kernel(const float* __restrict__ in, float* __restrict__ out, long long n, float scale) {
  const long long base = (long long)blockIdx.x * (WDX_XLAEXP_THREADS * WDX_XLAEXP_ITEMS) + threadIdx.x;
  if constexpr (VEC) {
    const long long n4 = n >> 2;
    const float4* in4 = reinterpret_cast<const float4*>(in);
    float4* out4 = reinterpret_cast<float4*>(out);
    float4 v[WDX_XLAEXP_ITEMS];
#pragma unroll
    for (int i = 0; i < WDX_XLAEXP_ITEMS; ++i) {
      const long long j = base + (long long)i * WDX_XLAEXP_THREADS;
      v[i] = j < n4 ? in4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < WDX_XLAEXP_ITEMS; ++i) {
      const long long j = base + (long long)i * WDX_XLAEXP_THREADS;
      if (j < n4)
        out4[j] = make_float4(wdx_xla_exp_scaled1(v[i].x, scale), wdx_xla_exp_scaled1(v[i].y, scale),
                              wdx_xla_exp_scaled1(v[i].z, scale), wdx_xla_exp_scaled1(v[i].w, scale));
    }
    const long long tail = (n4 << 2) + threadIdx.x;
    if (blockIdx.x == 0 && tail < n) out[tail] = wdx_xla_exp_scaled1(in[tail], scale);
  } else {
    float v[WDX_XLAEXP_ITEMS];
#pragma unroll
    for (int i = 0; i < WDX_XLAEXP_ITEMS; ++i) {
      const long long j = base + (long long)i * WDX_XLAEXP_THREADS;
      v[i] = j < n ? in[j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < WDX_XLAEXP_ITEMS; ++i) {
      const long long j = base + (long long)i * WDX_XLAEXP_THREADS;
      if (j < n) out[j] = wdx_xla_exp_scaled1(v[i], scale);
    }
  }
}

WDX_API int wdx_xla_exp_scaled(const float* in, float* out, long long n, float scale, cudaStream_t stream) {
  if (n == 0) return 0;
  if (n < 0) return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long per_block = (long long)WDX_XLAEXP_THREADS * WDX_XLAEXP_ITEMS;
  const long long items = vec ? n >> 2 : n;
  const long long blocks = items > 0 ? (items + per_block - 1) / per_block : 1;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (vec)
    wdx_xla_exp_scaled_kernel<true><<<(unsigned)blocks, WDX_XLAEXP_THREADS, 0, stream>>>(in, out, n, scale);
  else
    wdx_xla_exp_scaled_kernel<false><<<(unsigned)blocks, WDX_XLAEXP_THREADS, 0, stream>>>(in, out, n, scale);
  return (int)cudaGetLastError();
}
