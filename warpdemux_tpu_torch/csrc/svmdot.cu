// K12: the SVM's one-vs-one decision values, out = K . C + bias for K of
// (B, N) kernel rows against the support vectors and C the (N, P) pair
// coefficients, each output summed in the order of XLA:CPU's jitted
// float32 dot where that order is known (ops/numerics.py `dot_order` /
// `xla_dot`, the plain version), so that the probabilities, and the calls
// made by comparing them with per-barcode thresholds, are the JAX
// package's bit for bit; in the lanes order at every other shape:
//   mode 0 (lanes): four fma chains over the k of each residue mod 4,
//     combined (l0 + l1) + (l2 + l3), plus the last N mod 4 terms as rounded
//     products added one by one to 0;
//   mode 1 (chain): one fma chain from 0 over each block of kc terms, the
//     block sums added in order to 0.
// The bias is added last, as the JAX package's `jnp.dot(...) + intercept`.
//
// Replaces no Pallas kernel: the JAX package leaves the product to XLA
// (warpdemux_tpu/ops/svm.py decision_values, a jnp.dot). It was added
// because torch.matmul sums in another order, so the port's probabilities
// differed from JAX's in the last bits.
//
// One thread an output element; a warp's threads take neighbouring
// elements of a row, so the row's K value of each k is one broadcast load
// and the P coefficients of that k one coalesced load. The four lane chains
// are independent, so the lanes mode keeps four fmas in flight a thread.
//
// Bound: memory at the step's shapes (B = 1000, N = 851, P = 10: 3.45 MB
// read and written once against 17 MFLOP).
#include "common.cuh"

#ifndef WDX_SVMDOT_THREADS
#define WDX_SVMDOT_THREADS 64
#endif

__global__ void __launch_bounds__(WDX_SVMDOT_THREADS)
    wdx_svm_dot_kernel(const float* __restrict__ K, const float* __restrict__ C,
                       const float* __restrict__ bias, float* __restrict__ out, int B, int N,
                       int P, int mode, int kc) {
  const long long e = (long long)blockIdx.x * WDX_SVMDOT_THREADS + threadIdx.x;
  if (e >= (long long)B * P) return;
  const int b = (int)(e / P);
  const int p = (int)(e - (long long)b * P);
  const float* __restrict__ Kr = K + (long long)b * N;
  const float* __restrict__ Cp = C + p;
  float s;
  if (mode == 0) {
    const int m = N & ~3;
    float l0 = 0.f, l1 = 0.f, l2 = 0.f, l3 = 0.f;
#pragma unroll 2
    for (int k = 0; k < m; k += 4) {
      const float* c = Cp + (long long)k * P;
      l0 = __fmaf_rn(Kr[k], c[0], l0);
      l1 = __fmaf_rn(Kr[k + 1], c[P], l1);
      l2 = __fmaf_rn(Kr[k + 2], c[2 * P], l2);
      l3 = __fmaf_rn(Kr[k + 3], c[3 * P], l3);
    }
    float tail = 0.f;
    for (int k = m; k < N; ++k) tail = __fadd_rn(tail, __fmul_rn(Kr[k], Cp[(long long)k * P]));
    s = __fadd_rn(__fadd_rn(__fadd_rn(l0, l1), __fadd_rn(l2, l3)), tail);
  } else {
    s = 0.f;
    for (int lo = 0; lo < N; lo += kc) {
      const int hi = min(N, lo + kc);
      float acc = 0.f;
#pragma unroll 4
      for (int k = lo; k < hi; ++k) acc = __fmaf_rn(Kr[k], Cp[(long long)k * P], acc);
      s = __fadd_rn(s, acc);
    }
  }
  out[e] = __fadd_rn(s, bias[p]);
}

WDX_API int wdx_svm_dot(const float* K, const float* C, const float* bias, float* out, int B,
                        int N, int P, int mode, int kc, cudaStream_t stream) {
  const long long n = (long long)B * P;
  if (n == 0) return 0;
  if (B < 0 || N < 0 || P < 0 || kc <= 0 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + WDX_SVMDOT_THREADS - 1) / WDX_SVMDOT_THREADS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  wdx_svm_dot_kernel<<<(unsigned)blocks, WDX_SVMDOT_THREADS, 0, stream>>>(K, C, bias, out, B, N,
                                                                          P, mode, kc);
  return (int)cudaGetLastError();
}
