// K13: the SVM's class probabilities from its one-vs-one decision values
// (ops/svm.py `probabilities`, whose plain version is the same function in
// torch operations): libsvm's Platt sigmoid with the 1e-7 clamp, the
// pairwise matrix, and the Wu-Lin coupling (libsvm multiclass_probability,
// Gauss-Seidel with eps = 0.005 / k and max(100, k) passes), each row to
// its own convergence, in the float32 operations of the jitted JAX
// function: fApB = fma(dec, A, B); XLA:CPU's exp (Cephes, FMAs, flush to
// zero); Q's diagonal summed in order from 0; Q p as an fma chain over j
// from 0; p Q p as rounded products added in order, except on the rows
// from `scalar_from` on (XLA:CPU's scalar loop after its vectors of rows,
// ops/svm.py xla_vector_rows), where it is an fma chain; the update's
// multiply-adds as fmas.
//
// Replaces no Pallas kernel: the JAX package runs the coupling as a
// lax.while_loop (warpdemux_tpu/ops/svm.py multiclass_probability). In
// torch operations it took ~2,800 launches a step and a host read a pass;
// here it is one launch.
//
// One thread a row; the k x k matrix Q, p and Q p live in the thread's
// local memory (k <= WDX_SVM_MAX_CLASSES). A row's passes are a serial
// chain, so the kernel is bound by its dependency chains (latency), not
// by its bytes (B x P decision values in, B x k probabilities out).
#include "common.cuh"

#ifndef WDX_SVMPROB_THREADS
#define WDX_SVMPROB_THREADS 64
#endif
#define WDX_SVM_MAX_CLASSES 16

// XLA:CPU's float32 exp (ops/numerics.py xla_exp); the constants are the
// float32 bits of the plain version's.
__device__ __forceinline__ float wdx_xla_exp(float x) {
  if (isnan(x)) return x;
  const float xc = fminf(fmaxf(x, __int_as_float(0xC2AF999A)), __int_as_float(0x42B1999A));
  const float t = floorf(__fmaf_rn(xc, __int_as_float(0x3FB8AA3B), 0.5f));
  const float n = fminf(fmaxf(t, -126.f), 127.f);
  float r = __fmaf_rn(n, -0.693359375f, xc);
  r = __fmaf_rn(n, __int_as_float(0x395E8083), r);
  float z = __fmaf_rn(r, __int_as_float(0x39506967), __int_as_float(0x3AB743CE));
  z = __fmaf_rn(z, r, __int_as_float(0x3C088908));
  z = __fmaf_rn(z, r, __int_as_float(0x3D2AA9C1));
  z = __fmaf_rn(z, r, __int_as_float(0x3E2AAAAA));
  z = __fmaf_rn(z, r, 0.5f);
  z = __fadd_rn(1.f, __fmaf_rn(z, __fmul_rn(r, r), r));
  const float y = __fmul_rn(z, __int_as_float(((int)n + 127) << 23));
  return y < 1.17549435e-38f ? 0.f : y;
}

// max of |v| over a row as torch.amax: NaN if any is NaN
__device__ __forceinline__ float wdx_nan_max(float m, float v) {
  return (isnan(m) || isnan(v)) ? __int_as_float(0x7FC00000) : (v > m ? v : m);
}

__global__ void __launch_bounds__(WDX_SVMPROB_THREADS)
    wdx_svm_probs_kernel(const float* __restrict__ dec, const float* __restrict__ probA,
                         const float* __restrict__ probB, float* __restrict__ out, int B, int k,
                         float lo, float hi, float eps, int max_iter, int scalar_from) {
  const int b = blockIdx.x * WDX_SVMPROB_THREADS + threadIdx.x;
  if (b >= B) return;
  const int P = k * (k - 1) / 2;
  float Q[WDX_SVM_MAX_CLASSES][WDX_SVM_MAX_CLASSES];
  float p[WDX_SVM_MAX_CLASSES], Qp[WDX_SVM_MAX_CLASSES];
  // r[i][j] (kept in Q until Q is formed): rp of pair (i, j), 1 - rp below
  for (int i = 0; i < k; ++i) Q[i][i] = 0.f;
  int pair = 0;
  for (int i = 0; i < k; ++i) {
    for (int j = i + 1; j < k; ++j, ++pair) {
      const float fApB = __fmaf_rn(dec[(long long)b * P + pair], probA[pair], probB[pair]);
      const float efa = wdx_xla_exp(-fabsf(fApB));
      const float one_efa = __fadd_rn(1.f, efa);
      float rp = fApB >= 0.f ? __fdiv_rn(efa, one_efa) : __fdiv_rn(1.f, one_efa);
      rp = rp < lo ? lo : (rp > hi ? hi : rp);
      Q[i][j] = rp;
      Q[j][i] = __fsub_rn(1.f, rp);
    }
  }
  // Q[t][j] = -r[j][t] * r[t][j] off the diagonal; Q[t][t] = sum_j r[j][t]^2
  float diag[WDX_SVM_MAX_CLASSES];
  for (int t = 0; t < k; ++t) {
    float s = 0.f;
    for (int j = 0; j < k; ++j) s = __fadd_rn(s, j == t ? 0.f : __fmul_rn(Q[j][t], Q[j][t]));
    diag[t] = s;
  }
  for (int t = 0; t < k; ++t) {
    for (int j = t + 1; j < k; ++j) {
      const float q = __fmul_rn(-Q[j][t], Q[t][j]);
      Q[t][j] = q;
      Q[j][t] = q;
    }
    Q[t][t] = diag[t];
  }
  const float p0 = __fdiv_rn(1.f, (float)k);
  for (int t = 0; t < k; ++t) p[t] = p0;
  const bool scalar_tail = b >= scalar_from;
  for (int it = 0; it < max_iter; ++it) {
    for (int t = 0; t < k; ++t) {
      float s = 0.f;
      for (int j = 0; j < k; ++j) s = __fmaf_rn(Q[t][j], p[j], s);
      Qp[t] = s;
    }
    float pQp = 0.f;
    for (int t = 0; t < k; ++t)
      pQp = scalar_tail ? __fmaf_rn(p[t], Qp[t], pQp) : __fadd_rn(pQp, __fmul_rn(p[t], Qp[t]));
    float max_err = 0.f;
    for (int t = 0; t < k; ++t) max_err = wdx_nan_max(max_err, fabsf(__fsub_rn(Qp[t], pQp)));
    if (!(max_err >= eps)) break;
    for (int t = 0; t < k; ++t) {
      const float diff = __fdiv_rn(__fadd_rn(-Qp[t], pQp), Q[t][t]);
      p[t] = __fadd_rn(p[t], diff);
      const float inner = __fmaf_rn(diff, Q[t][t], __fmul_rn(2.f, Qp[t]));
      const float d1 = __fadd_rn(1.f, diff);
      pQp = __fdiv_rn(__fmaf_rn(diff, inner, pQp), __fmul_rn(d1, d1));
      for (int j = 0; j < k; ++j) Qp[j] = __fdiv_rn(__fmaf_rn(diff, Q[t][j], Qp[j]), d1);
      for (int j = 0; j < k; ++j) p[j] = __fdiv_rn(p[j], d1);
    }
  }
  for (int t = 0; t < k; ++t) out[(long long)b * k + t] = p[t];
}

WDX_API int wdx_svm_probs(const float* dec, const float* probA, const float* probB, float* out,
                          int B, int k, float lo, float hi, float eps, int max_iter,
                          int scalar_from, cudaStream_t stream) {
  if (B == 0) return 0;
  if (B < 0 || k < 2 || k > WDX_SVM_MAX_CLASSES || max_iter < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (B + WDX_SVMPROB_THREADS - 1) / WDX_SVMPROB_THREADS;
  wdx_svm_probs_kernel<<<blocks, WDX_SVMPROB_THREADS, 0, stream>>>(dec, probA, probB, out, B, k, lo,
                                                                   hi, eps, max_iter, scalar_from);
  return (int)cudaGetLastError();
}
