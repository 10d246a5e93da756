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
// One warp a row (k <= 16 classes, so a lane a class). Lane j holds row j
// of the symmetric Q (so also its column j), p[j] and (Q p)[j] in
// registers: the loops over classes are unrolled at compile time (an
// instance for each shipped class count, 5, 7, 9, 11 and 13, and one for
// any k <= 16 whose loops stop at k), so no array lives in local memory.
// Each lane computes the k - 1 sigmoids of its row itself. Q p: lane t's
// fma chain over j in order, p[j] taken by shuffle. p Q p and the largest
// error: every lane runs the same in-order chain over the lanes' terms
// (the error as a butterfly max that keeps the NaN rule). Gauss-Seidel
// step t: every lane computes its own candidate of diff and of the new
// p Q p, lane t's are broadcast, and every lane updates its (Q p)[j] and
// p[j] with its own two divisions at once. A row's passes are a serial
// chain, so the kernel is bound by its dependency chains (two dependent
// divisions a step: diff's, then the new p Q p's and (Q p)[j]'s side by
// side, which the next step's diff waits for), not by its bytes (B x P decision values in,
// B x k probabilities out); a row a warp spreads the rows over every SM.
#include "common.cuh"

#ifndef WDX_SVMPROB_WARPS
#define WDX_SVMPROB_WARPS 4
#endif
#define WDX_SVM_MAX_CLASSES 16
#define WDX_FULL_MASK 0xffffffffu

// KM classes at most; FIXED: exactly KM (the loops' bounds known)
template <int KM, bool FIXED>
__global__ void __launch_bounds__(WDX_SVMPROB_WARPS * 32)
    wdx_svm_probs_kernel(const float* __restrict__ dec, const float* __restrict__ probA,
                         const float* __restrict__ probB, float* __restrict__ out, int B, int k_arg,
                         float lo, float hi, float eps, int max_iter, int scalar_from) {
  const int k = FIXED ? KM : k_arg;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WDX_SVMPROB_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const int P = k * (k - 1) / 2;
  const bool mine = lane < k;  // lane `lane` is class `lane`
  // row `lane` of Q: Q[lane][j] = -(r[j][lane] r[lane][j]), the diagonal
  // sum_j r[j][lane]^2 in order from 0, r[i][j] = rp of pair (i, j) for
  // i < j and 1 - rp below
  float q[KM];
  float diag = 0.f;
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (!FIXED && j >= k) break;
    float r_lj = 0.f, r_jl = 0.f;
    if (mine && j != lane) {
      const int i0 = min(lane, j), j0 = max(lane, j);
      const int pair = i0 * k - i0 * (i0 + 1) / 2 + (j0 - i0 - 1);
      const float fApB = __fmaf_rn(dec[(long long)b * P + pair], probA[pair], probB[pair]);
      const float efa = wdx_xla_exp(-fabsf(fApB));
      const float one_efa = __fadd_rn(1.f, efa);
      float rp = fApB >= 0.f ? __fdiv_rn(efa, one_efa) : __fdiv_rn(1.f, one_efa);
      rp = rp < lo ? lo : (rp > hi ? hi : rp);
      const float rq = __fsub_rn(1.f, rp);
      r_lj = lane < j ? rp : rq;
      r_jl = lane < j ? rq : rp;
    }
    diag = __fadd_rn(diag, j == lane ? 0.f : __fmul_rn(r_jl, r_jl));
    q[j] = __fmul_rn(-r_jl, r_lj);
  }
#pragma unroll
  for (int j = 0; j < KM; ++j)
    if (j == lane) q[j] = diag;
  // the lanes past k hold a row of ones and p = 1: their values are never
  // read, and stay finite and nonzero (a division of 0, by 0 or of a NaN
  // takes the division's slow path, on every step of the warp)
  if (!mine) {
    diag = 1.f;
#pragma unroll
    for (int j = 0; j < KM; ++j) q[j] = 1.f;
  }
  const bool scalar_tail = b >= scalar_from;
  float p = mine ? __fdiv_rn(1.f, (float)k) : 1.f;
  for (int it = 0; it < max_iter; ++it) {
    float Qp = 0.f;
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      if (!FIXED && j >= k) break;
      Qp = __fmaf_rn(q[j], __shfl_sync(WDX_FULL_MASK, p, j), Qp);
    }
    float pQp = 0.f;
    if (scalar_tail) {
#pragma unroll
      for (int t = 0; t < KM; ++t) {
        if (!FIXED && t >= k) break;
        pQp = __fmaf_rn(__shfl_sync(WDX_FULL_MASK, p, t), __shfl_sync(WDX_FULL_MASK, Qp, t), pQp);
      }
    } else {
      const float term = __fmul_rn(p, Qp);
#pragma unroll
      for (int t = 0; t < KM; ++t) {
        if (!FIXED && t >= k) break;
        pQp = __fadd_rn(pQp, __shfl_sync(WDX_FULL_MASK, term, t));
      }
    }
    float err = mine ? fabsf(__fsub_rn(Qp, pQp)) : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) err = wdx_nan_max(err, __shfl_xor_sync(WDX_FULL_MASK, err, o));
    if (!(err >= eps)) break;
#pragma unroll
    for (int t = 0; t < KM; ++t) {
      if (!FIXED && t >= k) break;
      // lane t's diff and new p Q p, computed on every lane from its own
      // values and taken from lane t
      const float diff =
          __shfl_sync(WDX_FULL_MASK, __fdiv_rn(__fadd_rn(-Qp, pQp), diag), t);
      const float inner = __fmaf_rn(diff, diag, __fmul_rn(2.f, Qp));
      const float d1 = __fadd_rn(1.f, diff);
      pQp = __shfl_sync(WDX_FULL_MASK, __fdiv_rn(__fmaf_rn(diff, inner, pQp), __fmul_rn(d1, d1)), t);
      if (lane == t) p = __fadd_rn(p, diff);
      Qp = __fdiv_rn(__fmaf_rn(diff, q[t], Qp), d1);  // q[t] = Q[lane][t] = Q[t][lane]
      p = __fdiv_rn(p, d1);
    }
  }
  if (mine) out[(long long)b * k + lane] = p;
}

WDX_API int wdx_svm_probs(const float* dec, const float* probA, const float* probB, float* out,
                          int B, int k, float lo, float hi, float eps, int max_iter,
                          int scalar_from, cudaStream_t stream) {
  if (B == 0) return 0;
  if (B < 0 || k < 2 || k > WDX_SVM_MAX_CLASSES || max_iter < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (B + WDX_SVMPROB_WARPS - 1) / WDX_SVMPROB_WARPS;
  const int threads = WDX_SVMPROB_WARPS * 32;
#define WDX_SVMPROB_LAUNCH(KM, FIXED)                                                              \
  wdx_svm_probs_kernel<KM, FIXED><<<blocks, threads, 0, stream>>>(dec, probA, probB, out, B, k, lo, \
                                                                  hi, eps, max_iter, scalar_from)
  switch (k) {
    case 5: WDX_SVMPROB_LAUNCH(5, true); break;
    case 7: WDX_SVMPROB_LAUNCH(7, true); break;
    case 9: WDX_SVMPROB_LAUNCH(9, true); break;
    case 11: WDX_SVMPROB_LAUNCH(11, true); break;
    case 13: WDX_SVMPROB_LAUNCH(13, true); break;
    default: WDX_SVMPROB_LAUNCH(WDX_SVM_MAX_CLASSES, false); break;
  }
#undef WDX_SVMPROB_LAUNCH
  return (int)cudaGetLastError();
}

// A probe, not a kernel of the port: one thread runs n dependent correctly
// rounded divisions (chip_smoke.py times it for K13's latency floor).
__global__ void wdx_div_chain_kernel(float* x, int n) {
  float v = x[0];
  const float d = x[1];
  for (int i = 0; i < n; ++i) v = __fdiv_rn(v, d);
  x[0] = v;
}

WDX_API int wdx_div_chain(float* x, int n, cudaStream_t stream) {
  wdx_div_chain_kernel<<<1, 1, 0, stream>>>(x, n);
  return (int)cudaGetLastError();
}
