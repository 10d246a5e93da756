// K13: the SVM's class probabilities from its one-vs-one decision values
// (ops/svm.py `probabilities`, whose plain version is the same function in
// torch operations): libsvm's Platt sigmoid with the 1e-7 clamp, the
// pairwise matrix, and the Wu-Lin coupling (libsvm multiclass_probability,
// Gauss-Seidel with eps = 0.005 / k and max(100, k) passes), each row to
// its own convergence, in the float32 operations of the jitted JAX
// function: fApB = fma(dec, A, B); XLA:CPU's exp (Cephes, FMAs, flush to
// zero); Q's diagonal summed in `xla_sum`'s order (in order from 0 up to
// 32 classes); Q p as an fma chain over j from 0; p Q p as rounded
// products summed in `xla_sum`'s order, except on the rows from
// `scalar_from` on (XLA:CPU's scalar loop after its vectors of rows,
// ops/svm.py xla_vector_rows), where it is an fma chain; the update's
// multiply-adds as fmas.
//
// Replaces no Pallas kernel: the JAX package runs the coupling as a
// lax.while_loop (warpdemux_tpu/ops/svm.py multiclass_probability). In
// torch operations it took ~2,800 launches a step and a host read a pass;
// here it is one launch.
//
// Three variants behind the one entry point, chosen by the wrapper (any
// k >= 2 classes; a test may force either block variant at any k):
//
// The warp kernel (k <= 32, the default there). One warp a row, a lane a
// class. Lane j holds row j of the symmetric Q (so also its column j), p[j]
// and (Q p)[j] in registers: the loops over classes are unrolled at compile
// time (an instance for each shipped class count, 5, 7, 9, 11 and 13, one
// for any k <= 16 and one for any k <= 32, whose loops stop at k), so no
// array lives in local memory. Each lane computes the k - 1 sigmoids of its
// row itself. Q p: lane t's fma chain over j in order, p[j] taken by
// shuffle. p Q p and the largest error: every lane runs the same in-order
// chain over the lanes' terms (the error as a butterfly max that keeps the
// NaN rule). Gauss-Seidel step t: every lane computes its own candidate of
// diff and of the new p Q p, lane t's are broadcast, and every lane updates
// its (Q p)[j] and p[j] with its own two divisions at once.
//
// The block kernels (k > 32). One block a row, a thread a class (each
// thread its classes j = tid + s blockDim.x past 1,024). Q (k x k, thread
// j writing its row j, so that a warp's reads of one row of the symmetric Q
// fall on neighbouring words), p and (Q p) in two buffers (the pass's head
// writes the first) live in shared memory where k^2 + 3k
// floats fit a block's (k <= 239), else in a global workspace the wrapper
// allocates (a slot a resident block; the blocks walk the rows). A thread
// builds its class's column of Q and its diagonal (the sum streamed in
// XLA's order, WdxXlaSum). A pass: each thread its (Q p)[j] chains; a
// barrier; every thread the same p Q p from the shared terms; the largest
// error by warp butterflies and the warps' maxima. Step t: every thread
// reads (Q p)[t] from the current buffer and computes the same diff and
// new p Q p, then updates its own p[j] and writes its (Q p)[j] to the
// other buffer: one barrier a step.
//
// A row's passes are a serial chain, so the kernel is bound by its
// dependency chains (two dependent divisions a step: diff's, then the new
// p Q p's and (Q p)[j]'s side by side, which the next step's diff waits
// for), not by its bytes (B x P decision values in, B x k probabilities
// out); a row a warp or block spreads the rows over every SM.
#include "common.cuh"

#ifndef WDX_SVMPROB_WARPS
#define WDX_SVMPROB_WARPS 4
#endif
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

// The block kernels: Q, p and the two (Q p) buffers at `ws` (GLOBAL: slot
// blockIdx.x of a workspace of gridDim.x slots of k^2 + 3k floats) or in
// dynamic shared memory; blockDim.x a multiple of 32, at most 1,024.
template <bool GLOBAL>
__global__ void __launch_bounds__(1024)
    wdx_svm_probs_block_kernel(const float* __restrict__ dec, const float* __restrict__ probA,
                               const float* __restrict__ probB, float* __restrict__ out, float* ws,
                               int B, int k, float lo, float hi, float eps, int max_iter,
                               int scalar_from) {
  extern __shared__ float wdx_svm_smem[];
  __shared__ float warp_err[32];
  const long long kk = (long long)k * k;
  float* const Q = GLOBAL ? ws + (long long)blockIdx.x * (kk + 3 * k) : wdx_svm_smem;  // Q[j][l] at l k + j
  float* const p = Q + kk;
  float* const qp = p + k;  // [2][k]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const long long P = (long long)k * (k - 1) / 2;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const float* const drow = dec + (long long)b * P;
    for (int l = tid; l < k; l += nt) {
      // class l's column of Q: Q[j][l] = -(r[l][j] r[j][l]); its diagonal
      // sum_j r[j][l]^2 in XLA's order (the term j = l is 0)
      WdxXlaSum diag(k);
      for (int j = 0; j < k; ++j) {
        float r_lj = 0.f, r_jl = 0.f;
        if (j != l) {
          const long long i0 = min(l, j), j0 = max(l, j);
          const long long pair = i0 * k - i0 * (i0 + 1) / 2 + (j0 - i0 - 1);
          const float fApB = __fmaf_rn(drow[pair], probA[pair], probB[pair]);
          const float efa = wdx_xla_exp(-fabsf(fApB));
          const float one_efa = __fadd_rn(1.f, efa);
          float rp = fApB >= 0.f ? __fdiv_rn(efa, one_efa) : __fdiv_rn(1.f, one_efa);
          rp = rp < lo ? lo : (rp > hi ? hi : rp);
          const float rq = __fsub_rn(1.f, rp);
          r_lj = l < j ? rp : rq;
          r_jl = l < j ? rq : rp;
        }
        diag.add(j == l ? 0.f : __fmul_rn(r_jl, r_jl));
        Q[(long long)l * k + j] = __fmul_rn(-r_jl, r_lj);
      }
      Q[(long long)l * k + l] = diag.top;
      p[l] = __fdiv_rn(1.f, (float)k);
    }
    __syncthreads();
    const bool scalar_tail = b >= scalar_from;
    for (int it = 0; it < max_iter; ++it) {
      for (int l = tid; l < k; l += nt) {
        float acc = 0.f;
        for (int j = 0; j < k; ++j) acc = __fmaf_rn(Q[(long long)j * k + l], p[j], acc);
        qp[l] = acc;
      }
      __syncthreads();
      float pQp = 0.f;
      if (scalar_tail) {
        for (int j = 0; j < k; ++j) pQp = __fmaf_rn(p[j], qp[j], pQp);
      } else {
        WdxXlaSum sum(k);
        for (int j = 0; j < k; ++j) sum.add(__fmul_rn(p[j], qp[j]));
        pQp = sum.top;
      }
      float err = 0.f;
      for (int l = tid; l < k; l += nt) err = wdx_nan_max(err, fabsf(__fsub_rn(qp[l], pQp)));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) err = wdx_nan_max(err, __shfl_xor_sync(WDX_FULL_MASK, err, o));
      if (lane == 0) warp_err[warp] = err;
      __syncthreads();
      err = 0.f;
      for (int w = 0; w < n_warps; ++w) err = wdx_nan_max(err, warp_err[w]);
      if (!(err >= eps)) break;  // the same on every thread
      for (int t = 0; t < k; ++t) {
        const float* const cur = qp + (t & 1) * k;
        float* const nxt = qp + ((t & 1) ^ 1) * k;
        const float qpt = cur[t];
        const float dg = Q[(long long)t * k + t];
        const float diff = __fdiv_rn(__fadd_rn(-qpt, pQp), dg);
        const float inner = __fmaf_rn(diff, dg, __fmul_rn(2.f, qpt));
        const float d1 = __fadd_rn(1.f, diff);
        pQp = __fdiv_rn(__fmaf_rn(diff, inner, pQp), __fmul_rn(d1, d1));
        for (int l = tid; l < k; l += nt) {
          const float pl = p[l];
          p[l] = __fdiv_rn(l == t ? __fadd_rn(pl, diff) : pl, d1);
          nxt[l] = __fdiv_rn(__fmaf_rn(diff, Q[(long long)t * k + l], cur[l]), d1);
        }
        __syncthreads();
      }
    }
    for (int l = tid; l < k; l += nt) out[(long long)b * k + l] = p[l];
    __syncthreads();  // the next row's Q and p overwrite this row's
  }
}

// variant 0: the warp kernel (k <= 32); 1: the block kernel with Q in
// shared memory (shared_bytes: k^2 + 3k floats); 2: the block kernel with Q
// in `ws`, `slots` blocks of k^2 + 3k floats. threads: the block kernels'.
WDX_API int wdx_svm_probs(const float* dec, const float* probA, const float* probB, float* out,
                          float* ws, int B, int k, float lo, float hi, float eps, int max_iter,
                          int scalar_from, int variant, int threads, int slots, cudaStream_t stream) {
  if (B == 0) return 0;
  if (B < 0 || k < 2 || max_iter < 0) return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    if (k > 32) return (int)cudaErrorInvalidValue;
    const int blocks = (B + WDX_SVMPROB_WARPS - 1) / WDX_SVMPROB_WARPS;
    const int warp_threads = WDX_SVMPROB_WARPS * 32;
#define WDX_SVMPROB_LAUNCH(KM, FIXED)                                                       \
  wdx_svm_probs_kernel<KM, FIXED><<<blocks, warp_threads, 0, stream>>>(                     \
      dec, probA, probB, out, B, k, lo, hi, eps, max_iter, scalar_from)
    switch (k) {
      case 5: WDX_SVMPROB_LAUNCH(5, true); break;
      case 7: WDX_SVMPROB_LAUNCH(7, true); break;
      case 9: WDX_SVMPROB_LAUNCH(9, true); break;
      case 11: WDX_SVMPROB_LAUNCH(11, true); break;
      case 13: WDX_SVMPROB_LAUNCH(13, true); break;
      default:
        if (k <= 16)
          WDX_SVMPROB_LAUNCH(16, false);
        else
          WDX_SVMPROB_LAUNCH(32, false);
        break;
    }
#undef WDX_SVMPROB_LAUNCH
    return (int)cudaGetLastError();
  }
  if (threads < 32 || threads > 1024 || threads % 32) return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)k * k + 3 * (size_t)k;
  if (variant == 1) {
    const size_t bytes = floats * sizeof(float);
    if (bytes + 32 * sizeof(float) > WDX_MAX_SHARED_BYTES) return (int)cudaErrorInvalidValue;
    if (bytes > 48 * 1024) {
      const int err = wdx_allow_shared(wdx_svm_probs_block_kernel<false>, (int)bytes);
      if (err) return err;
    }
    wdx_svm_probs_block_kernel<false><<<B, threads, bytes, stream>>>(
        dec, probA, probB, out, nullptr, B, k, lo, hi, eps, max_iter, scalar_from);
    return (int)cudaGetLastError();
  }
  if (variant != 2 || ws == nullptr || slots < 1) return (int)cudaErrorInvalidValue;
  wdx_svm_probs_block_kernel<true><<<slots, threads, 0, stream>>>(
      dec, probA, probB, out, ws, B, k, lo, hi, eps, max_iter, scalar_from);
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
