// K12: the SVM's one-vs-one decision values, out = K . C + bias for K of
// (B, N) kernel rows against the support vectors and C the (N, P) pair
// coefficients (also the DTW-MLP's layers, h . W + b), each output summed in
// the order of XLA:CPU's jitted float32 dot where that order is known
// (ops/numerics.py `dot_order` / `xla_dot`, the plain version), so that the
// probabilities, and the calls made by comparing them with per-barcode
// thresholds, are the JAX package's bit for bit; in the lanes order at
// every other shape:
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
// Bound: memory at the step's shapes (B = 1000, N = 851, P = 10: 3.45 MB
// read and written once against 17 MFLOP). The order of every output is
// fixed, so the speed comes from memory-level parallelism and occupancy,
// not from reordering, and no tensor core takes part (wgmma reads float32
// as TF32 and sums in its own order):
// - a block takes R rows and a tile of PT of the P outputs of each, R sized
//   so that a full minibatch spreads over the card's SMs (one row a block
//   at the live lane's 16 / 32 rows); P is split over blocks where a
//   block would otherwise hold too few rows;
// - the K rows and the C slice are staged with 4-byte cp.async copies (K's
//   rows are N floats, so not 16-byte aligned) by every thread of the
//   block: all at once where they fit in shared memory (the step's WDX4
//   product), so that every load of the block is in flight together; else
//   by chunks of KT terms a chain into two buffers, the next chunk's
//   copies in flight while the current one is summed. Each K element is
//   read from device memory once a tile of outputs; C stays in L2;
// - a summing thread takes one chain of the order (`S` an output: the four
//   lanes, or one a block of kc terms) of RT rows x 4 neighbouring
//   outputs, so a term costs it one 16-byte read of C and RT broadcast
//   reads of K from shared memory for 4 RT independent fmas (RT = 2 for
//   the wide products, whose shared-memory reads bind otherwise);
// - the chains' sums meet in shared memory, where one thread an output
//   combines them in the order above, adds the tail and the bias.
#include "common.cuh"

#include <algorithm>

#ifndef WDX_SVMDOT_BLOCKS  // blocks a full minibatch is cut into: the H100's SMs
#define WDX_SVMDOT_BLOCKS 132
#endif
#ifndef WDX_SVMDOT_RT2_WIDTH  // chains x outputs of a row (S x P) from which a summing thread takes 2 rows
#define WDX_SVMDOT_RT2_WIDTH 256
#endif
#ifndef WDX_SVMDOT_MIN_THREADS  // threads a block at least (the extra ones only stage)
#define WDX_SVMDOT_MIN_THREADS 512
#endif
#ifndef WDX_SVMDOT_KT  // terms a chain a chunk where the operands are chunked
#define WDX_SVMDOT_KT 64
#endif
#ifndef WDX_SVMDOT_WHOLE_SMEM  // bytes of shared memory a block, at most, for operands staged whole
#define WDX_SVMDOT_WHOLE_SMEM (100 * 1024)
#endif

constexpr int WDX_SVMDOT_MAX_THREADS = 1024;
constexpr size_t WDX_SVMDOT_CHUNK_SMEM = 128 * 1024;  // bytes of shared memory a block, at most, for two buffers of chunks

__device__ __forceinline__ void wdx_cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void wdx_cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void wdx_cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The k of staged term q of the chunk from j0 (q < S KT, KT = 2^lkt), or -1
// where the chunk has no such term: lanes, q = 4 i + lane over
// k = 4 (j0 + i) + lane below the tail; chain, q = s KT + i over
// k = s kc + j0 + i inside block s.
template <int MODE>
__device__ __forceinline__ int wdx_term_k(int q, int j0, int N, int kc, int lkt) {
  if (MODE == 0) {
    const int k = 4 * j0 + q;
    return k < (N & ~3) ? k : -1;
  }
  const int i = q & ((1 << lkt) - 1);
  const int k = (q >> lkt) * kc + j0 + i;
  return (j0 + i < kc && k < N) ? k : -1;
}

// RT rows a summing thread; R a multiple of RT
template <int MODE, int RT>
__global__ void __launch_bounds__(WDX_SVMDOT_MAX_THREADS)
    wdx_svm_dot_kernel(const float* __restrict__ K, const float* __restrict__ C,
                       const float* __restrict__ bias, float* __restrict__ out, int B, int N,
                       int P, int kc, int S, int R, int PT, int lkt, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  const int KT = 1 << lkt;
  const int PTp = (PT + 3) & ~3;  // a staged C row: whole groups of four outputs
  const int CG = PTp >> 2;  // groups of four outputs
  const int RG = R / RT;  // groups of RT rows
  const int n_sum = S * RG * CG;  // summing threads; the others stage and combine
  const int n_threads = blockDim.x;
  const int n_buf = n_chunks > 1 ? 2 : 1;
  const int width = S * KT;  // terms staged a chunk a row
  const int ks_stride = width + 1;  // rows a word apart in banks
  float* const cs_buf = smem;  // [n_buf][width][PTp], 16-byte aligned rows
  float* const ks_buf = cs_buf + n_buf * width * PTp;  // [n_buf][R][ks_stride]
  float* const part = ks_buf + n_buf * R * ks_stride;  // [S][R][PTp]
  const int tid = threadIdx.x;
  const int cg = tid % CG, rg = (tid / CG) % RG, s = tid / (CG * RG);  // a warp: neighbouring cg
  const int row0 = blockIdx.x * R, p0 = blockIdx.y * PT;
  const int len = MODE == 0 ? N >> 2 : max(0, min(kc, N - s * kc));  // this chain's terms
  const int rows = min(R, B - row0), cols = min(PT, P - p0);
  // C is staged by columns: thread tid takes column tid % PT of every
  // c_step-th term (the threads past c_step x PT stage no C)
  const int c_step = n_threads / PT;
  const int c_col = tid % PT, c_q0 = tid / PT;

  auto stage = [&](int t) {
    const int j0 = t * KT;
    float* const ks = ks_buf + (t & 1) * R * ks_stride;
    float* const cs = cs_buf + (t & 1) * width * PTp;
    const int q_end = MODE == 0 ? 4 * min(KT, (N >> 2) - j0) : width;
    for (int rr = 0; rr < rows; ++rr) {
      const float* const krow = K + (long long)(row0 + rr) * N;
      for (int q = tid; q < q_end; q += n_threads) {
        const int k = wdx_term_k<MODE>(q, j0, N, kc, lkt);
        if (k >= 0) wdx_cp_async4(ks + rr * ks_stride + q, krow + k);
      }
    }
    if (c_q0 < c_step && c_col < cols) {
      for (int q = c_q0; q < q_end; q += c_step) {
        const int k = wdx_term_k<MODE>(q, j0, N, kc, lkt);
        if (k >= 0) wdx_cp_async4(cs + q * PTp + c_col, C + (long long)k * P + p0 + c_col);
      }
    }
    wdx_cp_async_commit();
  };

  // one combining thread an output (tid < R x PT): its tail terms and bias
  // are loaded before the staging, so that their latency passes beside it
  const int o_r = tid / PT, o_c = tid - o_r * PT;
  const int o_row = row0 + o_r, o_p = p0 + o_c;
  const bool combines = tid < R * PT && o_row < B && o_p < P;
  float tail_k[3] = {0.f, 0.f, 0.f}, tail_c[3] = {0.f, 0.f, 0.f}, b_p = 0.f;
  if (combines) {
    if (MODE == 0) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int k = (N & ~3) + j;
        if (k < N) {
          tail_k[j] = K[(long long)o_row * N + k];
          tail_c[j] = C[(long long)k * P + o_p];
        }
      }
    }
    b_p = bias[o_p];
  }

  float acc[RT][4];
#pragma unroll
  for (int j = 0; j < RT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if (n_chunks > 0) stage(0);
  for (int t = 0; t < n_chunks; ++t) {
    if (t + 1 < n_chunks) {
      stage(t + 1);
    } else {
      wdx_cp_async_commit();  // an empty group: wait_group 1 then waits for chunk t
    }
    wdx_cp_async_wait_one();
    __syncthreads();
    if (tid < n_sum) {
      const float* const ks = ks_buf + (t & 1) * R * ks_stride + rg * RT * ks_stride;
      const float4* const cs = reinterpret_cast<const float4*>(cs_buf + (t & 1) * width * PTp) + cg;
      const int cnt = min(KT, len - t * KT);  // the terms staged are read, no others
#pragma unroll 4
      for (int i = 0; i < cnt; ++i) {
        const int q = MODE == 0 ? 4 * i + s : s * KT + i;
        const float4 c = cs[q * CG];
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const float kv = ks[j * ks_stride + q];
          acc[j][0] = __fmaf_rn(kv, c.x, acc[j][0]);
          acc[j][1] = __fmaf_rn(kv, c.y, acc[j][1]);
          acc[j][2] = __fmaf_rn(kv, c.z, acc[j][2]);
          acc[j][3] = __fmaf_rn(kv, c.w, acc[j][3]);
        }
      }
    }
    __syncthreads();  // the buffer is staged again at t + 2
  }
  if (tid < n_sum) {
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      float* const dst = part + (s * R + rg * RT + j) * PTp + 4 * cg;
      dst[0] = acc[j][0];
      dst[1] = acc[j][1];
      dst[2] = acc[j][2];
      dst[3] = acc[j][3];
    }
  }
  __syncthreads();
  if (!combines) return;
  const float* const sums = part + o_r * PTp + o_c;  // chain c's sum at sums[c R PTp]
  float v;
  if (MODE == 0) {
    const int step = R * PTp;
    v = __fadd_rn(__fadd_rn(sums[0], sums[step]), __fadd_rn(sums[2 * step], sums[3 * step]));
    float tail = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if ((N & ~3) + j < N) tail = __fadd_rn(tail, __fmul_rn(tail_k[j], tail_c[j]));
    v = __fadd_rn(v, tail);
  } else {
    v = 0.f;
    for (int c = 0; c < S; ++c) v = __fadd_rn(v, sums[c * R * PTp]);
  }
  out[(long long)o_row * P + o_p] = __fadd_rn(v, b_p);
}

template <int MODE, int RT>
static int wdx_svm_dot_launch(dim3 grid, int threads, size_t smem, cudaStream_t stream, const float* K,
                              const float* C, const float* bias, float* out, int B, int N, int P, int kc,
                              int S, int R, int PT, int lkt, int n_chunks) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(wdx_svm_dot_kernel<MODE, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  wdx_svm_dot_kernel<MODE, RT><<<grid, threads, smem, stream>>>(K, C, bias, out, B, N, P, kc, S, R, PT, lkt,
                                                                n_chunks);
  return (int)cudaGetLastError();
}

WDX_API int wdx_svm_dot(const float* K, const float* C, const float* bias, float* out, int B,
                        int N, int P, int mode, int kc, cudaStream_t stream) {
  if (B < 0 || N < 0 || P < 0 || (mode != 0 && mode != 1) || (mode == 1 && kc <= 0))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || P == 0) return 0;
  const int S = mode == 0 ? 4 : std::max(1, (N + kc - 1) / kc);  // chains an output
  if (S > WDX_SVMDOT_MAX_THREADS) return (int)cudaErrorInvalidValue;
  // rows a block to spread a full minibatch over the SMs, RT of them a
  // summing thread (two for the wide products, where shared memory's reads
  // bind; one for the narrow, where more summing threads do better); P
  // split over blocks where the summing threads of a block would pass the
  // limit
  const int want_rows = (B + WDX_SVMDOT_BLOCKS - 1) / WDX_SVMDOT_BLOCKS;
  const int RT = want_rows >= 2 && S * P >= WDX_SVMDOT_RT2_WIDTH ? 2 : 1;
  const int want_groups = (want_rows + RT - 1) / RT;
  auto groups_of_four = [](int n) { return (n + 3) / 4; };
  int n_tiles = 1;
  while (n_tiles < P && S * groups_of_four((P + n_tiles - 1) / n_tiles) * want_groups > WDX_SVMDOT_MAX_THREADS)
    ++n_tiles;
  const int PT = (P + n_tiles - 1) / n_tiles;
  const int max_groups =
      std::min(WDX_SVMDOT_MAX_THREADS / (S * groups_of_four(PT)), WDX_SVMDOT_MAX_THREADS / (PT * RT));
  const int R = std::max(1, std::min(want_groups, max_groups)) * RT;
  const int PTp = (PT + 3) & ~3;
  const int longest = mode == 0 ? N >> 2 : std::min(kc, N);  // terms of the longest chain
  auto smem_bytes = [&](int lkt, int n_buf) {
    const size_t width = (size_t)S << lkt;
    return (n_buf * (width * PTp + R * (width + 1)) + (size_t)S * R * PTp) * sizeof(float);
  };
  int lkt = 0;
  while ((1 << lkt) < longest) ++lkt;
  int n_chunks = longest > 0 ? 1 : 0;
  if (smem_bytes(lkt, 1) > WDX_SVMDOT_WHOLE_SMEM) {  // chunks of KT terms, two buffers
    lkt = 0;
    while ((2 << lkt) <= WDX_SVMDOT_KT && smem_bytes(lkt + 1, 2) <= WDX_SVMDOT_CHUNK_SMEM) ++lkt;
    n_chunks = (longest + (1 << lkt) - 1) >> lkt;
  }
  const size_t smem = smem_bytes(lkt, n_chunks > 1 ? 2 : 1);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + R - 1) / R, (P + PT - 1) / PT);
  const int n_sum = S * (R / RT) * (PTp / 4);
  const int threads = (std::max({n_sum, R * PT, WDX_SVMDOT_MIN_THREADS}) + 31) / 32 * 32;
  if (threads > WDX_SVMDOT_MAX_THREADS) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    return RT == 2 ? wdx_svm_dot_launch<0, 2>(grid, threads, smem, stream, K, C, bias, out, B, N, P, kc, S, R, PT, lkt, n_chunks)
                   : wdx_svm_dot_launch<0, 1>(grid, threads, smem, stream, K, C, bias, out, B, N, P, kc, S, R, PT, lkt, n_chunks);
  return RT == 2 ? wdx_svm_dot_launch<1, 2>(grid, threads, smem, stream, K, C, bias, out, B, N, P, kc, S, R, PT, lkt, n_chunks)
                 : wdx_svm_dot_launch<1, 1>(grid, threads, smem, stream, K, C, bias, out, B, N, P, kc, S, R, PT, lkt, n_chunks);
}
