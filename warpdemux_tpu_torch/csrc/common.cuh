// Shared helpers of the hand-written Hopper kernels.
//
// Every kernel file exposes a plain C entry point (no PyTorch headers, so the
// whole library builds with one short nvcc call) that takes device pointers,
// sizes and the CUDA stream, launches, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch. The library is compiled with
// -fmad=false, so the compiler fuses no multiply-add on its own: the kernels
// call __fmaf_rn exactly where XLA:CPU fuses one in the JAX package's
// program, and threshold compares downstream see the same rounding.
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#define WDX_API extern "C" __attribute__((visibility("default")))

// Monotone int32 image of float32 (total order; -0.0 < +0.0).
__device__ __forceinline__ int wdx_order_key(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : (i ^ 0x7FFFFFFF);
}

__device__ __forceinline__ float wdx_key_to_float(int k) {
  int i = k >= 0 ? k : (k ^ 0x7FFFFFFF);
  return __int_as_float(i);
}

struct WdxSum {
  __device__ __forceinline__ int operator()(int a, int b) const { return a + b; }
};

struct WdxMin {
  __device__ __forceinline__ int operator()(int a, int b) const { return a < b ? a : b; }
};

// Block-wide reduction of one int per thread; every thread gets the result.
// blockDim.x must be a multiple of 32. Safe to call back to back.
template <typename Op>
__device__ int wdx_block_reduce(int v, Op op, int identity) {
  __shared__ int partial[32];
  __shared__ int result;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    v = lane < n_warps ? partial[lane] : identity;
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) result = v;
  }
  __syncthreads();
  const int r = result;
  __syncthreads();
  return r;
}

// Exclusive block scan of one int per thread, one round of a loop over a
// row: returns carry + the sum of v over the lower threads of this round
// and adds the round's total to carry (every thread keeps the same carry).
// warp_sums: 64 ints of shared memory, used in halves by round parity, so
// one barrier a round is enough. blockDim.x must be a multiple of 32 and
// every thread of the block must call, with the same round. Any packing of
// several counts into v that cannot carry between its fields scans as one.
__device__ __forceinline__ int wdx_block_exclusive_scan(int v, int* warp_sums, int round,
                                                        int& carry) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  int* sums = warp_sums + (round & 1) * 32;
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  int before = 0;
  int total = 0;
  for (int k = 0; k < n_warps; ++k) {
    const int s = sums[k];
    total += s;
    if (k < warp) before += s;
  }
  const int excl = carry + before + incl - v;
  carry += total;
  return excl;
}

// Exclusive prefix counts of the four 0/1 bytes of n (byte j of the result
// is n.b0 + ... + n.b(j-1)) and their total.
__device__ __forceinline__ unsigned wdx_byte_prefix(unsigned n, int& total) {
  const unsigned incl = n * 0x01010101u;
  total = (int)(incl >> 24);
  return incl << 8;
}

// XLA:CPU's float32 exp (ops/numerics.py xla_exp): Cephes with its
// multiply-adds as __fmaf_rn, subnormal results flushed to zero; the
// constants are the float32 bits of the plain version's. K13's Platt
// sigmoid and K15's softmax share it.
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

// XLA:CPU's float32 exp(scale * x): the product rounded once (__fmul_rn, as
// torch and a jitted JAX function multiply a Python float by a float32
// array), then wdx_xla_exp. K16's element, and K1's store of the SVM's
// kernel matrix exp(-gamma * D), so the two give the same bits.
__device__ __forceinline__ float wdx_xla_exp_scaled1(float x, float scale) {
  return wdx_xla_exp(__fmul_rn(scale, x));
}

// The larger of m and v as torch.amax and XLA's reduce max take it: NaN if
// either is NaN (K13's largest error, K15's row max), one instruction
// (max.NaN.f32, whose NaN is the canonical 0x7FC00000). Of +0.0 and -0.0 it
// may return either: both callers only compare the max or subtract it from
// a value whose exp it takes, where the two zeros give the same bits.
__device__ __forceinline__ float wdx_nan_max(float m, float v) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(v));
  return r;
}

// XLA:CPU's order for a float32 row sum of n terms (ops/numerics.py
// xla_sum), fed one term at a time in index order to one thread: the row
// zero-padded to windows of 32 (half the padding in front), each window
// summed in order from 0, the window sums summed so in turn until 32 or
// fewer are left, which are summed in order from 0; a row of one term is
// that term. A pad adds +0.0 to a sum started from +0.0, which changes no
// bit (such a sum is never -0.0), so the pads are skipped. K13 sums Q's
// diagonal and p Q p with it past 32 classes.
struct WdxXlaSum {
  static constexpr int kMaxLevels = 7;  // 32^7 > 2^31 terms
  int n, levels;
  int size[kMaxLevels], front[kMaxLevels], taken[kMaxLevels];
  float acc[kMaxLevels];
  float top;

  __device__ explicit WdxXlaSum(int n_terms) : n(n_terms), levels(0), top(0.f) {
    for (int d = n_terms; d > 32; d = (d + 31) / 32, ++levels) {
      size[levels] = d;
      front[levels] = ((d + 31) / 32 * 32 - d) / 2;
      taken[levels] = 0;
      acc[levels] = 0.f;
    }
  }

  __device__ void add(float v) {
    if (n == 1) {
      top = v;
      return;
    }
    for (int l = 0; l < levels; ++l) {
      acc[l] = __fadd_rn(acc[l], v);
      const int i = taken[l]++;
      if (((i + front[l]) & 31) != 31 && i != size[l] - 1) return;  // the window goes on
      v = acc[l];
      acc[l] = 0.f;
    }
    top = __fadd_rn(top, v);
  }
};

// Shared memory (static and dynamic together) a block may take on sm_90.
#define WDX_MAX_SHARED_BYTES 232448

// Dynamic shared memory above 48 KB has to be granted per kernel; the
// carve-out hint lets several blocks with large buffers share an SM.
template <typename Kernel>
static int wdx_allow_shared(Kernel kernel, int shared_bytes) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
}
