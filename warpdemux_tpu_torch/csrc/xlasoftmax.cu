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
// One warp a row, one lane a class. The max is a butterfly of shuffles (a
// max is exact in any order). The sum has to take XLA's order term by term,
// which a tree reduction (Triton's tl.sum) does not give: for k <= 32 it is
// 0 + e0 + e1 + ... + e(k-1); above, the row zero-padded to windows of 32
// (half the padding in front), each window summed so from 0, the window
// sums summed so in turn. Every lane reads each term of a window through a
// shuffle and adds it in that order, so every lane holds the sum without a
// broadcast; rows up to 32 windows (1,024 classes) take that one level.
// Above 32 classes each lane writes its e to the output as it goes and
// divides what it wrote once the sum is known. Bound: latency (a launch, a
// chain of k dependent shuffles and adds, one division); the bytes are
// 8 a class.
#include "common.cuh"

constexpr int WDX_SOFTMAX_WARPS = 4;
constexpr int WDX_SOFTMAX_MAX_CLASSES = 32 * 32;
#define WDX_SOFTMAX_FULL_MASK 0xffffffffu

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
    float window_sum = 0.f;
    for (int j = 0; j < terms; ++j)
      window_sum = __fadd_rn(window_sum, __shfl_sync(WDX_SOFTMAX_FULL_MASK, e, j));
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

WDX_API int wdx_xla_softmax(const float* z, float* out, int B, int k, cudaStream_t stream) {
  if (B == 0) return 0;
  if (B < 0 || k < 1 || k > WDX_SOFTMAX_MAX_CLASSES) return (int)cudaErrorInvalidValue;
  const int blocks = (B + WDX_SOFTMAX_WARPS - 1) / WDX_SOFTMAX_WARPS;
  wdx_xla_softmax_kernel<<<blocks, WDX_SOFTMAX_WARPS * 32, 0, stream>>>(z, out, B, k);
  return (int)cudaGetLastError();
}
