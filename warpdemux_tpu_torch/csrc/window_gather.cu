// K5: per-row window copy, out[b, j] = x[b, clamp(start[b] + j, 0, L - 1)].
//
// Replaces warpdemux_tpu/ops/window_gather.py shift_rows, which loads a
// 128-aligned superset window per row and rotates it in registers because
// Mosaic needs aligned dynamic lane offsets. A GPU reads any offset, so one
// thread copies one element.
//
// Bound: memory, 4 bytes read and 4 written per output element.
#include "common.cuh"

__global__ void wdx_shift_rows_kernel(const float* __restrict__ x, const int* __restrict__ starts,
                                      float* __restrict__ out, int B, int L, int out_len) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * out_len) return;
  const int b = (int)(idx / out_len);
  const int j = (int)(idx % out_len);
  long long src = (long long)starts[b] + j;
  src = src < 0 ? 0 : (src > L - 1 ? L - 1 : src);
  out[idx] = x[(long long)b * L + src];
}

WDX_API int wdx_shift_rows(const float* x, const int* starts, float* out, int B, int L,
                           int out_len, cudaStream_t stream) {
  const long long total = (long long)B * out_len;
  if (total == 0) return 0;
  if (L <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  wdx_shift_rows_kernel<<<(unsigned)blocks, threads, 0, stream>>>(x, starts, out, B, L, out_len);
  return (int)cudaGetLastError();
}
