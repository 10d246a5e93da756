// K5: per-row window copy. Output row r reads source row r mod B_x (the
// K windows of a read follow each other B_x rows apart and share its one
// signal):
//   without lengths: out[r, j] = x[r mod B_x, clamp(start[r] + j, 0, L - 1)];
//   with lengths:    out[r, j] = x[r mod B_x, start[r] + j] for j < lengths[r]
//                    where that lies inside the row, else 0, and nothing is
//                    read for the zeros (a window that is zero-filled past
//                    its length needs neither a padded copy of x nor a mask
//                    afterwards).
//
// Replaces warpdemux_tpu/ops/window_gather.py shift_rows, which loads a
// 128-aligned superset window per row and rotates it in registers because
// Mosaic needs aligned dynamic lane offsets.
//
// A grid of every chunk of every output row (row r's chunk c is block c *
// B_out + r: the rows' first chunks first), so a window of any length runs
// the same kernel; no division an element. A thread
// writes WDX_GATHER_VECTORS vectors of 16 bytes, a block's threads
// neighbouring vectors. Where the four samples of a vector lie inside the
// row and below the length, they come from the two aligned 16-byte loads
// that straddle start & 3, recombined in registers; a window's first and
// last vectors take the clamped scalar path. Rows of x or of out that do not
// start on 16 bytes (decided a launch) take scalar loads and stores
// throughout.
//
// Bound: memory, 4 bytes read per sample below the length and 4 written per
// output element.
#include "common.cuh"

#ifndef WDX_GATHER_THREADS
#define WDX_GATHER_THREADS 128
#endif
#ifndef WDX_GATHER_VECTORS
#define WDX_GATHER_VECTORS 2  // 16-byte vectors a thread
#endif

// One output element by the definition above (n_keep: the row's length,
// or out_len without lengths; zero_fill: lengths were given).
__device__ __forceinline__ float wdx_window_sample(const float* __restrict__ xr, int L,
                                                   long long src, long long j, int n_keep,
                                                   bool zero_fill) {
  if (zero_fill) return j < n_keep && src >= 0 && src < L ? xr[src] : 0.f;
  return xr[src < 0 ? 0 : (src > L - 1 ? L - 1 : src)];
}

template <bool VEC>
__global__ void __launch_bounds__(WDX_GATHER_THREADS)
    wdx_shift_rows_kernel(const float* __restrict__ x, const int* __restrict__ starts,
                          const int* __restrict__ lengths, float* __restrict__ out, int B_x, int B_out,
                          int L, int out_len) {
  const int r = (int)(blockIdx.x % (unsigned)B_out);
  const unsigned chunk = blockIdx.x / (unsigned)B_out;
  const float* xr = x + (long long)(r % B_x) * L;
  float* out_row = out + (long long)r * out_len;
  const int start = starts[r];
  const bool zero_fill = lengths != nullptr;
  const int n_keep = zero_fill ? min(lengths[r], out_len) : out_len;
  const long long first = (long long)chunk * (WDX_GATHER_THREADS * WDX_GATHER_VECTORS) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < WDX_GATHER_VECTORS; ++k) {
    const long long j0 = (first + k * WDX_GATHER_THREADS) * 4;
    if (j0 >= out_len) return;
    const long long src = (long long)start + j0;
    if (VEC) {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + 3 < n_keep && src >= 0 && src + 3 < L) {
        // interior: the aligned vectors around src, shifted by start & 3
        const int a = (int)(src & 3);
        const float4 lo = *reinterpret_cast<const float4*>(xr + (src - a));
        if (a == 0) {
          q = lo;
        } else {
          const float4 hi = *reinterpret_cast<const float4*>(xr + (src - a) + 4);
          if (a == 1) q = make_float4(lo.y, lo.z, lo.w, hi.x);
          else if (a == 2) q = make_float4(lo.z, lo.w, hi.x, hi.y);
          else q = make_float4(lo.w, hi.x, hi.y, hi.z);
        }
      } else if (!zero_fill || j0 < n_keep) {
        q.x = wdx_window_sample(xr, L, src, j0, n_keep, zero_fill);
        q.y = wdx_window_sample(xr, L, src + 1, j0 + 1, n_keep, zero_fill);
        q.z = wdx_window_sample(xr, L, src + 2, j0 + 2, n_keep, zero_fill);
        q.w = wdx_window_sample(xr, L, src + 3, j0 + 3, n_keep, zero_fill);
      }
      *reinterpret_cast<float4*>(out_row + j0) = q;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (j0 + i < out_len)
          out_row[j0 + i] = wdx_window_sample(xr, L, src + i, j0 + i, n_keep, zero_fill);
    }
  }
}

// x: (B_x, L); starts, lengths (or null): (B_out,), B_out a multiple of B_x;
// out: (B_out, out_len).
WDX_API int wdx_shift_rows(const float* x, const int* starts, const int* lengths, float* out,
                           int B_x, int B_out, int L, int out_len, cudaStream_t stream) {
  if ((long long)B_out * out_len == 0) return 0;
  if (L <= 0 || B_x <= 0 || B_out % B_x != 0) return (int)cudaErrorInvalidValue;
  const long long per_block = WDX_GATHER_THREADS * WDX_GATHER_VECTORS * 4;
  const long long blocks = (long long)B_out * ((out_len + per_block - 1) / per_block);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;  // an output of more than 8 TB
  const bool vec = L % 4 == 0 && out_len % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec)
    wdx_shift_rows_kernel<true><<<(unsigned)blocks, WDX_GATHER_THREADS, 0, stream>>>(
        x, starts, lengths, out, B_x, B_out, L, out_len);
  else
    wdx_shift_rows_kernel<false><<<(unsigned)blocks, WDX_GATHER_THREADS, 0, stream>>>(
        x, starts, lengths, out, B_x, B_out, L, out_len);
  return (int)cudaGetLastError();
}
