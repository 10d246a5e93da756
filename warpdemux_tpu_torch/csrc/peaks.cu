// K3: scipy _select_by_peak_distance as a priority fixpoint.
//
// Replaces warpdemux_tpu/ops/peaks_pallas.py suppress_by_distance_pallas.
// One block owns one row and runs the same rounds as the jnp fixpoint of
// ops/peaks.suppress_by_distance:
//
//   winner = alive peak with no higher-priority alive peak within distance
//            (priority = score, later position winning ties)
//   keep |= winner; alive -= winner + (alive within distance of a winner)
//
// until no peak is alive. The per-position flags live in device memory
// (alive is scratch from the wrapper, keep is the output); __syncthreads
// orders the two phases of a round and __syncthreads_or ends the loop.
//
// Bound: latency of the rounds (a few per row), each reading 2*(d-1)
// neighbours per alive position; the data (one row, ~25 KB) stays in L1/L2.
#include "common.cuh"

__device__ __forceinline__ float wdx_alive_score(const float* s, const uint8_t* alive, int q,
                                                 int L) {
  return (q >= 0 && q < L && alive[q]) ? s[q] : -INFINITY;
}

__global__ void wdx_suppress_kernel(const float* __restrict__ scores,
                                    const uint8_t* __restrict__ is_peak,
                                    const int* __restrict__ distance, uint8_t* alive_all,
                                    uint8_t* win_all, uint8_t* keep_all, int L, int W) {
  const int b = blockIdx.x;
  const float* s = scores + (long long)b * L;
  uint8_t* alive = alive_all + (long long)b * L;
  uint8_t* win = win_all + (long long)b * L;
  uint8_t* keep = keep_all + (long long)b * L;
  const int reach = min(distance[b], W);  // offsets o in [1, reach)

  int any_alive = 0;
  for (int p = threadIdx.x; p < L; p += blockDim.x) {
    const uint8_t a = is_peak[(long long)b * L + p] ? 1 : 0;
    alive[p] = a;
    keep[p] = 0;
    any_alive |= a;
  }
  any_alive = __syncthreads_or(any_alive);

  while (any_alive) {
    // phase 1: winners among the alive peaks
    for (int p = threadIdx.x; p < L; p += blockDim.x) {
      uint8_t w = 0;
      if (alive[p]) {
        const float sp = s[p];
        bool dom = false;
        for (int o = 1; o < reach && !dom; ++o) {
          dom = (wdx_alive_score(s, alive, p + o, L) >= sp) ||
                (wdx_alive_score(s, alive, p - o, L) > sp);
        }
        w = dom ? 0 : 1;
      }
      win[p] = w;
    }
    __syncthreads();
    // phase 2: winners are kept; they and their neighbourhoods die
    int local = 0;
    for (int p = threadIdx.x; p < L; p += blockDim.x) {
      if (!alive[p]) continue;
      bool dead = win[p] != 0;
      if (dead) keep[p] = 1;
      for (int o = 1; o < reach && !dead; ++o) {
        dead = (p + o < L && win[p + o]) || (p - o >= 0 && win[p - o]);
      }
      if (dead)
        alive[p] = 0;
      else
        local = 1;
    }
    any_alive = __syncthreads_or(local);
  }
}

WDX_API int wdx_suppress(const float* scores, const uint8_t* is_peak, const int* distance,
                         uint8_t* alive_scratch, uint8_t* win_scratch, uint8_t* keep, int B,
                         int L, int W, cudaStream_t stream) {
  if (B == 0 || L == 0) return 0;
  wdx_suppress_kernel<<<B, 256, 0, stream>>>(scores, is_peak, distance, alive_scratch,
                                             win_scratch, keep, L, W);
  return (int)cudaGetLastError();
}
