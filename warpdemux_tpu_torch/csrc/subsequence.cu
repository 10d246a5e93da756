// K10: subsequence DTW of one query (the 84-event consensus adapter) into
// every row of a batch of series (a read's normalized adapter event means).
// Writes per row the matched segment [start, end_excl) in series indices and
// the match distance.
//
// New: the JAX package has no Pallas kernel here. It runs the dynamic
// program as a lax.scan over the r + c + 1 anti-diagonals of the
// (r + 1) x (c + 1) grid (warpdemux_tpu/ops/subsequence.py:60), which XLA
// compiles into one loop; in eager PyTorch every diagonal would cost a score
// of launches, so the port gives it one kernel.
//
// Recurrence (grid point (i, j), i over the query, j over the series):
//   D[i, j] = fma(q[i-1] - s[j-1], q[i-1] - s[j-1], best)
//   best    = min(D[i-1, j-1], D[i-1, j] + p, D[i, j-1] + p),
// ties preferring the diagonal, then up, then left; D[0, 0..psi_2b] = 0,
// D[0..psi_1b, 0] = 0, every other boundary cell and every cell past the
// row's series length the "infinity" FLT_MAX / 4. S carries the row-0
// column each cell's path started from. Then matching = sqrt(D[r, j]) *
// float32(1 / r) for j = 1..c (infinity past the length), whose first
// minimum (the first NaN, if any) is the match. Each operation is the one
// XLA:CPU compiles for the jitted JAX function: it contracts d + best into
// the fused multiply-add and multiplies by the reciprocal of r. Minima
// propagate NaN, as XLA's do.
//
// Design: the warp kernel (r <= 32 x 8 = 256): one warp a read, a skewed
// pipeline in registers. Lane l < L = ceil(r / R) owns query rows
// R l + 1 .. R l + R and keeps their query values and their cells of the
// last column in registers. R is a template argument with two instances:
// R = 3 for queries of a multiple of 3 up to 96 (the consensus, r = 84:
// L = 28) and R = 8 for any other r <= 256. At step t it computes columns
// C (t - l) + 1 .. C (t - l) + C of its rows (C = 2), a column at a time,
// top to bottom. The cells above its first row are the previous lane's
// last row at the same columns, computed at step t - 1 and brought over by
// one shuffle of D and one of S a column; the diagonal neighbours come
// with them; lane 0 makes row 0's boundary cells itself. Where r is no
// multiple of R, the last busy lane's rows past r copy the cell above, so
// that its last row is row r. Lane L - 1 puts row r, C columns a step, into
// a ring of 32 steps in shared memory (3 KB a block); after every 32 steps
// the warp takes the ring's first NaN or first minimum of sqrt(D) * inv_r
// (sqrt and compare a lane, then five shuffle rounds) and keeps it if it
// comes before the match so far: the serial scan's rule and order, with no
// row kept and nothing scanned at the end. Columns past the row's length
// are never read by a cell at or below it, so the warp stops at
// ceil(n / C) + L - 1 steps (88 at the tRNA step's m = 84, n = 121), and
// the pipeline's first L - 1 steps keep only what lanes that have begun
// compute. The series values are read with __ldg two steps before they are
// used, into two buffers that the steps take in turn (a value read one
// step ahead stalled the step on the load; lane 0 reading them and handing
// them down a lane a step was slower), after the row was prefetched into
// L1. A cell's D + p serves as the next column's left and the next row's
// up (one add, not two); min(diagonal, up + p, left + p) is taken with the
// hardware's NaN-propagating minimum, up last (the only operand that waits
// on the cell above): the same value in any order, as no operand is -0 and
// a NaN gives NaN (the canonical one, as the card's arithmetic on any NaN). S
// follows the same choices: the diagonal where the minimum equals it (a
// NaN compares false), then up where up + p <= left + p, else left. Four
// reads a block, 1000 warps resident at once; no barrier.
//
// Why: the first design (kept below as the block kernel, for 256 < r < 1024)
// gave a read one block of r + 1 threads, thread i row i, one diagonal a
// step: (1) a block-wide barrier on each of the r + c + 1 dependent steps;
// (2) a step's shared-memory ring loads and stores, modulo indices and
// boundary branches, with 42% of the thread-steps idle at the barrier;
// (3) three warps a read, all stalled on the same barriers, too few to
// hide them; (4) a serial 121-step argmin by one thread at the end. Its
// NaN-propagating minimum compiled to branches, each a divergence point.
//
// Bound: operations, 7 a cell (a subtract, a square, two adds, three
// compares) over r x n cells a row; the bytes (the series, the query and
// three outputs) are a tenth of that time at these shapes. Any schedule
// also waits on the program's dependency chain: r + c - 1 cells one after
// another, each an add, a minimum and a fused multiply-add, ~1 us at the
// step shape, as far below the kernel as the operations bound. The warp
// kernel's time is its steps, each a shuffle and R + C - 1 dependent cells
// with ~100 instructions a warp issued in order: one warp alone takes
// nearly as long as two sharing a scheduler.
#include "common.cuh"

// reads (warps) a block of the warp kernel, and columns a lane computes a
// step (1 and 4 were slower, 2 warps and 8 no faster)
constexpr int WDX_SUBSEQ_WARPS = 4;
constexpr int WDX_SUBSEQ_COLS = 2;

// min(a, b) that propagates NaN (XLA's and torch.minimum's semantics)
__device__ __forceinline__ float wdx_min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// The same minimum in one instruction, without a branch: a NaN operand
// gives the canonical NaN, as any arithmetic on a NaN does on the card.
__device__ __forceinline__ float wdx_min_nan_fast(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float wdx_subseq_boundary(int i, int j, int psi_1b, int psi_2b,
                                                     float inf) {
  return (i == 0 && j <= psi_2b) || (j == 0 && i <= psi_1b) ? 0.f : inf;
}

// (m, j) comes before (m2, j2) in the match's order: a NaN first (the
// earlier column first), then the smaller value, then the earlier column.
__device__ __forceinline__ bool wdx_subseq_before(float m, int j, float m2, int j2) {
  const bool nan1 = m != m;
  const bool nan2 = m2 != m2;
  if (nan1 || nan2) return nan1 && (!nan2 || j < j2);
  return m < m2 || (m == m2 && j < j2);
}

// The series value at x, or 0 outside the row (a column that no cell at
// or below the row's length reads).
__device__ __forceinline__ float wdx_subseq_series(const float* srow, int x, int c) {
  return (unsigned)x < (unsigned)c ? __ldg(srow + x) : 0.f;
}

template <bool V>
struct WdxFlag {
  static constexpr bool value = V;
};

// One warp a row; R rows a lane, C columns a step; EXACT: r is a multiple
// of R (no lane holds rows past r).
template <int R, int C, bool EXACT>
__global__ void __launch_bounds__(32 * WDX_SUBSEQ_WARPS)
    wdx_subseq_dtw_warp_kernel(const float* __restrict__ q, const float* __restrict__ series,
                               const int* __restrict__ series_len, int* __restrict__ start_out,
                               int* __restrict__ end_out, float* __restrict__ dist_out, int B,
                               int r, int c, int psi_1b, int psi_2b, float p, float inf,
                               float inv_r) {
  // row r of the last 32 steps' columns, as lane busy - 1 computed them,
  // then a slot for every lane's store, so that the store takes no branch
  __shared__ float ring_d[WDX_SUBSEQ_WARPS][32 * C + 32];
  __shared__ int ring_s[WDX_SUBSEQ_WARPS][32 * C + 32];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WDX_SUBSEQ_WARPS + warp;
  if (b >= B) return;  // the whole warp: no barrier follows
  const int busy = (r + R - 1) / R;  // lanes that hold rows; lane busy - 1 holds row r
  const int n = min(max(series_len[b], 0), c);  // columns computed
  const float* srow = series + (long long)b * c;
  asm("" : "+l"(srow));  // kept in registers, not recomputed at every load
  if (n > 0) {  // the row into L1: a lane a 128-byte line, and the last
    for (int x = 32 * lane; x < n + 31; x += 32 * 32) {
      asm volatile("prefetch.global.L1 [%0];" ::"l"(srow + min(x, n - 1)));
    }
  }

  // The lane's rows base + 1 .. base + R: query values; D, D + p and S at
  // the last column; D and S of the row above at the column before this
  // step's first (the diagonal); D and S of the last row at this step's
  // columns, which the next lane reads as the cells above its first row.
  const int base = R * lane;
  float qv[R], dl[R], el[R];
  int sl[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = base + 1 + k;
    qv[k] = q[min(i, r) - 1];
    dl[k] = wdx_subseq_boundary(i, 0, psi_1b, psi_2b, inf);
    el[k] = __fadd_rn(dl[k], p);
    sl[k] = 0;
  }
  float diag_d = wdx_subseq_boundary(base, 0, psi_1b, psi_2b, inf);
  int diag_s = 0;
  float out_d[C];
  int out_s[C];
#pragma unroll
  for (int u = 0; u < C; ++u) {
    out_d[u] = inf;
    out_s[u] = 0;
  }

  // the match so far, the same in every lane: end 1, start S[r, 1] = 0
  // (every path to column 1 starts at 0) and infinity where nothing is
  // below infinity, as in the serial scan
  float best = INFINITY;
  int best_j = 1, best_s = 0;

  // The series values of this lane's columns, loaded two steps before they
  // are used, into two buffers that steps take in turn, so that no step
  // waits on a load.
  float sv_even[C], sv_odd[C];
#pragma unroll
  for (int u = 0; u < C; ++u) {
    sv_even[u] = wdx_subseq_series(srow, u - C * lane, c);
    sv_odd[u] = wdx_subseq_series(srow, C + u - C * lane, c);
  }

  // Step t: columns j0 .. j0 + C - 1 of this lane's rows, j0 = C (t - lane) + 1.
  auto step = [&](int t, auto fill, float(&sv_buf)[C]) {
    const int j0 = C * (t - lane) + 1;
    float up_d[C];
    int up_s[C];
#pragma unroll
    for (int u = 0; u < C; ++u) {
      up_d[u] = __shfl_up_sync(full, out_d[u], 1);
      up_s[u] = __shfl_up_sync(full, out_s[u], 1);
      if (lane == 0) {  // row 0's boundary cells
        up_d[u] = j0 + u <= psi_2b ? 0.f : inf;
        up_s[u] = j0 + u;
      }
    }
    float sv[C];  // this step's; sv_buf then takes the values of step t + 2
#pragma unroll
    for (int u = 0; u < C; ++u) {
      sv[u] = sv_buf[u];
      sv_buf[u] = wdx_subseq_series(srow, j0 + 2 * C - 1 + u, c);
    }
    const bool keep = !decltype(fill)::value || j0 >= 1;
    float nd[R], ne[R];
    int ns[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      nd[k] = dl[k];
      ne[k] = el[k];
      ns[k] = sl[k];
    }
    float dg0 = diag_d;
    int dg0_s = diag_s;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      float up_raw = up_d[u];
      float up_e = __fadd_rn(up_raw, p);
      int ups = up_s[u];
      float dg = dg0;
      int dg_s = dg0_s;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float left_d = nd[k];
        const float left_e = ne[k];
        const int left_s = ns[k];
        // min(diagonal, up + p, left + p) is the same value in any order
        // (no operand is -0; a NaN gives NaN): up, which waits on the
        // cell just above, comes last. Ties prefer the diagonal, then up,
        // then left, and a NaN compares false: the diagonal wins where the
        // minimum equals it.
        const float best_k = wdx_min_nan_fast(up_e, wdx_min_nan_fast(dg, left_e));
        int sk = best_k == dg ? dg_s : (up_e <= left_e ? ups : left_s);
        const float diff = __fsub_rn(qv[k], sv[u]);
        float dk = __fmaf_rn(diff, diff, best_k);
        float ek = __fadd_rn(dk, p);
        if (!EXACT && k > 0 && base + 1 + k > r) {  // past r: hand row r on
          dk = up_raw;
          ek = up_e;
          sk = ups;
        }
        nd[k] = dk;
        ne[k] = ek;
        ns[k] = sk;
        dg = left_d;
        dg_s = left_s;
        up_raw = dk;
        up_e = ek;
        ups = sk;
      }
      dg0 = up_d[u];
      dg0_s = up_s[u];
      out_d[u] = keep ? up_raw : out_d[u];
      out_s[u] = keep ? ups : out_s[u];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      dl[k] = keep ? nd[k] : dl[k];
      el[k] = keep ? ne[k] : el[k];
      sl[k] = keep ? ns[k] : sl[k];
    }
    diag_d = keep ? dg0 : diag_d;
    diag_s = keep ? dg0_s : diag_s;
    // row r at this step's columns, from lane busy - 1
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int slot = lane == busy - 1 ? C * (t & 31) + u : 32 * C + lane;
      ring_d[warp][slot] = out_d[u];
      ring_s[warp][slot] = out_s[u];
    }
  };
  // two steps: the first takes the even buffer, the second the odd
  auto two_steps = [&](int t, auto fill) {
    step(t, fill, sv_even);
    step(t + 1, fill, sv_odd);
  };
  // The chunk of steps that ends before `end` (its first a multiple of
  // 32): its columns' first NaN or first minimum of sqrt(D) * inv_r,
  // merged into the match, in the same order as the serial scan.
  auto merge = [&](int end) {
    __syncwarp();
    const int first = (end - 1) & ~31;
    float m = INFINITY;
    int mj = INT_MAX, ms = 0;
#pragma unroll
    for (int v = 0; v < C; ++v) {
      const int slot = lane + 32 * v;
      const int t = first + slot / C;  // the step that wrote this slot
      const int col = C * (t - busy + 1) + 1 + slot % C;
      if (t < end && col >= 1 && col <= n) {
        const float mv = __fmul_rn(__fsqrt_rn(ring_d[warp][slot]), inv_r);
        if (wdx_subseq_before(mv, col, m, mj)) {
          m = mv;
          mj = col;
          ms = ring_s[warp][slot];
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(full, m, o);
      const int j2 = __shfl_xor_sync(full, mj, o);
      const int s2 = __shfl_xor_sync(full, ms, o);
      if (wdx_subseq_before(m2, j2, m, mj)) {
        m = m2;
        mj = j2;
        ms = s2;
      }
    }
    if (wdx_subseq_before(m, mj, best, best_j)) {
      best = m;
      best_j = mj;
      best_s = ms;
    }
  };
  // Steps: busy - 1 fill the pipeline; lane busy - 1 reaches column n at
  // step ceil(n / C) + busy - 2.
  // Steps run in pairs, so a chunk's last step may be one past the row's
  // last (its cells lie past n, and its slot in no chunk); the pairs that
  // fill the pipeline (busy - 1 steps, rounded up) keep only what the
  // lanes that have begun computed.
  const int steps = n > 0 ? (n + C - 1) / C + busy - 1 : 0;
  const int filling = (busy - 1 + 1) & ~1;
  int t = 0;
  while (t < steps) {
    const int end = min((t | 31) + 1, steps);
    for (; t < min(filling, end); t += 2) two_steps(t, WdxFlag<true>());
    for (; t < end; t += 2) two_steps(t, WdxFlag<false>());
    merge(end);
  }
  if (lane == 0) {
    start_out[b] = best_s;
    end_out[b] = best_j;
    dist_out[b] = best;
  }
}

// The block kernel (r > 256): one block a row; thread i owns query row i
// and walks the diagonals k = 0..r+c, computing cell (i, k - i). D and S
// of the last three diagonals live in shared memory (a ring, so one
// barrier a diagonal suffices: a diagonal's buffer is rewritten only after
// the barrier that follows the last read of it); the series row is staged
// there once, and row r's D and S are kept as they are produced. Thread 0
// then scans row r for the argmin.
__global__ void wdx_subseq_dtw_block_kernel(const float* __restrict__ q,
                                            const float* __restrict__ series,
                                            const int* __restrict__ series_len,
                                            int* __restrict__ start_out, int* __restrict__ end_out,
                                            float* __restrict__ dist_out, int r, int c, int psi_1b,
                                            int psi_2b, float p, float inf, float inv_r) {
  extern __shared__ float smem[];
  const int rows = r + 1;
  float* s = smem;                                   // (c,) the series row
  float* d_last = s + c;                             // (c,) D[r, 1..c]
  int* s_last = reinterpret_cast<int*>(d_last + c);  // (c,) S[r, 1..c]
  float* dbuf = reinterpret_cast<float*>(s_last + c);  // (3, rows) D of diagonals k % 3
  int* sbuf = reinterpret_cast<int*>(dbuf + 3 * rows);  // (3, rows) S of them

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const float* srow = series + (long long)b * c;
  for (int t = i; t < c; t += blockDim.x) s[t] = srow[t];
  const int n = series_len[b];
  const float qi = q[i >= 1 && i <= r ? i - 1 : 0];
  if (i < rows) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      dbuf[m * rows + i] = inf;
      sbuf[m * rows + i] = 0;
    }
  }
  __syncthreads();

  for (int k = 0; k <= r + c; ++k) {
    if (i < rows) {
      const int cur = k % 3;
      const int prev1 = (k + 2) % 3;  // diagonal k - 1
      const int prev2 = (k + 1) % 3;  // diagonal k - 2
      const int j = k - i;
      float dk;
      int sk;
      if (i == 0 || j == 0) {
        dk = wdx_subseq_boundary(i, j, psi_1b, psi_2b, inf);
        sk = i == 0 ? j : 0;
      } else if (j >= 1 && j <= n) {
        const float diag_d = dbuf[prev2 * rows + i - 1];
        const float o1 = __fadd_rn(dbuf[prev1 * rows + i - 1], p);  // up
        const float o2 = __fadd_rn(dbuf[prev1 * rows + i], p);      // left
        const float m12 = wdx_min_nan(o1, o2);
        const float best = wdx_min_nan(diag_d, m12);
        sk = diag_d <= m12 ? sbuf[prev2 * rows + i - 1]
                           : (o1 <= o2 ? sbuf[prev1 * rows + i - 1] : sbuf[prev1 * rows + i]);
        const float diff = __fsub_rn(qi, s[min(j, c) - 1]);
        dk = __fmaf_rn(diff, diff, best);
      } else {
        dk = inf;
        sk = 0;
      }
      dbuf[cur * rows + i] = dk;
      sbuf[cur * rows + i] = sk;
      if (i == r && j >= 1 && j <= c) {
        d_last[j - 1] = dk;
        s_last[j - 1] = sk;
      }
    }
    __syncthreads();
  }

  if (i == 0) {
    int jstar = 0;
    float best = INFINITY;
    for (int t = 0; t < c; ++t) {
      const float m = t + 1 <= n ? __fmul_rn(__fsqrt_rn(d_last[t]), inv_r) : INFINITY;
      if (m != m) {  // argmin and min both stop at the first NaN
        jstar = t;
        best = m;
        break;
      }
      if (m < best) {
        best = m;
        jstar = t;
      }
    }
    start_out[b] = s_last[jstar];
    end_out[b] = jstar + 1;
    dist_out[b] = best;
  }
}

// Shared memory a block of the block kernel: the series row, row r's D and
// S, and three diagonals of D and S.
static long long wdx_subseq_shared_bytes(int r, int c) {
  return 4LL * (3LL * c + 6LL * (r + 1));
}

template <int R, bool EXACT>
static int wdx_subseq_launch_warp(const float* q, const float* series, const int* series_len,
                                  int* start, int* end, float* dist, int B, int r, int c,
                                  int psi_1b, int psi_2b, float p, float inf, float inv_r,
                                  cudaStream_t stream) {
  const int blocks = (B + WDX_SUBSEQ_WARPS - 1) / WDX_SUBSEQ_WARPS;
  wdx_subseq_dtw_warp_kernel<R, WDX_SUBSEQ_COLS, EXACT><<<blocks, 32 * WDX_SUBSEQ_WARPS, 0, stream>>>(
      q, series, series_len, start, end, dist, B, r, c, psi_1b, psi_2b, p, inf, inv_r);
  return (int)cudaGetLastError();
}

// q: (r,); series: (B, c); series_len: (B,); start, end: (B,) int32;
// dist: (B,) float32. psi_1b / psi_2b: the relaxed query / series starts;
// p: penalty**2; inf: the program's infinity; inv_r: float32(1 / r).
// rows_per_lane: R of the warp kernel (3 for r a multiple of 3 up to 96, 8
// for r <= 256), or 0 for the block kernel (r + 1 <= 1024 threads, its
// shared memory within a block's).
WDX_API int wdx_subseq_dtw(const float* q, const float* series, const int* series_len, int* start,
                           int* end, float* dist, int B, int r, int c, int psi_1b, int psi_2b,
                           float p, float inf, float inv_r, int rows_per_lane,
                           cudaStream_t stream) {
  if (B == 0) return 0;
  if (r < 1 || c < 1) return (int)cudaErrorInvalidValue;
  if (rows_per_lane == 3 && r % 3 == 0 && r <= 96) {
    return wdx_subseq_launch_warp<3, true>(q, series, series_len, start, end, dist, B, r, c,
                                           psi_1b, psi_2b, p, inf, inv_r, stream);
  }
  if (rows_per_lane == 8 && r <= 256) {
    return wdx_subseq_launch_warp<8, false>(q, series, series_len, start, end, dist, B, r, c,
                                            psi_1b, psi_2b, p, inf, inv_r, stream);
  }
  if (rows_per_lane != 0) return (int)cudaErrorInvalidValue;
  if (r + 1 > 1024) return (int)cudaErrorInvalidValue;
  const long long shared = wdx_subseq_shared_bytes(r, c);
  if (shared > WDX_MAX_SHARED_BYTES) return (int)cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const int err = wdx_allow_shared(wdx_subseq_dtw_block_kernel, (int)shared);
    if (err != 0) return err;
  }
  const int threads = (r + 1 + 31) / 32 * 32;
  wdx_subseq_dtw_block_kernel<<<B, threads, (size_t)shared, stream>>>(
      q, series, series_len, start, end, dist, r, c, psi_1b, psi_2b, p, inf, inv_r);
  return (int)cudaGetLastError();
}
