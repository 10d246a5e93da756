"""Batched subsequence DTW: locate the consensus adapter in segmented reads.

Port of warpdemux_tpu/ops/subsequence.py. The tRNA path matches the
84-event consensus adapter signal into each read's 121 segmented adapter
events with psi-relaxed DTW (dtaidistance's warping_paths_fast(query,
series, penalty, psi=(5, 0, 40, 0)) and best_match):

- the full (r+1) x (c+1) program, cost (q[i]-s[j])^2, penalty^2 on the two
  non-diagonal moves, no band;
- psi = (psi_1b, psi_1e, psi_2b, psi_2e): D[0, 0:psi_2b+1] = 0 and
  D[0:psi_1b+1, 0] = 0 relax the query and series starts (the ends are not
  relaxed in the shipped configuration);
- matching = sqrt(D[r, 1:]) / r; the end is its first argmin, and the
  start is carried forward through the recurrence (each cell holds the
  row-0 column its path started from), so no row backtracks.

`subsequence_dtw_ref` is the scalar numpy golden; `subsequence_dtw_plain`
walks the r + c + 1 anti-diagonals as the JAX function's lax.scan does,
with the operations XLA:CPU compiles for it (d + best as one fused
multiply-add, the division by r as a product with float32(1 / r), minima
that propagate NaN); `subsequence_dtw` launches kernel K10
(csrc/subsequence.cu) on CUDA tensors, in one of two variants:

- the warp kernel, for queries of r <= 256 (the consensus: r = 84): one
  warp a read, a skewed pipeline in registers. Lane l of the first
  ceil(r / R) owns R query rows (R = 3 for r a multiple of 3 up to 96, the
  consensus's case; R = 8 for any other r) and computes two columns of
  them a step, 2 (t - l) + 1 and 2 (t - l) + 2 at step t; the cells
  above its first row come from the previous lane by shuffles. The last
  busy lane puts row r into a ring of 32 steps in shared memory, and the
  warp merges each ring into the running first minimum.
  ceil(n / 2) + ceil(r / R) - 1 steps a read, no barrier, no limit in the
  series' width. It answers the first design's four limits: a block-wide
  barrier on each of the r + c + 1 diagonals, a diagonal's shared-memory
  traffic and branches with 42% of the threads idle, three warps a read
  stalled on the same barriers, and one thread's serial argmin over row r
  at the end.
- the block kernel, for 257 <= r <= 1023 (where its shared memory fits):
  the first design, one block of r + 1 threads a read, a diagonal a step.

`_warp_rows` says which: the rows a lane of the warp kernel holds, or 0
for the block kernel. Both are bound by operations (7 a cell of the r x n
grid) and wait on the program's dependency chain of r + c - 1 cells, ~1 us
at the tRNA step's shape; a CUDA tensor beyond both raises ValueError.
"""

from __future__ import annotations

import numpy as np
import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.ops.numerics import exact_sqrt, fma

# the program's "infinity": finite, so that adding the penalty stays finite
INF = float(np.float32(np.finfo(np.float32).max / 4))

# the warp kernel: 32 lanes hold query rows, 3 each for queries of a
# multiple of 3 up to 96 (the consensus, r = 84), else 8, so it takes
# r <= 256; the block kernel takes longer queries
_WARP_MAX_R = 256
_BLOCK_MAX_R = 1023


def _warp_rows(r: int) -> int:
    """Rows a lane of K10's warp kernel holds for a query of r: 3 where r is
    a multiple of 3 up to 96, 8 for any other r <= 256; 0 above (the block
    kernel)."""
    if r % 3 == 0 and r <= 96:
        return 3
    return 8 if r <= _WARP_MAX_R else 0


def _block_shared_bytes(r: int, c: int) -> int:
    """Shared memory a block of K10's block kernel: the series row, row r's
    D and S, three diagonals of D and S."""
    return 4 * (3 * c + 6 * (r + 1))


def _rows_per_lane(r: int, c: int) -> int:
    """K10's variant for a query of r into series of c: the warp kernel's
    rows a lane, or 0 for the block kernel; ValueError beyond both."""
    rows = _warp_rows(r)
    block_fits = r <= _BLOCK_MAX_R and _block_shared_bytes(r, c) <= _cuda.MAX_SHARED_BYTES
    if r < 1 or c < 1 or not (rows or block_fits):
        raise ValueError(f"subsequence_dtw: query of {r} and series of {c} are beyond K10")
    return rows


def subsequence_dtw_ref(query, series, penalty, psi):
    """Scalar numpy golden reference. Returns (start, end, dist)."""
    q, s = np.asarray(query, float), np.asarray(series, float)
    r, c = len(q), len(s)
    p = penalty * penalty
    psi_1b, psi_1e, psi_2b, psi_2e = psi
    D = np.full((r + 1, c + 1), np.inf)
    D[0, 0 : psi_2b + 1] = 0.0
    D[0 : psi_1b + 1, 0] = 0.0
    S = np.full((r + 1, c + 1), -1, int)
    S[0, :] = np.arange(c + 1)
    S[:, 0] = 0
    for i in range(1, r + 1):
        for j in range(1, c + 1):
            d = (q[i - 1] - s[j - 1]) ** 2
            opts = (D[i - 1, j - 1], D[i - 1, j] + p, D[i, j - 1] + p)
            k = int(np.argmin(opts))
            D[i, j] = d + opts[k]
            S[i, j] = (S[i - 1, j - 1], S[i - 1, j], S[i, j - 1])[k]
    matching = np.sqrt(D[r, 1:]) / r
    j_star = int(np.argmin(matching)) + 1
    return int(S[r, j_star]), j_star, float(matching[j_star - 1])


def _scalars(r: int, penalty: float):
    """(penalty**2, float32(1 / r)) as the JAX function rounds them."""
    p = float(np.float32(penalty * penalty))
    inv_r = float(np.float32(1.0) / np.float32(r))
    return p, inv_r


def _first_argmin_nan(m: torch.Tensor):
    """(first index of the minimum, the minimum) per row, where a NaN is
    the minimum (jnp.argmin / jnp.min)."""
    n = m.shape[1]
    low = m.amin(1)  # propagates NaN
    hit = (m == low[:, None]) | (low.isnan()[:, None] & m.isnan())
    pos = torch.arange(n, device=m.device)[None, :]
    idx = torch.where(hit, pos, torch.full_like(pos, n)).amin(1)
    return idx, low


def subsequence_dtw_plain(query, series, series_len, penalty: float = 1.5, psi: tuple = (5, 0, 40, 0)):
    m = query.shape[0]
    B, C = series.shape
    r, c = m, C
    p, inv_r = _scalars(r, penalty)
    psi_1b, _, psi_2b, _ = (int(v) for v in psi)
    dev = series.device
    q = query.to(torch.float32)
    s = series.to(torch.float32)
    n = series_len.to(torch.int64)[:, None]
    iarr = torch.arange(r + 1, device=dev)
    qi = q[(iarr - 1).clamp(0, r - 1)][None, :]
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)

    def shift_i(a, fill):
        return torch.cat([torch.full_like(a[:, :1], fill), a[:, :-1]], dim=1)

    D2 = D1 = torch.full((B, r + 1), INF, dtype=torch.float32, device=dev)
    S2 = S1 = torch.zeros((B, r + 1), dtype=torch.int64, device=dev)
    D_last, S_last = [], []
    for k in range(r + c + 1):
        j = k - iarr
        jr = j[None, :]
        interior = (iarr[None, :] >= 1) & (jr >= 1) & (jr <= n)
        diff = qi - s[:, j.clamp(1, c) - 1]
        o0 = shift_i(D2, INF)
        o1 = shift_i(D1, INF) + p
        o2 = D1 + p
        m12 = torch.minimum(o1, o2)
        best = torch.minimum(o0, m12)
        S_best = torch.where(o0 <= m12, shift_i(S2, 0), torch.where(o1 <= o2, shift_i(S1, 0), S1))
        Dk_int = fma(diff, diff, best)
        bd_D = torch.where(
            ((iarr == 0) & (j <= psi_2b)) | ((j == 0) & (iarr <= psi_1b)),
            torch.zeros((), device=dev), inf,
        )
        bd_S = torch.where(iarr == 0, j, torch.zeros_like(j))
        is_boundary = ((iarr == 0) | (j == 0))[None, :]
        Dk = torch.where(is_boundary, bd_D[None, :], torch.where(interior, Dk_int, inf))
        Sk = torch.where(is_boundary, bd_S[None, :], torch.where(interior, S_best, torch.zeros_like(S_best)))
        if k >= r + 1:  # row r of the grid: D[r, k - r]
            D_last.append(Dk[:, r])
            S_last.append(Sk[:, r])
        D2, S2, D1, S1 = D1, S1, Dk, Sk
    D_last = torch.stack(D_last, dim=1)
    S_last = torch.stack(S_last, dim=1)
    matching = exact_sqrt(D_last) * inv_r
    valid = torch.arange(1, c + 1, device=dev)[None, :] <= n
    matching = torch.where(valid, matching, torch.full_like(matching, float("inf")))
    idx, dist = _first_argmin_nan(matching)
    start = torch.gather(S_last, 1, idx[:, None])[:, 0]
    return start.to(torch.int32), (idx + 1).to(torch.int32), dist


def subsequence_dtw(
    query: torch.Tensor,
    series: torch.Tensor,
    series_len: torch.Tensor,
    penalty: float = 1.5,
    psi: tuple = (5, 0, 40, 0),
):
    """Batched subsequence match; K10 on CUDA (its warp kernel for a query
    of at most 256, the block kernel above).

    Args:
      query: (m,) consensus signal.
      series: (B, C) normalized event means, garbage past series_len.
      series_len: (B,) valid series lengths.
    Returns:
      (start (B,) int32, end (B,) int32, dist (B,) float32): the matched
      segment [start, end) in series indices and the match distance.
    """
    if not _cuda.on_cuda(query, series, series_len):
        return subsequence_dtw_plain(query, series, series_len, penalty, psi)
    (r,) = query.shape
    B, c = series.shape
    query = query.contiguous()
    series = series.contiguous()
    lens = series_len.to(torch.int32).contiguous()
    _cuda.check(query, torch.float32, 1, "subsequence_dtw query")
    _cuda.check(series, torch.float32, 2, "subsequence_dtw series")
    if lens.shape != (B,):
        raise ValueError("series_len must be (B,) for series of shape (B, C)")
    rows = _rows_per_lane(r, c)
    p, inv_r = _scalars(r, penalty)
    psi_1b, _, psi_2b, _ = (int(v) for v in psi)
    start = torch.empty(B, dtype=torch.int32, device=series.device)
    end = torch.empty_like(start)
    dist = torch.empty(B, dtype=torch.float32, device=series.device)
    _cuda.launch(
        "wdx_subseq_dtw", series.device, query.data_ptr(), series.data_ptr(), lens.data_ptr(),
        start.data_ptr(), end.data_ptr(), dist.data_ptr(), B, r, c, psi_1b, psi_2b, p, INF, inv_r, rows,
    )
    return start, end, dist
