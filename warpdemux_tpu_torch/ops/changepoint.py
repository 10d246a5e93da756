"""Exact optimal changepoint segmentation (linear-kernel dynamic program).

Copy of warpdemux_tpu/ops/changepoint.py (numpy only). The reference's
optional `segmentation.refinement_optimal_cpts` path replaces peak picking
with ruptures' KernelCPD(kernel="linear").predict(n_bkps=...) over the
barcode score curve; both shipped configurations leave it off. With a
linear kernel over a 1-D series the within-segment cost is

    c(a, b) = sum_{i in [a,b)} x_i^2 - (sum_{i in [a,b)} x_i)^2 / (b - a)

and the optimal K-changepoint segmentation minimizes the total cost, here
with an exact O(K n^2) dynamic program (prefix-sum costs, row minima),
equal to ruptures' dynp solution up to cost ties.
"""

from __future__ import annotations

import numpy as np


def _segment_cost_row(c1, c2, t, min_size):
    """Costs c(s, t) for all starts s < t; +inf where b - a < min_size."""
    s = np.arange(t)
    n = t - s
    sum_ = c1[t] - c1[s]
    sq = c2[t] - c2[s]
    cost = sq - sum_ * sum_ / n
    cost[n < min_size] = np.inf
    return cost


def kernel_cpd_linear(
    x: np.ndarray, n_bkps: int, min_size: int = 2
) -> np.ndarray:
    """Optimal n_bkps changepoints of 1-D series x (linear kernel).

    Returns the breakpoint list in ruptures convention: n_bkps interior
    boundaries plus the series length as the final element (the caller
    prepends 0, as the reference does at sig_proc.py:352-354).
    """
    x = np.asarray(x, np.float64)
    n = x.size
    K = n_bkps
    if n < (K + 1) * min_size:
        return np.array([], np.int64)
    c1 = np.concatenate([[0.0], np.cumsum(x)])
    c2 = np.concatenate([[0.0], np.cumsum(x * x)])

    # D[k, t] = min cost of splitting x[:t] into k+1 segments
    D = np.full((K + 1, n + 1), np.inf)
    arg = np.zeros((K + 1, n + 1), np.int64)

    # k = 0: single segment [0, t)
    t_idx = np.arange(min_size, n + 1)
    D[0, t_idx] = (c2[t_idx] - c2[0]) - (c1[t_idx] - c1[0]) ** 2 / t_idx

    for k in range(1, K + 1):
        # candidate splits s for each t: cost = D[k-1, s] + c(s, t)
        # vectorize over (t, s) with cumulative sums
        tmin = (k + 1) * min_size
        for t in range(tmin, n + 1):
            cost = _segment_cost_row(c1, c2, t, min_size)
            total = D[k - 1, :t] + cost
            j = int(np.argmin(total))
            D[k, t] = total[j]
            arg[k, t] = j

    # backtrack
    bkps = [n]
    t = n
    for k in range(K, 0, -1):
        t = int(arg[k, t])
        bkps.append(t)
    bkps.reverse()
    return np.asarray(bkps, np.int64)  # K interior + final n
