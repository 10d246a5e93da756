"""Per-chunk streaming detectors for the live (read-until) path.

A numpy copy of warpdemux_tpu/detect/streaming.py with the same results:
float64 cumsums, the first sustained run of candidates.

The live session must decide on partial reads at 100 ms chunk cadence, one
read at a time, on the host — latency matters, batch throughput does not.
These are numpy implementations of the streaming contracts the reference
pulls from ADAPTed (mean_var_shift_polyA_detect called per chunk at
live_balancing/session.py:343-351; real_range_check at :362-365), mirroring
the batched device detectors in detect/boundaries.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class StreamingConfig:
    """[streaming] knobs (reference live config contract,
    DEPRECATED/config_files/rna002_70bps@v0.4.4_live.toml:4-19)."""

    min_obs_adapter: int = 1500
    search_increment_step: int = 200
    polya_window: int = 200
    pA_var_window: int = 500
    pA_var_max: float = 30.0
    polya_scale: float = 1.3
    min_obs_post_loc: int = 100
    min_obs_polya: int = 100


def mean_var_shift_polya_detect(
    signal: np.ndarray, params: StreamingConfig
) -> int:
    """Detect the adapter->polyA transition in a growing chunk.

    Returns the polyA start sample index, or 0 when not (yet) found —
    matching the reference's streaming contract (0 = keep accumulating).
    """
    n = signal.size
    if n < params.min_obs_adapter + params.min_obs_polya:
        return 0
    adapter_med = float(np.median(signal[: params.min_obs_adapter]))
    thr = params.polya_scale * adapter_med

    w = params.polya_window
    # rolling mean / var via cumsums over the searched region
    start = params.min_obs_adapter
    seg = signal[start:]
    if seg.size < w + params.min_obs_post_loc:
        return 0
    c1 = np.concatenate([[0.0], np.cumsum(seg, dtype=np.float64)])
    c2 = np.concatenate([[0.0], np.cumsum(seg.astype(np.float64) ** 2)])
    m = (c1[w:] - c1[:-w]) / w
    v = np.maximum((c2[w:] - c2[:-w]) / w - m * m, 0.0)
    cand = (m > thr) & (v < params.pA_var_max)
    if not cand.any():
        return 0
    # sustained for min_obs_polya: first run of True of sufficient length
    k = max(params.min_obs_polya // 1, 1)
    run = np.convolve(cand.astype(np.int32), np.ones(min(k, cand.size), np.int32), "valid")
    hits = np.nonzero(run == min(k, cand.size))[0]
    if hits.size == 0:
        return 0
    loc = int(hits[0]) + start
    # require enough observations after the located start
    if n - loc < params.min_obs_post_loc:
        return 0
    return loc


@dataclass
class RealRangeConfig:
    """[real_range] plausibility-check knobs
    (reference rna004_130bps@v1.0_tRNA.toml:51-59)."""

    local_range: tuple = (7.0, 35.0)
    adapter_mad_range: tuple = (3.0, 12.0)
    mean_window: int = 300
    max_obs_local_range: int = 5000
    downscale_factor: int = 10


def real_range_check(signal: np.ndarray, params: RealRangeConfig) -> bool:
    """True when the adapter-region signal looks like real squiggle."""
    sig = np.asarray(signal[: params.max_obs_local_range], np.float64)
    if sig.size < params.mean_window:
        return False
    med = np.median(sig)
    mad = np.median(np.abs(sig - med))
    lo, hi = params.adapter_mad_range
    if not (lo <= mad <= hi):
        return False
    ds = params.downscale_factor
    n = sig.size // ds
    if n < 2:
        return False
    x = sig[: n * ds].reshape(n, ds).mean(axis=1)
    w = max(params.mean_window // ds, 2)
    if x.size < w:
        return False
    view = np.lib.stride_tricks.sliding_window_view(x, w)
    local_rng = float(np.median(view.max(axis=1) - view.min(axis=1)))
    lo, hi = params.local_range
    return lo <= local_rng <= hi
