"""Detect results -> barcode fingerprints, batched.

Port of warpdemux_tpu/ops/fingerprint.py. `fingerprints_from_boundaries`:

1. adapter extraction with padding into a fixed (B, buffer_len) buffer
   (kernel K5 on CUDA),
2. outlier clipping to median +/- thresh * MAD (kernel K4),
3. the pre-normalization of sig_extract.normalization ("none" in the
   shipped chemistries): (x - mean) / std of the valid samples ("mean",
   kernel K11) or (x - median) / MAD ("median", kernel K4),
4. event segmentation into num_events changepoints (kernels K2, K3),
5. mean/std normalization of the event means,
6. fingerprint = the last barcode_num_events normalized event means,
7. adapter event statistics.

`fingerprints_consensus_refined` (the tRNA path) segments the whole
adapter the same way, then finds where the barcode starts by matching the
consensus adapter signal into the normalized event means (subsequence
DTW: kernel K10), re-picks the peaks of the t-scores from there on (K3
again), and normalizes the barcode's event means by the adapter's event
statistics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from warpdemux_tpu_torch.config.sig_proc import FingerprintConfig
from warpdemux_tpu_torch.ops.normalize import (
    check_method,
    clip_outliers_prefix,
    masked_mad,
    masked_median,
    mean_std,
)
from warpdemux_tpu_torch.ops.peaks import find_peaks_batch, select_top_peaks
from warpdemux_tpu_torch.ops.rowstats import range_mean_std
from warpdemux_tpu_torch.ops.select import range_median_mad
from warpdemux_tpu_torch.ops.segmentation import segment_means, segment_signal_batch
from warpdemux_tpu_torch.ops.subsequence import subsequence_dtw
from warpdemux_tpu_torch.ops.window_gather import shift_rows


class FingerprintArrays(NamedTuple):
    """Batched fingerprint results; (B, ...) tensors."""

    ok: torch.Tensor  # bool: segmentation + normalization succeeded
    fpt: torch.Tensor  # (B, barcode_num_events) float32
    dwell: torch.Tensor  # (B, barcode_num_events) int32
    adapter_dt_med: torch.Tensor
    adapter_dt_mad: torch.Tensor
    adapter_event_mean: torch.Tensor
    adapter_event_std: torch.Tensor
    adapter_event_med: torch.Tensor
    adapter_event_mad: torch.Tensor


def extract_adapter_batch(
    signals, in_lens, adapter_start, adapter_end, padding: int, buffer_len: int
):
    """Copy [max(0, start - pad), min(len, end + pad)) into a fixed buffer.

    Returns (buffer (B, buffer_len), lengths (B,)). The buffer is zero past
    a row's length and where the window leaves the signal: the gather
    fills those itself (`shift_rows` with lengths)."""
    start = torch.clamp_min(adapter_start - padding, 0)
    end = torch.minimum(in_lens, adapter_end + padding)
    length = (end - start).clamp(0, buffer_len)
    return shift_rows(signals, start, buffer_len, length), length


def normalize_prefix(x, n_valid, method: str):
    """`normalize.normalize(x, mask, method)` for "mean" or "median" where
    the valid lanes of each row are the prefix [0, n_valid): the statistics
    of the one range in one launch (K11's mean and std, K4's median and
    MAD on CUDA), then (x - shift) / scale, a true division (NaN or inf
    where the scale is 0, as in JAX)."""
    starts = torch.zeros((1, x.shape[0]), dtype=torch.int32, device=x.device)
    ends = n_valid.to(torch.int32)[None]
    stats = range_mean_std if method == "mean" else range_median_mad
    shift, scale = stats(x, starts, ends)
    return (x - shift[0][:, None]) / scale[0][:, None]


def _segmented_adapter(signals, in_lens, adapter_start, adapter_end, cfg: FingerprintConfig):
    """The clipped (and pre-normalized) adapter buffer, its lengths, and
    its segmentation into num_events + 1 events (segment_signal_batch's
    six outputs). ValueError for an unknown sig_extract.normalization."""
    method = cfg.extract_normalization
    check_method(method)
    adapter, a_len = extract_adapter_batch(
        signals,
        in_lens.to(torch.int32),
        adapter_start.to(torch.int32),
        adapter_end.to(torch.int32),
        cfg.padding,
        cfg.buffer_len,
    )
    A = adapter.shape[1]
    amask = torch.arange(A, device=signals.device)[None, :] < a_len[:, None]
    zeros = torch.zeros_like(adapter)
    adapter = torch.where(amask, clip_outliers_prefix(adapter, a_len, cfg.sig_norm_outlier_thresh), zeros)
    if method != "none":
        adapter = torch.where(amask, normalize_prefix(adapter, a_len, method), zeros)
    seg = segment_signal_batch(
        adapter,
        a_len,
        cfg.num_events,
        cfg.min_obs_per_base,
        cfg.running_stat_width,
    )
    return adapter, a_len, seg


def _event_stats(means, dwell):
    """Adapter event statistics over all events: (mean, std, ok = std > 0,
    dwell median, dwell MAD, event median, event MAD)."""
    all_mask = torch.ones_like(means, dtype=torch.bool)
    ev_mean, ev_std = mean_std(means)
    dwell_f = dwell.to(torch.float32)
    dt_med = masked_median(dwell_f, all_mask)
    ev_med = masked_median(means, all_mask)
    return (
        ev_mean, ev_std, ev_std > 0, dt_med, masked_mad(dwell_f, all_mask, dt_med),
        ev_med, masked_mad(means, all_mask, ev_med),
    )


def _normalize_wrt(a, ev_mean, ev_std, norm_ok):
    """(a - mean) / std of the adapter's events, a true division (std 1
    where it is 0)."""
    return (a - ev_mean[:, None]) / torch.where(norm_ok, ev_std, torch.ones_like(ev_std))[:, None]


def fingerprints_from_boundaries(
    signals: torch.Tensor,
    in_lens: torch.Tensor,
    adapter_start: torch.Tensor,
    adapter_end: torch.Tensor,
    cfg: FingerprintConfig = FingerprintConfig(),
) -> FingerprintArrays:
    _, _, (means, dwell, seg_ok, _, _, _) = _segmented_adapter(
        signals, in_lens, adapter_start, adapter_end, cfg
    )
    # normalize event means over ALL events, keep the last
    # barcode_num_events as the fingerprint
    ev_mean, ev_std, norm_ok, dt_med, dt_mad, ev_med, ev_mad = _event_stats(means, dwell)
    k = cfg.barcode_num_events
    return FingerprintArrays(
        ok=seg_ok & norm_ok,
        fpt=_normalize_wrt(means, ev_mean, ev_std, norm_ok)[:, -k:],
        dwell=dwell[:, -k:],
        adapter_dt_med=dt_med,
        adapter_dt_mad=dt_mad,
        adapter_event_mean=ev_mean,
        adapter_event_std=ev_std,
        adapter_event_med=ev_med,
        adapter_event_mad=ev_mad,
    )


class ConsensusFingerprintArrays(NamedTuple):
    """FingerprintArrays + the consensus-match fields (tRNA path)."""

    base: FingerprintArrays
    outlier: torch.Tensor  # (B,) bool: consensus query outlier
    seg_query_start: torch.Tensor  # (B,) int32, matched consensus segment
    seg_query_end: torch.Tensor  # (B,) int32 (inclusive event index)
    sig_barcode_start: torch.Tensor  # (B,) int32 sample index into the adapter


def fingerprints_consensus_refined(
    signals: torch.Tensor,
    in_lens: torch.Tensor,
    adapter_start: torch.Tensor,
    adapter_end: torch.Tensor,
    consensus_query: torch.Tensor,
    cfg: FingerprintConfig,
    sx,
) -> ConsensusFingerprintArrays:
    """Consensus-guided barcode-refined fingerprints (the tRNA path).

    1. segment the whole adapter into cfg.num_events events,
    2. match the mean-normalized consensus query into the mean-normalized
       adapter event means (subsequence DTW, K10; penalty and psi from
       `sx`, a SegmentationExtra),
    3. sig_barcode_start = the segment boundary at the matched end event,
    4. re-pick the t-score peaks at sig_barcode_start + 1 or later (the
       config's min_obs_per_base as the distance, not the per-read one),
       keep the sx.barcode_seg_num_events highest; changepoints = peaks +
       cfg.running_stat_width,
    5. the barcode's event means between those changepoints, normalized
       by the adapter's event statistics,
    6. fingerprint = the last cfg.barcode_num_events of them,
    7. outlier gate: matched start > ub_start, or the matched (inclusive)
       end outside [lb_end, ub_end] -> "consensus query outlier".
    """
    adapter, a_len, (means, dwell, seg_ok, scores, n_scores, boundaries) = _segmented_adapter(
        signals, in_lens, adapter_start, adapter_end, cfg
    )
    B, E = means.shape  # num_events + 1 adapter events
    ev_mean, ev_std, norm_ok, dt_med, dt_mad, ev_med, ev_mad = _event_stats(means, dwell)
    norm_series = _normalize_wrt(means, ev_mean, ev_std, norm_ok)

    q_start, q_end_excl, _ = subsequence_dtw(
        consensus_query.to(torch.float32),
        norm_series,
        torch.full((B,), E, dtype=torch.int32, device=means.device),
        penalty=float(sx.consensus_subseq_match_penalty),
        psi=tuple(int(v) for v in sx.consensus_subseq_match_psi),
    )
    # the match end as dtaidistance reports it: the inclusive event index
    q_end = q_end_excl - 1
    # sum(dwell[:q_end]) == the segment boundary at event q_end
    sig_bc_start = torch.gather(boundaries, 1, q_end.clamp(0, E).to(torch.int64)[:, None])[:, 0]

    # re-segment scores[sig_bc_start:] with the config's distance
    w = cfg.running_stat_width
    dist_row = torch.full((B,), max(cfg.min_obs_per_base, 1), dtype=torch.int32, device=means.device)
    keep_mask, cnt = find_peaks_batch(
        scores, n_scores, dist_row, max_distance=cfg.min_obs_per_base + 1, min_pos=sig_bc_start
    )
    sel_pos, bc_ok = select_top_peaks(scores, keep_mask, cnt, int(sx.barcode_seg_num_events))
    cpts = torch.sort(sel_pos, dim=1).values + w
    last = (n_scores + 2 * w)[:, None]
    bc_bounds = torch.cat([sig_bc_start[:, None], cpts, last], dim=1)
    bc_means = segment_means(adapter, bc_bounds, a_len)
    bc_dwell = bc_bounds[:, 1:] - bc_bounds[:, :-1]
    norm_bc = _normalize_wrt(bc_means, ev_mean, ev_std, norm_ok)

    k = cfg.barcode_num_events
    outlier = (
        (q_start > sx.consensus_subseq_match_ub_start)
        | (q_end < sx.consensus_subseq_match_lb_end)
        | (q_end > sx.consensus_subseq_match_ub_end)
    )
    base = FingerprintArrays(
        ok=seg_ok & bc_ok & norm_ok & ~outlier,
        fpt=norm_bc[:, -k:],
        dwell=bc_dwell[:, -k:],
        adapter_dt_med=dt_med,
        adapter_dt_mad=dt_mad,
        adapter_event_mean=ev_mean,
        adapter_event_std=ev_std,
        adapter_event_med=ev_med,
        adapter_event_mad=ev_mad,
    )
    return ConsensusFingerprintArrays(
        base=base,
        outlier=outlier & seg_ok & norm_ok,
        seg_query_start=q_start,
        seg_query_end=q_end,
        sig_barcode_start=sig_bc_start,
    )
